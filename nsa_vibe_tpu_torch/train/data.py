"""Data pipeline: byte-LM token streams with fixed-length packing.

The port's own copy of nsa_vibe_tpu/train/data.py (tokenize_bytes, the
byte tokenizer, synthetic_docs, pack_token_stream, its native form
pack_token_stream_native over the C++ packer of nsa_vibe_tpu_torch/native,
local_docs, make_batches, collate_varlen, Shard): the same numpy
arithmetic, so a seed gives the same batches in both packages, whichever
packer runs. Packed-document (varlen) batches come from
ops/varlen.py::make_varlen_batches over the same sources. Doc-level
sharding (`Shard`) splits documents across the dp members of a parallel
run (parallel/): member r of n reads the documents whose index is r mod n
(synthetic: the stream of seed + r); the sp ranks of one member read the
same rows and each takes its positions. Not ported: HF tokenizers (they
need tokenizer files the repo does not hold; `make_tokenizer("hf:...")`
raises) and the fineweb stream (it needs the network and HF `datasets`;
`make_batches("fineweb...")` raises).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class Shard:
    """Doc-level modulo sharding: rank `rem` of `mod` consumes docs where
    doc_index % mod == rem."""

    mod: int = 1
    rem: int = 0

    def owns(self, index: int) -> bool:
        return index % self.mod == self.rem


def tokenize_bytes(text: str) -> np.ndarray:
    """Byte-level tokenizer (vocab 256)."""
    return np.frombuffer(text.encode("utf-8", errors="ignore"), dtype=np.uint8).astype(
        np.int32
    )


def make_tokenizer(spec: str = "byte"):
    """Tokenizer factory: only "byte" (vocab 256) in the port."""
    if spec == "byte":
        return tokenize_bytes
    if spec.startswith("hf:"):
        raise ValueError(f"tokenizer {spec!r}: an HF tokenizer needs tokenizer files that are "
                         "not in the repo; the port reads --tokenizer byte only")
    raise ValueError(f"unknown tokenizer spec: {spec} (the port has only 'byte')")


def pack_token_stream(
    docs: Iterable[np.ndarray], seq_len: int, batch_size: int
) -> Iterator[np.ndarray]:
    """Concatenate document token streams into dense [batch, seq_len+1]
    rows (the +1 column provides next-token targets). Rolling buffer, no
    padding, no document-boundary loss masking."""
    need = batch_size * (seq_len + 1)
    buf = np.zeros(0, dtype=np.int32)
    for doc in docs:
        if doc.size == 0:
            continue
        buf = np.concatenate([buf, doc])
        while buf.size >= need:
            chunk, buf = buf[:need], buf[need:]
            yield chunk.reshape(batch_size, seq_len + 1)


def pack_token_stream_native(
    docs: Iterable[np.ndarray], seq_len: int, batch_size: int
) -> Iterator[np.ndarray]:
    """pack_token_stream through the C++ ring-buffer packer
    (nsa_vibe_tpu_torch.native): the same batches, no per-document Python
    concatenation. Raises RuntimeError when the library does not build."""
    from nsa_vibe_tpu_torch.native import ByteStreamPacker

    packer = ByteStreamPacker(seq_len, batch_size)
    try:
        for doc in docs:
            if doc.size == 0:
                continue
            packer.feed(doc)
            while (b := packer.next_batch()) is not None:
                yield b
    finally:
        packer.close()


def synthetic_docs(seed: int = 0, doc_len: int = 2048) -> Iterator[np.ndarray]:
    """Deterministic synthetic byte docs with learnable structure (repeated
    patterns + noise) so smoke-training loss visibly decreases."""
    rng = np.random.default_rng(seed)
    while True:
        period = int(rng.integers(3, 17))
        pattern = rng.integers(0, 256, size=period)
        reps = doc_len // period + 1
        doc = np.tile(pattern, reps)[:doc_len]
        noise = rng.random(doc_len) < 0.02
        doc = np.where(noise, rng.integers(0, 256, size=doc_len), doc)
        yield doc.astype(np.int32)


def local_docs(path: str, shard: Shard = Shard(), tokenize=tokenize_bytes,
               epochs: int = 1) -> Iterator[np.ndarray]:
    """Local .jsonl ({'text': ...} per line) or plain .txt file (one
    document, index 0), the documents `shard` owns. epochs=0 cycles the
    file forever."""
    e = 0
    while True:
        idx = 0
        if path.endswith(".jsonl"):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if shard.owns(idx):
                        try:
                            text = json.loads(line).get("text", "")
                        except json.JSONDecodeError:
                            text = ""
                        if text:
                            yield tokenize(text)
                    idx += 1
        else:
            with open(path) as f:
                text = f.read()
            if shard.owns(0):
                yield tokenize(text)
        e += 1
        if epochs and e >= epochs:
            return


def make_batches(
    source: str,
    seq_len: int,
    batch_size: int,
    seed: int = 0,
    tokenizer: str = "byte",
    epochs: int = 1,
    shard: Shard = Shard(),
    native: Optional[bool] = None,
) -> Iterator[np.ndarray]:
    """source: 'synthetic' | path to .jsonl/.txt, the documents `shard`
    owns (synthetic: the stream of seed + shard.rem). epochs (local files
    only): 0 cycles forever. Yields int32 [batch_size, seq_len+1].
    native: True = the C++ packer (raises when it does not build), False =
    Python, None = the C++ packer when it builds; the batches are the same
    (the packer stores byte tokens, and the port's only tokenizer is byte)."""
    tokenize = make_tokenizer(tokenizer)
    if source == "synthetic":
        docs: Iterator[np.ndarray] = synthetic_docs(seed + shard.rem)
    elif source.startswith("fineweb"):
        raise ValueError("the fineweb source needs the network and HF `datasets`; the port "
                         "reads --data synthetic or a local .jsonl/.txt file")
    elif os.path.exists(source):
        docs = local_docs(source, shard, tokenize=tokenize, epochs=epochs)
    else:
        raise ValueError(f"unknown data source: {source}")
    if native is None:
        from nsa_vibe_tpu_torch.native import native_available

        native = native_available()
    pack = pack_token_stream_native if native else pack_token_stream
    yield from pack(docs, seq_len, batch_size)


def collate_varlen(docs: list, seq_len: int, pad_id: int = 0) -> dict:
    """Pad variable-length docs to [B, seq_len] with attention/loss masks,
    shifted labels and cu_seqlens (the cu_seqlens surface of the reference
    implementation; the JAX package's train.data.collate_varlen)."""
    B = len(docs)
    tokens = np.full((B, seq_len), pad_id, np.int32)
    attn_mask = np.zeros((B, seq_len), np.int32)
    labels = np.full((B, seq_len), -1, np.int32)
    lengths = np.zeros(B + 1, np.int32)
    for i, doc in enumerate(docs):
        n = min(len(doc), seq_len)
        tokens[i, :n] = doc[:n]
        attn_mask[i, :n] = 1
        labels[i, : n - 1] = doc[1:n]
        lengths[i + 1] = lengths[i] + n
    return {
        "tokens": tokens,
        "attn_mask": attn_mask,
        "labels": np.where(labels >= 0, labels, 0),
        "loss_mask": (labels >= 0).astype(np.int32),
        "cu_seqlens": lengths,
    }
