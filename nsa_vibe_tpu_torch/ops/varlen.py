"""Varlen (document-masked) batching: packed multi-document rows.

The port's own copy of nsa_vibe_tpu/ops/varlen.py: the masks, the plain
branches that the kernels' plain versions are built from, the doc-local
selection pipeline, and the numpy packer and batch source (the same
arithmetic, so a seed gives the same batches in both packages).

Documents are packed contiguously, each start aligned to a multiple of
l_sel (pad tokens are loss-masked). One [B, S] int32 tensor `seq_start`,
the packed index of each token's document start, carries the contract:

  * positions are document-local: t_local = t - seq_start[t] (RoPE of Q,
    K_sel, K_win and the ϕ positions);
  * window: row t sees keys [max(t - w + 1, ds), t];
  * compressed: pooled token j (packed [j*d, j*d + l)) is visible iff
    j*d >= ds and j*d + l <= t + 1; a row with none gets O = 0 (lse
    EMPTY_LSE) and, in the scorer, p = 0;
  * selection: candidates are blocks [ds // l_sel, t // l_sel]; the forced
    "init" block is ds // l_sel and the forced local blocks are clamped to
    it from below. The selection kernels take no seq_start: doc-local sets
    and kpos <= t keep them inside the document.

Because the alignment makes each document's window, pooling and block
grids coincide with the packed grid, a packed document computes what it
computes alone in its own row. The port's avg ϕ is window-exact
(ops/compress.py), so perturbing one document moves every other
document's outputs by exactly 0.0 (the JAX package's `varlen_exact`).
The contract is not checked where the tensors are used (that would make
the host wait for the card); `pack_documents_aligned` makes it.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from nsa_vibe_tpu_torch.ops.reference import attend_masked
from nsa_vibe_tpu_torch.ops.selection import (
    NEG_INF, canonicalize_sel, group_reduce, map_pcmp_to_pslc, tie_break_scores,
)

# ------------------------------------------------------------------ masks


def win_mask_varlen(t_pos: torch.Tensor, seq_start: torch.Tensor, S_kv: int,
                    w: int) -> torch.Tensor:
    """[S] t_pos, [B,S] seq_start -> [B,S,S_kv] bool."""
    k = torch.arange(S_kv, device=t_pos.device)[None, None, :]
    t = t_pos.to(torch.int64)[None, :, None]
    ds = seq_start.to(torch.int64)[:, :, None]
    return (k <= t) & (k > t - w) & (k >= ds)


def cmp_mask_varlen(t_pos: torch.Tensor, seq_start: torch.Tensor, S_cmp: int, l: int,
                    d: int) -> torch.Tensor:
    """Visibility of pooled tokens: [B,S,S_cmp] bool."""
    j = torch.arange(S_cmp, device=t_pos.device)[None, None, :]
    t = t_pos.to(torch.int64)[None, :, None]
    ds = seq_start.to(torch.int64)[:, :, None]
    return (j * d >= ds) & (j * d + l <= t + 1)


def sel_token_mask_varlen(sel_idx: torch.Tensor, t_pos: torch.Tensor,
                          seq_start: torch.Tensor, l_sel: int, S_kv: int) -> torch.Tensor:
    """[B,S,G,n] sel_idx -> [B,S,G,S_kv] bool: the union of the selected
    blocks (-1 and repeats add nothing), clamped to [ds, t]."""
    kv = torch.arange(S_kv, device=sel_idx.device)
    chosen = (sel_idx.long()[..., :, None] == (kv // l_sel)).any(dim=-2)
    t = t_pos.to(torch.int64)[None, :, None]
    ds = seq_start.to(torch.int64)[:, :, None]
    return chosen & ((kv <= t) & (kv >= ds))[:, :, None, :]


# ------------------------------------------------------------------ plain branches


def sliding_window_attention_varlen(Q, K, V, t_pos, seq_start, w: int, scale: float,
                                    return_lse: bool = False, gate=None):
    m = win_mask_varlen(t_pos, seq_start, K.shape[2], w)
    return attend_masked(Q, K, V, m[:, :, None, None, :], scale, return_lse, gate)


def compressed_attention_varlen(Q, K_cmp, V_cmp, t_pos, seq_start, l: int, d: int,
                                scale: float, return_lse: bool = False, gate=None):
    m = cmp_mask_varlen(t_pos, seq_start, K_cmp.shape[2], l, d)
    return attend_masked(Q, K_cmp, V_cmp, m[:, :, None, None, :], scale, return_lse, gate)


def selection_attention_varlen(Q, K, V, sel_idx, t_pos, seq_start, l_sel: int, scale: float,
                               return_lse: bool = False):
    m = sel_token_mask_varlen(sel_idx, t_pos, seq_start, l_sel, K.shape[2])
    return attend_masked(Q, K, V, m[:, :, :, None, :], scale, return_lse)


# ------------------------------------------------------------------ selection pipeline


def compute_pcmp_varlen(Q, K_cmp, scale: float, t_pos, seq_start, l: int,
                        d: int) -> torch.Tensor:
    """Eq. 8 under the document bound: f32 [B,S,G,h,S_cmp], rows with no
    visible pooled token all zero."""
    logits = torch.einsum("bsghd,bgcd->bsghc", Q.float(), K_cmp.float()) * scale
    vis = cmp_mask_varlen(t_pos, seq_start, K_cmp.shape[2], l, d)[:, :, None, None, :]
    p = torch.softmax(logits.masked_fill(~vis, NEG_INF), dim=-1)
    return torch.where(vis.any(dim=-1, keepdim=True), p, torch.zeros((), device=p.device))


def selection_scores_varlen(Q, K_cmp, M_csl, scale: float, t_pos, seq_start, l: int,
                            d: int) -> torch.Tensor:
    """Eq. 8-10 with per-document visibility. Q [B,S,G,h,Dk] -> p_grp
    [B,S,G,S_sel] f32."""
    p = compute_pcmp_varlen(Q, K_cmp, scale, t_pos, seq_start, l, d)
    return group_reduce(map_pcmp_to_pslc(p, M_csl))


def topn_forced_first_varlen(p_grp: torch.Tensor, n_top: int, t_pos: torch.Tensor,
                             seq_start: torch.Tensor, l_sel: int, force_init: bool = True,
                             force_local: int = 2) -> torch.Tensor:
    """Doc-local Eq. 11-12 in the fused scorer's form (scorer.py::
    _scorer_topn with ds_t): the forced slots (ds // l_sel, then
    max(t // l_sel - i, ds // l_sel)), then the non-forced blocks of
    [ds // l_sel, t // l_sel] in descending `p_grp - 1e-8 * index` order,
    -1 when none is left. p_grp [B,S,G,S_sel], t_pos [S] -> [B,S,G,n_out]."""
    B, S, G, S_sel = p_grp.shape
    dev = p_grp.device
    blk = torch.arange(S_sel, device=dev)
    t = t_pos.to(torch.int64)[None, :, None]                          # [1,S,1]
    first = torch.div(seq_start.to(torch.int64), l_sel, rounding_mode="floor")[:, :, None]
    last = torch.div(t, l_sel, rounding_mode="floor")
    valid = (blk * l_sel <= t) & (blk >= first)                       # [B,S,S_sel]
    scores = torch.where(valid[:, :, None, :], p_grp.float(),
                         torch.full((), NEG_INF, device=dev))
    cols = ([first] if force_init else []) + [torch.maximum(last - i, first)
                                              for i in range(force_local)]
    F_ = len(cols)
    picks = []
    if F_:
        forced = torch.cat([c.expand(B, S, 1) for c in cols], dim=-1)   # [B,S,F]
        fmask = (blk[:, None] == forced[..., None, :]).any(dim=-1)
        scores = scores.masked_fill(fmask[:, :, None, :], NEG_INF)
        picks.append(forced[:, :, None, :].expand(B, S, G, F_).to(torch.int32))
    k_rest = max(0, n_top - F_)
    if k_rest > 0:
        srt = torch.sort(tie_break_scores(scores), dim=-1, descending=True, stable=True)
        k_actual = min(k_rest, S_sel)
        top_val, top_idx = srt.values[..., :k_actual], srt.indices[..., :k_actual]
        picks.append(torch.where(torch.isfinite(top_val), top_idx.to(torch.int32),
                                 torch.full_like(top_idx, -1, dtype=torch.int32)))
        if k_rest > k_actual:
            picks.append(torch.full((B, S, G, k_rest - k_actual), -1, dtype=torch.int32,
                                    device=dev))
    return torch.cat(picks, dim=-1)


def select_topn_blocks_varlen(p_grp: torch.Tensor, n_top: int, t_pos: torch.Tensor,
                              seq_start: torch.Tensor, l_sel: int, force_init: bool = True,
                              force_local: int = 2) -> torch.Tensor:
    """`topn_forced_first_varlen` in canonical form: unique ids sorted
    ascending, -1 padding at the tail (the JAX function's output)."""
    return canonicalize_sel(topn_forced_first_varlen(p_grp, n_top, t_pos, seq_start, l_sel,
                                                     force_init, force_local))


# ------------------------------------------------------------------ packing


def pack_documents_aligned(docs: List[np.ndarray], seq_len: int, align: int,
                           batch_size: int,
                           pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy first-fit packing of token docs into [N, seq_len+1] rows with
    every document start aligned to `align` (= l_sel). Returns (tokens
    [N, seq_len+1] int32, seq_start [N, seq_len] int32, loss_mask
    [N, seq_len] f32), N a multiple of batch_size. A document longer than
    seq_len is split into seq_len-sized pieces (each its own document);
    pieces of fewer than 2 tokens are dropped. The label at position t is
    token t+1, masked at each document's last token and on padding; the
    padding up to the next aligned start keeps its document's start, and a
    row's tail of padding starts at its own aligned start."""
    pieces: List[np.ndarray] = []
    for d0 in docs:
        a = np.asarray(d0, dtype=np.int32).reshape(-1)
        for i in range(0, len(a), seq_len):
            piece = a[i:i + seq_len]
            if len(piece) >= 2:
                pieces.append(piece)

    rows_tok, rows_ds, rows_lm = [], [], []

    def empty_row():
        return (np.full((seq_len + 1,), pad_id, np.int32), np.zeros((seq_len,), np.int32),
                np.zeros((seq_len,), np.float32))

    cur, cur_ds, cur_lm = empty_row()
    off = 0
    for piece in pieces:
        n = len(piece)
        if off + n > seq_len:
            if off > 0:
                rows_tok.append(cur)
                rows_ds.append(cur_ds)
                rows_lm.append(cur_lm)
            cur, cur_ds, cur_lm = empty_row()
            off = 0
        cur[off:off + n] = piece
        cur_ds[off:off + n] = off
        cur_lm[off:off + n - 1] = 1.0
        off = -(-(off + n) // align) * align
        if off >= seq_len:
            rows_tok.append(cur)
            rows_ds.append(cur_ds)
            rows_lm.append(cur_lm)
            cur, cur_ds, cur_lm = empty_row()
            off = 0
        else:
            cur_ds[off:] = off
    if off > 0:
        rows_tok.append(cur)
        rows_ds.append(cur_ds)
        rows_lm.append(cur_lm)
    if not rows_tok:
        raise ValueError("no documents with >= 2 tokens to pack")
    while len(rows_tok) % batch_size != 0:
        t, ds, lm = empty_row()
        rows_tok.append(t)
        rows_ds.append(ds)
        rows_lm.append(lm)
    return np.stack(rows_tok), np.stack(rows_ds), np.stack(rows_lm)


def make_varlen_batches(source: str, seq_len: int, batch_size: int, align: int,
                        seed: int = 0, tokenizer: str = "byte", pad_id: int = 0,
                        epochs: int = 1, shard=None
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (tokens [B,S+1], seq_start [B,S], loss_mask [B,S]) batches of
    align-packed documents from 'synthetic' (documents of max(seq_len // 3,
    8) tokens) or a local .jsonl/.txt file (train.data's sources; fineweb
    needs the network and is not read), the documents `shard` (a
    train.data.Shard) owns; synthetic takes the stream of seed +
    shard.rem, as make_batches does. Packs batch_size * 4 documents at a
    time. epochs (local files only): 0 cycles forever."""
    from nsa_vibe_tpu_torch.train.data import Shard, local_docs, make_tokenizer, synthetic_docs

    tokenize = make_tokenizer(tokenizer)
    shard = shard or Shard()
    if source == "synthetic":
        docs = synthetic_docs(seed=seed + shard.rem, doc_len=max(seq_len // 3, 8))
    elif source.startswith("fineweb"):
        raise ValueError("the fineweb source needs the network and HF `datasets`; the port "
                         "reads --data synthetic or a local .jsonl/.txt file")
    elif os.path.exists(source):
        docs = local_docs(source, shard, tokenize=tokenize, epochs=epochs)
    else:
        raise ValueError(f"unknown data source: {source}")

    def emit(buf):
        toks, ds, lm = pack_documents_aligned(buf, seq_len, align, batch_size, pad_id)
        for i in range(0, len(toks), batch_size):
            yield toks[i:i + batch_size], ds[i:i + batch_size], lm[i:i + batch_size]

    buf: List[np.ndarray] = []
    for doc in docs:
        buf.append(np.asarray(doc))
        if len(buf) >= batch_size * 4:
            yield from emit(buf)
            buf = []
    if buf:
        yield from emit(buf)

