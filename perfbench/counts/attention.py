"""The least work of NSA attention, for its roofline share.

Operations come from the exact visible-key counts of counts/flops.py;
bytes from the tensors the work must touch, each read or written once:
Q, the K and V of each branch, O and the row statistics lse (float32)
for every branch, and in training also dO, dQ, dK and dV. The
compressed branch's softmax serves the selection scores, so its QK is
counted once. Training counts the forward and a backward of twice the
forward's operations; recomputation is not counted. The same work is
read whatever kernels do it, so the share cannot exceed what the chip
allows. Decode counts the selection branch alone: its compressed and
window branches are plain tensor code, not the port's kernels.
"""

from __future__ import annotations

from perfbench.counts.flops import key_reads, num_cmp

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _ops(keys: int, cfg: dict) -> int:
    return keys * cfg["n_heads"] * 2 * (cfg["d_k"] + cfg["d_v"])


def prefill_work(cfg: dict, rows: int, seq: int, train: bool) -> dict:
    """{"ops", "bytes"} of the three branches over rows x seq tokens, all
    layers."""
    e = ELEM[cfg["dtype"]]
    H, G, dk, dv, L = (cfg["n_heads"], cfg["n_kv_groups"], cfg["d_k"], cfg["d_v"],
                       cfg["n_layers"])
    reads = key_reads(seq, cfg)
    ops = _ops(sum(reads.values()), cfg) * rows * L
    s_cmp = num_cmp(seq, cfg["l"], cfg["d"])
    tok = rows * seq
    q = tok * H * dk * e
    o = tok * H * dv * e
    lse = tok * H * 4
    kv = rows * G * (2 * seq + s_cmp) * (dk + dv) * e          # sel, win, cmp streams
    nbytes = q + 3 * (o + lse) + kv
    if train:
        ops *= 3
        nbytes += 3 * o + q + kv                                 # dO per branch, dQ, dK/dV
    return {"ops": ops, "bytes": nbytes * L}


def decode_sel_work(cfg: dict, t: int) -> dict:
    """{"ops", "bytes"} of the selection branch for the token at
    position t, all layers."""
    e = ELEM[cfg["dtype"]]
    H, G, dk, dv, L = (cfg["n_heads"], cfg["n_kv_groups"], cfg["d_k"], cfg["d_v"],
                       cfg["n_layers"])
    keys = min(t + 1, cfg["n_sel"] * cfg["l_sel"])
    return {"ops": _ops(keys, cfg) * L,
            "bytes": (H * (dk + dv) * e + G * keys * (dk + dv) * e) * L}


def least_seconds(work: dict, peak_flops: float, bytes_per_s: float) -> float:
    return max(work["ops"] / peak_flops, work["bytes"] / bytes_per_s)
