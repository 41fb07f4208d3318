"""Diagonal sliding-window attention backward (csrc/banded_bwd_mma.cu,
csrc/win_bwd_diag.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_bwd_diag (the
window backward of the JAX train step under win.bwd_diag = 1). It computes
the same function as banded_bwd and banded_bwd_1p in window mode, so its
plain version is banded_bwd's. Two kernels, chosen by dtype alone:
- bf16: the q-major tensor-core kernel (banded_bwd_mma.cu; P and dS
  rounded to bf16 before their products, as the TPU kernel does; its bound
  is the plain version's unrounded f32 gradients within a multiple of
  `banded_bwd.banded_bwd_rss`), q tiles of MMA_TILE_ROWS rows;
- f32: the FMA kernel (win_bwd_diag.cu), q tiles of one 64-row chunk.
Both sum per-tile f32 dK/dV strips per key in tile order (`strip_bytes`).
With `seq_start` (packed documents) each row's keys stop at its document
start; a q tile's strips keep the dense band, so the keys no row of it
sees are written as zeros. Bound on the H100 and design: see the notes at
the top of the CUDA sources.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd_plain
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import ROWS_PER_CHUNK, check_banded_operands
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_smem, ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)

# rows (tokens x heads) per q tile of the bf16 kernel: 64, 128 or 192 (192
# for Dk, Dv <= 64 only); 128 halves the strips of 64 (PERF.md)
MMA_TILE_ROWS = 128


def tile_plan(lib, dtype, B: int, S: int, S_kv: int, G: int, h: int, Dk: int, Dv: int,
              w: int) -> tuple:
    """(tokens per q tile, strip keys SL, strip bytes) of a launch: the
    strips are B * G * ceil(S / tokens) * SL * (Dk + Dv) f32."""
    if dtype == torch.bfloat16:
        tq = MMA_TILE_ROWS // h
        sl = lib.nsa_win_bwd_diag_mma_strip_keys(MMA_TILE_ROWS, h, w, S_kv)
    else:
        tq = max(1, ROWS_PER_CHUNK // h)   # the tokens of one 64-row chunk
        sl = lib.nsa_win_bwd_diag_strip_keys(tq, w, S_kv)
    return tq, sl, B * G * -(-S // tq) * sl * (Dk + Dv) * 4


def win_bwd_diag(Q, K, V, dO, lse, delta, *, w: int, scale: float, seq_start=None,
                 t_start: int = 0):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) of the window branch (query row s at position t = t_start
    + s, a host int, sees keys [t-w+1, t]; the strips scatter into all
    S_kv keys; with seq_start [B,S] int32 (at any t_start) none before the
    row's document start) in the operands' dtype.
    CPU tensors take the plain version. Counts launches in
    `win_bwd_diag.launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode="win", w=w, scale=scale,
                                seq_start=seq_start, t_start=t_start)
    code = check_banded_operands("win_bwd_diag", Q, K, V, dO, lse, delta, mode="win", w=w, l=0,
                                 d=1, seq_start=seq_start, t_start=t_start)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    mma = code == DTYPE_CODES[torch.bfloat16]
    lib = library()
    check_smem("win_bwd_diag", lib.nsa_win_bwd_diag_mma_smem_bytes(Dk, Dv, MMA_TILE_ROWS) if mma
               else lib.nsa_win_bwd_diag_smem_bytes(Dk, Dv))
    tq, sl, _ = tile_plan(lib, Q.dtype, B, S, S_kv, G, h, Dk, Dv, w)
    n_q = -(-S // tq)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    strip_k = torch.empty(B * G * n_q * sl * Dk, dtype=torch.float32, device=Q.device)
    strip_v = torch.empty(B * G * n_q * sl * Dv, dtype=torch.float32, device=Q.device)
    args = (ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta), ptr_or_null(seq_start),
            ptr(dQ), ptr(dK), ptr(dV), ptr(strip_k), ptr(strip_v), B, S, S_kv, G, h, Dk, Dv, w,
            float(scale), t_start)
    with torch.cuda.device(Q.device):
        if mma:
            err = lib.nsa_win_bwd_diag_mma(*args, MMA_TILE_ROWS, stream_of(Q))
        else:
            err = lib.nsa_win_bwd_diag(*args, tq, stream_of(Q))
    raise_on_error(lib, "win_bwd_diag", err)
    win_bwd_diag.launches += 1
    return dQ, dK, dV


win_bwd_diag.launches = 0
