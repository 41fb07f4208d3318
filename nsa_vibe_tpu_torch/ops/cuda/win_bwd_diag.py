"""Diagonal sliding-window attention backward (csrc/win_bwd_diag.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_bwd_diag (the
window backward of the JAX train step under win.bwd_diag = 1). It computes
the same function as banded_bwd and banded_bwd_1p in window mode, so its
plain version is banded_bwd's. Bound on the H100 and design: see the note
at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd_plain
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import ROWS_PER_CHUNK, check_banded_operands
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_smem, ptr, raise_on_error, resolve_kernel, stream_of,
)


def win_bwd_diag(Q, K, V, dO, lse, delta, *, w: int, scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) of the window branch (row t sees keys [t-w+1, t]) in the
    operands' dtype. CPU tensors take the plain version. Counts launches in
    `win_bwd_diag.launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode="win", w=w, scale=scale)
    code = check_banded_operands("win_bwd_diag", Q, K, V, dO, lse, delta, mode="win", w=w, l=0,
                                 d=1)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    tq = max(1, ROWS_PER_CHUNK // h)   # q tile: the tokens of one 64-row chunk
    lib = library()
    check_smem("win_bwd_diag", lib.nsa_win_bwd_diag_smem_bytes(Dk, Dv))
    n_q = -(-S // tq)
    sl = lib.nsa_win_bwd_diag_strip_keys(tq, w, S_kv)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    strip_k = torch.empty(B * G * n_q * sl * Dk, dtype=torch.float32, device=Q.device)
    strip_v = torch.empty(B * G * n_q * sl * Dv, dtype=torch.float32, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_win_bwd_diag(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta),
                                   ptr(dQ), ptr(dK), ptr(dV), ptr(strip_k), ptr(strip_v), B, S,
                                   S_kv, G, h, Dk, Dv, w, float(scale), tq, stream_of(Q))
    raise_on_error(lib, "win_bwd_diag", err)
    win_bwd_diag.launches += 1
    return dQ, dK, dV


win_bwd_diag.launches = 0
