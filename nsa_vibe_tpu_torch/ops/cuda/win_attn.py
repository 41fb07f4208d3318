"""Sliding-window attention forward (csrc/win_attn.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_diag (the
win forward that flash.py::flash_banded dispatches to under the shipped
tuning). Bound on the H100 and design: see the note at the top of the
CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, ptr, raise_on_error, resolve_kernel,
    stream_of,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) per block, the kernel's maximum
MAX_DV = 128          # output dims the kernel's register slices cover


def win_attn_plain(Q, K, V, *, w: int, scale: float):
    """Plain PyTorch version: row t sees keys [t-w+1, t]."""
    t_pos = torch.arange(Q.shape[1], device=Q.device)
    return ref.sliding_window_attention(Q, K, V, t_pos, w, scale)


def win_attn(Q, K, V, *, w: int, scale: float):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv] -> O [B,S,G,h,Dv].
    CPU tensors take the plain version."""
    if resolve_kernel(Q) == "plain":
        return win_attn_plain(Q, K, V, w=w, scale=scale)
    code = check_operands("win_attn", {"Q": Q, "K": K, "V": V})
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv):
        raise ValueError(f"win_attn: K {tuple(K.shape)} / V {tuple(V.shape)} do not match "
                         f"Q {tuple(Q.shape)}")
    check_vector_rows("win_attn", Q=Q, K=K, V=V)
    if w <= 0:
        raise ValueError("win_attn: window w must be positive")
    if h > ROWS_PER_BLOCK or Dv > MAX_DV:
        raise ValueError(f"win_attn: needs h <= {ROWS_PER_BLOCK} and Dv <= {MAX_DV}, "
                         f"got h={h}, Dv={Dv}")
    lib = library()
    tq = max(1, ROWS_PER_BLOCK // h)
    check_smem("win_attn", lib.nsa_win_attn_smem_bytes(tq, h, Dk, Dv))
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_win_attn(code, ptr(Q), ptr(K), ptr(V), ptr(O), B, S, S_kv, G, h, Dk, Dv,
                               w, float(scale), tq, stream_of(Q))
    raise_on_error(lib, "win_attn", err)
    win_attn.launches += 1
    return O


win_attn.launches = 0
