"""Banded (window) or prefix (compressed) attention forward with a query
position offset (csrc/banded_attn.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash.py::flash_banded (axis-aligned
tiles). The prefill runs it for the compressed branch when the fused
scorer does not fit (`ops.cuda.select_cmp.select_cmp_fits`); the window
branch keeps win_attn. Bound on the H100 and design: see the note at the
top of the CUDA source.

Row statistics follow the port's convention (ops.reference): natural-log
lse [B,S,G,h], EMPTY_LSE on a row with no visible key; the TPU kernel's
base-2 flat [B*G, 1, stats_rows] layout is not copied.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import MODES, banded_mask
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, ptr, ptr_or_null, raise_on_error,
    resolve_kernel, stream_of,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) per block, the kernel's maximum
MAX_DV = 128          # output dims the kernel's register slices cover


def banded_attn_plain(Q, K, V, *, mode: str, w: int = 0, l: int = 0, d: int = 1, scale: float,
                      t_start: int = 0, return_lse: bool = False):
    """Plain PyTorch version: masked attention under `banded_mask`."""
    m = banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, t_start=t_start,
                    device=Q.device)
    return ref.attend_masked(Q, K, V, m[None, :, None, None, :], scale, return_lse)


def banded_attn(Q, K, V, *, mode: str, w: int = 0, l: int = 0, d: int = 1, scale: float,
                t_start: int = 0, return_lse: bool = False):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv] -> O [B,S,G,h,Dv],
    and with return_lse the f32 row statistics lse [B,S,G,h]. Query row s
    sits at position t_start + s (a host int). "win" needs w > 0, "cmp"
    needs l, d > 0. CPU tensors take the plain version."""
    if resolve_kernel(Q) == "plain":
        return banded_attn_plain(Q, K, V, mode=mode, w=w, l=l, d=d, scale=scale,
                                 t_start=t_start, return_lse=return_lse)
    if mode not in MODES:
        raise ValueError(f"banded_attn: mode must be 'win' or 'cmp', got {mode!r}")
    code = check_operands("banded_attn", {"Q": Q, "K": K, "V": V})
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv):
        raise ValueError(f"banded_attn: K {tuple(K.shape)} / V {tuple(V.shape)} do not match "
                         f"Q {tuple(Q.shape)}")
    check_vector_rows("banded_attn", Q=Q, K=K, V=V)
    if (mode == "win" and w <= 0) or (mode == "cmp" and (l <= 0 or d <= 0)) or t_start < 0:
        raise ValueError("banded_attn: win needs w > 0, cmp needs l, d > 0; t_start >= 0")
    if h > ROWS_PER_BLOCK or Dv > MAX_DV:
        raise ValueError(f"banded_attn: needs h <= {ROWS_PER_BLOCK} and Dv <= {MAX_DV}, "
                         f"got h={h}, Dv={Dv}")
    lib = library()
    tq = max(1, ROWS_PER_BLOCK // h)
    check_smem("banded_attn", lib.nsa_banded_attn_smem_bytes(tq, h, Dk, Dv))
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    lse = (torch.empty((B, S, G, h), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    with torch.cuda.device(Q.device):
        err = lib.nsa_banded_attn(code, ptr(Q), ptr(K), ptr(V), ptr(O), ptr_or_null(lse), B, S,
                                  S_kv, G, h, Dk, Dv, MODES[mode], w, l, d, int(t_start),
                                  float(scale), tq, stream_of(Q))
    raise_on_error(lib, "banded_attn", err)
    banded_attn.launches += 1
    return (O, lse) if return_lse else O


banded_attn.launches = 0
