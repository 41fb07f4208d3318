"""Banded (window) or prefix (compressed) attention forward with a query
position offset (csrc/banded_fwd_mma.cu, csrc/banded_attn.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash.py::flash_banded (axis-aligned
tiles). The prefill runs it for the compressed branch when the fused
scorer does not fit (`ops.cuda.select_cmp.select_cmp_fits`); the window
branch calls win_attn, which launches the same kernels in window mode.
Two kernels, chosen by dtype alone:
- bf16: the tensor-core kernel (banded_fwd_mma.cu; P rounded to bf16
  before P V, as the TPU kernels do, so its bound is the plain version's
  unrounded f32 result within a multiple of `banded_attn_rss`, not two
  ulps), q tiles of MMA_TILE_ROWS rows;
- f32: the FMA kernel (banded_attn.cu).
Bound on the H100 and design: see the notes at the top of the CUDA
sources.

Row statistics follow the port's convention (ops.reference): natural-log
lse [B,S,G,h], EMPTY_LSE on a row with no visible key; the TPU kernel's
base-2 flat [B*G, 1, stats_rows] layout is not copied.

Packed documents (ops/varlen.py): with `seq_start` [B,S] int32 (row s
reads seq_start[b, s], a packed position, also at t_start > 0) row t sees
no key before its document start (window) and no pooled token that starts
before it (compressed); the kernels get a pointer to it,
null for the dense bound, whose bits they keep.

Gate-epilogue fold (nsa.gate_fold): with `gate` [B,S,G] f32 the kernels
emit O * g, formed in f32 before the cast (flash.py:274, flash_diag.py:125);
lse stays the ungated softmax's. Null launches the ungated entries.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import MODES, banded_mask, mask5
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_gate, check_offset, check_operands, check_seq_start, check_smem,
    check_vector_rows, ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) per block of the f32 kernel, its maximum
MAX_DV = 128          # output dims the kernels' register slices and tiles cover
# rows (tokens x heads) per q tile of the bf16 kernel, 64 or 128: 128 was the
# faster in both modes at the serve, train and 64k shapes (PERF.md)
MMA_TILE_ROWS = 128


def banded_attn_plain(Q, K, V, *, mode: str, w: int = 0, l: int = 0, d: int = 1, scale: float,
                      t_start: int = 0, return_lse: bool = False, seq_start=None, gate=None):
    """Plain PyTorch version: masked attention under `banded_mask`."""
    m = banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, t_start=t_start,
                    device=Q.device, seq_start=seq_start)
    return ref.attend_masked(Q, K, V, mask5(m), scale, return_lse, gate)


def banded_attn_rss(Q, K, V, *, mode: str, w: int = 0, l: int = 0, d: int = 1, scale: float,
                    t_start: int = 0, seq_start=None):
    """O of the plain version in f32 from the operands' values, unrounded,
    and the root sum of squares of each element's terms
    (ops/reference.py::attend_masked_rss): the scale of what rounding P to
    bf16 before P V moves each element."""
    m = mask5(banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, t_start=t_start,
                          device=Q.device, seq_start=seq_start))
    args = [x.float() for x in (Q, K, V)]
    return ref.attend_masked(*args, m, scale), ref.attend_masked_rss(*args, m, scale)


def launch_banded(name: str, Q, K, V, *, mode: str, w: int, l: int, d: int, scale: float,
                  t_start: int, return_lse: bool, seq_start=None, gate=None):
    """Checks the operands and launches the kernel of Q's dtype; returns O,
    or (O, lse) with return_lse. The caller counts the launch."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be 'win' or 'cmp', got {mode!r}")
    code = check_operands(name, {"Q": Q, "K": K, "V": V})
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv):
        raise ValueError(f"{name}: K {tuple(K.shape)} / V {tuple(V.shape)} do not match "
                         f"Q {tuple(Q.shape)}")
    check_vector_rows(name, Q=Q, K=K, V=V)
    check_seq_start(name, seq_start, B, S, Q.device)
    check_gate(name, gate, B, S, G, Q.device)
    if (mode == "win" and w <= 0) or (mode == "cmp" and (l <= 0 or d <= 0)) or t_start < 0:
        raise ValueError(f"{name}: win needs w > 0, cmp needs l, d > 0; t_start >= 0")
    check_offset(name, t_start)
    mma = code == DTYPE_CODES[torch.bfloat16]
    if h > ROWS_PER_BLOCK or Dv > MAX_DV or (mma and Dk > MAX_DV):
        raise ValueError(f"{name}: needs h <= {ROWS_PER_BLOCK} and Dv <= {MAX_DV}"
                         f"{f', Dk <= {MAX_DV}' if mma else ''}, got h={h}, Dk={Dk}, Dv={Dv}")
    lib = library()
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    lse = (torch.empty((B, S, G, h), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    args = (ptr(Q), ptr(K), ptr(V), ptr_or_null(seq_start), ptr_or_null(gate), ptr(O),
            ptr_or_null(lse), B, S, S_kv, G, h, Dk, Dv, MODES[mode], w, l, d, int(t_start),
            float(scale))
    with torch.cuda.device(Q.device):
        if mma:
            check_smem(name, lib.nsa_banded_fwd_mma_smem_bytes(Dk, Dv, MMA_TILE_ROWS))
            err = lib.nsa_banded_fwd_mma(*args, MMA_TILE_ROWS, stream_of(Q))
        else:
            tq = max(1, ROWS_PER_BLOCK // h)
            check_smem(name, lib.nsa_banded_attn_smem_bytes(tq, h, Dk, Dv))
            err = lib.nsa_banded_attn(*args, tq, stream_of(Q))
    raise_on_error(lib, name, err)
    return (O, lse) if return_lse else O


def banded_attn(Q, K, V, *, mode: str, w: int = 0, l: int = 0, d: int = 1, scale: float,
                t_start: int = 0, return_lse: bool = False, seq_start=None, gate=None):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv] -> O [B,S,G,h,Dv],
    and with return_lse the f32 row statistics lse [B,S,G,h]. Query row s
    sits at position t_start + s (a host int). "win" needs w > 0, "cmp"
    needs l, d > 0; seq_start [B,S] int32 (at any t_start) bounds each row to
    its document; gate [B,S,G] f32 (or None) scales O. CPU tensors take the
    plain version. Counts launches in `banded_attn.launches`, the gated ones
    also in `banded_attn.gated_launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_attn_plain(Q, K, V, mode=mode, w=w, l=l, d=d, scale=scale,
                                 t_start=t_start, return_lse=return_lse, seq_start=seq_start,
                                 gate=gate)
    out = launch_banded("banded_attn", Q, K, V, mode=mode, w=w, l=l, d=d, scale=scale,
                        t_start=t_start, return_lse=return_lse, seq_start=seq_start, gate=gate)
    banded_attn.launches += 1
    banded_attn.gated_launches += gate is not None
    return out


banded_attn.launches = 0
banded_attn.gated_launches = 0
