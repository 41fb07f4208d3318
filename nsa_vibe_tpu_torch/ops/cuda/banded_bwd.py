"""Window / compressed-prefix attention backward, two-pass design
(csrc/banded_bwd_mma.cu, csrc/banded_bwd.cu, and the kv-major kernels of
csrc/banded_bwd_mma.cu and csrc/banded_bwd_1p.cu with their dQ slots off).

Replaces nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd (the
two-pass win and cmp backward of the JAX train step under bwd.onepass =
0): a q-major dQ pass, then a kv-major dK/dV pass. Kernels, chosen by
dtype alone:
- bf16: dQ from the q-major tensor-core kernel (banded_bwd_dq_mma_kernel,
  q tiles of DQ_TILE_ROWS rows), dK and dV from the one-pass tensor-core
  kernel with its slots off (banded_bwd_1p.kv_pass); P and dS rounded to
  bf16 before their products, as the TPU kernels do, so the bound is the
  plain version's unrounded f32 gradients within a multiple of
  `banded_bwd_rss`, not two ulps;
- f32: dQ from the FMA kernel of banded_bwd.cu, dK and dV from the FMA
  one-pass kernel with its slots off.
This module also holds the plain version of every banded backward design
(`banded_bwd_plain`, `banded_bwd_rss`). Every design takes an optional
`seq_start` [B,S] int32 (packed documents, ops/varlen.py): row t then sees
no key before its document start (window) or no pooled token that starts
before it (compressed); the kernels take a pointer to it, null for the
dense bound, whose bits they keep. Bound on the H100 and design: see the
notes at the top of the CUDA sources.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops import varlen
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_offset, check_smem, ptr, ptr_or_null, raise_on_error, resolve_kernel,
    stream_of,
)

MODES = {"win": 0, "cmp": 1}
ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per block of the f32 dQ kernel, its maximum
# rows (tokens x heads) per q tile of the bf16 dQ kernel: 64 or 128 (PERF.md)
DQ_TILE_ROWS = 128


def banded_mask(S: int, S_kv: int, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                t_start: int = 0, device=None, seq_start=None) -> torch.Tensor:
    """[S, S_kv] visibility of query row s at position t = t_start + s:
    "win" sees keys [t-w+1, t]; "cmp" the first num_cmp(t+1) compressed
    tokens (flash.py::_bounds_fn). With seq_start [B,S] (packed documents)
    [B, S, S_kv], under ops/varlen.py's document bound."""
    t_pos = torch.arange(t_start, t_start + S, device=device)
    if mode not in MODES:
        raise ValueError(f"banded mode must be 'win' or 'cmp', got {mode!r}")
    if seq_start is not None:
        if mode == "win":
            return varlen.win_mask_varlen(t_pos, seq_start, S_kv, w)
        return varlen.cmp_mask_varlen(t_pos, seq_start, S_kv, l, d)
    if mode == "win":
        return ref.sliding_window_mask(t_pos, S_kv, w)
    return ref.compressed_mask(ref.num_cmp_per_token(S, l, d, S_kv, device, t_start), S_kv)


def mask5(m: torch.Tensor) -> torch.Tensor:
    """banded_mask's [S, S_kv] or [B, S, S_kv] -> broadcastable [B,S,G,h,S_kv]."""
    return m[None, :, None, None, :] if m.dim() == 2 else m[:, :, None, None, :]


def banded_bwd_plain(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                     scale: float, seq_start=None, t_start: int = 0, gate=None):
    """Plain PyTorch version: the dense formula on the same operands (with
    gate [B,S,G] f32, the gate-epilogue fold: on ref.gate_dO(dO, gate))."""
    check_offset("banded_bwd", t_start)
    m = banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, t_start=t_start,
                    device=Q.device, seq_start=seq_start)
    if gate is not None:
        dO = ref.gate_dO(dO, gate)
    return ref.attend_masked_bwd(Q, K, V, dO, lse, delta, mask5(m), scale)


def banded_bwd_rss(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                   scale: float, seq_start=None, t_start: int = 0):
    """(dQ, dK, dV) of the plain version in f32 from the operands' values,
    unrounded, and the root sum of squares of each element's terms
    (ops/reference.py::attend_masked_bwd_rss): the scale of what rounding
    P and dS to bf16 before their products moves each element."""
    m = mask5(banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, t_start=t_start,
                          device=Q.device, seq_start=seq_start))
    args = [x.float() for x in (Q, K, V, dO)]
    return (ref.attend_masked_bwd(*args, lse, delta, m, scale),
            ref.attend_masked_bwd_rss(*args, lse, delta, m, scale))


def banded_bwd(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
               scale: float, seq_start=None, t_start: int = 0):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) in the operands' dtype. Query row s is at position
    t_start + s (a host int: sequence sharding, where K/V cover the whole
    sequence); seq_start [B,S] int32 (or None; at any t_start) bounds each row
    to its document.
    CPU tensors take the plain version. Counts launches in
    `banded_bwd.launches` and, of those in cmp mode, in
    `banded_bwd.cmp_launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode=mode, w=w, l=l, d=d, scale=scale,
                                seq_start=seq_start, t_start=t_start)
    # imported here: banded_bwd_1p takes its plain version from this module
    from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import check_banded_operands, kv_pass

    code = check_banded_operands("banded_bwd", Q, K, V, dO, lse, delta, mode=mode, w=w, l=l, d=d,
                                 seq_start=seq_start, t_start=t_start)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    lib = library()
    dQ = torch.empty_like(Q)
    args = (ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta), ptr_or_null(seq_start),
            ptr(dQ), B, S, S_kv, G, h, Dk, Dv, MODES[mode], w, l, d, float(scale), t_start)
    with torch.cuda.device(Q.device):
        if code == DTYPE_CODES[torch.bfloat16]:
            check_smem("banded_bwd", lib.nsa_banded_bwd_dq_mma_smem_bytes(Dk, Dv, DQ_TILE_ROWS))
            err = lib.nsa_banded_bwd_dq_mma(*args, DQ_TILE_ROWS, stream_of(Q))
        else:
            check_smem("banded_bwd", lib.nsa_banded_bwd_smem_bytes(Dk, Dv))
            err = lib.nsa_banded_bwd(*args, max(1, ROWS_PER_CHUNK // h), stream_of(Q))
    raise_on_error(lib, "banded_bwd", err)
    _, dK, dV = kv_pass("banded_bwd", lib, code, Q, K, V, dO, lse, delta, mode=mode, w=w, l=l,
                        d=d, scale=scale, slots=False, seq_start=seq_start, t_start=t_start)
    banded_bwd.launches += 1
    if mode == "cmp":
        banded_bwd.cmp_launches += 1
    return dQ, dK, dV


banded_bwd.launches = 0
banded_bwd.cmp_launches = 0
