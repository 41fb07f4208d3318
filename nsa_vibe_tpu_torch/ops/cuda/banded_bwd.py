"""Window / compressed-prefix attention backward (csrc/banded_bwd.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd (the
two-pass win and cmp backward of the JAX train step under bwd.onepass =
0). Bound on the H100 and design: see the note at the top of the CUDA
source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, kv_splits, ptr, ptr_or_null, raise_on_error,
    resolve_kernel, stream_of,
)

MODES = {"win": 0, "cmp": 1}
ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per chunk, the kernel's maximum
KEYS_PER_TILE = 64    # keys per tile of the kv-major pass
MAX_D = 128           # head widths the kernel's register slices cover


def banded_mask(S: int, S_kv: int, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                t_start: int = 0, device=None) -> torch.Tensor:
    """[S, S_kv] visibility of query row s at position t = t_start + s:
    "win" sees keys [t-w+1, t]; "cmp" the first num_cmp(t+1) compressed
    tokens (flash.py::_bounds_fn)."""
    if mode == "win":
        return ref.sliding_window_mask(torch.arange(t_start, t_start + S, device=device), S_kv, w)
    if mode == "cmp":
        return ref.compressed_mask(ref.num_cmp_per_token(S, l, d, S_kv, device, t_start), S_kv)
    raise ValueError(f"banded mode must be 'win' or 'cmp', got {mode!r}")


def banded_bwd_plain(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                     scale: float):
    """Plain PyTorch version: the dense formula on the same operands."""
    m = banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d, device=Q.device)
    return ref.attend_masked_bwd(Q, K, V, dO, lse, delta, m[None, :, None, None, :], scale)


def banded_bwd_rss(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                   scale: float):
    """(dQ, dK, dV) of the plain version in f32 from the operands' values,
    unrounded, and the root sum of squares of each element's terms
    (ops/reference.py::attend_masked_bwd_rss): the scale of what rounding
    P and dS to bf16 before their products moves each element."""
    m = banded_mask(Q.shape[1], K.shape[2], mode=mode, w=w, l=l, d=d,
                    device=Q.device)[None, :, None, None, :]
    args = [x.float() for x in (Q, K, V, dO)]
    return (ref.attend_masked_bwd(*args, lse, delta, m, scale),
            ref.attend_masked_bwd_rss(*args, lse, delta, m, scale))


def banded_bwd(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
               scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) in the operands' dtype. Query row s is at position s.
    CPU tensors take the plain version. Counts launches in
    `banded_bwd.launches` and, of those in cmp mode, in
    `banded_bwd.cmp_launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode=mode, w=w, l=l, d=d, scale=scale)
    if mode not in MODES:
        raise ValueError(f"banded_bwd: mode must be 'win' or 'cmp', got {mode!r}")
    code = check_operands("banded_bwd", {"Q": Q, "K": K, "V": V, "dO": dO})
    check_operands("banded_bwd", {"lse": lse, "delta": delta})
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or dO.shape != (B, S, G, h, Dv) or lse.shape != (B, S, G, h) \
            or delta.shape != lse.shape or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise ValueError(f"banded_bwd: shapes Q {tuple(Q.shape)} K {tuple(K.shape)} "
                         f"V {tuple(V.shape)} dO {tuple(dO.shape)} lse {tuple(lse.shape)} "
                         f"delta {tuple(delta.shape)} do not match (lse/delta f32)")
    check_vector_rows("banded_bwd", Q=Q, K=K, V=V, dO=dO)
    if h > ROWS_PER_CHUNK or Dk > MAX_D or Dv > MAX_D:
        raise ValueError(f"banded_bwd: needs h <= {ROWS_PER_CHUNK}, Dk and Dv <= {MAX_D}")
    if (mode == "win" and w <= 0) or (mode == "cmp" and (l <= 0 or d <= 0)):
        raise ValueError("banded_bwd: win needs w > 0, cmp needs l, d > 0")
    lib = library()
    check_smem("banded_bwd", lib.nsa_banded_bwd_smem_bytes(Dk, Dv))
    tq = max(1, ROWS_PER_CHUNK // h)
    n_kt = -(-S_kv // KEYS_PER_TILE)
    nsplit = kv_splits(Q.device, B * G * n_kt, -(-S // tq))
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    part = (torch.empty(nsplit * B * G * S_kv * (Dk + Dv), dtype=torch.float32, device=Q.device)
            if nsplit > 1 else None)
    with torch.cuda.device(Q.device):
        err = lib.nsa_banded_bwd(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta),
                                 ptr(dQ), ptr(dK), ptr(dV), ptr_or_null(part), B, S, S_kv, G, h,
                                 Dk, Dv, MODES[mode], w, l, d, float(scale), tq, nsplit,
                                 stream_of(Q))
    raise_on_error(lib, "banded_bwd", err)
    banded_bwd.launches += 1
    if mode == "cmp":
        banded_bwd.cmp_launches += 1
    return dQ, dK, dV


banded_bwd.launches = 0
banded_bwd.cmp_launches = 0
