"""One-pass window / compressed-prefix attention backward (csrc/banded_bwd_1p.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd_onepass
(the win and cmp backward of the JAX train step under bwd.onepass = 1).
It computes the same function as banded_bwd (the two-pass design), so its
plain version is that module's. Bound on the H100 and design: see the
note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import MODES, banded_bwd_plain
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, kv_splits, ptr, raise_on_error,
    resolve_kernel, stream_of,
)

ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per chunk, the kernel's maximum
KEYS_PER_TILE = 64    # keys per tile of the kv-major pass
MAX_D = 128           # head widths the kernel's register slices cover


def check_banded_operands(name: str, Q, K, V, dO, lse, delta, *, mode: str, w: int, l: int,
                          d: int) -> int:
    """The checks of a banded backward launch (shapes, dtypes, devices,
    contiguity, alignment, mode). Returns the dtype code."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be 'win' or 'cmp', got {mode!r}")
    code = check_operands(name, {"Q": Q, "K": K, "V": V, "dO": dO})
    check_operands(name, {"lse": lse, "delta": delta})
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or dO.shape != (B, S, G, h, Dv) or lse.shape != (B, S, G, h) \
            or delta.shape != lse.shape or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise ValueError(f"{name}: shapes Q {tuple(Q.shape)} K {tuple(K.shape)} "
                         f"V {tuple(V.shape)} dO {tuple(dO.shape)} lse {tuple(lse.shape)} "
                         f"delta {tuple(delta.shape)} do not match (lse/delta f32)")
    check_vector_rows(name, Q=Q, K=K, V=V, dO=dO)
    if h > ROWS_PER_CHUNK or Dk > MAX_D or Dv > MAX_D or S_kv == 0:
        raise ValueError(f"{name}: needs h <= {ROWS_PER_CHUNK}, Dk and Dv <= {MAX_D}, "
                         f"S_kv > 0")
    if (mode == "win" and w <= 0) or (mode == "cmp" and (l <= 0 or d <= 0)):
        raise ValueError(f"{name}: win needs w > 0, cmp needs l, d > 0")
    return code


def banded_bwd_1p(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                  scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) in the operands' dtype. Query row s is at position s.
    CPU tensors take the plain version. Counts launches in
    `banded_bwd_1p.launches` and, of those in cmp mode, in
    `banded_bwd_1p.cmp_launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode=mode, w=w, l=l, d=d, scale=scale)
    code = check_banded_operands("banded_bwd_1p", Q, K, V, dO, lse, delta, mode=mode, w=w, l=l,
                                 d=d)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    lib = library()
    check_smem("banded_bwd_1p", lib.nsa_banded_bwd_1p_smem_bytes(Dk, Dv))
    tq = max(1, ROWS_PER_CHUNK // h)
    n_kt = -(-S_kv // KEYS_PER_TILE)
    nsplit = kv_splits(Q.device, B * G * n_kt, -(-S // tq))
    n_slots = lib.nsa_banded_bwd_1p_slots(MODES[mode], w, S_kv)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    ws = torch.empty(n_slots * Q.numel(), dtype=torch.float32, device=Q.device)
    part = torch.empty(nsplit * B * G * S_kv * (Dk + Dv), dtype=torch.float32, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_banded_bwd_1p(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta),
                                    ptr(dQ), ptr(dK), ptr(dV), ptr(part), ptr(ws), B, S,
                                    S_kv, G, h, Dk, Dv, MODES[mode], w, l, d, float(scale), tq,
                                    nsplit, stream_of(Q))
    raise_on_error(lib, "banded_bwd_1p", err)
    banded_bwd_1p.launches += 1
    if mode == "cmp":
        banded_bwd_1p.cmp_launches += 1
    return dQ, dK, dV


banded_bwd_1p.launches = 0
banded_bwd_1p.cmp_launches = 0
