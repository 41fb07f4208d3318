"""One-pass window / compressed-prefix attention backward
(csrc/banded_bwd_mma.cu, csrc/banded_bwd_1p.cu).

Replaces nsa_vibe_tpu/ops/pallas/flash_bwd.py::flash_banded_bwd_onepass
(the win and cmp backward of the JAX train step under bwd.onepass = 1).
It computes the same function as banded_bwd (the two-pass design), so its
plain version is that module's. Two kernels, chosen by dtype alone:
- bf16: the kv-major tensor-core kernel (banded_bwd_mma.cu; P and dS
  rounded to bf16 before their products, as the TPU kernels do, so its
  bound is the plain version's unrounded f32 gradients within a multiple
  of `banded_bwd.banded_bwd_rss`, not two ulps), chunks of
  `mma_plan` band rows (token * h + head), cut by `split_shares`;
- f32: the FMA kernel (banded_bwd_1p.cu), chunks of ROWS_PER_CHUNK // h
  tokens.
Both write each dQ partial to its own f32 slot and sum them in order. The
same launch with the slots off (`kv_pass`) is the two-pass design's dK/dV
pass (banded_bwd). With `seq_start` (packed documents) each row's keys
stop at its document start; a row's slots count from the first key tile
it sees there. With `gate` [B,S,G] f32 (the gate-epilogue fold,
flash_bwd.py:422-424) the kernels scale each staged dO row by its gate and
round it to dO's dtype before any product: the bits of the ungated launch
on (dO * g).to(dO.dtype) (bf16: csrc/banded_bwd_gated_mma.cu). Bound on the
H100 and design: see the notes at the top of the CUDA sources.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import MODES, banded_bwd_plain
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_gate, check_offset, check_operands, check_seq_start, check_smem,
    check_vector_rows, kv_splits, ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)

ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per chunk of the f32 kernel, its maximum
KEYS_PER_TILE = 64    # keys per tile of the kv-major pass
MAX_D = 128           # head widths the kernels' register slices and tiles cover


def check_banded_operands(name: str, Q, K, V, dO, lse, delta, *, mode: str, w: int, l: int,
                          d: int, seq_start=None, t_start: int = 0, gate=None) -> int:
    """The checks of a banded backward launch (shapes, dtypes, devices,
    contiguity, alignment, mode, seq_start, the query offset, the gate).
    Returns the dtype code."""
    check_offset(name, t_start)
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be 'win' or 'cmp', got {mode!r}")
    code = check_operands(name, {"Q": Q, "K": K, "V": V, "dO": dO})
    check_operands(name, {"lse": lse, "delta": delta})
    B, S, G, h, Dk = Q.shape
    check_seq_start(name, seq_start, B, S, Q.device)
    check_gate(name, gate, B, S, G, Q.device)
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


def split_shares(S: int, S_kv: int, h: int, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                 rows: int, nsplit: int, t_start: int = 0) -> list:
    """[key tile][split] -> band rows [ra, rb) (row = token * h + head) of
    the bf16 kernel's CTA (tile, split), as the kernel cuts them: the rows
    whose tokens (at positions t_start + token) see a key of the tile
    (banded_common.cuh::token_range), in nsplit shares of whole chunks of
    `rows` rows. An empty share has ra >= rb."""
    out = []
    for k0 in range(0, S_kv, KEYS_PER_TILE):
        k1 = min(k0 + KEYS_PER_TILE, S_kv)
        t_lo, t_hi = ((k0, k1 - 1 + w - 1) if mode == "win"
                      else (k0 * d + l - 1, t_start + S - 1))    # positions
        t_lo, t_hi = max(t_lo - t_start, 0), min(t_hi - t_start, S - 1)   # row tokens
        R0, n = t_lo * h, max(t_hi - t_lo + 1, 0) * h
        per = -(-(-(-n // nsplit)) // rows) * rows
        out.append([(R0 + s * per, min(R0 + n, R0 + s * per + per)) for s in range(nsplit)])
    return out


def mma_plan(lib, device, B: int, S: int, S_kv: int, G: int, h: int, Dk: int,
             Dv: int) -> tuple:
    """(band rows per chunk, splits) of the bf16 kernel's launch: fixed by
    shape and card (kv_splits), so a launch's sums are always the same."""
    rows = lib.nsa_banded_bwd_1p_mma_rows(Dk, Dv)
    return rows, kv_splits(device, B * G * -(-S_kv // KEYS_PER_TILE), -(-S * h // rows))


def kv_pass(name: str, lib, code: int, Q, K, V, dO, lse, delta, *, mode: str, w: int, l: int,
            d: int, scale: float, slots: bool, seq_start=None, t_start: int = 0,
            gate=None) -> tuple:
    """Launches the kv-major kernel on checked operands (dtype code `code`):
    bf16 the tensor-core kernel, f32 the FMA kernel. With `slots` it writes
    each chunk's dQ partial to its slot and returns (dQ, dK, dV) (the
    one-pass design); without, it forms (None, dK, dV) alone (the two-pass
    design's dK/dV pass: no slot workspace). gate: the fold's [B,S,G] f32
    scaling each dO row, or None."""
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    mma = code == DTYPE_CODES[torch.bfloat16]
    if mma:
        check_smem(name, lib.nsa_banded_bwd_1p_mma_smem_bytes(Dk, Dv))
        _, nsplit = mma_plan(lib, Q.device, B, S, S_kv, G, h, Dk, Dv)
    else:
        check_smem(name, lib.nsa_banded_bwd_1p_smem_bytes(Dk, Dv))
        tq = max(1, ROWS_PER_CHUNK // h)
        nsplit = kv_splits(Q.device, B * G * -(-S_kv // KEYS_PER_TILE), -(-S // tq))
    dQ = torch.empty_like(Q) if slots else None
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    ws = (torch.empty(lib.nsa_banded_bwd_1p_slots(MODES[mode], w, S_kv) * Q.numel(),
                      dtype=torch.float32, device=Q.device) if slots else None)
    part = torch.empty(nsplit * B * G * S_kv * (Dk + Dv), dtype=torch.float32, device=Q.device)
    args = (ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta), ptr_or_null(seq_start),
            ptr_or_null(gate), ptr_or_null(dQ), ptr(dK), ptr(dV), ptr(part), ptr_or_null(ws), B,
            S, S_kv, G, h, Dk, Dv, MODES[mode], w, l, d, float(scale), t_start)
    with torch.cuda.device(Q.device):
        if mma:
            err = lib.nsa_banded_bwd_1p_mma(*args, nsplit, stream_of(Q))
        else:
            err = lib.nsa_banded_bwd_1p(*args, tq, nsplit, stream_of(Q))
    raise_on_error(lib, name, err)
    return dQ, dK, dV


def banded_bwd_1p(Q, K, V, dO, lse, delta, *, mode: str, w: int = 0, l: int = 0, d: int = 1,
                  scale: float, seq_start=None, t_start: int = 0, gate=None):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], lse/delta [B,S,G,h] f32 ->
    (dQ, dK, dV) in the operands' dtype. Query row s is at position
    t_start + s (a host int: sequence sharding, where K/V cover the whole
    sequence; the key tiles span all S_kv keys); seq_start [B,S] int32 (or
    None; at any t_start) bounds each row to its document; gate [B,S,G] f32
    (the gate-epilogue fold, or None): the gradients of Y = g O given dY =
    dO, delta = rowsum(dY * Y). CPU tensors take the plain version. Counts
    launches in `banded_bwd_1p.launches`, of those in cmp mode in
    `banded_bwd_1p.cmp_launches` and of the gated ones in
    `banded_bwd_1p.gated_launches`."""
    if resolve_kernel(Q) == "plain":
        return banded_bwd_plain(Q, K, V, dO, lse, delta, mode=mode, w=w, l=l, d=d, scale=scale,
                                seq_start=seq_start, t_start=t_start, gate=gate)
    code = check_banded_operands("banded_bwd_1p", Q, K, V, dO, lse, delta, mode=mode, w=w, l=l,
                                 d=d, seq_start=seq_start, t_start=t_start, gate=gate)
    grads = kv_pass("banded_bwd_1p", library(), code, Q, K, V, dO, lse, delta, mode=mode, w=w,
                    l=l, d=d, scale=scale, slots=True, seq_start=seq_start, t_start=t_start,
                    gate=gate)
    banded_bwd_1p.launches += 1
    banded_bwd_1p.gated_launches += gate is not None
    if mode == "cmp":
        banded_bwd_1p.cmp_launches += 1
    return grads


banded_bwd_1p.launches = 0
banded_bwd_1p.cmp_launches = 0
banded_bwd_1p.gated_launches = 0
