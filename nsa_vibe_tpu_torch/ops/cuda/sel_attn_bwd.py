"""Selection-branch attention backward (csrc/sel_attn_bwd.cu).

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd (the
two-pass selection backward of the JAX train step under sel.bwd_onepass =
0). The selection is a set:
-1 slots and repeated ids add nothing. Bound on the H100 and design: see
the note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, kv_splits, ptr, ptr_or_null, raise_on_error,
    resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import selection_token_mask

ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per chunk of the kv-major pass
KEYS_PER_TILE = 64    # keys per tile of the kv-major pass (a block may take several)
MAX_H = 16
MAX_D = 128
MAX_SPLITS = 8


def sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float):
    """Plain PyTorch version: the dense formula on the same operands.
    t_pos: [S] or [B,S] query positions."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])
    return ref.attend_masked_bwd(Q, K, V, dO, lse, delta, m[:, :, :, None, :], scale)


def selection_inverse_index(sel_idx, t_pos, l_sel: int, S_kv: int):
    """For each (b, g, block j): the query rows s whose selection set holds
    a visible block j (j*l_sel <= t, j*l_sel < S_kv), ascending. Returns
    (inv [B,G,NB,S+1] int32, row (b, g, j) holding its members in columns
    [0, cnt); cnt [B,G,NB] int32). Built on the device with no host sync:
    a membership scatter, a cumulative count for each member's slot and a
    scatter of the row index into it (non-members land in column S, which
    is never read)."""
    B, S, G, _ = sel_idx.shape
    NB = -(-S_kv // l_sel)
    dev = sel_idx.device
    t = t_pos.to(torch.int64).expand(B, S)[:, :, None, None]
    ids = sel_idx.to(torch.int64)
    ok = (ids >= 0) & (ids < NB) & (ids * l_sel <= t)
    ids = torch.where(ok, ids, torch.full_like(ids, NB))
    member = torch.zeros((B, S, G, NB + 1), dtype=torch.bool, device=dev)
    member.scatter_(-1, ids, True)
    member = member[..., :NB].permute(0, 2, 3, 1)                       # [B,G,NB,S]
    slot = torch.cumsum(member, dim=-1, dtype=torch.int32)
    cnt = slot[..., -1].contiguous()
    slot = torch.where(member, slot - 1, torch.full((), S, dtype=torch.int32, device=dev))
    rows = torch.arange(S, dtype=torch.int32, device=dev).expand(B, G, NB, S)
    inv = torch.empty((B, G, NB, S + 1), dtype=torch.int32, device=dev)
    inv.scatter_(-1, slot.long(), rows)
    return inv, cnt


def sel_attn_bwd(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], sel_idx [B,S,G,n] int32,
    t_pos [S] or [B,S], lse/delta [B,S,G,h] f32 -> (dQ, dK, dV) in the
    operands' dtype. CPU tensors take the plain version."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, l_sel=l_sel,
                                  scale=scale)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    n = sel_idx.shape[-1]
    tpos = t_pos.to(torch.int32).expand(B, S).contiguous()
    code = check_operands("sel_attn_bwd", {"Q": Q, "K": K, "V": V, "dO": dO},
                          {"sel_idx": sel_idx, "t_pos": tpos})
    check_operands("sel_attn_bwd", {"lse": lse, "delta": delta})
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or sel_idx.shape[:3] != (B, S, G) or dO.shape != (B, S, G, h, Dv) \
            or lse.shape != (B, S, G, h) or delta.shape != lse.shape \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"sel_attn_bwd: shapes Q {tuple(Q.shape)} K {tuple(K.shape)} "
                         f"V {tuple(V.shape)} sel_idx {tuple(sel_idx.shape)} "
                         f"dO {tuple(dO.shape)} lse {tuple(lse.shape)} do not match "
                         f"(lse/delta f32)")
    check_vector_rows("sel_attn_bwd", Q=Q, K=K, V=V, dO=dO)
    if h > MAX_H or Dk > MAX_D or Dv > MAX_D:
        raise ValueError(f"sel_attn_bwd: needs h <= {MAX_H}, Dk and Dv <= {MAX_D}")
    lib = library()
    check_smem("sel_attn_bwd", lib.nsa_sel_attn_bwd_smem_bytes(0, h, Dk, Dv, n, l_sel))
    check_smem("sel_attn_bwd", lib.nsa_sel_attn_bwd_smem_bytes(1, h, Dk, Dv, n, l_sel))
    inv, cnt = selection_inverse_index(sel_idx, t_pos, l_sel, S_kv)
    tq = max(1, ROWS_PER_CHUNK // h)
    n_tiles = B * G * inv.shape[2] * -(-l_sel // KEYS_PER_TILE)
    nsplit = kv_splits(Q.device, n_tiles, MAX_SPLITS)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    part = (torch.empty(nsplit * B * G * S_kv * (Dk + Dv), dtype=torch.float32, device=Q.device)
            if nsplit > 1 else None)
    with torch.cuda.device(Q.device):
        err = lib.nsa_sel_attn_bwd(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta),
                                   ptr(sel_idx), ptr(tpos), ptr(inv), ptr(cnt), ptr(dQ),
                                   ptr(dK), ptr(dV), ptr_or_null(part), B, S, S_kv, G, h, Dk,
                                   Dv, n, l_sel, inv.shape[-1], float(scale), tq, nsplit,
                                   stream_of(Q))
    raise_on_error(lib, "sel_attn_bwd", err)
    sel_attn_bwd.launches += 1
    return dQ, dK, dV


sel_attn_bwd.launches = 0
