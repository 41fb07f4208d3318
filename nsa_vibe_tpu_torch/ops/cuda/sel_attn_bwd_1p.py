"""One-pass selection-branch attention backward (csrc/sel_attn_bwd_1p.cu).

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd_onepass
(the selection backward of the JAX train step under sel.bwd_onepass = 1).
It computes the same function as sel_attn_bwd (the two-pass design), so
its plain version is that module's. The selection is a set: -1 slots and
repeated ids add nothing. Bound on the H100 and design: see the note at
the top of the CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, kv_splits, ptr, raise_on_error,
    resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import sel_attn_bwd_plain

ROWS_PER_CHUNK = 64   # query rows (tokens x heads) per chunk of the kv-major pass
KEYS_PER_TILE = 64    # keys per tile of the kv-major pass (a block may take several)
MAX_D = 128
MAX_SPLITS = 8


def selection_slot_index(sel_idx, t_pos, l_sel: int, S_kv: int):
    """The work list of the one-pass kernel, built on the device with no
    host sync. For each (b, g, block j): the query rows s whose selection
    set holds a visible block j (j*l_sel <= t, j*l_sel < S_kv), ascending,
    and for each such row the rank of j among the row's distinct visible
    blocks (ascending id), its dQ slot. Returns (inv, rank [B,G,NB,S+1]
    int32, each row (b, g, j) filled in columns [0, cnt); cnt [B,G,NB]
    int32; nblk [B,S,G] int32, the distinct visible blocks of each query
    row). inv and cnt are sel_attn_bwd.selection_inverse_index's."""
    B, S, G, _ = sel_idx.shape
    NB = -(-S_kv // l_sel)
    dev = sel_idx.device
    t = t_pos.to(torch.int64).expand(B, S)[:, :, None, None]
    ids = sel_idx.to(torch.int64)
    ok = (ids >= 0) & (ids < NB) & (ids * l_sel <= t)
    ids = torch.where(ok, ids, torch.full_like(ids, NB))
    member = torch.zeros((B, S, G, NB + 1), dtype=torch.bool, device=dev)
    member.scatter_(-1, ids, True)
    member = member[..., :NB]                                            # [B,S,G,NB]
    rank = torch.cumsum(member, dim=-1, dtype=torch.int32)
    nblk = rank[..., -1].contiguous()
    member, rank = member.permute(0, 2, 3, 1), (rank - 1).permute(0, 2, 3, 1)   # [B,G,NB,S]
    slot = torch.cumsum(member, dim=-1, dtype=torch.int32)
    cnt = slot[..., -1].contiguous()
    slot = torch.where(member, slot - 1, torch.full((), S, dtype=torch.int32, device=dev)).long()
    rows = torch.arange(S, dtype=torch.int32, device=dev).expand(B, G, NB, S)
    inv = torch.empty((B, G, NB, S + 1), dtype=torch.int32, device=dev)
    inv.scatter_(-1, slot, rows)
    ranks = torch.empty((B, G, NB, S + 1), dtype=torch.int32, device=dev)
    ranks.scatter_(-1, slot, rank)
    return inv, ranks, cnt, nblk


def sel_attn_bwd_1p(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], sel_idx [B,S,G,n] int32,
    t_pos [S] or [B,S], lse/delta [B,S,G,h] f32 -> (dQ, dK, dV) in the
    operands' dtype. CPU tensors take the plain version. Counts launches
    in `sel_attn_bwd_1p.launches`."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, l_sel=l_sel,
                                  scale=scale)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    n = sel_idx.shape[-1]
    tpos = t_pos.to(torch.int32).expand(B, S).contiguous()
    code = check_operands("sel_attn_bwd_1p", {"Q": Q, "K": K, "V": V, "dO": dO},
                          {"sel_idx": sel_idx, "t_pos": tpos})
    check_operands("sel_attn_bwd_1p", {"lse": lse, "delta": delta})
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or sel_idx.shape[:3] != (B, S, G) or dO.shape != (B, S, G, h, Dv) \
            or lse.shape != (B, S, G, h) or delta.shape != lse.shape \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"sel_attn_bwd_1p: shapes Q {tuple(Q.shape)} K {tuple(K.shape)} "
                         f"V {tuple(V.shape)} sel_idx {tuple(sel_idx.shape)} "
                         f"dO {tuple(dO.shape)} lse {tuple(lse.shape)} do not match "
                         f"(lse/delta f32)")
    check_vector_rows("sel_attn_bwd_1p", Q=Q, K=K, V=V, dO=dO)
    if h > ROWS_PER_CHUNK or Dk > MAX_D or Dv > MAX_D or S_kv == 0:
        raise ValueError(f"sel_attn_bwd_1p: needs h <= {ROWS_PER_CHUNK}, Dk and Dv <= {MAX_D}, "
                         f"S_kv > 0")
    lib = library()
    check_smem("sel_attn_bwd_1p", lib.nsa_sel_attn_bwd_1p_smem_bytes(Dk, Dv))
    inv, ranks, cnt, nblk = selection_slot_index(sel_idx, t_pos, l_sel, S_kv)
    NB = inv.shape[2]
    n_sub = -(-l_sel // KEYS_PER_TILE)
    tq = max(1, ROWS_PER_CHUNK // h)
    nsplit = kv_splits(Q.device, B * G * NB * n_sub, MAX_SPLITS)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    ws = torch.empty(min(n, NB) * n_sub * Q.numel(), dtype=torch.float32, device=Q.device)
    part = torch.empty(nsplit * B * G * S_kv * (Dk + Dv), dtype=torch.float32, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_sel_attn_bwd_1p(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse),
                                      ptr(delta), ptr(tpos), ptr(inv), ptr(cnt), ptr(ranks),
                                      ptr(nblk), ptr(dQ), ptr(dK), ptr(dV), ptr(part),
                                      ptr(ws), B, S, S_kv, G, h, Dk, Dv, l_sel, inv.shape[-1],
                                      float(scale), tq, nsplit, stream_of(Q))
    raise_on_error(lib, "sel_attn_bwd_1p", err)
    sel_attn_bwd_1p.launches += 1
    return dQ, dK, dV


sel_attn_bwd_1p.launches = 0
