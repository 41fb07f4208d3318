"""Selection-branch attention backward: the two-pass design
(csrc/sel_attn_bwd.cu) and what both designs share.

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd (the
two-pass selection backward of the JAX train step under sel.bwd_onepass =
0). The selection is a set: -1 slots and repeated ids add nothing. Bound
on the H100 and design: see the notes at the top of the CUDA sources.

Shared with the one-pass design (sel_attn_bwd_1p.py): the plain version,
the operand check, the index of each block's member rows
(`selection_index`) and the balanced work list of the kv-major pass
(`selection_work_items`), all built on the device with no host sync. The
two-pass design adds the q-tile union of its bf16 dQ kernel
(`selection_tile_union`).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_operands, check_smem, check_vector_rows, ptr, ptr_or_null, raise_on_error,
    resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import selection_token_mask

KEYS_PER_TILE = 64     # keys per tile of the kv-major pass (a block may take several)
MAX_H = 16             # heads per group (the forward's limit, sel_attn.MAX_H)
MAX_D = 128
CHUNKS_PER_ITEM = 16   # chunks of the kv-major pass per work item
UNION_ROWS = 64        # rows of a q tile of the bf16 union dQ kernel: UNION_ROWS // h tokens


def sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float,
                       gate=None):
    """Plain PyTorch version: the dense formula on the same operands (with
    gate [B,S,G] f32, the gate-epilogue fold: on ref.gate_dO(dO, gate)).
    t_pos: [S] or [B,S] query positions."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])
    if gate is not None:
        dO = ref.gate_dO(dO, gate)
    return ref.attend_masked_bwd(Q, K, V, dO, lse, delta, m[:, :, :, None, :], scale)


def sel_attn_bwd_rss(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float):
    """(dQ, dK, dV) of the plain version in f32 from the operands' values,
    unrounded, and the root sum of squares of each element's terms
    (ops/reference.py::attend_masked_bwd_rss): the scale of what rounding
    P and dS to bf16 before their products moves each element."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])[:, :, :, None, :]
    args = [x.float() for x in (Q, K, V, dO)]
    return (ref.attend_masked_bwd(*args, lse, delta, m, scale),
            ref.attend_masked_bwd_rss(*args, lse, delta, m, scale))


def _visible_blocks(sel_idx, t_pos, l_sel: int, S_kv: int):
    """[B,S,G,NB] bool: block j is in row (b, s, g)'s selection set and
    visible (j*l_sel <= t, j*l_sel < S_kv)."""
    B, S, G, _ = sel_idx.shape
    NB = -(-S_kv // l_sel)
    t = t_pos.to(torch.int64).expand(B, S)[:, :, None, None]
    ids = sel_idx.to(torch.int64)
    ok = (ids >= 0) & (ids < NB) & (ids * l_sel <= t)
    ids = torch.where(ok, ids, torch.full_like(ids, NB))
    member = torch.zeros((B, S, G, NB + 1), dtype=torch.bool, device=sel_idx.device)
    member.scatter_(-1, ids, True)
    return member[..., :NB]


def selection_index(sel_idx, t_pos, l_sel: int, S_kv: int):
    """The kv-major pass's index, built on the device with no host sync.
    For each (b, g, block j): the query rows s whose selection set holds a
    visible block j (j*l_sel <= t, j*l_sel < S_kv), ascending, and for each
    such row the rank of j among the row's distinct visible blocks
    (ascending id), its one-pass dQ slot. Returns (inv, rank [B,G,NB,S+1]
    int32, each row (b, g, j) filled in columns [0, cnt); cnt [B,G,NB]
    int32; nblk [B,S,G] int32, the distinct visible blocks of each query
    row). Non-members land in column S, which is never read."""
    B, S, G, _ = sel_idx.shape
    dev = sel_idx.device
    member = _visible_blocks(sel_idx, t_pos, l_sel, S_kv)                # [B,S,G,NB]
    NB = member.shape[-1]
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


def work_items_bound(B: int, S: int, G: int, n: int, NB: int, per: int) -> int:
    """Entries of the work list, from shapes alone: each row holds at most
    min(n, NB) blocks, and a block of c members makes ceil(c / per) items."""
    return -(-(B * G * S * min(n, NB)) // per) + B * G * NB


def selection_work_items(cnt, per: int, n_work: int):
    """The kv-major pass's balanced work list (csrc/sel_bwd.cuh), built on
    the device with no host sync: block (b, g, j)'s member list (cnt[b, g,
    j] tokens) is cut into items of `per` tokens, numbered block by block.
    Returns (work [n_work, 3] int32: (item slot, block, item number) per
    CTA, the largest items first (ties in slot order), entries past the
    last item with block -1; span [B*G*NB, 2] int32: each block's first
    slot and item count)."""
    c = cnt.reshape(-1).long()
    items = -(-c // per)
    ends = torch.cumsum(items, 0)
    first = ends - items
    slot = torch.arange(n_work, device=cnt.device)
    blk = torch.searchsorted(ends, slot, right=True).clamp(max=c.numel() - 1)
    item = slot - first[blk]
    live = slot < ends[-1]
    size = torch.where(live, (c[blk] - item * per).clamp(max=per), torch.full_like(slot, -1))
    order = torch.argsort(size, descending=True, stable=True)
    work = torch.stack([slot, torch.where(live, blk, torch.full_like(blk, -1)), item], 1)
    return work[order].to(torch.int32).contiguous(), \
        torch.stack([first, items], 1).to(torch.int32).contiguous()


def selection_tile_union(sel_idx, t_pos, l_sel: int, S_kv: int, T: int):
    """The q tiles of the bf16 union dQ kernel, T tokens each, built on the
    device with no host sync: for each (b, g, tile), the distinct blocks
    visible to any of its rows, ascending (nsa_vibe_tpu/ops/pallas/
    sel_flash.py::_tile_active then _compact_active over visible blocks),
    and for each row its membership as a bitmask over that union. Returns
    (order [B,G,nq,U] int32, filled in columns [0, count); count [B,G,nq]
    int32; mask [B,S,G,W] int32, bit u % 32 of word u // 32 set when the
    row's set holds order[u]), U = min(NB, T * n) and W = ceil(U / 32)."""
    B, S, G, n = sel_idx.shape
    dev = sel_idx.device
    member = _visible_blocks(sel_idx, t_pos, l_sel, S_kv)                # [B,S,G,NB]
    NB = member.shape[-1]
    nq = -(-S // T)
    U = min(NB, T * n)
    W = -(-U // 32)
    padded = torch.zeros((B, nq * T, G, NB), dtype=torch.bool, device=dev)
    padded[:, :S] = member
    active = padded.reshape(B, nq, T, G, NB).any(2).permute(0, 2, 1, 3)  # [B,G,nq,NB]
    pos = torch.cumsum(active, dim=-1, dtype=torch.int32)
    count = pos[..., -1].contiguous()
    pos = torch.where(active, pos - 1, torch.full((), NB, dtype=torch.int32, device=dev)).long()
    order = torch.zeros((B, G, nq, NB + 1), dtype=torch.int32, device=dev)
    order.scatter_(-1, pos, torch.arange(NB, dtype=torch.int32, device=dev).expand(B, G, nq, NB))
    order = order[..., :U].contiguous()
    # row (b, s, g) reads its tile's union: member[b, s, g, order[b, g, s // T, u]]
    urow = order.permute(0, 2, 1, 3).repeat_interleave(T, dim=1)[:, :S]  # [B,S,G,U]
    live = torch.arange(U, device=dev) < count.permute(0, 2, 1).repeat_interleave(T, dim=1)[
        :, :S, :, None]
    bits = member.gather(-1, urow.long()) & live
    bits = torch.nn.functional.pad(bits, (0, 32 * W - U)).reshape(B, S, G, W, 32)
    words = (bits.long() << torch.arange(32, device=dev)).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)      # two's complement int32
    return order, count, words.to(torch.int32).contiguous()


def check_sel_bwd_operands(name: str, Q, K, V, sel_idx, t_pos, dO, lse, delta):
    """Device, dtype, shape and layout checks of both selection backward
    wrappers. Returns (dtype code, t_pos as contiguous int32 [B,S])."""
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    tpos = t_pos.to(torch.int32).expand(B, S).contiguous()
    code = check_operands(name, {"Q": Q, "K": K, "V": V, "dO": dO},
                          {"sel_idx": sel_idx, "t_pos": tpos})
    check_operands(name, {"lse": lse, "delta": delta})
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or sel_idx.shape[:3] != (B, S, G) or dO.shape != (B, S, G, h, Dv) \
            or lse.shape != (B, S, G, h) or delta.shape != lse.shape \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{name}: shapes Q {tuple(Q.shape)} K {tuple(K.shape)} "
                         f"V {tuple(V.shape)} sel_idx {tuple(sel_idx.shape)} "
                         f"dO {tuple(dO.shape)} lse {tuple(lse.shape)} do not match "
                         f"(lse/delta f32)")
    check_vector_rows(name, Q=Q, K=K, V=V, dO=dO)
    if h > MAX_H or Dk > MAX_D or Dv > MAX_D or S_kv == 0:
        raise ValueError(f"{name}: needs h <= {MAX_H}, Dk and Dv <= {MAX_D}, S_kv > 0")
    return code, tpos


def kv_pass(lib, name: str, code: int, Q, K, V, sel_idx, t_pos, l_sel: int):
    """The kv-major pass's index, work list and f32 partial buffer."""
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    check_smem(name, lib.nsa_sel_attn_bwd_1p_smem_bytes(code, Dk, Dv))
    inv, rank, cnt, nblk = selection_index(sel_idx, t_pos, l_sel, S_kv)
    NB = inv.shape[2]
    tq = lib.nsa_sel_attn_bwd_kv_rows(code, Dk, Dv) // h
    per = tq * CHUNKS_PER_ITEM
    n_work = work_items_bound(B, S, G, sel_idx.shape[-1], NB, per)
    work, span = selection_work_items(cnt, per, n_work)
    n_sub = -(-l_sel // KEYS_PER_TILE)
    part = torch.empty(n_work * n_sub * KEYS_PER_TILE * (Dk + Dv), dtype=torch.float32,
                       device=Q.device)
    return SimpleNamespace(inv=inv, rank=rank, cnt=cnt, nblk=nblk, NB=NB, n_sub=n_sub, tq=tq,
                           per=per, n_work=n_work, work=work, span=span, part=part)


def union_tokens(h: int) -> int:
    """Tokens per q tile of the bf16 union dQ kernel (the fastest of 1, 2,
    5 and 10 tokens at h = 6 on the H100: PERF.md)."""
    return max(1, UNION_ROWS // h)


def sel_attn_bwd(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], sel_idx [B,S,G,n] int32,
    t_pos [S] or [B,S], lse/delta [B,S,G,h] f32 -> (dQ, dK, dV) in the
    operands' dtype. CPU tensors take the plain version. Counts launches
    in `sel_attn_bwd.launches`."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, l_sel=l_sel,
                                  scale=scale)
    code, tpos = check_sel_bwd_operands("sel_attn_bwd", Q, K, V, sel_idx, t_pos, dO, lse, delta)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    n = sel_idx.shape[-1]
    lib = library()
    kv = kv_pass(lib, "sel_attn_bwd", code, Q, K, V, sel_idx, t_pos, l_sel)
    order = count = mask = None
    qT = U = W = 0
    if code == DTYPE_CODES[torch.bfloat16]:
        qT = union_tokens(h)
        if not 1 <= qT * h <= UNION_ROWS:
            raise ValueError(f"sel_attn_bwd: q tile of {qT} tokens x {h} heads is not in "
                             f"[1, {UNION_ROWS}] rows")
        order, count, mask = selection_tile_union(sel_idx, t_pos, l_sel, S_kv, qT)
        U, W = order.shape[-1], mask.shape[-1]
    check_smem("sel_attn_bwd", lib.nsa_sel_attn_bwd_smem_bytes(0, code, h, Dk, Dv, n, l_sel,
                                                               qT, W))
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    with torch.cuda.device(Q.device):
        err = lib.nsa_sel_attn_bwd(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse), ptr(delta),
                                   ptr(sel_idx), ptr(tpos), ptr(kv.inv), ptr(kv.cnt),
                                   ptr(kv.work), ptr(kv.span), ptr_or_null(order),
                                   ptr_or_null(count), ptr_or_null(mask), ptr(dQ), ptr(dK),
                                   ptr(dV), ptr(kv.part), B, S, S_kv, G, h, Dk, Dv, n, l_sel,
                                   kv.inv.shape[-1], kv.n_work, kv.tq, kv.per, U, W, qT,
                                   float(scale), stream_of(Q))
    raise_on_error(lib, "sel_attn_bwd", err)
    sel_attn_bwd.launches += 1
    return dQ, dK, dV


sel_attn_bwd.launches = 0
