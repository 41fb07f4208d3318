"""The selection backward's device-built tables and both designs vs the JAX package (CPU).

The tensor-core kernels of the selection backward (csrc/sel_attn_bwd.cu,
csrc/sel_attn_bwd_1p.cu) run only on the card; here their inputs are held
to their definitions, with numpy-seeded data:
- the q-tile union of the two-pass dQ kernel (`selection_tile_union`)
  against nsa_vibe_tpu/ops/pallas/sel_flash.py::_tile_active and
  _compact_active over the visible blocks, with -1 and repeated ids;
- the balanced work list of the kv-major pass (`selection_work_items`):
  every (block, member) in exactly one item, in order, largest items
  first;
- a PyTorch walk of both kernels' decompositions over those tables (items,
  chunks, slots, q tiles with membership bits) rebuilds the plain
  gradients;
- sel_attn_bwd and sel_attn_bwd_1p (their plain versions on CPU tensors)
  against selection_flash_bwd / selection_flash_bwd_onepass in interpret
  mode, from each package's own forward.

Tolerances: integer tables exactly equal; f32 gradients 2e-5 of each
gradient's max |value| (sum order, and the TPU kernels' exp2 folding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops.pallas import sel_flash as jsel
from nsa_vibe_tpu.ops.pallas.flash import stats_rows
from nsa_vibe_tpu.ops.selection import select_topn_blocks
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn_plain
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import (
    KEYS_PER_TILE, sel_attn_bwd, sel_attn_bwd_plain, selection_index, selection_tile_union,
    selection_work_items, work_items_bound,
)
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd_1p import sel_attn_bwd_1p
from nsa_vibe_tpu_torch.ops.reference import attention_delta


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * max(np.abs(want).max(), 1e-12),
                               rtol=0)


def _selection(B, S, G, n, NB, seed):
    """Random ids in [-1, NB) with repeats; row 0 of each (b, g) holds only -1."""
    sel = np.random.RandomState(seed).randint(-1, NB, size=(B, S, G, n)).astype(np.int32)
    sel[:, :, :, -1] = sel[:, :, :, 0]                  # a repeated id in every row
    sel[:, 0] = -1                                      # a row with an empty set
    return sel


def _visible_sets(sel, l_sel, NB):
    """[B][S][G] -> the sorted distinct visible block ids of each row."""
    B, S, G, _ = sel.shape
    return [[[sorted({int(j) for j in sel[b, s, g] if 0 <= j < NB and j * l_sel <= s})
              for g in range(G)] for s in range(S)] for b in range(B)]


# ---------------------------------------------------------------- q-tile union

@pytest.mark.parametrize("T,l_sel", [(1, 8), (2, 8), (5, 8), (10, 8),
                                     (10, 1)])   # unions past 32 blocks: two mask words
def test_tile_union_matches_the_tpu_kernels_active_lists(T, l_sel):
    B, S, G, n = 2, 53, 2, 5
    NB = -(-S // l_sel)
    sel = _selection(B, S, G, n, NB, seed=T)
    t = np.arange(S)
    vis = np.where((sel >= 0) & (sel * l_sel <= t[None, :, None, None]), sel, -1)
    nq = -(-S // T)
    jorder, jcount = jsel._compact_active(jsel._tile_active(jnp.asarray(vis), nq, T, NB))
    jorder, jcount = np.asarray(jorder), np.asarray(jcount)
    order, count, mask = selection_tile_union(torch.from_numpy(sel), torch.arange(S), l_sel, S, T)
    U = min(NB, T * n)
    assert order.shape == (B, G, nq, U) and mask.shape == (B, S, G, -(-U // 32))
    np.testing.assert_array_equal(count.numpy(), jcount)
    sets = _visible_sets(sel, l_sel, NB)
    words = mask.numpy().astype(np.int64) & 0xFFFFFFFF
    for b in range(B):
        for g in range(G):
            for q in range(nq):
                c = int(count[b, g, q])
                assert order[b, g, q, :c].tolist() == jorder[b, g, q, :c].tolist()
                for s in range(q * T, min(S, q * T + T)):
                    for u in range(U):
                        bit = (int(words[b, s, g, u // 32]) >> (u % 32)) & 1
                        assert bit == (u < c and int(order[b, g, q, u]) in sets[b][s][g])


# ---------------------------------------------------------------- the work list

@pytest.mark.parametrize("per", [1, 7, 64])
def test_work_items_cover_each_member_once_in_order(per):
    """Each block's member list [0, cnt) is cut into items of `per` tokens:
    every member lies in exactly one item, items of a block take
    consecutive slots in member order, and the list runs largest first."""
    rs = np.random.RandomState(per)
    cnt = rs.randint(0, 40, size=(2, 3, 6)).astype(np.int32)
    cnt[0, 0, 0] = 200                                   # the forced block: every row
    cnt[1, 2, :2] = 0
    n_work = int(np.ceil(cnt / per).sum()) + 5
    work, span = selection_work_items(torch.from_numpy(cnt), per, n_work)
    work, span = work.numpy(), span.numpy()
    live = work[:, 1] >= 0
    assert live.sum() == np.ceil(cnt / per).sum() and not live[live.sum():].any()
    flat = cnt.reshape(-1)
    size = np.minimum(flat[work[live, 1]] - work[live, 2] * per, per)
    assert (size > 0).all() and (np.diff(size) <= 0).all()          # largest first
    by_slot = {int(s): (int(blk), int(it)) for s, blk, it in work[live]}
    assert sorted(by_slot) == list(range(int(live.sum())))           # each slot once
    for blk, c in enumerate(flat):
        first, items = span[blk]
        assert items == -(-c // per)
        members = []
        for i in range(items):
            assert by_slot[first + i] == (blk, i)
            members += list(range(i * per, min(c, (i + 1) * per)))
        assert members == list(range(c))


def test_work_items_bound_holds_for_every_selection():
    """work_items_bound, from shapes alone, is at least the items the
    member counts make, also when every row holds n distinct blocks."""
    B, S, G, n, l_sel = 2, 70, 2, 4, 8
    NB = -(-S // l_sel)
    for sel in (_selection(B, S, G, n, NB, seed=1),
                np.broadcast_to(np.arange(n, dtype=np.int32), (B, S, G, n)).copy()):
        _, _, cnt, _ = selection_index(torch.from_numpy(sel), torch.arange(S), l_sel, S)
        for per in (1, 5, 30):
            need = int(np.ceil(cnt.numpy() / per).sum())
            assert need <= work_items_bound(B, S, G, n, NB, per)


# ---------------------------------------------------------------- the kernels' walks

def _walk_kv(Q, K, V, sel, t, dO, lse, delta, l_sel, scale, tq, chunks):
    """dQ (by slots), dK, dV as the kv-major kernel forms them: per work
    item and 64-key sub-tile, chunks of tq tokens; partials summed in slot
    order; dQ slot = rank * nsub + sub, summed in slot order."""
    B, S, G, h, Dk = Q.shape
    S_kv = K.shape[2]
    inv, rank, cnt, nblk = selection_index(sel, t, l_sel, S_kv)
    NB = inv.shape[2]
    nsub = -(-l_sel // KEYS_PER_TILE)
    per = tq * chunks
    n_work = work_items_bound(B, S, G, sel.shape[-1], NB, per)
    work, span = selection_work_items(cnt, per, n_work)
    part_k = torch.zeros(n_work, nsub * KEYS_PER_TILE, Dk)
    part_v = torch.zeros(n_work, nsub * KEYS_PER_TILE, V.shape[3])
    ws = torch.zeros(min(sel.shape[-1], NB) * nsub, B, S, G, h, Dk)
    for slot, blk, it in work.tolist():
        if blk < 0:
            continue
        b, g, jb = blk // (G * NB), blk // NB % G, blk % NB
        toks = inv[b, g, jb, it * per:min(int(cnt[b, g, jb]), (it + 1) * per)]
        rks = rank[b, g, jb, it * per:it * per + len(toks)]
        for sub in range(nsub):
            k0 = jb * l_sel + sub * KEYS_PER_TILE
            keys = torch.arange(k0, max(k0, min(k0 + KEYS_PER_TILE, (jb + 1) * l_sel, S_kv)))
            for c0 in range(0, len(toks), tq):
                s_ = toks[c0:c0 + tq].long()
                q, do = Q[b, s_, g], dO[b, s_, g]                          # [T,h,D]
                vis = keys[None, None, :] <= t[s_][:, None, None]
                p = torch.where(vis, torch.exp(q @ K[b, g, keys].T * scale
                                               - lse[b, s_, g][..., None]), torch.zeros(()))
                ds = p * (do @ V[b, g, keys].T - delta[b, s_, g][..., None])
                kk = keys - k0 + sub * KEYS_PER_TILE
                part_v[slot, kk] += torch.einsum("thk,thd->kd", p, do)
                part_k[slot, kk] += torch.einsum("thk,thd->kd", ds, q)
                for i, s in enumerate(s_.tolist()):
                    ws[int(rks[c0 + i]) * nsub + sub, b, s, g] = ds[i] @ K[b, g, keys]
    dK, dV = torch.zeros_like(K), torch.zeros_like(V)
    for blk, (first, items) in enumerate(span.tolist()):
        b, g, jb = blk // (G * NB), blk // NB % G, blk % NB
        lo, hi = jb * l_sel, min((jb + 1) * l_sel, S_kv)
        for i in range(items):
            dK[b, g, lo:hi] += part_k[first + i, :hi - lo]
            dV[b, g, lo:hi] += part_v[first + i, :hi - lo]
    used = (torch.arange(ws.shape[0])[:, None, None, None] < nblk[None] * nsub)
    dQ = (ws * used[..., None, None]).sum(0)
    return dQ * scale, dK * scale, dV


def _walk_union(Q, K, V, sel, t, dO, lse, delta, l_sel, scale, T):
    """dQ as the union kernel forms it: per q tile of T tokens, over the
    union's 64-key tiles, each row masked by its membership bit."""
    B, S, G, h, Dk = Q.shape
    S_kv = K.shape[2]
    order, count, mask = selection_tile_union(sel, t, l_sel, S_kv, T)
    words = mask.long() & 0xFFFFFFFF
    dQ = torch.zeros_like(Q)
    for b in range(B):
        for g in range(G):
            for q in range(order.shape[2]):
                s_ = torch.arange(q * T, min(S, q * T + T))
                for u in range(int(count[b, g, q])):
                    blk = int(order[b, g, q, u])
                    mem = ((words[b, s_, g, u // 32] >> (u % 32)) & 1).bool()
                    keys = torch.arange(blk * l_sel, min((blk + 1) * l_sel, S_kv))
                    vis = mem[:, None, None] & (keys[None, None, :] <= t[s_][:, None, None])
                    p = torch.where(vis, torch.exp(Q[b, s_, g] @ K[b, g, keys].T * scale
                                                   - lse[b, s_, g][..., None]), torch.zeros(()))
                    ds = p * (dO[b, s_, g] @ V[b, g, keys].T - delta[b, s_, g][..., None])
                    dQ[b, s_, g] += ds @ K[b, g, keys]
    return dQ * scale


def _operands(B, S, G, h, D, S_kv, n, l_sel, seed):
    Q, dO = (torch.from_numpy(_rand(B, S, G, h, D, seed=seed + i)) for i in (0, 1))
    K, V = (torch.from_numpy(_rand(B, G, S_kv, D, seed=seed + i)) for i in (2, 3))
    sel = torch.from_numpy(_selection(B, S, G, n, -(-S_kv // l_sel), seed=seed + 4))
    t = torch.arange(S)
    O, lse = sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel, scale=0.3, return_lse=True)
    return Q, K, V, sel, t, dO, lse, attention_delta(dO, O)


@pytest.mark.parametrize("l_sel,S,tq,chunks,T", [
    (16, 45, 2, 2, 3),       # one sub-tile per block, S % l_sel != 0
    (128, 150, 3, 1, 10),    # two 64-key sub-tiles per block, the last one partial
])
def test_kernel_walks_over_the_tables_rebuild_the_plain_gradients(l_sel, S, tq, chunks, T):
    args = _operands(1, S, 2, 3, 8, S, 4, l_sel, seed=40)
    want = sel_attn_bwd_plain(*args, l_sel=l_sel, scale=0.3)
    got = _walk_kv(*args, l_sel, 0.3, tq, chunks)
    for g, w in zip(got, want):
        _close_rel(g.numpy(), w.numpy(), 2e-5)
    _close_rel(_walk_union(*args, l_sel, 0.3, T).numpy(), want[0].numpy(), 2e-5)


# ---------------------------------------------------------------- both designs vs JAX

@pytest.mark.parametrize("S,l_sel,n", [(96, 16, 4), (75, 32, 3)])
def test_both_designs_match_the_tpu_kernels(S, l_sel, n):
    """sel_attn_bwd and sel_attn_bwd_1p (plain versions on the CPU) against
    selection_flash_bwd and selection_flash_bwd_onepass in interpret mode,
    each from its own package's forward (the JAX lse is the kernels' base-2
    row-flat statistic)."""
    B, G, h, D, scale = 2, 2, 3, 16, 0.25
    Q, K, V, dO = _rand(B, S, G, h, D, seed=1), _rand(B, G, S, D, seed=2), \
        _rand(B, G, S, D, seed=3), _rand(B, S, G, h, D, seed=4)
    NB = -(-S // l_sel)
    sel = np.array(select_topn_blocks(
        jnp.asarray(np.random.RandomState(5).rand(B, S, G, NB)), n,
        jnp.arange(S, dtype=jnp.int32), l_sel))
    jargs = tuple(jnp.asarray(a) for a in (Q, K, V))
    O, lse = jsel.selection_flash_pallas(*jargs, jnp.asarray(sel), l_sel=l_sel, scale=scale,
                                         return_lse=True, interpret=True, block_q=16, kv_batch=2)
    d0 = jnp.sum(jnp.asarray(dO) * O, axis=-1).transpose(0, 2, 1, 3).reshape(B * G, 1, S * h)
    delta = jnp.pad(d0, ((0, 0), (0, 0), (0, stats_rows(S, h) - S * h)))
    kw = dict(l_sel=l_sel, scale=scale, block_q=16, kv_batch=2, interpret=True)
    tq = [torch.from_numpy(a) for a in (Q, K, V)]
    tsel, t, tdO = torch.from_numpy(sel), torch.arange(S), torch.from_numpy(dO)
    tO, tlse = sel_attn_plain(*tq, tsel, t, l_sel=l_sel, scale=scale, return_lse=True)
    targs = (*tq, tsel, t, tdO, tlse, attention_delta(tdO, tO))
    for jfn, tfn in ((jsel.selection_flash_bwd, sel_attn_bwd),
                     (jsel.selection_flash_bwd_onepass, sel_attn_bwd_1p)):
        want = jfn(*jargs, jnp.asarray(sel), jnp.asarray(dO), lse, delta, **kw)
        got = tfn(*targs, l_sel=l_sel, scale=scale)
        for g, w in zip(got, want):
            _close_rel(g.numpy(), w, 2e-5)
    assert sel_attn_bwd.launches == 0 and sel_attn_bwd_1p.launches == 0
