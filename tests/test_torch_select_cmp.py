"""The fused scorer's tensor-core decomposition vs its plain version and the JAX kernel (CPU).

Row 1 (`select_cmp`, scorer.py::nsa_select_and_cmp_pallas) runs in bf16 on
the card as csrc/select_cmp_mma.cu. That kernel cannot run here; a
PyTorch walk of its decomposition does, on bf16-valued inputs from a numpy
seed: CTAs of `rows` band rows (row = token * h + head) over q tiles of TQ
tokens (`tile_plan`), taken from the last q tile down and covering every
(b, g, q tile) once; 64-token tiles of K_cmp at absolute multiples of 64;
pass 1 the base-2 online softmax (running max floored at -1e20) with P
rounded to bf16 for P V, giving O, lse and lse2 = m + log2(l); pass 2 p =
exp2(s * scale * log2 e - lse2) in f32, each token's heads summed per
compressed token, then per chunk the band of M that the chunk's tokens
overlap (the entries `select_blocks.cuh::chunk_scores` reads, and no
other); then the top-n, by the kernel's rank per block where S_sel <= 32.
It rebuilds `select_cmp_plain`'s group scores and lse, its sets with the
forced slots in order, and its O within the tensor-core bound; the JAX
kernel in interpret mode (with scale_on_q off: its default also rounds Q *
scale to bf16, which the port's kernel does not) gives the same sets, O
within the same bound, and the same lse after its base-2, flat [B*G, 1,
stats_rows] layout is converted. Cases: odd h, h = 1, the m7c geometry (h
= 6, l = 32, d = 16, l_sel = 64), S_sel = 256 (the route's limit, where the
tile shrinks), Dk != Dv, and rows that see no compressed token. Also: the
Eq. 9 map `build_M_csl_on` is zero outside that band at every tested shape
and at the m7c prompts of 2048 and 16384 tokens, so the kernel reads every
nonzero entry; `tile_plan` against the kernel's shared-memory layout.

Tolerances: group scores 1e-6 absolute (f32 exp2 vs the plain version's
exp, sums in another order; the scores are at most h); lse 1e-5 absolute;
O within one bf16 ulp of the plain version's unrounded f32 O, plus 5e-5 of
its max, plus 4 * 2^-9 times the root sum of squares of each element's
terms (`banded_attn_rss` in cmp mode), as chip_smoke.py::allowed_tc_err
holds it on the card, where a 1% fault planted in O must fail it. Sets
equal (random normal inputs, well separated scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops.pallas import scorer as jscorer
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn_rss
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel, topn_forced_first

KC = 64                       # compressed tokens per K_cmp tile and per chunk of the map
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)
M_FLOOR, NEG = -1e20, -3.4028234663852886e38
EMPTY_LSE = 1e30
F32_TOL, TC_SIGMAS, FAULT = 5e-5, 4, 1.01


def _num_cmp(t, l, d):
    return torch.where(t >= l, (t - l) // d + 1, torch.zeros_like(t))


def _band(c0, c1, S_sel, l, d, l_sel):
    """(j_lo, mask [c1 - c0, nj]) of the entries chunk_scores reads for the
    chunk of compressed tokens [c0, c1): blocks j_lo..j_hi, and per block j
    the tokens lo_c..hi_c whose span [c*d, c*d + l) overlaps it."""
    j_lo, j_hi = c0 * d // l_sel, min(((c1 - 1) * d + l - 1) // l_sel, S_sel - 1)
    mask = torch.zeros(c1 - c0, j_hi - j_lo + 1, dtype=torch.bool)
    for j in range(j_lo, j_hi + 1):
        b0, b1 = j * l_sel, (j + 1) * l_sel
        first = b0 - l + 1
        lo_c = max(c0, 0 if first <= 0 else -(-first // d))
        hi_c = min(c1 - 1, (b1 - 1) // d)
        mask[lo_c - c0:hi_c - c0 + 1, j - j_lo] = True
    return j_lo, mask


def _read_mask(S_cmp, S_sel, l, d, l_sel):
    """[S_cmp, S_sel]: the entries of M that chunk_scores reads, over the
    chunks [c0, c0 + 64) of a tile that sees every compressed token."""
    read = torch.zeros(S_cmp, S_sel, dtype=torch.bool)
    for c0 in range(0, S_cmp, KC):
        c1 = min(c0 + KC, S_cmp)
        j_lo, mask = _band(c0, c1, S_sel, l, d, l_sel)
        read[c0:c1, j_lo:j_lo + mask.shape[1]] |= mask
    return read


def _top_n_rank(p_grp, l_sel, n_top):
    """select_blocks.cuh::top_n at S_sel <= 32 (forced slots 0, t//l_sel,
    t//l_sel - 1): each block's rank among the candidates by (score - 1e-8 *
    index descending, index ascending); the block of rank k fills slot 3 + k,
    slots past the candidates get -1."""
    B, S, G, S_sel = p_grp.shape
    assert S_sel <= 32
    t = torch.arange(S)[None, :, None, None]
    c = torch.arange(S_sel)
    last = t // l_sel
    forced = (c == 0) | (c == last) | (c == (last - 1).clamp(min=0))
    cand = (c * l_sel <= t) & ~forced                                   # [1,S,1,S_sel]
    v = torch.where(cand, p_grp - c.float() * 1e-8, torch.tensor(NEG))   # tie_break_scores
    ahead = (v[..., None, :] > v[..., :, None]) | (
        (v[..., None, :] == v[..., :, None]) & (c[None, :] < c[:, None]))
    rank = ahead.sum(-1)
    k_rest = n_top - 3
    slot = torch.where(cand & (rank < k_rest), rank, torch.full_like(rank, k_rest))
    rest = torch.full((B, S, G, k_rest + 1), -1, dtype=torch.int64)
    rest.scatter_(-1, slot.expand(B, S, G, S_sel), c.expand(B, S, G, S_sel))
    first = torch.cat([torch.zeros_like(last), last, (last - 1).clamp(min=0)], -1)
    return torch.cat([first.expand(B, S, G, 3), rest[..., :k_rest]], -1).to(torch.int32)


def _walk(Q, Kc, Vc, M, *, scale, l, d, l_sel, n_top, TQ):
    """(sel_idx, O bf16, lse, p_grp) as select_cmp_mma.cu forms them with TQ
    tokens a CTA (module docstring)."""
    B, S, G, h, Dk = Q.shape
    S_cmp, S_sel = M.shape
    Dv = Vc.shape[3]
    nq, BG = -(-S // TQ), B * G
    order = [(nq - 1 - bid // BG, bid % BG) for bid in range(nq * BG)]
    assert sorted(order) == [(qt, bg) for qt in range(nq) for bg in range(BG)]
    assert all(a[0] >= b[0] for a, b in zip(order, order[1:]))          # heaviest first
    sl2 = torch.tensor(np.float32(scale) * LOG2E)
    p_grp, O = torch.zeros(B, S, G, S_sel), torch.zeros(B, S, G, h, Dv)
    lse = torch.zeros(B, S, G, h)
    for qt, bg in order:
        b, g = divmod(bg, G)
        s0 = qt * TQ
        nt = min(TQ, S - s0)
        t = s0 + torch.arange(nt)
        q = Q[b, s0:s0 + nt, g].float().reshape(nt * h, Dk)
        nv = _num_cmp(t + 1, l, d).clamp(max=S_cmp).repeat_interleave(h)   # [R]
        n_vis = min(int(_num_cmp(t[-1:] + 1, l, d)), S_cmp)
        Kz = torch.cat([Kc[b, g].float(), torch.zeros(KC, Dk)])           # zero-filled tiles
        Vz = torch.cat([Vc[b, g].float(), torch.zeros(KC, Dv)])
        m, lsum = torch.full((nt * h,), M_FLOOR), torch.zeros(nt * h)
        acc_o = torch.zeros(nt * h, Dv)
        for c0 in range(0, n_vis, KC):                                     # pass 1
            keys = torch.arange(c0, c0 + KC)
            vis = keys[None, :] < nv[:, None]
            x = torch.where(vis, (q @ Kz[keys].T) * sl2, torch.tensor(NEG))
            m_new = torch.maximum(m, x.max(1).values)
            alpha = torch.where(m_new == m, torch.ones(()), torch.exp2(m - m_new))
            p = torch.exp2(x - m_new[:, None])
            lsum = lsum * alpha + p.sum(1)
            acc_o = acc_o * alpha[:, None] + p.bfloat16().float() @ Vz[keys]
            m = m_new
        live = lsum > 0
        lse2 = m + torch.log2(lsum.clamp(min=1e-38))
        O[b, s0:s0 + nt, g] = torch.where(live[:, None], acc_o / lsum.clamp(min=1e-38)[:, None],
                                          torch.zeros(())).reshape(nt, h, Dv)
        lse[b, s0:s0 + nt, g] = torch.where(live, lse2 * LN2,
                                            torch.tensor(EMPTY_LSE)).reshape(nt, h)
        nlse2 = torch.where(live, -lse2, torch.zeros(()))
        acc = torch.zeros(nt, S_sel)
        for c0 in range(0, n_vis, KC):                                     # pass 2
            c1 = min(c0 + KC, n_vis)
            keys = torch.arange(c0, c0 + KC)
            vis = keys[None, :] < nv[:, None]
            p = torch.where(vis, torch.exp2((q @ Kz[keys].T) * sl2 + nlse2[:, None]),
                            torch.zeros(()))
            ph = p.reshape(nt, h, KC).sum(1)[:, :c1 - c0]                  # heads per token
            j_lo, mask = _band(c0, c1, S_sel, l, d, l_sel)
            W = torch.where(mask, M[c0:c1, j_lo:j_lo + mask.shape[1]], torch.zeros(()))
            acc[:, j_lo:j_lo + mask.shape[1]] += ph @ W
        p_grp[b, s0:s0 + nt, g] = acc
    sel = (_top_n_rank(p_grp, l_sel, n_top) if S_sel <= 32
           else topn_forced_first(p_grp, n_top, torch.arange(S), l_sel))
    return sel, O.bfloat16(), lse, p_grp


def _tc_bound(plain32, rss):
    """One bf16 ulp of the unrounded plain value, F32_TOL of its max and
    TC_SIGMAS * 2^-9 * rss (module docstring)."""
    x = plain32.abs()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return (torch.where(x > 0, ulp, torch.zeros_like(x)) + F32_TOL * float(x.max())
            + TC_SIGMAS * 2.0 ** -9 * rss)


def _ratio(got, want, bound):
    return float(((got.float() - want).abs() / bound).max())


class _Layout:
    """The shared-memory bytes select_cmp_mma.cu::Layout reports, for tile_plan."""

    @staticmethod
    def nsa_select_cmp_mma_smem_bytes(rows, tq, h, Dk, Dv, S_sel):
        P = (64 if max(Dk, Dv) <= 64 else 128) + 8
        return 4 * KC * P * 2 + rows * P * 2 + tq * h * (KC + 4) * 4 + tq * S_sel * 4


def test_tile_plan_keeps_two_ctas_an_sm_at_head_width_64():
    """The tokens a CTA takes at these shapes, and the shrink where the
    group scores would not let two CTAs of 128 rows share an SM."""
    lib = _Layout()
    for (h, Dk, Dv, S_sel), tq in {(6, 64, 64, 32): 21, (6, 64, 64, 256): 21, (3, 64, 64, 5): 42,
                                   (1, 32, 32, 13): 128, (1, 16, 16, 256): 46,
                                   (5, 128, 128, 5): 25, (2, 64, 32, 6): 64}.items():
        assert sc_mod.tile_plan(lib, h, Dk, Dv, S_sel) == tq, (h, Dk, Dv, S_sel)
        need = lib.nsa_select_cmp_mma_smem_bytes(128, tq, h, Dk, Dv, S_sel)
        assert need <= (sc_mod.TWO_CTA_SMEM if max(Dk, Dv) <= 64 else sc_mod.SMEM_LIMIT)
    assert lib.nsa_select_cmp_mma_smem_bytes(128, 21, 6, 64, 64, 256) == 111072
    for h in (1, 7, 64):   # every shape select_cmp_fits admits takes a tile
        assert sc_mod.select_cmp_fits(h, 256)
        assert 1 <= sc_mod.tile_plan(lib, h, 128, 128, 256) <= 128 // h


def test_tile_plan_gives_packed_documents_the_one_cta_budget():
    """With seq_start the kernel runs one CTA an SM (its DOCS instantiation),
    so its tiles shrink only past SMEM_LIMIT: at h = 1, S_sel = 256 a CTA
    keeps all 128 tokens where the dense kernel takes 46."""
    lib = _Layout()
    for (h, Dk, Dv, S_sel), (dense, docs) in {(1, 16, 16, 256): (46, 128),
                                              (6, 64, 64, 32): (21, 21)}.items():
        assert sc_mod.tile_plan(lib, h, Dk, Dv, S_sel) == dense
        assert sc_mod.tile_plan(lib, h, Dk, Dv, S_sel, docs=True) == docs
        need = lib.nsa_select_cmp_mma_smem_bytes(128, docs, h, Dk, Dv, S_sel)
        assert sc_mod.TWO_CTA_SMEM < need <= sc_mod.SMEM_LIMIT or docs == dense


@pytest.mark.parametrize("S,l,d,l_sel", [
    (100, 8, 4, 16), (90, 8, 4, 8), (200, 32, 16, 64), (1024, 8, 4, 4), (120, 16, 8, 16),
    (2048, 32, 16, 64), (16384, 32, 16, 64),   # the m7c serve / train prompt, the route's limit
])
def test_the_map_is_zero_outside_the_band_the_kernel_reads(S, l, d, l_sel):
    M = build_M_csl_on(S, l, d, l_sel, "cpu")
    read = _read_mask(*M.shape, l, d, l_sel)
    assert not M[~read].any()
    assert bool((M[read] > 0).all())


@pytest.fixture
def jax_scale_off_q(monkeypatch):
    """The JAX fused scorer with flash.scale_on_q off, its traces cleared
    before and after."""
    jscorer.nsa_select_and_cmp_pallas.clear_cache()
    monkeypatch.setattr(jscorer, "_scale_on_q", lambda: False)
    yield jscorer.nsa_select_and_cmp_pallas
    jscorer.nsa_select_and_cmp_pallas.clear_cache()


@pytest.mark.parametrize("B,G,S,h,Dk,Dv,l,d,l_sel,n_top", [
    (2, 2, 100, 3, 32, 32, 8, 4, 16, 6),       # odd h; rows t < 7 see no compressed token
    (2, 2, 90, 1, 32, 32, 8, 4, 8, 4),         # h = 1: 128 tokens a CTA
    (2, 2, 200, 6, 16, 16, 32, 16, 64, 4),     # the m7c geometry; rows t < 31 see none
    (1, 1, 1024, 1, 16, 16, 8, 4, 4, 16),      # S_sel = 256: the tile shrinks to 46 tokens
    (2, 2, 120, 2, 32, 16, 16, 8, 16, 5),      # Dk != Dv
])
def test_tensor_core_walk_rebuilds_the_plain_result_and_matches_the_jax_kernel(
        B, G, S, h, Dk, Dv, l, d, l_sel, n_top, jax_scale_off_q):
    rng = np.random.RandomState(S + h)
    S_cmp = num_cmp_blocks(S, l, d)
    Q, Kc, Vc = (torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
                 for s in ((B, S, G, h, Dk), (B, G, S_cmp, Dk), (B, G, S_cmp, Dv)))
    M = build_M_csl_on(S, l, d, l_sel, "cpu")
    scale = Dk ** -0.5
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top)
    tq = sc_mod.tile_plan(_Layout(), h, Dk, Dv, M.shape[1])
    sel, O, lse, p_grp = _walk(Q, Kc, Vc, M, **kw, TQ=tq)
    psel, _, plse, pp = sc_mod.select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=True,
                                               return_scores=True)
    torch.testing.assert_close(p_grp, pp, atol=1e-6, rtol=0)
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(psel))
    assert torch.equal(sel[..., :3], psel[..., :3])                    # forced slots, in order
    if M.shape[1] <= 32:    # the rank top-n gives the argmax passes' slots, in order
        assert torch.equal(sel, topn_forced_first(p_grp, n_top, torch.arange(S), l_sel))
    empty = plse >= 1e29
    assert bool(empty[:, :l - 1].all()) and not bool(empty[:, l - 1:].any())
    assert torch.equal(lse >= 1e29, empty)
    assert float(torch.where(empty, 0.0, (lse - plse).abs()).max()) <= 1e-5
    assert not O[:, :l - 1].float().any() and not p_grp[:, :l - 1].any()
    want, rss = banded_attn_rss(Q, Kc, Vc, mode="cmp", l=l, d=d, scale=scale)
    bound = _tc_bound(want, rss)
    assert _ratio(O, want, bound) <= 1.0
    assert _ratio(O.float() * FAULT, want, bound) > 1.0
    # the TPU kernel it replaces, in interpret mode, on the same values
    jsel, jO, jlse = jax_scale_off_q(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                       for x in (Q, Kc, Vc)), jnp.asarray(M.numpy()), **kw,
                                     block_q=32, cmp_chunk=64, interpret=True)
    jsel = torch.from_numpy(np.array(jsel))
    assert torch.equal(canonicalize_sel(jsel), canonicalize_sel(sel))
    assert torch.equal(jsel[..., :3], sel[..., :3])
    jO = torch.from_numpy(np.array(jO.astype(jnp.float32)))
    assert _ratio(jO, want, bound) <= 1.0
    jl = torch.from_numpy(np.array(jlse))[:, 0, :S * h].reshape(B, G, S, h).permute(0, 2, 1, 3)
    assert torch.equal(jl >= 1e29, empty)
    assert float(torch.where(empty, 0.0, (jl * LN2 - plse).abs()).max()) <= 1e-5
