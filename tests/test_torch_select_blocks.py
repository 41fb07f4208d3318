"""The select-only scorer's tensor-core decomposition vs its plain version and the JAX kernel (CPU).

Row 6 (`select_blocks`, scorer.py::nsa_select_pallas) runs in bf16 on the
card as csrc/select_blocks_mma.cu. That kernel cannot run here; a PyTorch
walk of its decomposition does, on bf16-valued inputs from a numpy seed:
CTAs of `rows` band rows (row = token * h + head) over q tiles of TQ
tokens, taken from the last q tile down and covering every (b, g, q
tile) once; 64-token chunks of K_cmp at absolute multiples of 64; pass 0
the online max (floored at -1e20) and sum per row in base 2, pass 1 p =
exp2(s * scale * log2 e - lse2) in f32, the heads summed per (token,
compressed token), then the closed-form overlap map per (token, block)
over the blocks a chunk touches (which is the Eq. 9 map, entry for
entry); then the top-n. It rebuilds `select_blocks_plain`'s group scores
within 1e-6 and its sets, for odd h, h = 1, pos_offset > 0, rows with no
compressed token and an S_sel that makes `tile_plan` shrink the tile, and
the sets of the JAX kernel in interpret mode. `tile_plan` is checked
against the kernels' shared-memory layouts: it shrinks the tokens until
the scores fit, takes 55184 blocks in bf16 and keeps the f32 kernel's limit
of 52976 blocks at h = 6, Dk = 64.

Tolerance: group scores 1e-6 absolute (f32 exp2 vs the plain version's
exp, sums in another order; the scores are at most h). Sets equal
(random normal inputs, well separated scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops.pallas.scorer import nsa_select_pallas
from nsa_vibe_tpu_torch.ops.block_index import num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import select_blocks as sk
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel, topn_forced_first

KC = 64                       # compressed tokens per chunk
LOG2E = np.float32(1.4426950408889634)
M_FLOOR, NEG = -1e20, -3.4028234663852886e38


def _num_cmp(t, l, d):
    return torch.where(t >= l, (t - l) // d + 1, torch.zeros_like(t))


def _overlap(c, j, l, d, l_sel):
    """M[c, j] in closed form: overlap([c*d, c*d+l), [j*l_sel, (j+1)*l_sel)) / l."""
    a0, b0 = c[:, None] * d, j[None, :] * l_sel
    ov = (torch.minimum(a0 + l, b0 + l_sel) - torch.maximum(a0, b0)).clamp(min=0)
    return ov.float() / l


def _walk(Q, Kc, *, S_sel, scale, l, d, l_sel, n_top, pos_offset, TQ):
    """(sel_idx, p_grp) as the tensor-core kernel forms them with TQ
    tokens a CTA (module docstring)."""
    B, S, G, h, Dk = Q.shape
    S_cmp = Kc.shape[2]
    nq, BG = -(-S // TQ), B * G
    order = [(nq - 1 - bid // BG, bid % BG) for bid in range(nq * BG)]
    assert sorted(order) == [(qt, bg) for qt in range(nq) for bg in range(BG)]
    assert all(a[0] >= b[0] for a, b in zip(order, order[1:]))          # heaviest first
    M = sk.selection_map(S_cmp, S_sel, l, d, l_sel)
    sl2 = torch.tensor(np.float32(scale) * LOG2E)
    p_grp = torch.zeros(B, S, G, S_sel)
    for qt, bg in order:
        b, g = divmod(bg, G)
        s0 = qt * TQ
        nt = min(TQ, S - s0)
        t = pos_offset + s0 + torch.arange(nt)
        q = Q[b, s0:s0 + nt, g].float().reshape(nt * h, Dk)
        nv = _num_cmp(t + 1, l, d).clamp(max=S_cmp).repeat_interleave(h)   # [R]
        n_vis = min(int(_num_cmp(t[-1:] + 1, l, d)), S_cmp)
        Kz = torch.cat([Kc[b, g].float(), torch.zeros(KC, Dk)])
        m, lsum = torch.full((nt * h,), M_FLOOR), torch.zeros(nt * h)
        for c0 in range(0, n_vis, KC):                                     # pass 0
            keys = torch.arange(c0, c0 + KC)
            vis = keys[None, :] < nv[:, None]
            x = torch.where(vis, (q @ Kz[keys].T) * sl2, torch.tensor(NEG))
            m_new = torch.maximum(m, x.max(1).values)
            alpha = torch.where(m_new == m, torch.ones(()), torch.exp2(m - m_new))
            lsum = lsum * alpha + torch.exp2(x - m_new[:, None]).sum(1)
            m = m_new
        nlse2 = torch.where(lsum > 0, -(m + torch.log2(lsum)), torch.zeros(()))
        acc = torch.zeros(nt, S_sel)
        for c0 in range(0, n_vis, KC):                                     # pass 1
            c1 = min(c0 + KC, n_vis)
            keys = torch.arange(c0, c0 + KC)
            vis = keys[None, :] < nv[:, None]
            p = torch.where(vis, torch.exp2((q @ Kz[keys].T) * sl2 + nlse2[:, None]),
                            torch.zeros(()))
            ph = p.reshape(nt, h, KC).sum(1)[:, :c1 - c0]                  # heads per token
            j_lo, j_hi = c0 * d // l_sel, min(((c1 - 1) * d + l - 1) // l_sel, S_sel - 1)
            js, cs = torch.arange(j_lo, j_hi + 1), torch.arange(c0, c1)
            W = _overlap(cs, js, l, d, l_sel)
            # the closed form is the Eq. 9 map, and the chunk touches no other block
            assert torch.equal(W, M[c0:c1, j_lo:j_hi + 1])
            assert not M[c0:c1, :j_lo].any() and not M[c0:c1, j_hi + 1:].any()
            acc[:, j_lo:j_hi + 1] += ph @ W
        p_grp[b, s0:s0 + nt, g] = acc
    t_pos = pos_offset + torch.arange(S)
    return topn_forced_first(p_grp, n_top, t_pos, l_sel), p_grp


def _inputs(B, S, G, h, Dk, S_cmp, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16().float()
                 for s in ((B, S, G, h, Dk), (B, G, S_cmp, Dk)))


class _Layouts:
    """The shared-memory bytes the kernels' C functions report
    (select_blocks_mma.cu::Layout, select_blocks.cu::Smem), for tile_plan."""

    @staticmethod
    def nsa_select_blocks_mma_smem_bytes(tq, h, Dk, S_sel):
        pitch = ((64 if Dk <= 64 else 128) + 8) * 2
        return KC * pitch + tq * h * pitch + tq * h * (KC + 4) * 4 + tq * S_sel * 4

    @staticmethod
    def nsa_select_blocks_smem_bytes(tq, h, Dk, S_sel):
        r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
        R = tq * h
        return 4 * (r4(R * Dk) + r4(KC * (Dk + 4)) + r4(R * KC) + 2 * r4(R) + r4(tq * S_sel))


@pytest.mark.parametrize("rows", [64, 128])
def test_tile_plan_shrinks_the_tile_to_fit_the_scores(rows, monkeypatch):
    monkeypatch.setattr(sk, "MMA_TILE_ROWS", rows)
    lib, bf, f32 = _Layouts(), torch.bfloat16, torch.float32
    assert sk.tile_plan(lib, bf, 6, 64, 1024) == rows // 6       # the 64k prompt
    assert sk.tile_plan(lib, f32, 6, 64, 1024) == 10
    assert 1 < sk.tile_plan(lib, bf, 6, 64, 8192) < rows // 6
    assert sk.tile_plan(lib, bf, 6, 64, 55184) == 1              # ~55k blocks in bf16
    assert sk.tile_plan(lib, f32, 6, 64, 52976) == 1             # the f32 kernel's ~53k stay
    for dtype, S_sel in ((f32, 52977), (bf, 55185)):
        with pytest.raises(ValueError, match="exceed the kernel's limit"):
            sk.tile_plan(lib, dtype, 6, 64, S_sel)


@pytest.mark.parametrize("S,h,Dk,l,d,l_sel,n_top,pos_offset,rows", [
    (100, 3, 32, 8, 4, 16, 6, 0, 128),     # odd h; rows t < 7 see no compressed token
    (60, 6, 16, 16, 8, 16, 5, 70, 64),     # the m7c head count at positions 70..129
    (90, 1, 32, 8, 4, 8, 4, 0, 64),        # h = 1: 64 tokens a tile
    (68, 6, 64, 32, 16, 16, 16, 32700, 128),  # S_sel = 2048: tile_plan shrinks the tile
])
def test_tensor_core_walk_rebuilds_the_plain_scores_and_the_jax_sets(S, h, Dk, l, d, l_sel, n_top,
                                                                     pos_offset, rows,
                                                                     monkeypatch):
    B, G, scale = 2, 2, Dk ** -0.5
    n_pos = pos_offset + S
    S_cmp, S_sel = num_cmp_blocks(n_pos, l, d), -(-n_pos // l_sel)
    Q, Kc = _inputs(B, S, G, h, Dk, S_cmp, seed=S + h)
    kw = dict(S_sel=S_sel, scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top,
              pos_offset=pos_offset)
    monkeypatch.setattr(sk, "MMA_TILE_ROWS", rows)
    tq = sk.tile_plan(_Layouts(), torch.bfloat16, h, Dk, S_sel)
    assert (tq < rows // h) == (S_sel == 2048)
    sel, p_grp = _walk(Q, Kc, **kw, TQ=tq)
    psel, pp = sk.select_blocks_plain(Q, Kc, **kw, return_scores=True)
    torch.testing.assert_close(p_grp, pp, atol=1e-6, rtol=0)
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(psel))
    assert torch.equal(sel[..., :3], psel[..., :3])                    # forced slots, in order
    M = sk.selection_map(S_cmp, S_sel, l, d, l_sel)
    pal = nsa_select_pallas(jnp.asarray(Q.numpy()), jnp.asarray(Kc.numpy()),
                            jnp.asarray(M.numpy()), scale=scale, l=l, d=d, l_sel=l_sel,
                            n_top=n_top, pos_offset=pos_offset, block_q=16, cmp_chunk=512,
                            interpret=True)
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(torch.as_tensor(np.array(pal))))
    if pos_offset == 0:   # rows before the first compressed token score nothing
        assert not p_grp[:, :l - 1].any()

