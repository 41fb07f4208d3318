"""The banded forward's bound and decomposition vs the JAX package (CPU).

The bf16 banded forward (csrc/banded_fwd_mma.cu, behind win_attn and
banded_attn) rounds P to bf16 before P V, as the TPU kernels do
(flash.py:213, flash_diag.py:119), so it is held to the plain version's
unrounded f32 result within one bf16 ulp, plus 5e-5 of the output's max,
plus 4 * 2^-9 times the root sum of squares of each element's terms
(`banded_attn_rss`), as chip_smoke.py::allowed_tc_err holds it on the
card. Here, with numpy-seeded data:
- banded_attn_rss against a direct numpy sum, in both modes;
- that bound against the TPU kernels themselves: flash_banded_diag and
  flash_banded (window and compressed prefix, t_start > 0, odd h, S_kv
  not a multiple of 64) in interpret mode on bf16 inputs lie within it,
  and a 1% error planted in their output does not;
- a PyTorch walk of the kernel's decomposition (key tiles of 64 at
  absolute multiples of 64, 16-row warps that mask only the band's edge
  tiles and skip tiles they do not see, the base-2 online softmax with
  its running max floored at -1e20, P rounded to bf16, q tiles of 64 and
  128 rows) rebuilds the plain result within the bound, and its rows are
  bit-identical under both q tiles and under t_start;
- rows that see no compressed token give O = 0 and lse = EMPTY_LSE.

Tolerances: rss 1e-6 absolute + 1e-5 relative (f32 sum order); lse 1e-4
absolute (chip_smoke.py's LSE_TOL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops.pallas.flash import flash_banded
from nsa_vibe_tpu.ops.pallas.flash_diag import flash_banded_diag
from nsa_vibe_tpu_torch.ops.block_index import num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import (
    banded_attn, banded_attn_plain, banded_attn_rss,
)
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn, win_attn_rss

F32_TOL, TC_SIGMAS, FAULT, LSE_TOL = 5e-5, 4, 1.01, 1e-4
KC = 64                # keys per tile of the kernel
EMPTY_LSE = 1e30
NEG = -torch.finfo(torch.float32).max
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


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


def _operands(mode, S, t_start, h, D, kw, B=1, G=2, seed=0):
    n_pos = t_start + S
    S_kv = n_pos if mode == "win" else num_cmp_blocks(n_pos, kw["l"], kw["d"])
    return tuple(_bf16(_rand(*shape, seed=seed + i)) for i, shape in
                 enumerate(((B, S, G, h, D), (B, G, S_kv, D), (B, G, S_kv, D))))


@pytest.mark.parametrize("mode,kw", [("win", dict(w=3)), ("cmp", dict(l=4, d=2))])
def test_banded_attn_rss_matches_a_direct_sum(mode, kw):
    B, S, G, h, D, scale, t_start = 1, 6, 2, 2, 3, 0.4, 2
    n_pos = t_start + S
    S_kv = n_pos if mode == "win" else num_cmp_blocks(n_pos, kw["l"], kw["d"])
    Q, K, V = _rand(B, S, G, h, D, seed=1), _rand(B, G, S_kv, D, seed=2), \
        _rand(B, G, S_kv, D, seed=3)
    want32, got = banded_attn_rss(*(torch.from_numpy(a) for a in (Q, K, V)), mode=mode, **kw,
                                  scale=scale, t_start=t_start)
    want = np.zeros((B, S, G, h, D))
    for b, s, g, j in np.ndindex(B, S, G, h):
        t = t_start + s
        if mode == "win":
            keys = np.arange(max(t - kw["w"] + 1, 0), min(t + 1, S_kv))
        else:
            keys = np.arange(min(num_cmp_blocks(t + 1, kw["l"], kw["d"]), S_kv))
        if keys.size == 0:
            continue
        z = np.array([scale * Q[b, s, g, j] @ K[b, g, k] for k in keys], np.float64)
        p = np.exp(z - z.max())
        for c in range(D):
            want[b, s, g, j, c] = np.sqrt(sum((p[i] * V[b, g, k, c]) ** 2
                                              for i, k in enumerate(keys))) / p.sum()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(want32, banded_attn_plain(
        *(torch.from_numpy(a) for a in (Q, K, V)), mode=mode, **kw, scale=scale,
        t_start=t_start), atol=1e-6, rtol=0)
    if mode == "cmp":
        assert not got[:, 0].any()                      # t = 2: no compressed token yet


@pytest.mark.parametrize("kernel,mode,S,t_start,h,kw", [
    ("diag", "win", 200, 0, 3, dict(w=40)),       # odd h; S_kv = 200, not a multiple of 64
    ("diag", "win", 72, 128, 2, dict(w=48)),      # rows at positions 128..199
    ("flash", "win", 100, 30, 1, dict(w=24)),     # h = 1; S_kv = 130
    ("flash", "cmp", 150, 0, 3, dict(l=8, d=4)),  # odd h; rows t < 7 see no token
    ("flash", "cmp", 64, 200, 2, dict(l=8, d=4)),   # S_kv = 65
])
def test_the_tpu_kernels_bf16_output_lies_within_the_forward_bound(kernel, mode, S, t_start, h,
                                                                   kw):
    """The TPU kernels (interpret mode, bf16, scale_on_q off so that the
    scale is folded into the f32 logits as the port's kernel folds it)
    round P to bf16 as the port's kernel does: their output lies within
    the forward bound of the port's unrounded f32 result, and a planted
    1% error does not."""
    D, scale = 32, 32 ** -0.5
    Q, K, V = _operands(mode, S, t_start, h, D, kw, B=2, seed=7)
    jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (Q, K, V)]
    t0 = jnp.asarray([t_start], jnp.int32)
    if kernel == "diag":
        O = flash_banded_diag(*jargs, **kw, scale=scale, block_q=64, interpret=True,
                              t_start=t0, scale_on_q=False)
    else:
        O = flash_banded(*jargs, mode=mode, **kw, scale=scale, block_q=32, block_k=32,
                         interpret=True, t_start=t0, scale_on_q=False)
    got = torch.from_numpy(np.array(O.astype(jnp.float32)))
    want, rss = banded_attn_rss(Q, K, V, mode=mode, **kw, scale=scale, t_start=t_start)
    bound = _tc_bound(want, rss)
    ratio, fault = _ratio(got, want, bound), _ratio(got * FAULT, want, bound)
    print(f"worst err/bound {ratio:.3f}; with a 1% fault {fault:.3f}")
    assert ratio <= 1.0, ratio
    assert fault > 1.0, fault


def _key_range(mode, t, S_kv, w=0, l=0, d=1):
    """Keys [lo, hi) of the query at position t (banded_fwd_mma.cu::key_range)."""
    if mode == "win":
        return max(t - w + 1, 0), min(t + 1, S_kv)
    return 0, min(num_cmp_blocks(t + 1, l, d), S_kv)


def _exp2(x):
    """exp2 of f32 values to f32, the same bits wherever an element lies
    in the tensor (PyTorch's vectorised f32 exp2 and its scalar tail may
    differ in the last bit; in f64 they agree to far below an f32 ulp)."""
    return torch.exp2(x.double()).float()


def _log2(x):
    return torch.log2(x.double()).float()


def _walk(Q, K, V, *, mode, scale, t_start, rows, w=0, l=0, d=1):
    """O (bf16) and lse as banded_fwd_mma.cu forms them: per q tile of
    rows // h tokens, key tiles of KC keys from floor(lo(t_first) / KC) *
    KC to hi(t_last); per warp of 16 rows, a tile none of its live rows
    sees is skipped and one all of them see whole is not masked; online
    softmax in base 2 (scaled logits rounded once, running max floored at
    -1e20), l summing the unrounded p, O += bf16(P) V. Each sum runs in a
    fixed order over the keys, so a row's bits depend only on the tiles
    it passes."""
    B, S, G, h, _ = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    qT = rows // h
    sl2 = torch.tensor(np.float32(scale) * LOG2E)
    z = torch.einsum("bsghd,bgkd->bgshk", Q.float(), K.float())                # [B,G,S,h,S_kv]
    z = torch.cat([z, torch.zeros(B, G, S, h, KC)], dim=-1) * sl2              # keys past S_kv
    Vz = torch.cat([V.float(), torch.zeros(B, G, KC, Dv)], dim=2)              # zero-filled
    O, lse = torch.zeros(B, G, S, h, Dv), torch.zeros(B, G, S, h)
    rng = dict(w=w, l=l, d=d)
    for s0 in range(0, S, qT):
        T = min(qT, S - s0)
        R = T * h
        lo, _ = _key_range(mode, t_start + s0, S_kv, **rng)
        _, hi = _key_range(mode, t_start + s0 + T - 1, S_kv, **rng)
        kb0 = lo // KC * KC
        n_tiles = -(-(hi - kb0) // KC) if hi > lo else 0
        for r0 in range(0, R, 16):
            r = torch.arange(r0, min(r0 + 16, R))
            tok, head = s0 + r // h, r % h
            t = t_start + tok
            bands = [_key_range(mode, int(x), S_kv, **rng) for x in t]
            rlo = torch.tensor([a for a, _ in bands])[:, None]
            rhi = torch.tensor([b for _, b in bands])[:, None]
            lo_a, hi_a = bands[0]
            lo_b, hi_b = bands[-1]
            m2 = torch.full((B, G, len(r)), -1e20)
            lsum, acc = torch.zeros(B, G, len(r)), torch.zeros(B, G, len(r), Dv)
            for j in range(n_tiles):
                k0 = kb0 + j * KC
                if not (k0 + KC > lo_a and k0 < hi_b):
                    continue                                            # the warp sees no key
                x = z[:, :, tok, head, k0:k0 + KC]                       # [B,G,rows,KC]
                if not (k0 >= lo_b and k0 + KC <= hi_a):                # an edge tile: mask
                    key = torch.arange(k0, k0 + KC)[None, :]
                    x = torch.where((key >= rlo) & (key < rhi), x, torch.tensor(NEG))
                m_new = torch.maximum(m2, x.max(-1).values)
                alpha = _exp2(m2 - m_new)
                p = _exp2(x - m_new[..., None])
                pb = p.to(torch.bfloat16).float()
                lsum = lsum * alpha
                acc = acc * alpha[..., None]
                for k in range(KC):
                    lsum = lsum + p[..., k]
                    acc = acc + pb[..., k, None] * Vz[:, :, None, k0 + k]
                m2 = m_new
            inv = torch.where(lsum > 0, 1.0 / lsum.clamp(min=1e-38), torch.zeros(()))
            O[:, :, tok, head] = acc * inv[..., None]
            lse[:, :, tok, head] = torch.where(lsum > 0, (m2 + _log2(lsum.clamp(min=1e-38))) * LN2,
                                               torch.tensor(EMPTY_LSE))
    return O.permute(0, 2, 1, 3, 4).to(torch.bfloat16), lse.permute(0, 2, 1, 3)


@pytest.mark.parametrize("mode,S,t_start,h,D,kw", [
    ("win", 150, 0, 3, 16, dict(w=40)),      # odd h: 63 and 126 live rows a tile
    ("win", 96, 70, 6, 8, dict(w=100)),      # t_start not a multiple of either q tile
    ("win", 60, 0, 1, 8, dict(w=300)),       # h = 1, window wider than S
    ("cmp", 150, 0, 2, 16, dict(l=8, d=4)),  # rows t < 7 see no token
    ("cmp", 80, 131, 3, 8, dict(l=16, d=8)),   # S_kv = 26, not a multiple of 64
])
def test_kernel_walk_rebuilds_the_plain_result_and_its_bits_follow_the_key_tiles(
        mode, S, t_start, h, D, kw):
    Q, K, V = _operands(mode, S, t_start, h, D, kw, seed=11)
    scale = D ** -0.5
    want, rss = banded_attn_rss(Q, K, V, mode=mode, **kw, scale=scale, t_start=t_start)
    bound = _tc_bound(want, rss)
    _, want_lse = banded_attn_plain(Q.float(), K.float(), V.float(), mode=mode, **kw,
                                    scale=scale, t_start=t_start, return_lse=True)
    empty = want_lse >= 1e29
    walks = {rows: _walk(Q, K, V, mode=mode, **kw, scale=scale, t_start=t_start, rows=rows)
             for rows in (64, 128)}
    for rows, (O, lse) in walks.items():
        assert _ratio(O, want, bound) <= 1.0, rows
        assert _ratio(O.float() * FAULT, want, bound) > 1.0, rows
        assert torch.equal(lse >= 1e29, empty)
        assert float(torch.where(empty, 0.0, (lse - want_lse).abs()).max()) <= LSE_TOL
    assert torch.equal(walks[64][0], walks[128][0]) and torch.equal(walks[64][1], walks[128][1])
    # the same rows from a call over every position (t_start = 0)
    Qf = torch.cat([_bf16(_rand(1, t_start, *Q.shape[2:], seed=12)), Q], dim=1)
    Of, lsef = _walk(Qf, K, V, mode=mode, **kw, scale=scale, t_start=0, rows=64)
    assert torch.equal(Of[:, t_start:], walks[64][0])
    assert torch.equal(lsef[:, t_start:], walks[64][1])


def test_rows_without_a_compressed_token_give_zero_and_the_empty_lse():
    """The first q tiles of CMP (t + 1 < l) see no key at all: O = 0 and
    lse = EMPTY_LSE, from the walk and from the wrapper's plain version."""
    mode, kw, S, h, D = "cmp", dict(l=32, d=16), 100, 2, 8
    Q, K, V = _operands(mode, S, 0, h, D, kw, seed=21)
    O, lse = _walk(Q, K, V, mode=mode, **kw, scale=0.3, t_start=0, rows=64)
    Op, lsep = banded_attn(Q, K, V, mode=mode, **kw, scale=0.3, return_lse=True)
    for o, s in ((O, lse), (Op, lsep)):
        assert not o[:, :kw["l"] - 1].float().any() and bool(o[:, kw["l"] - 1:].float().any())
        assert bool((s[:, :kw["l"] - 1] == EMPTY_LSE).all())
        assert bool((s[:, kw["l"] - 1:] < 1e29).all())
    assert banded_attn.launches == 0


def test_win_attn_is_banded_attn_in_window_mode():
    """win_attn's plain version and rss are banded_attn's in window mode at
    t_start = 0 (the kernels it launches on the card)."""
    Q, K, V = _operands("win", 70, 0, 3, 16, dict(w=20), seed=31)
    a, b = win_attn(Q, K, V, w=20, scale=0.25, return_lse=True), \
        banded_attn(Q, K, V, mode="win", w=20, scale=0.25, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(win_attn_rss(Q, K, V, w=20, scale=0.25),
                                                 banded_attn_rss(Q, K, V, mode="win", w=20,
                                                                 scale=0.25)))
    assert win_attn.launches == 0
