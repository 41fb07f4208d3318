"""The banded backward's bound and decompositions vs the JAX package (CPU).

The bf16 banded backward (csrc/banded_bwd_mma.cu: the q-major diagonal
window kernel behind win_bwd_diag, the kv-major one-pass kernel behind
banded_bwd_1p, window and compressed prefix, and the two-pass banded_bwd:
the q-major kernel's dQ in either mode, then the kv-major kernel with its
dQ slots off) rounds P and dS to bf16 before their products, as the TPU
kernels do (flash_bwd.py:131, :345, :350; flash_diag.py:337, :341). It
is held to the plain version's unrounded f32 gradients within one bf16
ulp, plus F32_TOL = 5e-5 of each gradient's max |value|, plus 4 * 2^-9
times the root sum of squares of each element's terms (`banded_bwd_rss`),
as chip_smoke.py::allowed_tc_err holds it on the card. Here, with
numpy-seeded data:
- banded_bwd_rss against a direct numpy sum, in both modes;
- that bound against the TPU kernels themselves, in interpret mode on
  bf16 inputs with scale_on_q off (the scale folded into the f32 logits,
  as the port's kernels fold it), fed the port's row statistics:
  flash_banded_bwd_onepass and flash_banded_bwd (two passes) in both
  modes and flash_banded_bwd_diag lie within it, and a 1% fault planted in
  each of dQ, dK, dV does not. The
  diagonal kernel also rounds its dK/dV strips to bf16 (flash_diag.py:338,
  :344; the port keeps them f32), which takes its dK past that bound
  (1.06 of it at the first diagonal case): each strip, a partial sum over
  a q tile's rows, moves by up to half a bf16 ulp of itself. It is held to
  the bound plus half a bf16 ulp of each of the element's strips, formed
  from the plain terms (`_strip_term`), which holds, and still fails the
  planted faults;
- PyTorch walks of the three decompositions (key tiles at absolute
  multiples of 64; the q-major walk's q tiles of 64 and 128 rows, in
  window mode with their strips summed per key in tile order (the
  diagonal design), in either mode dQ alone (the two-pass dQ pass); the
  kv-major walk's split shares, chunks of band rows and dQ slots, each
  (slot, row) written once, summed in slot order, split partials in split
  order, or with the slots off (the two-pass dK/dV pass, which gives the
  one-pass walk's dK and dV bit for bit); P and dS rounded to bf16)
  rebuild the plain gradients within the bound, with odd h, h = 1, S_kv
  not a multiple of 64, w > S and compressed rows that see no token. The
  walks form P and dS from the same logits, so they differ only in
  summation order: they agree within two bf16 ulps plus F32_TOL of each
  gradient's max (chip_smoke.py's allowed_rel_err), the bound the card
  holds the kernels of rows 7, 8 and 11 to each other by;
- rows of the compressed branch with t < l - 1 get zero dQ.

Tolerances: rss 1e-6 absolute + 1e-5 relative (f64 vs f32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops.pallas import flash_bwd as jflash_bwd
from nsa_vibe_tpu.ops.pallas.flash import stats_rows
from nsa_vibe_tpu.ops.pallas.flash_diag import flash_banded_bwd_diag
from nsa_vibe_tpu_torch.ops.block_index import num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn_plain
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import (
    banded_bwd, banded_bwd_plain, banded_bwd_rss, banded_mask,
)
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import banded_bwd_1p, split_shares
from nsa_vibe_tpu_torch.ops.cuda.win_bwd_diag import win_bwd_diag
from nsa_vibe_tpu_torch.ops.reference import attention_delta

F32_TOL, TC_SIGMAS, FAULT, BF16_ULPS = 5e-5, 4, 1.01, 2
KC = 64                # keys per tile of the kernels
EMPTY_LSE = 1e30
LOG2E = np.float32(1.4426950408889634)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _ulp(x):
    _, e = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 8), torch.zeros_like(x))


def _tc_bound(plain32, rss):
    """One bf16 ulp of the unrounded plain value, F32_TOL of its max and
    TC_SIGMAS * 2^-9 * rss (module docstring)."""
    x = plain32.abs()
    return _ulp(x) + F32_TOL * float(x.max()) + TC_SIGMAS * 2.0 ** -9 * rss


def _rel_bound(plain):
    """BF16_ULPS bf16 ulps of each value plus F32_TOL of the max."""
    x = plain.float().abs()
    return BF16_ULPS * _ulp(x) + F32_TOL * float(x.max())


def _ratio(got, want, bound):
    return float(((got.float() - want.float()).abs() / bound).max())


def _kv_len(mode, S, kw):
    return S if mode == "win" else num_cmp_blocks(S, kw["l"], kw["d"])


def _operands(mode, S, h, D, kw, B=1, G=2, seed=0):
    """bf16 Q, K, V, dO and the plain forward's f32 lse and delta."""
    S_kv = _kv_len(mode, S, kw)
    Q, K, V, dO = (_bf16(_rand(*shape, seed=seed + i)) for i, shape in enumerate(
        ((B, S, G, h, D), (B, G, S_kv, D), (B, G, S_kv, D), (B, S, G, h, D))))
    O, lse = banded_attn_plain(Q.float(), K.float(), V.float(), mode=mode, **kw,
                               scale=D ** -0.5, return_lse=True)
    return Q, K, V, dO, lse, attention_delta(dO, O)


def _key_range(mode, t, S_kv, w=0, l=0, d=1):
    """Keys [lo, hi) that tokens t (a tensor) see (banded_common.cuh::key_range)."""
    if mode == "win":
        return (t - w + 1).clamp(min=0), (t + 1).clamp(max=S_kv)
    n = torch.where(t + 1 >= l, (t + 1 - l) // d + 1, torch.zeros_like(t))
    return torch.zeros_like(t), n.clamp(max=S_kv)


@pytest.mark.parametrize("mode,kw", [("win", dict(w=3)), ("cmp", dict(l=4, d=2))])
def test_banded_bwd_rss_matches_a_direct_sum(mode, kw):
    B, S, G, h, D, scale = 1, 9, 2, 2, 3, 0.4
    S_kv = _kv_len(mode, S, kw)
    Q, dO = _rand(B, S, G, h, D, seed=1), _rand(B, S, G, h, D, seed=4)
    K, V = _rand(B, G, S_kv, D, seed=2), _rand(B, G, S_kv, D, seed=3)
    lse, delta = _rand(B, S, G, h, seed=5) + 3.0, _rand(B, S, G, h, seed=6)
    (wq, wk, wv), (rq, rk, rv) = banded_bwd_rss(
        *(torch.from_numpy(a) for a in (Q, K, V, dO, lse, delta)), mode=mode, **kw, scale=scale)
    want = [np.zeros(x.shape) for x in (Q, K, V)]
    for b, s, g, j in np.ndindex(B, S, G, h):
        lo, hi = (int(x) for x in _key_range(mode, torch.tensor(s), S_kv, **kw))
        for k in range(lo, hi):
            p = np.exp(np.float64(scale) * (Q[b, s, g, j] @ K[b, g, k]) - lse[b, s, g, j])
            ds = p * (dO[b, s, g, j] @ V[b, g, k] - delta[b, s, g, j])
            want[0][b, s, g, j] += (scale * ds * K[b, g, k]) ** 2
            want[1][b, g, k] += (scale * ds * Q[b, s, g, j]) ** 2
            want[2][b, g, k] += (p * dO[b, s, g, j]) ** 2
    for got, w in zip((rq, rk, rv), want):
        np.testing.assert_allclose(got.numpy(), np.sqrt(w), atol=1e-6, rtol=1e-5)
    plain = banded_bwd_plain(*(torch.from_numpy(a) for a in (Q, K, V, dO, lse, delta)), mode=mode,
                             **kw, scale=scale)
    for got, w in zip((wq, wk, wv), plain):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=0)
    if mode == "cmp":
        assert not rq[:, :kw["l"] - 1].any()           # t < l - 1: no compressed token yet


def _flat_stats(x, B, S, G, h, fill):
    """[B,S,G,h] -> the TPU kernels' [B*G, 1, stats_rows(S, h)] row-flat layout."""
    flat = np.asarray(x, np.float32).transpose(0, 2, 1, 3).reshape(B * G, 1, S * h)
    return jnp.pad(jnp.asarray(flat), ((0, 0), (0, 0), (0, stats_rows(S, h) - S * h)),
                   constant_values=fill)


@pytest.mark.parametrize("kernel,mode,S,h,kw", [
    ("onepass", "win", 200, 3, dict(w=40)),         # odd h; S_kv = 200, not a multiple of 64
    ("onepass", "cmp", 150, 3, dict(l=8, d=4)),     # odd h; rows t < 7 see no token
    ("onepass", "win", 90, 1, dict(w=120)),         # h = 1, w > S
    ("diag", "win", 200, 3, dict(w=40)),            # odd h, S_kv = 200
    ("diag", "win", 150, 2, dict(w=200)),           # w > S
    ("twopass", "win", 200, 3, dict(w=40)),         # odd h; S_kv = 200
    ("twopass", "cmp", 150, 3, dict(l=8, d=4)),     # odd h; rows t < 7 see no token
])
def test_the_tpu_kernels_bf16_gradients_lie_within_the_backward_bound(kernel, mode, S, h, kw,
                                                                      monkeypatch):
    """The TPU kernels (interpret mode, bf16, scale_on_q off), given the
    port's lse (times log2 e, their base-2 statistic) and delta, round P
    and dS to bf16 as the port's kernels do: their gradients lie within
    the backward bound of the port's unrounded f32 gradients, and a 1%
    fault planted in each of dQ, dK, dV does not."""
    B, G, D = 2, 2, 32
    scale = D ** -0.5
    Q, K, V, dO, lse, delta = _operands(mode, S, h, D, kw, B=B, G=G, seed=3)
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jkeys = dict(jtuning._load(), **{"win.bwd_diag": 0})   # the one-pass kernel itself
    monkeypatch.setattr(jtuning, "_load", lambda: jkeys)
    jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (Q, K, V, dO)]
    jlse = _flat_stats(lse.numpy() * LOG2E, B, S, G, h, EMPTY_LSE)
    jdelta = _flat_stats(delta.numpy(), B, S, G, h, 0.0)
    if kernel == "diag":
        out = flash_banded_bwd_diag(*jargs, jlse, jdelta, w=kw["w"], scale=scale, block_q=64,
                                    interpret=True, scale_on_q=False)
    elif kernel == "twopass":
        out = jflash_bwd.flash_banded_bwd(*jargs, jlse, jdelta, mode=mode, **kw, scale=scale,
                                          block_q=32, block_k=64, interpret=True,
                                          scale_on_q=False)
    else:
        out = jflash_bwd.flash_banded_bwd_onepass(
            *jargs, jlse, jdelta, mode=mode, **kw, scale=scale, block_q=32, block_k=64,
            interpret=True, scale_on_q=False, fastpath=False)
    jax.block_until_ready(out)
    want, rss = banded_bwd_rss(Q, K, V, dO, lse, delta, mode=mode, **kw, scale=scale)
    strips = (_strip_term(Q, K, V, dO, lse, delta, w=kw["w"], scale=scale, block_q=64)
              if kernel == "diag" else [0, 0, 0])
    for name, got, w, r, st in zip("QKV", out, want, rss, strips):
        got = torch.from_numpy(np.array(got.astype(jnp.float32)))
        bound = _tc_bound(w, r) + st
        ratio, fault = _ratio(got, w, bound), _ratio(got * FAULT, w, bound)
        print(f"d{name}: worst err/bound {ratio:.3f}; with a 1% fault {fault:.3f}")
        assert ratio <= 1.0, (name, ratio)
        assert fault > 1.0, (name, fault)


def _strip_term(Q, K, V, dO, lse, delta, *, w, scale, block_q):
    """Half a bf16 ulp of each dK / dV strip of the TPU diagonal kernel
    (q tiles of block_q tokens), summed per element over its strips: the
    most its bf16 strips move an element. Strips from the plain f32 terms."""
    B, S, G, h, _ = Q.shape
    m = banded_mask(S, K.shape[2], mode="win", w=w)[None, :, None, None, :]
    s = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    p = torch.where(m, torch.exp(s - lse[..., None]), torch.zeros(()))
    ds = p * (torch.einsum("bsghv,bgkv->bsghk", dO.float(), V.float()) - delta[..., None])
    out = []
    for wt, x, mul in ((ds, Q, scale), (p, dO, 1.0)):
        term = 0
        for t0 in range(0, S, block_q):
            strip = torch.einsum("bsghk,bsghd->bgkd", wt[:, t0:t0 + block_q],
                                 x[:, t0:t0 + block_q].float()) * mul
            term = term + _ulp(strip.abs()) / 2
        out.append(term)
    return [torch.zeros(()), *out]


def _tiles(Q, K, V, dO, lse, delta, scale):
    """The walks' dense operands: logits z = Q.K and dP = dO.V over every
    (row, key), f32, with KC zero keys past S_kv (the kernels zero-fill
    them); -lse * log2 e and delta per row. Both walks slice P and dS out
    of these, so they form them from the same values."""
    B, S, G, h, _ = Q.shape
    z = torch.einsum("bsghd,bgkd->bgshk", Q.float(), K.float())
    dp = torch.einsum("bsghd,bgkd->bgshk", dO.float(), V.float())
    pad = torch.zeros(B, G, S, h, KC)
    nl2 = -(lse.permute(0, 2, 1, 3) * torch.tensor(LOG2E))
    return (torch.cat([z, pad], -1), torch.cat([dp, pad], -1), nl2, delta.permute(0, 2, 1, 3),
            torch.tensor(np.float32(scale) * LOG2E))


def _p_ds(t, z, dp, nl2, dl, sl2, keys, lo, hi):
    """P and dS (rounded to bf16) of tokens t x keys: P = exp2(s * scale *
    log2 e - lse * log2 e) where visible (lo <= key < hi), else 0; dS = P
    (dP - delta). [B, G, len(t), h, len(keys)]."""
    vis = ((keys[None, :] >= lo[:, None]) & (keys[None, :] < hi[:, None]))[None, None, :, None]
    x = z[:, :, t][..., keys] * sl2 + nl2[:, :, t, :, None]
    p = torch.where(vis, torch.exp2(x.double()).float(), torch.zeros(()))
    ds = torch.where(vis, p * (dp[:, :, t][..., keys] - dl[:, :, t, :, None]), torch.zeros(()))
    return p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()


def _walk_q(Q, K, V, dO, lse, delta, *, mode, scale, rows, strips, w=0, l=0, d=1):
    """(dQ, dK, dV) in bf16 as the q-major kernel forms them (dK and dV
    None unless `strips`): per q tile of rows // h tokens, key tiles of KC
    keys from floor(lo(t_first) / KC) * KC to hi(t_last); dQ summed over the
    tiles. With `strips` (the diagonal design, window mode) each tile's dK /
    dV go over its rows into the q tile's strip (row 0 = key kb0), then
    each key's strips are summed in ascending q-tile order (sum_strips,
    align KC). The CTAs take the q tiles from the last one down in cmp
    mode; the order changes no sum."""
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    kw = dict(w=w, l=l, d=d)
    z, dp, nl2, dl, sl2 = _tiles(Q, K, V, dO, lse, delta, scale)
    Kz = torch.cat([K.float(), torch.zeros(B, G, KC, Dk)], 2)
    q_, do_ = Q.float().permute(0, 2, 1, 3, 4), dO.float().permute(0, 2, 1, 3, 4)   # [B,G,S,h,D]
    tq = rows // h
    nq = -(-S // tq)
    SL = KC * min(-(-(KC - 1 + tq - 1 + w) // KC), -(-S_kv // KC))
    strip_k, strip_v = torch.zeros(B, G, nq, SL, Dk), torch.zeros(B, G, nq, SL, Dv)
    dQ = torch.zeros(B, G, S, h, Dk)
    order = list(range(nq))[::-1] if mode == "cmp" else list(range(nq))
    assert sorted(order) == list(range(nq))                      # every q tile once
    for qt in order:
        t = torch.arange(qt * tq, min(S, qt * tq + tq))
        lo_t, hi_t = _key_range(mode, t, S_kv, **kw)
        lo, hi = int(lo_t[0]), int(hi_t[-1])
        kb0 = lo // KC * KC
        n_tiles = -(-(hi - kb0) // KC) if hi > lo else 0
        for j in range(n_tiles):
            keys = torch.arange(kb0 + j * KC, kb0 + j * KC + KC)
            p, ds = _p_ds(t, z, dp, nl2, dl, sl2, keys, lo_t, hi_t)
            dQ[:, :, t] += torch.einsum("bgthk,bgkd->bgthd", ds, Kz[:, :, keys])
            if strips:
                assert n_tiles * KC <= SL
                strip_v[:, :, qt, j * KC:j * KC + KC] = torch.einsum("bgthk,bgthd->bgkd", p,
                                                                      do_[:, :, t])
                strip_k[:, :, qt, j * KC:j * KC + KC] = torch.einsum("bgthk,bgthd->bgkd", ds,
                                                                      q_[:, :, t])
    dQ = (dQ * scale).permute(0, 2, 1, 3, 4).to(torch.bfloat16)
    if not strips:
        return dQ, None, None
    dK, dV = torch.zeros(B, G, S_kv, Dk), torch.zeros(B, G, S_kv, Dv)
    for k in range(min(S, S_kv)):
        for qt in range(k // tq, min((k + w - 1) // tq, nq - 1) + 1):
            r = k - max(qt * tq - w + 1, 0) // KC * KC
            dK[:, :, k] += strip_k[:, :, qt, r]
            dV[:, :, k] += strip_v[:, :, qt, r]
    return dQ, (dK * scale).to(torch.bfloat16), dV.to(torch.bfloat16)


def _walk_1p(Q, K, V, dO, lse, delta, *, mode, scale, rows, nsplit, slots=True, w=0, l=0, d=1):
    """(dQ, dK, dV) in bf16 as the kv-major kernel forms them: per key tile
    kt and split share (split_shares), chunks of `rows` band rows (row =
    token * h + head); dK / dV summed over the chunks into the split's
    partial, the partials in split order; with `slots` (the one-pass
    design) each chunk's dQ = dS K_tile to slot kt - lo(t) // KC (win) or kt
    (cmp), every (slot, row) a row sees written exactly once, the slots
    summed in order (sum_slots); without (the two-pass design's dK/dV
    pass) dQ is None."""
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    kw = dict(w=w, l=l, d=d)
    z, dp, nl2, dl, sl2 = _tiles(Q, K, V, dO, lse, delta, scale)
    Kz = torch.cat([K.float(), torch.zeros(B, G, KC, Dk)], 2)
    q_ = Q.float().permute(0, 2, 1, 3, 4).reshape(B, G, S * h, Dk)
    do_ = dO.float().permute(0, 2, 1, 3, 4).reshape(B, G, S * h, Dv)
    nkt = -(-S_kv // KC)
    n_slots = min((w + KC - 2) // KC + 1, nkt) if mode == "win" else nkt
    ws = torch.zeros(n_slots, B, G, S * h, Dk)
    writes = torch.zeros(n_slots, S * h, dtype=torch.int64)
    part_k, part_v = torch.zeros(nsplit, B, G, S_kv, Dk), torch.zeros(nsplit, B, G, S_kv, Dv)
    for kt, shares in enumerate(split_shares(S, S_kv, h, mode=mode, **kw, rows=rows,
                                             nsplit=nsplit)):
        keys = torch.arange(kt * KC, kt * KC + KC)
        live = keys < S_kv
        for s, (ra, rb) in enumerate(shares):
            for a0 in range(ra, rb, rows):
                a = torch.arange(a0, min(a0 + rows, rb))
                t, j = a // h, a % h
                lo, hi = _key_range(mode, t, S_kv, **kw)
                p, ds = _p_ds(t, z, dp, nl2, dl, sl2, keys, lo, hi)        # [B,G,n,h,KC]
                idx = torch.arange(len(a))
                p, ds = p[:, :, idx, j], ds[:, :, idx, j]                 # [B,G,n,KC]
                part_v[s, :, :, keys[live]] += torch.einsum("bgnk,bgnd->bgkd", p,
                                                            do_[:, :, a])[:, :, live]
                part_k[s, :, :, keys[live]] += torch.einsum("bgnk,bgnd->bgkd", ds,
                                                            q_[:, :, a])[:, :, live]
                if not slots:
                    continue
                slot = kt - lo // KC if mode == "win" else torch.full_like(lo, kt)
                dq = torch.einsum("bgnk,bgkd->bgnd", ds, Kz[:, :, keys])
                ws[slot, :, :, a] = dq.permute(2, 0, 1, 3)
                writes[slot, a] += 1
    dK, dV = part_k[0] * scale, part_v[0]
    for s in range(1, nsplit):
        dK, dV = dK + part_k[s] * scale, dV + part_v[s]
    dK, dV = dK.to(torch.bfloat16), dV.to(torch.bfloat16)
    if not slots:
        return None, dK, dV
    t = torch.arange(S * h) // h
    lo, hi = _key_range(mode, t, S_kv, **kw)
    count = torch.where(hi > lo, (hi - 1) // KC - lo // KC + 1, torch.zeros_like(lo))
    assert torch.equal(writes, (torch.arange(n_slots)[:, None] < count[None]).long())
    dQ = torch.zeros(B, G, S * h, Dk)
    for sl in range(n_slots):
        dQ += ws[sl] * (sl < count)[None, None, :, None]
    dQ = (dQ * scale).reshape(B, G, S, h, Dk).permute(0, 2, 1, 3, 4)
    return dQ.to(torch.bfloat16), dK, dV


@pytest.mark.parametrize("mode,S,h,D,kw,nsplit", [
    ("win", 150, 3, 16, dict(w=40), 1),      # odd h; S_kv = 150, not a multiple of 64
    ("win", 60, 1, 8, dict(w=300), 3),       # h = 1, window wider than S
    ("win", 130, 6, 8, dict(w=70), 2),       # the m7c head count
    ("cmp", 150, 3, 16, dict(l=8, d=4), 3),  # odd h; rows t < 7 see no token
    ("cmp", 300, 2, 8, dict(l=8, d=4), 2),   # S_kv = 74: two key tiles, the last partial
])
def test_kernel_walks_rebuild_the_plain_gradients(mode, S, h, D, kw, nsplit):
    Q, K, V, dO, lse, delta = _operands(mode, S, h, D, kw, seed=11)
    scale = D ** -0.5
    args = (Q, K, V, dO, lse, delta)
    want, rss = banded_bwd_rss(*args, mode=mode, **kw, scale=scale)
    walks = {f"1p-{rows}": _walk_1p(*args, mode=mode, **kw, scale=scale, rows=rows,
                                    nsplit=nsplit) for rows in (32, 64)}
    # the two-pass design: the q-major dQ, the kv-major dK and dV with the slots off
    _, dK, dV = _walk_1p(*args, mode=mode, **kw, scale=scale, rows=64, nsplit=nsplit,
                         slots=False)
    assert torch.equal(dK, walks["1p-64"][1]) and torch.equal(dV, walks["1p-64"][2])
    for rows in (64, 128):
        dQ, _, _ = _walk_q(*args, mode=mode, **kw, scale=scale, rows=rows, strips=False)
        walks[f"2p-{rows}"] = (dQ, dK, dV)
    if mode == "win":
        walks.update({f"diag-{rows}": _walk_q(*args, mode="win", **kw, scale=scale, rows=rows,
                                              strips=True) for rows in (64, 128)})
    for name, got in walks.items():
        for g, w, r in zip(got, want, rss):
            bound = _tc_bound(w, r)
            assert _ratio(g, w, bound) <= 1.0, name
            assert _ratio(g.float() * FAULT, w, bound) > 1.0, name
    # the same P and dS: the designs (rows 7, 8 and 11) differ in summation order only
    for other in ("diag-128", "1p-64") if mode == "win" else ("1p-64",):
        for a, b in zip(walks["2p-128"], walks[other]):
            assert _ratio(a, b, _rel_bound(b)) <= 1.0, other
    # a row's dQ does not depend on the q tile (key tiles at multiples of 64)
    assert torch.equal(walks["2p-64"][0], walks["2p-128"][0])
    if mode == "win":   # the diagonal design's dQ is the two-pass design's
        assert torch.equal(walks["diag-64"][0], walks["2p-128"][0])
    if mode == "cmp":
        for name in ("1p-64", "2p-128"):
            assert not walks[name][0][:, :kw["l"] - 1].float().any()


def test_rows_without_a_compressed_token_get_zero_dq():
    """Rows t < l - 1 see no compressed token: dQ = 0 from the plain version
    (the wrappers on CPU tensors, all three designs) and from banded_rss;
    the wrappers take no kernel on the CPU."""
    mode, kw, S, h, D = "cmp", dict(l=32, d=16), 100, 2, 8
    Q, K, V, dO, lse, delta = _operands(mode, S, h, D, kw, seed=21)
    assert bool((lse[:, :kw["l"] - 1] == EMPTY_LSE).all())
    dQ, dK, dV = banded_bwd_1p(Q, K, V, dO, lse, delta, mode=mode, **kw, scale=0.3)
    (wq, _, _), (rq, _, _) = banded_bwd_rss(Q, K, V, dO, lse, delta, mode=mode, **kw, scale=0.3)
    for x in (dQ.float(), wq, rq):
        assert not x[:, :kw["l"] - 1].any() and bool(x[:, kw["l"] - 1:].any())
    c = banded_bwd(Q, K, V, dO, lse, delta, mode=mode, **kw, scale=0.3)
    assert all(torch.equal(x, y) for x, y in zip(c, (dQ, dK, dV)))
    a = win_bwd_diag(Q, K, V, dO, lse, delta, w=5, scale=0.3)
    b = banded_bwd_1p(Q, K, V, dO, lse, delta, mode="win", w=5, scale=0.3)
    c = banded_bwd(Q, K, V, dO, lse, delta, mode="win", w=5, scale=0.3)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))
    assert banded_bwd_1p.launches == 0 and win_bwd_diag.launches == 0 \
        and banded_bwd.launches == 0
