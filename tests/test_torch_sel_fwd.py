"""The selection forward's bounds and decompositions vs the JAX package (CPU).

The bf16 prefill kernel (csrc/sel_attn_fwd_mma.cu) rounds P to bf16 before
P V, as the TPU kernel does (sel_flash.py:157), so it is held to the plain
version's unrounded f32 result within one bf16 ulp, plus 5e-5 of the
output's max, plus 4 * 2^-9 times the root sum of squares of each
element's terms (`attend_masked_rss`), as chip_smoke.py::allowed_tc_err
holds the selection backward. Here, with numpy-seeded data:
- attend_masked_rss against a direct numpy sum;
- that bound against the TPU kernel itself: selection_flash_pallas in
  interpret mode on bf16 inputs lies within it, and a 1% error planted in
  its output does not;
- the decode kernel's semantics: sel_attn_plain at S = 1 on raw slots
  (-1, repeated ids, an empty row, a partial last block) against
  selection_attention_pallas on the canonical sets;
- PyTorch walks of the two new kernels' decompositions (the split decode's
  per-slot partials merged in slot order; the union kernel's q tiles, key
  tiles, membership bits and floored online softmax) rebuild the plain
  result.

Tolerances: f32 results 2e-5 absolute (sum order, the TPU kernels' exp2
folding); integer tables exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops.pallas.sel_flash import selection_flash_pallas
from nsa_vibe_tpu.ops.pallas.selection import selection_attention_pallas
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn, sel_attn_plain, sel_attn_rss
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import selection_tile_union
from nsa_vibe_tpu_torch.ops.reference import attend_masked_rss
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

F32_TOL, TC_SIGMAS, FAULT = 5e-5, 4, 1.01
KC = 64   # keys per tile of the union kernel


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


def _selection(B, S, G, n, NB, seed):
    """Random ids in [-1, NB) with repeats; row 0 of each (b, g) holds only -1."""
    sel = np.random.RandomState(seed).randint(-1, NB, size=(B, S, G, n)).astype(np.int32)
    sel[:, :, :, -1] = sel[:, :, :, 0]                  # a repeated id in every row
    sel[:, 0] = -1                                      # a row with an empty set
    return sel


def test_attend_masked_rss_matches_a_direct_sum():
    B, S, G, h, D, S_kv, scale = 1, 5, 2, 2, 3, 7, 0.4
    Q, K, V = _rand(B, S, G, h, D, seed=1), _rand(B, G, S_kv, D, seed=2), \
        _rand(B, G, S_kv, D, seed=3)
    mask = np.random.RandomState(4).rand(B, S, G, 1, S_kv) < 0.5
    mask[:, 0] = False                                  # a row with no visible key
    got = attend_masked_rss(*(torch.from_numpy(a) for a in (Q, K, V, mask)), scale).numpy()
    want = np.zeros((B, S, G, h, D))
    for b, s, g, j in np.ndindex(B, S, G, h):
        keys = np.flatnonzero(mask[b, s, g, 0])
        if keys.size == 0:
            continue
        z = np.array([scale * Q[b, s, g, j] @ K[b, g, k] for k in keys], np.float64)
        p = np.exp(z - z.max())
        for d in range(D):
            want[b, s, g, j, d] = np.sqrt(sum((p[i] * V[b, g, k, d]) ** 2
                                              for i, k in enumerate(keys))) / p.sum()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert not got[:, 0].any()


@pytest.fixture
def q_unscaled(monkeypatch):
    """The JAX package's key flash.scale_on_q at 0, so that the TPU kernel
    scales its f32 logits, as the union kernel does, instead of rounding
    Q * scale to bf16 (a second rounding the port does not make); the jit
    cache is cleared around the test, since the key is read while
    tracing."""
    selection_flash_pallas.clear_cache()
    keys = dict(jtuning._load(), **{"flash.scale_on_q": 0})
    monkeypatch.setattr(jtuning, "_load", lambda: keys)
    yield
    selection_flash_pallas.clear_cache()


@pytest.mark.parametrize("S,l_sel,n", [(96, 16, 4), (75, 16, 3)])   # S_kv % l_sel != 0
def test_the_tpu_kernels_bf16_output_lies_within_the_forward_bound(q_unscaled, S, l_sel, n):
    """selection_flash_pallas (interpret) rounds P to bf16 as the union
    kernel does: its bf16 output lies within the forward bound of the
    port's unrounded f32 result, and a planted 1% error does not."""
    B, G, h, D, scale = 2, 2, 3, 32, 32 ** -0.5
    Q, K, V = (_bf16(_rand(*shape, seed=i)) for i, shape in
               enumerate(((B, S, G, h, D), (B, G, S, D), (B, G, S, D))))
    sel = _selection(B, S, G, n, -(-S // l_sel), seed=5)
    jargs = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (Q, K, V))
    O = selection_flash_pallas(*jargs, jnp.asarray(sel), l_sel=l_sel, scale=scale, block_q=16,
                               kv_batch=2, interpret=True)
    got = torch.from_numpy(np.array(O.astype(jnp.float32)))
    want, rss = sel_attn_rss(Q, K, V, torch.from_numpy(sel), torch.arange(S), l_sel=l_sel,
                             scale=scale)
    bound = _tc_bound(want, rss)
    ratio = float(((got - want).abs() / bound).max())
    fault = float(((got * FAULT - want).abs() / bound).max())
    print(f"worst err/bound {ratio:.3f}; with a 1% fault {fault:.3f}")
    assert ratio <= 1.0, ratio
    assert fault > 1.0, fault
    assert not got[:, 0].any()                          # the empty rows


def test_decode_plain_matches_the_tpu_decode_kernel():
    """One query per row at its own depth: raw slots with -1, repeated ids,
    an empty row and the partial last block of the cache, against the
    TPU kernel on the canonical sets (sorted, unique, -1 last)."""
    B, G, h, D, C, l_sel, scale = 4, 2, 3, 16, 100, 16, 0.25
    Q, K, V = _rand(B, 1, G, h, D, seed=10), _rand(B, G, C, D, seed=11), _rand(B, G, C, D,
                                                                             seed=12)
    t = np.array([[99], [37], [60], [99]], np.int32)
    sel = np.array([[6, 6, 0, -1, 3], [2, 0, 2, 2, -1], [-1] * 5, [0, 6, -1, 6, 5]], np.int32)
    sel = np.repeat(sel[:, None, None], G, axis=2)      # [B,1,G,5]; block 6: keys 96..99
    got = sel_attn_plain(*(torch.from_numpy(a) for a in (Q, K, V, sel, t)), l_sel=l_sel,
                         scale=scale)
    canon = canonicalize_sel(torch.from_numpy(sel)).numpy()
    want = selection_attention_pallas(*(jnp.asarray(a) for a in (Q, K, V, canon, t)),
                                      l_sel=l_sel, scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert not got[2].any()                             # the empty row


def _walk_split(Q, K, V, sel, t, l_sel, scale):
    """O as the split decode forms it: per slot, the slot's block if it is
    visible and in no earlier slot, as a partial (m, l, acc); the partials
    merged in slot order."""
    B, _, G, h, _ = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    n = sel.shape[-1]
    O = torch.zeros(B, 1, G, h, Dv)
    for b, g in np.ndindex(B, G):
        tb = int(t[b, 0])
        parts = []
        for j in range(n):
            blk = int(sel[b, 0, g, j])
            if blk < 0 or blk * l_sel > tb or blk * l_sel >= S_kv \
                    or blk in sel[b, 0, g, :j].tolist():
                parts.append((torch.full((h,), -3.4e38), torch.zeros(h), torch.zeros(h, Dv)))
                continue
            keys = torch.arange(blk * l_sel, min((blk + 1) * l_sel, tb + 1, S_kv))
            z = Q[b, 0, g] @ K[b, g, keys].T * scale                       # [h, nk]
            m = z.max(-1).values
            p = torch.exp(z - m[:, None])
            parts.append((m, p.sum(-1), p @ V[b, g, keys]))
        M = torch.stack([p[0] for p in parts]).max(0).values
        l = sum(p[1] * torch.exp(p[0] - M) for p in parts)
        acc = sum(p[2] * torch.exp(p[0] - M)[:, None] for p in parts)
        O[b, 0, g] = torch.where(l[:, None] > 0, acc / l.clamp(min=1e-30)[:, None], 0.0)
    return O


def _walk_union(Q, K, V, sel, t, l_sel, scale, T):
    """O and lse as the union kernel forms them: per q tile of T tokens,
    over its union's key tiles of KC keys, each row masked by its
    membership bit, key <= t and key < S_kv; online softmax in base 2 with
    the running max floored at -1e20."""
    B, S, G, h, _ = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    order, count, mask = selection_tile_union(sel, t, l_sel, S_kv, T)
    words = mask.long() & 0xFFFFFFFF
    O, lse = torch.zeros(B, S, G, h, Dv), torch.zeros(B, S, G, h)
    sl2 = scale * np.log2(np.e)
    for b, g, q in np.ndindex(B, G, order.shape[2]):
        s_ = torch.arange(q * T, min(S, q * T + T))
        m2 = torch.full((len(s_), h), -1e20)
        l, acc = torch.zeros(len(s_), h), torch.zeros(len(s_), h, Dv)
        for u in range(int(count[b, g, q])):
            blk = int(order[b, g, q, u])
            mem = ((words[b, s_, g, u // 32] >> (u % 32)) & 1).bool()
            for k0 in range(blk * l_sel, (blk + 1) * l_sel, KC):
                keys = torch.arange(k0, max(k0, min(k0 + KC, (blk + 1) * l_sel, S_kv)))
                if keys.numel() == 0:
                    continue
                vis = mem[:, None, None] & (keys[None, None, :] <= t[s_][:, None, None])
                z = torch.where(vis, Q[b, s_, g] @ K[b, g, keys].T * sl2, -3.4e38)
                m_new = torch.maximum(m2, z.max(-1).values)
                alpha = torch.exp2(m2 - m_new)
                p = torch.exp2(z - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ V[b, g, keys]
                m2 = m_new
        O[b, s_, g] = torch.where(l[..., None] > 0, acc / l.clamp(min=1e-30)[..., None], 0.0)
        lse[b, s_, g] = torch.where(l > 0, (m2 + torch.log2(l.clamp(min=1e-30))) / np.log2(np.e),
                                    1e30)
    return O, lse


def test_split_decode_walk_rebuilds_the_plain_result():
    B, G, h, D, C, l_sel, n = 3, 2, 3, 16, 100, 16, 5
    Q, K, V = (torch.from_numpy(_rand(*shape, seed=20 + i)) for i, shape in
               enumerate(((B, 1, G, h, D), (B, G, C, D), (B, G, C, D))))
    t = torch.tensor([[99], [40], [7]])
    sel = torch.from_numpy(np.random.RandomState(23).randint(-1, 7, size=(B, 1, G, n)))
    sel[..., -1] = sel[..., 0]                                          # repeats
    sel[1, 0, 1] = -1                                                   # an empty row
    want = sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel, scale=0.3)
    np.testing.assert_allclose(_walk_split(Q, K, V, sel, t, l_sel, 0.3).numpy(), want.numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("l_sel,S,T", [
    (16, 45, 3),      # blocks shorter than a key tile, S % T != 0, S % l_sel != 0
    (128, 150, 10),   # two key tiles per block, the last one partial
    (8, 90, 21),      # unions past 32 blocks: two membership words
])
def test_union_walk_rebuilds_the_plain_result(l_sel, S, T):
    B, G, h, D, n = 1, 2, 3, 8, 4
    Q, K, V = (torch.from_numpy(_rand(*shape, seed=30 + i)) for i, shape in
               enumerate(((B, S, G, h, D), (B, G, S, D), (B, G, S, D))))
    sel = torch.from_numpy(_selection(B, S, G, n, -(-S // l_sel), seed=33))
    t = torch.arange(S)
    want, want_lse = sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=0.3, return_lse=True)
    got, lse = _walk_union(Q, K, V, sel, t, l_sel, 0.3, T)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    empty = want_lse >= 1e29
    assert torch.equal(lse >= 1e29, empty)
    np.testing.assert_allclose(lse[~empty].numpy(), want_lse[~empty].numpy(), atol=2e-5,
                               rtol=0)
    assert sel_attn.launches == 0
