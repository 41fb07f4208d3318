"""The port's long-context path vs the JAX package (CPU, f32).

Row 5 (`banded_attn`, flash.py::flash_banded) and row 6 (`select_blocks`,
scorer.py::nsa_select_pallas) run their plain PyTorch versions here and
are held against the Pallas kernels they replace, run in interpret mode
as the JAX package's own tests run them, and against the JAX oracles;
`nsa_prefill` on the non-fused route against JAX `kernel="reference"`;
the needle tools and the compare helpers. Inputs are numpy arrays from a
seed; JAX parameters come in through `convert.params_from_numpy`.

Tolerances: f32 forward 1e-5 absolute (sum order; the Pallas kernels run
their softmax in base 2); row statistics 1e-5 absolute after the JAX
kernel's base-2 lse is scaled by ln 2; gradients 2e-5 of each tensor's max
|value|; needle cosines 1e-4. Selections are compared as sets and must be
equal (random normal inputs, well separated scores).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core import nsa as jnsa
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.ops import reference as jref
from nsa_vibe_tpu.ops import selection as jsel
from nsa_vibe_tpu.ops.pallas.flash import flash_banded
from nsa_vibe_tpu.ops.pallas.scorer import nsa_select_pallas
from nsa_vibe_tpu.utils import needle as jneedle
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.ops import attention as attn_ops
from nsa_vibe_tpu_torch.ops import reference as tref
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import build as kbuild
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn
from nsa_vibe_tpu_torch.ops.cuda.select_blocks import select_blocks, selection_map
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.utils import needle as tneedle
from nsa_vibe_tpu_torch.utils.compare import debug_compare_prefill, validate_selection

TOL = 1e-5
LN2 = float(np.log(2.0))


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _sets(sel):
    return canonicalize_sel(torch.as_tensor(np.array(sel))).numpy()


# ------------------------------------------------------------------ (a) row 5

@pytest.mark.parametrize("mode,S,t_start,kw", [
    ("win", 96, 0, dict(w=24)),
    ("win", 64, 136, dict(w=40)),     # rows at positions 136..199 of 200 keys
    ("cmp", 100, 0, dict(l=8, d=4)),  # rows t < 7 see no compressed token
    ("cmp", 64, 200, dict(l=8, d=4)),
])
def test_banded_attn_plain_matches_pallas(mode, S, t_start, kw):
    B, G, h, D, scale = 2, 2, 3, 16, 0.3
    n_pos = t_start + S
    S_kv = n_pos if mode == "win" else num_cmp_blocks(n_pos, kw["l"], kw["d"])
    Q, K, V = _r(1, B, S, G, h, D), _r(2, B, G, S_kv, D), _r(3, B, G, S_kv, D)
    O, lse = banded_attn(_t(Q), _t(K), _t(V), mode=mode, **kw, scale=scale, t_start=t_start,
                         return_lse=True)
    # the Pallas kernel (S < 128 keeps flash_banded on its own tiles for "win")
    pO, plse = flash_banded(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V), mode=mode, **kw,
                            scale=scale, block_q=32, block_k=32, interpret=True,
                            return_lse=True, t_start=jnp.asarray([t_start], jnp.int32))
    _close(O, pO)
    plse = np.asarray(plse)[:, 0, :S * h].reshape(B, G, S, h).transpose(0, 2, 1, 3)
    empty = plse >= 1e29                                   # rows with no visible key
    np.testing.assert_array_equal(lse.numpy() >= 1e29, empty)
    _close(torch.where(torch.from_numpy(empty), 0.0, lse), np.where(empty, 0.0, plse * LN2))
    # the jnp oracle
    t_pos = jnp.arange(t_start, n_pos)
    if mode == "win":
        want = jref.sliding_window_attention(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                             t_pos, kw["w"], scale)
    else:
        nct = jnp.minimum(jnp.asarray(num_cmp_blocks(np.arange(t_start + 1, n_pos + 1),
                                                     kw["l"], kw["d"])), S_kv)
        want = jref.compressed_attention(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V), nct,
                                         scale)
    _close(O, want)
    if t_start:
        # the same rows of the call over every position (the chip check's shape)
        Qf = np.concatenate([_r(4, B, t_start, G, h, D), Q], axis=1)
        full = banded_attn(_t(Qf), _t(K), _t(V), mode=mode, **kw, scale=scale)
        torch.testing.assert_close(full[:, t_start:], O, atol=TOL, rtol=0)


# ------------------------------------------------------------------ (b) row 6

@pytest.mark.parametrize("S,h,l,d,l_sel,n_top,pos_offset", [
    (64, 2, 8, 4, 8, 4, 0),
    (100, 3, 8, 4, 8, 6, 0),          # odd h, S not divisible by l_sel
    (48, 2, 8, 4, 16, 5, 80),         # rows at positions 80..127
    (40, 1, 16, 8, 16, 2, 30),        # n_top < n_forced: forced slots only
])
def test_select_blocks_plain_matches_pallas(S, h, l, d, l_sel, n_top, pos_offset):
    B, G, Dk, scale = 2, 2, 32, 0.2
    n_pos = pos_offset + S
    S_cmp, S_sel = num_cmp_blocks(n_pos, l, d), -(-n_pos // l_sel)
    Q, Kc = _r(5, B, S, G, h, Dk), _r(6, B, G, S_cmp, Dk)
    M = build_M_csl(n_pos, l, d, l_sel)
    np.testing.assert_array_equal(selection_map(S_cmp, S_sel, l, d, l_sel).numpy(), M)
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top)
    got = select_blocks(_t(Q), _t(Kc), S_sel=S_sel, **kw, pos_offset=pos_offset)
    pal = nsa_select_pallas(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(M), **kw,
                            pos_offset=pos_offset, block_q=16, cmp_chunk=16, interpret=True)
    assert got.shape == pal.shape
    np.testing.assert_array_equal(_sets(got), _sets(pal))
    t_pos = jnp.arange(pos_offset, n_pos)
    nct = jnp.minimum(jnp.asarray(num_cmp_blocks(np.arange(pos_offset + 1, n_pos + 1), l, d)),
                      S_cmp)
    p_grp = jsel.selection_scores(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(M), scale, nct)
    want = jsel.select_topn_blocks(p_grp, n_top, t_pos, l_sel)
    np.testing.assert_array_equal(_sets(got), np.asarray(want))


def test_select_blocks_one_row_past_the_fused_limit():
    """The needle smoke's shape: one query row at pos_offset = S-1 with
    S_sel = 257 selection blocks, more than select_cmp takes."""
    cfg = NSAConfig(dim=64, n_heads=4, n_kv_groups=2, d_k=32, d_v=32, l=32, d=16, l_sel=64,
                    n_sel=16, w=512)
    S = 16448
    S_cmp, S_sel = num_cmp_blocks(S, cfg.l, cfg.d), -(-S // cfg.l_sel)
    assert S_sel > sc_mod.SELECT_CMP_MAX_S_SEL
    Q, Kc, pos = tneedle.smoke_inputs(np.random.default_rng(3), S, 0.37, cfg)
    Kc = Kc + _r(7, *Kc.shape)          # scores spread over every block, not one needle
    kw = dict(scale=cfg.d_k ** -0.5, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    got = select_blocks(_t(Q), _t(Kc), S_sel=S_sel, **kw, pos_offset=S - 1)
    M = build_M_csl(S, cfg.l, cfg.d, cfg.l_sel)[:S_cmp]
    pal = nsa_select_pallas(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(M), **kw,
                            pos_offset=S - 1, interpret=True)
    np.testing.assert_array_equal(_sets(got), _sets(pal))
    assert (_sets(got) >= 0).sum() == 2 * cfg.n_sel


# ------------------------------------------------------------------ (c) the route

LONG = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=32, d=16, l_sel=64, n_sel=4,
            w=64)


def test_route_is_chosen_by_shape_alone():
    """The fused scorer takes S_sel <= 256: at m7c (l_sel = 64) prompts up
    to 16384 tokens; deciding loads no kernel library."""
    assert sc_mod.select_cmp_fits(6, -(-16384 // 64))
    assert not sc_mod.select_cmp_fits(6, -(-16385 // 64))
    assert sc_mod.select_cmp_fits(64, 1) and not sc_mod.select_cmp_fits(65, 1)
    assert kbuild._LIB is None


def _force_long_route(monkeypatch):
    """S_sel = 8 at S = 512: below it the prefill must take select_blocks +
    compressed_attention and never the fused scorer."""
    monkeypatch.setattr(sc_mod, "SELECT_CMP_MAX_S_SEL", 4)

    def trap(*a, **k):
        raise AssertionError("the fused scorer ran on the long route")

    monkeypatch.setattr(attn_ops, "fused_select_cmp", trap)


def test_nsa_prefill_long_route_matches_jax(monkeypatch):
    _force_long_route(monkeypatch)
    jc, tc = JNSAConfig(**LONG, kernel="reference"), NSAConfig(**LONG)
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    S = 512
    x, g = _r(1, 2, S, jc.dim), _r(2, 2, S, jc.dim)
    (jout, jaux), (jgp, jgx) = jax.jit(lambda p, x: (
        jnsa.nsa_prefill(p, x, jc),
        jax.grad(lambda p, x: (jnsa.nsa_prefill(p, x, jc)[0] * g).sum(), argnums=(0, 1))(p, x),
    ))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in tts.param_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    out, aux = tnsa.nsa_prefill(tp, xt, tc)
    _close(out, jout)
    np.testing.assert_array_equal(_sets(aux["sel_idx"]), np.asarray(jaux["sel_idx"]))
    grads = torch.autograd.grad((out * _t(g)).sum(), [xt] + leaves)
    tg = {"x": grads[0].numpy(), **params_to_numpy(tts.tree_from_leaves(tp, list(grads[1:])))}
    for path, want in jax.tree_util.tree_leaves_with_path({"x": jgx, **jgp}):
        got = tg
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(want).max(), 1e-12),
                                   rtol=0, err_msg=str(path))


def _offset_operands():
    """Q of 12 rows (positions 4..15 at t_start 4) and 5 compressed keys."""
    g = torch.Generator().manual_seed(0)
    Q = torch.randn(1, 12, 1, 2, 16, generator=g, requires_grad=True)
    K = torch.randn(1, 1, 5, 16, generator=g, requires_grad=True)
    return g, Q, K


def test_compressed_attention_offset_has_no_backward():
    # The name is older than the offset's backward. compressed_attention at
    # t_start used to run without autograd only, and this test held that a
    # recorded call raised. Sequence-parallel training (parallel/context.py)
    # made it differentiable at an offset, so the test now holds the call
    # without autograd to the full call's rows; the backward is held by
    # test_compressed_attention_backward_at_offset_matches_full_call.
    _, Q, K = _offset_operands()
    out = attn_ops.compressed_attention(Q.detach(), K.detach(), K.detach(), l=4, d=2,
                                        scale=0.25, t_start=4)
    assert out.shape == (1, 12, 1, 2, 16)
    full = attn_ops.compressed_attention(torch.cat([torch.zeros(1, 4, 1, 2, 16), Q.detach()], 1),
                                         K.detach(), K.detach(), l=4, d=2, scale=0.25)
    torch.testing.assert_close(out, full[:, 4:], atol=TOL, rtol=0)


def test_compressed_attention_backward_at_offset_matches_full_call():
    # a recorded call at t_start runs the backward kernels at that offset:
    # its rows and gradients are those of the full call from position 0
    g, Q, K = _offset_operands()
    full = attn_ops.compressed_attention(torch.cat([torch.zeros(1, 4, 1, 2, 16), Q], 1), K, K,
                                         l=4, d=2, scale=0.25)
    part = attn_ops.compressed_attention(Q, K, K, l=4, d=2, scale=0.25, t_start=4)
    torch.testing.assert_close(part, full[:, 4:], atol=TOL, rtol=0)
    dO = torch.randn(part.shape, generator=g)
    gp = torch.autograd.grad(part, (Q, K), dO)
    gf = torch.autograd.grad(full[:, 4:], (Q, K), dO)
    for a, b in zip(gp, gf):
        torch.testing.assert_close(a, b, atol=TOL, rtol=0)


# ------------------------------------------------------------------ (d), (e) needle tools

@pytest.mark.parametrize("forced", [False, True])
def test_needle_probe_passes(forced, monkeypatch):
    """tests/test_needle.py's end-to-end probe at S = 4096 (S_sel = 64),
    on the fused route and, forced, on the long one."""
    if forced:
        _force_long_route(monkeypatch)
    for depth in (0.1, 0.5, 0.9):
        r = tneedle.needle_probe(tneedle.NEEDLE_CFG, 4096, depth, device="cpu")
        assert r["pass_"], r


def test_needle_probe_matches_jax():
    """On the JAX probe's own parameters and inputs, the port's cosines
    equal JAX's."""
    jc = JNSAConfig(**dataclasses.asdict(tneedle.NEEDLE_CFG), kernel="reference")
    jp = jneedle._probe_params(jc.replace(rope_scale=1e9), jnp.float32, 0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for depth in (0.1, 0.9):
        want = jneedle.needle_probe(jc, 4096, depth)
        got = tneedle.needle_probe(tneedle.NEEDLE_CFG, 4096, depth, device="cpu", params=tp)
        assert got["needle_pos"] == want["needle_pos"] and got["found_sel"] == want["found_sel"]
        for k in ("cos_needle", "cos_ablated"):
            assert abs(got[k] - want[k]) <= 1e-4, (depth, k, got[k], want[k])


def test_needle_smoke_matches_jax_selection():
    S, cfg = 4096, tneedle.NEEDLE_CFG
    depths = (0.1, 0.5, 0.9)
    out = tneedle.needle_smoke(S, depths, device="cpu", dtype=torch.float32)
    assert out["pass"]
    S_cmp = num_cmp_blocks(S, cfg.l, cfg.d)
    M = jnp.asarray(build_M_csl(S, cfg.l, cfg.d, cfg.l_sel)[:S_cmp])
    rng = np.random.default_rng(0)
    for depth, r in zip(depths, out["results"]):
        Q, Kc, pos = tneedle.smoke_inputs(rng, S, depth, cfg)
        assert r["pos"] == pos
        p_grp = jsel.selection_scores(jnp.asarray(Q), jnp.asarray(Kc), M, cfg.d_k ** -0.5,
                                      jnp.asarray([S_cmp]))
        want = jsel.select_topn_blocks(p_grp, cfg.n_sel, jnp.asarray([S - 1]), cfg.l_sel)
        np.testing.assert_array_equal(_sets(np.asarray(r["sel"])[None, None]),
                                      np.asarray(want))
    assert tneedle.main(["smoke", "--S", "1024", "--device", "cpu", "--dtype", "float32"]) == 0


# ------------------------------------------------------------------ (f) compare

def test_validate_selection_accepts_good_and_names_bad_sets():
    t = torch.arange(4) * 16 + 15                               # positions 15, 31, 47, 63
    good = torch.tensor([[0, -1, -1], [0, 1, -1], [0, 1, 2], [0, 2, 3]], dtype=torch.int32)
    good = good[None, :, None, :]                               # [1, 4, 1, 3]
    assert validate_selection(good, t, 16) is None
    for bad, what in (
        ([0, 4, -1], "causality violated at (b=0, t=63"),       # block 4 starts at 64 > 63
        ([0, 2, 2], "duplicate"),
        ([1, 2, 3], "block 0"),
    ):
        sel = good.clone()
        sel[0, 3, 0] = torch.tensor(bad, dtype=torch.int32)
        assert what in validate_selection(sel, t, 16)
    assert validate_selection(torch.tensor([[[[1, -1]]]]), t[:1], 16, force_init=False) \
        is not None                                             # causality still holds


def test_debug_compare_prefill_on_the_long_route(monkeypatch):
    """Both runs use the plain versions on this machine: every difference is 0."""
    _force_long_route(monkeypatch)
    tc = NSAConfig(**LONG)
    params = tnsa.init_nsa_params(tc, torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_r(9, 1, 300, tc.dim))
    res = debug_compare_prefill(params, x, tc)
    assert res == {"cmp": 0.0, "sel": 0.0, "win": 0.0, "all": 0.0, "sel_idx_mismatch": 0.0}
    _, aux = tnsa.nsa_prefill(params, x, tc)
    assert validate_selection(canonicalize_sel(aux["sel_idx"]), torch.arange(300), tc.l_sel) \
        is None
    assert tref.num_cmp_per_token(4, 8, 4, 9, t_start=30).tolist() == [6, 7, 7, 7]
