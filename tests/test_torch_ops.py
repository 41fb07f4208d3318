"""PyTorch port vs JAX package: RoPE, ϕ compression, block metadata,
the selection pipeline, the gate and sampling (CPU, float32).

Inputs are made with numpy from a seed and given to both packages.
Tolerance 1e-5 absolute for float results (the two frameworks order f32
sums differently and compute pow/sin/cos with different libm code);
integer results must be equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nsa_vibe_tpu.core import gate as jgate
from nsa_vibe_tpu.ops import block_index as jbi
from nsa_vibe_tpu.ops import compress as jcomp
from nsa_vibe_tpu.ops import rope as jrope
from nsa_vibe_tpu.ops import selection as jsel
from nsa_vibe_tpu.utils import sampling as jsamp
from nsa_vibe_tpu_torch.core import gate as tgate
from nsa_vibe_tpu_torch.core.config import M7C_125M
from nsa_vibe_tpu_torch.ops import block_index as tbi
from nsa_vibe_tpu_torch.ops import compress as tcomp
from nsa_vibe_tpu_torch.ops import rope as trope
from nsa_vibe_tpu_torch.ops import selection as tsel
from nsa_vibe_tpu_torch.utils import sampling as tsamp

TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("base,scale", [(10000.0, 1.0), (500.0, 2.0)])
def test_rope_matches_jax(base, scale):
    x = _rng().randn(2, 7, 3, 16).astype(np.float32)    # [B,S,H,D], pos per token
    pos = np.arange(5, 12)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[:, None], base, scale)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None], base, scale)
    _close(got, want)


@pytest.mark.parametrize("S,l,d", [(64, 8, 4), (70, 16, 8), (16, 16, 8), (5, 8, 4)])
def test_avg_pool_phi_matches_jax(S, l, d):
    x = _rng(1).randn(2, 3, S, 8).astype(np.float32)
    got = tcomp.avg_pool_phi(torch.from_numpy(x), l, d)
    want = jcomp.avg_pool_phi(jnp.asarray(x), l, d)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_conv_phi_and_pool_rope_match_jax():
    r = _rng(2)
    K = r.randn(2, 2, 50, 8).astype(np.float32)
    V = r.randn(2, 2, 50, 6).astype(np.float32)
    wk = r.rand(8, 16).astype(np.float32)
    wv = r.rand(6, 16).astype(np.float32)
    got = tcomp.conv_phi(torch.from_numpy(K), torch.from_numpy(wk), 16, 8)
    _close(got, jcomp.conv_phi(jnp.asarray(K), jnp.asarray(wk), 16, 8))
    for kw in (dict(), dict(k_weight=wk, v_weight=wv)):
        got = tcomp.pool_phi_rope_kv(torch.from_numpy(K), torch.from_numpy(V), 16, 8,
                                     **{k: torch.from_numpy(v) for k, v in kw.items()})
        want = jcomp.pool_phi_rope_kv(jnp.asarray(K), jnp.asarray(V), 16, 8,
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize("S,l,d,l_sel", [(2048, 32, 16, 64), (100, 16, 8, 32), (7, 8, 4, 8),
                                         (130, 32, 16, 16)])
def test_block_index_matches_jax(S, l, d, l_sel):
    M = tbi.build_M_csl(S, l, d, l_sel)
    np.testing.assert_array_equal(M, jbi.build_M_csl(S, l, d, l_sel))
    np.testing.assert_array_equal(tbi.build_M_csl_on(S, l, d, l_sel, "cpu").numpy(), M)
    rows = M.sum(axis=1)
    assert np.all((np.abs(rows - 1) < 1e-6) | (rows == 0))            # fractional overlap rows
    tm, jm = tbi.build_block_meta(S, l, d, l_sel, 4, 16), jbi.build_block_meta(S, l, d, l_sel, 4, 16)
    assert (tm.S_cmp, tm.S_sel) == (jm.S_cmp, jm.S_sel)
    s_raw = np.arange(0, S + 3)
    np.testing.assert_array_equal(tbi.num_cmp_blocks(s_raw, l, d), jbi.num_cmp_blocks(s_raw, l, d))
    assert tbi.num_cmp_blocks(S, l, d) == jbi.num_cmp_blocks(S, l, d)
    assert tbi.expected_decode_reads(S, l, d, l_sel, 16, 512) == \
        jbi.expected_decode_reads(S, l, d, l_sel, 16, 512)


def test_m7c_preset_matches_yaml():
    with open(Path(__file__).resolve().parents[1] / "configs" / "m7c_125m.yaml") as f:
        y = yaml.safe_load(f)
    assert M7C_125M.vocab_size == y["model"]["vocab_size"]
    assert M7C_125M.n_layers == y["model"]["n_layers"]
    assert M7C_125M.dtype == y["model"]["dtype"]
    for k, v in y["nsa"].items():
        assert getattr(M7C_125M.nsa, k) == v, k


def _sel_inputs(seed=3, B=2, S=40, G=2, h=3, D=8, S_cmp=7):
    r = _rng(seed)
    Q = r.randn(B, S, G, h, D).astype(np.float32)
    Kc = r.randn(B, G, S_cmp, D).astype(np.float32)
    nct = np.minimum(tbi.num_cmp_blocks(np.arange(1, S + 1), 8, 4), S_cmp).astype(np.int32)
    return Q, Kc, nct


def test_selection_scores_match_jax():
    Q, Kc, nct = _sel_inputs()
    M = tbi.build_M_csl(40, 8, 4, 16)[:7]
    tq, tk = torch.from_numpy(Q), torch.from_numpy(Kc)
    p = tsel.compute_pcmp_masked(tq, tk, 0.3, torch.from_numpy(nct))
    _close(p, jsel.compute_pcmp_masked(jnp.asarray(Q), jnp.asarray(Kc), 0.3, jnp.asarray(nct)))
    nct2 = np.stack([nct, np.maximum(nct - 2, 0)])          # per-row depths [B,S]
    p2 = tsel.compute_pcmp_masked(tq, tk, 0.3, torch.from_numpy(nct2))
    _close(p2, jsel.compute_pcmp_masked(jnp.asarray(Q), jnp.asarray(Kc), 0.3, jnp.asarray(nct2)))
    _close(tsel.group_reduce(tsel.map_pcmp_to_pslc(p, torch.from_numpy(M))),
           jsel.group_reduce(jsel.map_pcmp_to_pslc(jnp.asarray(np.asarray(p)), jnp.asarray(M))))
    got = tsel.selection_scores(tq, tk, torch.from_numpy(M), 0.3, torch.from_numpy(nct))
    want = jsel.selection_scores(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(M), 0.3,
                                 jnp.asarray(nct))
    _close(got, want)


@pytest.mark.parametrize("n_top,force_init,force_local,ragged", [
    (4, True, 2, False), (6, True, 2, True), (2, True, 2, False), (5, False, 0, False),
    (3, False, 1, True)])
def test_select_topn_blocks_matches_jax(n_top, force_init, force_local, ragged):
    r = _rng(4)
    B, S, G, l_sel = 2, 50, 2, 8
    S_sel = -(-S // l_sel)
    p = r.rand(B, S, G, S_sel).astype(np.float32)
    t = np.arange(S, dtype=np.int32)
    if ragged:
        t = np.stack([t, t[::-1].copy()])
    got = tsel.select_topn_blocks(torch.from_numpy(p), n_top, torch.from_numpy(t), l_sel,
                                  force_init, force_local)
    want = jsel.select_topn_blocks(jnp.asarray(p), n_top, jnp.asarray(t), l_sel,
                                   force_init, force_local)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tsel.forced_block_ids(torch.from_numpy(np.arange(S)), l_sel, force_init, force_local).numpy(),
        np.asarray(jsel.forced_block_ids(jnp.arange(S), l_sel, force_init, force_local)))
    assert tsel.effective_sel_blocks(n_top, force_init, force_local) == \
        jsel.effective_sel_blocks(n_top, force_init, force_local)


@pytest.mark.parametrize("S_kv", [64, 70])
def test_selection_token_mask_matches_jax(S_kv):
    r = _rng(5)
    B, S, G, n, l_sel = 2, 30, 2, 4, 16
    sel = r.randint(-1, -(-S_kv // l_sel), size=(B, S, G, n)).astype(np.int32)
    sel[0, 0, 0] = [1, 1, 0, -1]                             # repeats count once
    t = np.arange(S_kv - S, S_kv, dtype=np.int32)
    got = tsel.selection_token_mask(torch.from_numpy(sel), torch.from_numpy(t), l_sel, S_kv)
    want = jsel.selection_token_mask(jnp.asarray(sel), jnp.asarray(t), l_sel, S_kv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonicalize_sel():
    sel = torch.tensor([[0, 3, 3, -1, 1], [2, 2, 2, 2, 2], [-1, -1, -1, -1, -1]], dtype=torch.int32)
    want = [[0, 1, 3, -1, -1], [2, -1, -1, -1, -1], [-1, -1, -1, -1, -1]]
    assert tsel.canonicalize_sel(sel).tolist() == want


@pytest.mark.parametrize("force_branch,force_uniform", [(None, False), ("sel", False),
                                                        ("WIN ", False), (None, True)])
def test_gate_matches_jax(force_branch, force_uniform):
    jp = jgate.init_gate_params(jax.random.PRNGKey(0), 16)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    q = _rng(6).randn(2, 5, 2, 16).astype(np.float32)
    got = tgate.gate_probs(tp, torch.from_numpy(q), 0.7, force_branch, force_uniform)
    want = jgate.gate_probs(jp, jnp.asarray(q), 0.7, force_branch, force_uniform)
    _close(got, want)


def test_gate_init_shapes_and_near_uniform_start():
    p = tgate.init_gate_params(torch.Generator().manual_seed(0), 64)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"w1": (64, 32), "b1": (32,), "w2": (32, 3), "b2": (3,)}
    g = tgate.gate_probs(p, torch.randn(100, 64, generator=torch.Generator().manual_seed(1)))
    assert torch.allclose(g.sum(-1), torch.ones(100))
    assert float((g - 1 / 3).abs().max()) < 0.1


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 4, 1.0), (0.7, 0, 0.8),
                                                     (1.3, 5, 0.9), (1.0, 1, 1.0)])
def test_sampling_keeps_the_same_support_as_jax(temperature, top_k, top_p):
    """The two frameworks draw different random numbers, so compare what the
    filters keep: the set of tokens drawn over many draws from each."""
    logits = np.log(np.array([0.30, 0.22, 0.16, 0.12, 0.08, 0.06, 0.04, 0.02],
                             np.float32))[None].repeat(4000, axis=0)
    got = tsamp.sample_logits(torch.from_numpy(logits), temperature, top_k, top_p,
                              torch.Generator().manual_seed(0))
    want = jsamp.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits), temperature,
                               top_k, top_p)
    assert set(got.tolist()) == set(np.asarray(want).tolist())
    assert tsamp.sample_logits(torch.from_numpy(logits[:2]), 0.0).tolist() == [0, 0]
