"""The port's NSA layer and TinyLM serving path vs the JAX package (CPU, f32).

Parameters are made by the JAX package, moved with `params_from_numpy`,
and inputs are numpy arrays from a seed, so both packages see the same
numbers. JAX runs its `kernel="reference"` path. Tolerances: 1e-5
absolute on attention-layer outputs (f32 sum order), 1e-4 on logits of a
2-layer model; integer results (selection as a set, read counters,
greedy tokens) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core import cache as jcache
from nsa_vibe_tpu.core import decode as jdecode
from nsa_vibe_tpu.core import nsa as jnsa
from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu_torch.convert import params_from_numpy
from nsa_vibe_tpu_torch.core import cache as tcache
from nsa_vibe_tpu_torch.core import decode as tdecode
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.ops import cuda as kernels
from nsa_vibe_tpu_torch.ops.block_index import expected_decode_reads
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

TOL = 1e-5
BASE = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
            w=16)


def _configs(**kw):
    kw = {**BASE, **kw}
    return JNSAConfig(**kw, kernel="reference"), NSAConfig(**kw)


def _params(jc):
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jprefill(jp, x, jc):
    return jax.jit(lambda p, x: jnsa.nsa_prefill(p, x, jc))(jp, jnp.asarray(x))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("S,extra", [
    (70, {}),                                   # odd h=3, S not divisible by l_sel
    (48, {"phi": "conv", "n_heads": 4}),        # learnable ϕ, h=2
    (5, {}),                                    # S < l: no compressed tokens
    (40, {"force_branch": "sel"}),
])
def test_nsa_prefill_matches_jax(S, extra):
    jc, tc = _configs(**extra)
    jp, tp = _params(jc)
    x = _x(2, S, jc.dim)
    jout, jaux = _jprefill(jp, x, jc)
    tout, taux = tnsa.nsa_prefill(tp, torch.from_numpy(x), tc)
    _close(tout, jout)
    np.testing.assert_array_equal(canonicalize_sel(taux["sel_idx"]).numpy(),
                                  np.asarray(jaux["sel_idx"]))
    for k in ("gates", "K_sel", "V_win", "K_cmp", "V_cmp"):
        _close(taux[k], jaux[k])


def test_project_qkv_fused_equals_split():
    jc, tc = _configs()
    _, tp = _params(jc)
    x = torch.from_numpy(_x(2, 9, jc.dim))
    fused, split = tnsa.project_qkv(tp, x, tc, fused=True), tnsa.project_qkv(tp, x, tc, False)
    for a, b in zip(fused, split):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert tp["W_Q"].data_ptr() == tp["W_qkv"].data_ptr()      # views, not copies


def test_decode_after_prefill_matches_jax():
    """Seed both caches from a prefill, decode 20 steps across emission
    boundaries: same outputs, same selection, exact read counters."""
    jc, tc = _configs()
    jp, tp = _params(jc)
    S0, n, cap = 30, 20, 56
    x = _x(2, S0 + n, jc.dim, seed=2)
    _, jaux = _jprefill(jp, x[:, :S0], jc)
    _, taux = tnsa.nsa_prefill(tp, torch.from_numpy(x[:, :S0]), tc)
    jc_ = jcache.cache_from_prefill(jc, jaux, cap)
    tc_ = tcache.cache_from_prefill(tc, taux, cap)
    step = jax.jit(lambda p, xt, c: jdecode.nsa_decode_step(p, xt, c, jc))
    for i in range(n):
        xt = x[:, S0 + i:S0 + i + 1]
        jo, jc_, ji = step(jp, jnp.asarray(xt), jc_)
        to, tc_, ti = tdecode.nsa_decode_step(tp, torch.from_numpy(xt), tc_, tc)
        _close(to, jo)
        np.testing.assert_array_equal(ti.sel_idx.numpy(), np.asarray(ji.sel_idx))
        s_raw = S0 + i + 1
        assert ti.reads_pred == expected_decode_reads(s_raw, tc.l, tc.d, tc.l_sel, tc.n_sel, tc.w)
        for f in ("reads_pred", "reads_cmp", "reads_sel", "reads_win", "reads_actual_cmp",
                  "reads_actual_win"):
            assert int(getattr(ti, f)) == int(getattr(ji, f)), f
        for f in ("sel_valid_tokens", "reads_actual"):
            assert float(getattr(ti, f)) == pytest.approx(float(getattr(ji, f))), f
    for f in ("k_sel", "v_win", "k_cmp_raw", "k_cmp", "v_cmp"):
        _close(getattr(tc_, f), getattr(jc_, f))
    assert tc_.t == int(jc_.t) == S0 + n


def test_decode_past_capacity_raises():
    jc, tc = _configs()
    _, tp = _params(jc)
    cache = tcache.init_cache(tc, 1, 3, device="cpu")
    x = torch.from_numpy(_x(1, 1, jc.dim))
    for _ in range(3):
        _, cache, _ = tdecode.nsa_decode_step(tp, x, cache, tc)
    with pytest.raises(ValueError, match="capacity"):
        tdecode.nsa_decode_step(tp, x, cache, tc)


def test_prefill_matches_prefill_via_decode():
    jc, tc = _configs()
    _, tp = _params(jc)
    x = torch.from_numpy(_x(2, 40, jc.dim, seed=3))
    out_b, _ = tnsa.nsa_prefill(tp, x, tc)
    cache = tcache.init_cache(tc, 2, 48, device="cpu")
    out_s, cache = tdecode.nsa_prefill_via_decode(tp, x, cache, tc)
    torch.testing.assert_close(out_s, out_b, atol=TOL, rtol=0)
    assert cache.t == 40


def test_cpu_path_launches_no_kernel():
    """Launch counters move only where a kernel launches: the CPU path
    (plain versions) leaves them at 0."""
    jc, tc = _configs()
    _, tp = _params(jc)
    kernels.reset_launch_counts()
    tnsa.nsa_prefill(tp, torch.from_numpy(_x(1, 40, jc.dim)), tc)
    assert kernels.launch_counts() == {"select_cmp": 0, "sel_attn": 0, "win_attn": 0}


def test_tinylm_logits_and_greedy_generate_match_jax():
    kw = dict(BASE, n_heads=6, n_kv_groups=2)
    jm = JModelConfig(vocab_size=64, n_layers=2, nsa=JNSAConfig(**kw, kernel="reference"))
    tm = ModelConfig(vocab_size=64, n_layers=2, nsa=NSAConfig(**kw))
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.RandomState(4).randint(0, 64, size=(2, 37)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t: jtiny.model_forward(p, t, jm))(jp, jnp.asarray(prompt))
    tl, _ = ttiny.model_forward(tp, torch.from_numpy(prompt).long(), tm)
    _close(tl, jl, 1e-4)
    tl2, _ = ttiny.model_prefill_with_caches(tp, torch.from_numpy(prompt).long(), tm, 48)
    torch.testing.assert_close(tl2, tl, atol=0, rtol=0)
    jg = jtiny.generate(jp, jnp.asarray(prompt), 8, jm)
    tg = ttiny.generate(tp, torch.from_numpy(prompt).long(), 8, tm)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    with pytest.raises(ValueError, match="capacity"):
        ttiny.generate(tp, torch.from_numpy(prompt).long(), 8, tm, capacity=40)


def test_generate_sampling_is_seeded():
    tm = ModelConfig(vocab_size=32, n_layers=1, nsa=NSAConfig(**BASE))
    tp = ttiny.init_model_params(tm, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, 32, (2, 20), generator=torch.Generator().manual_seed(1))

    def run(seed):
        return ttiny.generate(tp, prompt, 6, tm, temperature=0.8, top_k=8, top_p=0.9,
                              generator=torch.Generator().manual_seed(seed))

    a, b = run(5), run(5)
    assert torch.equal(a, b) and a.shape == (2, 26) and int(a.max()) < 32
