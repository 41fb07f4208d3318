"""The port's ragged decode, admission and graph-replayed generation vs the
JAX package (CPU, float32).

The JAX package's own ragged tests (tests/test_decode.py:191, 239, 253,
298) rebuilt as JAX-vs-port comparisons: the caches are built by JAX
(`nsa_prefill_via_decode`, `kernel="reference"`) and moved to the port
through numpy, parameters through `params_from_numpy`, and both packages
take the same steps. Tolerances: 1e-5 absolute on outputs and cache
contents (f32 sum order); read counters, overflow flags and greedy tokens
must be equal; `sel_idx` is compared as sets (`canonicalize_sel`).
"""

import functools

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
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

TOL = 1e-5
BASE = dict(dim=64, n_heads=4, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=8, n_sel=3, w=16)


def _configs(**kw):
    kw = {**BASE, **kw}
    return JNSAConfig(**kw, kernel="reference"), NSAConfig(**kw)


def _params(jc, seed=0):
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jrows(jp, jc, xs, depths, C):
    """One JAX B = 1 cache per row, each prefilled by the decode step to its depth."""
    rows = []
    for i, t in enumerate(depths):
        c = jcache.init_cache(jc, 1, C)
        if t:
            _, c = jdecode.nsa_prefill_via_decode(jp, jnp.asarray(xs[i:i + 1, :t]), c, jc)
        rows.append(c)
    return rows


def _jbatch(rows, depths):
    return jcache.NSACache(*[jnp.concatenate([getattr(r, f) for r in rows], axis=0)
                             for f in jcache.NSACache._fields[:-1]],
                           t=jnp.asarray(depths, jnp.int32))


def _tcache(tc, jc_cache):
    """The port's cache holding a JAX cache's buffers; t stays a host int
    for a scalar JAX t and becomes the ragged int32 [B] tensor otherwise."""
    B, _, C, _ = jc_cache.k_sel.shape
    c = tcache.init_cache(tc, B, C, device="cpu")
    for f in tcache.BUFFERS:
        getattr(c, f).copy_(torch.from_numpy(np.array(getattr(jc_cache, f))))
    t = np.asarray(jc_cache.t)
    c.t = int(t) if t.ndim == 0 else torch.from_numpy(t.astype(np.int32))
    return c


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0, err_msg=msg)


def _same_cache(tc_cache, jc_cache):
    for f in tcache.BUFFERS:
        _close(getattr(tc_cache, f), getattr(jc_cache, f), msg=f)
    np.testing.assert_array_equal(tc_cache.t.numpy(), np.asarray(jc_cache.t))


@functools.lru_cache(maxsize=None)
def _jstep(jc):
    return jax.jit(lambda p, xt, c: jdecode.nsa_decode_step_ragged(p, xt, c, jc))


@functools.lru_cache(maxsize=None)
def _jrows_cached(phi, depths, seed):
    """JAX per-row caches at `depths` (capacity 64) for the BASE config with
    `phi`, parameters from PRNGKey(seed), inputs from seed 5."""
    jc, _ = _configs(phi=phi)
    jp, _ = _params(jc, seed)
    return _jrows(jp, jc, _x(len(depths), max(depths), jc.dim, seed=5), list(depths), 64)


@pytest.mark.parametrize("phi,depths,steps", [("avg", [1, 17, 40], 3), ("conv", [9, 26], 4)])
def test_ragged_step_matches_jax(phi, depths, steps):
    """Per-row depths straddling the warm-up l and several emissions: the
    outputs, every cache buffer, t, the per-row read counters and the
    selection sets equal JAX's ragged step (conv ϕ reads each row's ring
    window in its own order)."""
    jc, tc = _configs(phi=phi)
    seed = 2 if phi == "conv" else 0
    jp, tp = _params(jc, seed)
    B = len(depths)
    jr = _jbatch(_jrows_cached(phi, tuple(depths), seed), depths)
    tr = _tcache(tc, jr)
    assert tr.t.dtype == torch.int32 and tr.t.tolist() == depths
    x_new = _x(B, steps, jc.dim, seed=6)
    step = _jstep(jc)
    for k in range(steps):
        jo, jr, ji = step(jp, jnp.asarray(x_new[:, k:k + 1]), jr)
        to, tr, ti = tdecode.nsa_decode_step_ragged(tp, torch.from_numpy(x_new[:, k:k + 1]),
                                                    tr, tc)
        _close(to, jo, msg=f"step {k}")
        for f in ("reads_pred", "reads_cmp", "reads_sel", "reads_win", "reads_actual_cmp",
                  "reads_actual_win", "overflow"):
            np.testing.assert_array_equal(getattr(ti, f).numpy(), np.asarray(getattr(ji, f)),
                                          err_msg=f)
        for f in ("reads_actual_sel", "reads_actual", "sel_valid_tokens"):
            _close(getattr(ti, f), getattr(ji, f), msg=f)
        assert torch.equal(canonicalize_sel(ti.sel_idx),
                           canonicalize_sel(torch.from_numpy(np.array(ji.sel_idx))))
        _close(ti.gates, ji.gates)
        _same_cache(tr, jr)
    assert tr.t.tolist() == [d + steps for d in depths]


def test_ragged_step_equals_uniform_step_per_row():
    """The port's ragged step, row by row, is its uniform step at that row's
    depth (tests/test_decode.py's claim, here within the port)."""
    jc, tc = _configs()
    jp, tp = _params(jc)
    depths = [1, 17, 40]
    jrows = _jrows_cached("avg", tuple(depths), 0)
    rows = [_tcache(tc, r) for r in jrows]
    ragged = _tcache(tc, _jbatch(jrows, depths))
    x_new = torch.from_numpy(_x(3, 3, jc.dim, seed=6))
    for k in range(3):
        out_r, ragged, info_r = tdecode.nsa_decode_step_ragged(tp, x_new[:, k:k + 1], ragged, tc)
        for i in range(3):
            out_u, rows[i], info_u = tdecode.nsa_decode_step(tp, x_new[i:i + 1, k:k + 1],
                                                             rows[i], tc)
            assert float((out_r[i:i + 1] - out_u).abs().max()) < TOL
            assert int(info_r.reads_pred[i]) == info_u.reads_pred
            assert torch.equal(info_r.sel_idx[i], info_u.sel_idx[0])


def test_ragged_overflow_per_row():
    """overflow fires per row exactly when that row is at capacity, as in
    JAX, and the step does not raise."""
    jc, tc = _configs()
    jp, tp = _params(jc)
    C = 16
    jr = jcache.init_cache(jc, 2, C)._replace(t=jnp.asarray([C - 1, C], jnp.int32))
    x = _x(2, 1, jc.dim, seed=7)
    _, _, ji = _jstep(jc)(jp, jnp.asarray(x), jr)
    tr = _tcache(tc, jr)
    _, tr, ti = tdecode.nsa_decode_step_ragged(tp, torch.from_numpy(x), tr, tc)
    np.testing.assert_array_equal(ti.overflow.numpy(), np.asarray(ji.overflow))
    assert ti.overflow.tolist() == [False, True]
    assert tr.t.tolist() == [C, C + 1]


def test_admit_row_mid_stream_in_place():
    """Continuous batching: a request prefilled alone and admitted as row 2
    of a running batch decodes as it would alone and as JAX's admitted row
    does; the admission writes into the batch's tensors (their addresses do
    not move) and raises on a cache of another capacity."""
    jc, tc = _configs()
    jp, tp = _params(jc)
    C = 64
    xs = _x(3, 33, jc.dim, seed=8)
    jrows = _jrows(jp, jc, xs, [20, 33], C)
    jr = _jbatch(jrows + [jrows[0]], [20, 33, 0])
    jsolo = _jrows(jp, jc, _x(1, 11, jc.dim, seed=9), [11], C)[0]
    jr = jcache.admit_row(jr, jcache.ragged_cache(jsolo), 2)

    tr = _tcache(tc, _jbatch(jrows + [jrows[0]], [20, 33, 0]))
    ptrs = [x.data_ptr() for x in tcache.cache_tensors(tr)]
    solo = _tcache(tc, jsolo)                                  # uniform, t = 11
    assert tcache.admit_row(tr, tcache.ragged_cache(solo), 2) is tr
    assert [x.data_ptr() for x in tcache.cache_tensors(tr)] == ptrs
    assert tr.t.tolist() == [20, 33, 11]
    _same_cache(tr, jr)

    x_steps = _x(3, 2, jc.dim, seed=10)
    step = _jstep(jc)
    for k in range(2):
        xt = x_steps[:, k:k + 1]
        jo, jr, _ = step(jp, jnp.asarray(xt), jr)
        to, tr, _ = tdecode.nsa_decode_step_ragged(tp, torch.from_numpy(xt), tr, tc)
        so, solo, _ = tdecode.nsa_decode_step(tp, torch.from_numpy(xt[2:3]), solo, tc)
        _close(to, jo, msg=f"step {k}")
        assert float((to[2:3] - so).abs().max()) < TOL, k
    assert [x.data_ptr() for x in tcache.cache_tensors(tr)] == ptrs

    with pytest.raises(ValueError, match="differs"):
        tcache.admit_row(tr, tcache.init_cache(tc, 1, C + 8, device="cpu"), 0)
    with pytest.raises(ValueError, match="ragged"):
        tcache.admit_row(solo, solo, 0)


def test_generate_scan_and_ragged_match_jax():
    """Greedy tokens of the port's generate_scan and generate_ragged (the
    captured tick, run eagerly on the CPU) equal the JAX package's, on a
    2-layer vocab-64 model; generate_ragged's rows equal each row's own
    generate, and lens outside [1, L_max] raise."""
    kw = dict(BASE, n_heads=6, n_kv_groups=2, dim=48, l_sel=16, n_sel=4)
    jm = JModelConfig(vocab_size=64, n_layers=2, nsa=JNSAConfig(**kw, kernel="reference"))
    tm = ModelConfig(vocab_size=64, n_layers=2, nsa=NSAConfig(**kw))
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, 64, size=(2, 24)).astype(np.int32)
    js = jtiny.generate_scan(jp, jnp.asarray(prompt), 4, jm)
    ts = ttiny.generate_scan(tp, torch.from_numpy(prompt).long(), 4, tm)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert torch.equal(ts, ttiny.generate(tp, torch.from_numpy(prompt).long(), 4, tm))

    lens = [3, 9, 14]
    prompts = rs.randint(0, 64, size=(3, 14)).astype(np.int32)
    jg = jtiny.generate_ragged(jp, jnp.asarray(prompts), jnp.asarray(lens, jnp.int32), 4, jm)
    tg = ttiny.generate_ragged(tp, torch.from_numpy(prompts).long(), lens, 4, tm)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for i, n in enumerate(lens):
        alone = ttiny.generate(tp, torch.from_numpy(prompts[i:i + 1, :n]).long(), 4, tm)
        assert torch.equal(tg[i], alone[0, n:])
    for bad in ([0, 9, 14], [3, 9, 15]):
        with pytest.raises(ValueError, match="prompt_lens"):
            ttiny.generate_ragged(tp, torch.from_numpy(prompts).long(), bad, 4, tm)
    with pytest.raises(ValueError, match="capacity"):
        ttiny.generate_ragged(tp, torch.from_numpy(prompts).long(), lens, 4, tm, capacity=16)


def test_generate_scan_sampling_is_seeded():
    """Sampled generate_scan draws from the caller's generator: a seed
    gives the same tokens twice, and the same as `generate` from that seed
    (both draw each step's sample in the same order)."""
    tm = ModelConfig(vocab_size=32, n_layers=1, nsa=NSAConfig(**BASE))
    tp = ttiny.init_model_params(tm, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, 32, (2, 20), generator=torch.Generator().manual_seed(1))

    def run(fn, seed):
        return fn(tp, prompt, 6, tm, temperature=0.8, top_k=8, top_p=0.9,
                  generator=torch.Generator().manual_seed(seed))

    a = run(ttiny.generate_scan, 5)
    assert torch.equal(a, run(ttiny.generate_scan, 5)) and a.shape == (2, 26)
    assert torch.equal(a, run(ttiny.generate, 5))
