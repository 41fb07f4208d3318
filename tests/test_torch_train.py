"""The port's training slice vs the JAX package (CPU, f32).

Inputs are numpy arrays from a seed and parameters are made by the JAX
package and moved with `params_from_numpy`, so both packages see the same
numbers; JAX runs `kernel="reference"` and optax. On the CPU the port's
branch Functions run the kernels' plain versions, forward and backward.

Tolerances (absolute unless stated; f32 sum order is the only difference):
  * branch backward, dense formula vs jax.vjp of the reference: 2e-5;
  * forward row statistics vs a numpy logsumexp: 1e-5;
  * NSA layer gradients: 2e-5 of each gradient's max |value|;
  * TinyLM loss 1e-5, gradients 5e-5 of each gradient's max |value|;
  * train step: loss, grad norm and gate stats 1e-5 relative, every
    parameter within 1e-5 of its leaf's max |value| after each of three
    AdamW steps (an update moves a parameter by <= lr);
  * integer results (selection sets, counts, batches) exactly equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsa_vibe_tpu.core import nsa as jnsa
from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.core.config import TrainConfig as JTrainConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.ops import reference as jref
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu.train import data as jdata
from nsa_vibe_tpu.train.trainer import load_config as jload_config
from nsa_vibe_tpu_torch import M7C_125M, M7C_125M_TRAIN
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.ops import reference as tref
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd, banded_bwd_plain
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import sel_attn_bwd, selection_index
from nsa_vibe_tpu_torch.ops.selection import count_distinct_blocks, selection_token_mask
from nsa_vibe_tpu_torch.train import data as tdata
from nsa_vibe_tpu_torch.train import optim as toptim
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.train.trainer import load_config, train
from nsa_vibe_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
            w=16)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _close_rel(t, j, rel):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, atol=rel * max(np.abs(j).max(), 1e-12),
                               rtol=0)


# ---------------------------------------------------------------- branch backward

def _branch_operands(B, S, G, h, D, S_kv, seed):
    return (_rand(B, S, G, h, D, seed=seed), _rand(B, G, S_kv, D, seed=seed + 1),
            _rand(B, G, S_kv, D, seed=seed + 2), _rand(B, S, G, h, D, seed=seed + 3))


def _port_bwd(fwd, bwd, Q, K, V, dO):
    """Forward (O, lse) and the backward from the row statistics."""
    Q, K, V, dO = map(_t, (Q, K, V, dO))
    O, lse = fwd(Q, K, V)
    return (O, lse), bwd(Q, K, V, dO, lse, tref.attention_delta(dO, O))


def _numpy_lse(Q, K, mask, scale):
    s = np.einsum("bsghd,bgkd->bsghk", Q, K).astype(np.float64) * scale
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    return np.where(mask.any(-1), lse, tref.EMPTY_LSE).astype(np.float32)


@pytest.mark.parametrize("mode,S,w,l,d", [
    ("win", 37, 8, 0, 1),          # band narrower than S
    ("win", 20, 64, 0, 1),         # window wider than S
    ("cmp", 45, 0, 8, 4),          # rows t < 7 see no compressed token
])
def test_banded_backward_matches_jax_vjp(mode, S, w, l, d):
    B, G, h, D, scale = 2, 2, 3, 8, 0.35
    S_kv = S if mode == "win" else (S - l) // d + 1
    Q, K, V, dO = _branch_operands(B, S, G, h, D, S_kv, seed=10)
    t_pos = jnp.arange(S)
    if mode == "win":
        jf = lambda q, k, v: jref.sliding_window_attention(q, k, v, t_pos, w, scale)  # noqa: E731
        tf = lambda q, k, v: tref.sliding_window_attention(  # noqa: E731
            q, k, v, torch.arange(S), w, scale, True)
        mask = np.asarray(jref.sliding_window_mask(t_pos, S_kv, w))
    else:
        ncmp = jnp.asarray(np.clip(np.where(np.arange(1, S + 1) >= l,
                                            (np.arange(1, S + 1) - l) // d + 1, 0), 0, S_kv))
        jf = lambda q, k, v: jref.compressed_attention(q, k, v, ncmp, scale)  # noqa: E731
        tf = lambda q, k, v: tref.compressed_attention(  # noqa: E731
            q, k, v, tref.num_cmp_per_token(S, l, d, S_kv), scale, True)
        mask = np.asarray(jref.compressed_mask(ncmp, S_kv))
    jO, vjp = jax.vjp(jf, jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V))
    jgrads = vjp(jnp.asarray(dO))
    (O, lse), grads = _port_bwd(
        tf, lambda *a: banded_bwd(*a, mode=mode, w=w, l=l, d=d, scale=scale), Q, K, V, dO)
    _close(O, jO, 2e-5)
    _close(lse, _numpy_lse(Q, K, mask[None, :, None, None, :], scale), 1e-5)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, 2e-5)
    if mode == "cmp":                                   # empty rows: no gradient at all
        assert bool((lse[:, :l - 1] == tref.EMPTY_LSE).all())
        assert not bool(grads[0][:, :l - 1].any())


@pytest.mark.parametrize("S,l_sel,sel_rows", [
    (40, 16, [[0, 2, 2, -1], [1, -1, -1, -1], [2, 0, 1, 0]]),   # repeats, -1, S % l_sel != 0
    (33, 8, [[4, 4, 4, 4], [0, 3, -1, 1], [-1, -1, -1, 2]]),
])
def test_selection_backward_matches_jax_vjp(S, l_sel, sel_rows):
    """Forced-first selections with repeated ids and -1 slots act as sets;
    blocks past t are invisible."""
    B, G, h, D, scale = 2, 2, 3, 8, 0.3
    Q, K, V, dO = _branch_operands(B, S, G, h, D, S, seed=20)
    rs = np.random.RandomState(21)
    sel = np.asarray(sel_rows, np.int32)[rs.randint(0, len(sel_rows), size=(B, S, G))]
    t_pos = jnp.arange(S)
    jf = lambda q, k, v: jref.selection_attention(  # noqa: E731
        q, k, v, jnp.asarray(sel), t_pos, l_sel, scale)
    jO, vjp = jax.vjp(jf, jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V))
    jgrads = vjp(jnp.asarray(dO))
    tsel, tt = _t(sel), torch.arange(S)
    (O, lse), grads = _port_bwd(
        lambda q, k, v: tref.selection_attention(q, k, v, tsel, tt, l_sel, scale, True),
        lambda q, k, v, do, ls, dl: sel_attn_bwd(q, k, v, tsel, tt, do, ls, dl, l_sel=l_sel,
                                                 scale=scale),
        Q, K, V, dO)
    _close(O, jO, 2e-5)
    mask = selection_token_mask(tsel, tt, l_sel, S).numpy()[:, :, :, None, :]
    _close(lse, _numpy_lse(Q, K, mask, scale), 1e-5)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, 2e-5)


def test_selection_inverse_index_lists_each_row_once():
    """inv/cnt name exactly the rows whose selection SET holds a visible
    block, ascending: the kv-major pass's work list."""
    B, S, G, n, l_sel = 2, 50, 2, 5, 8
    rs = np.random.RandomState(3)
    sel = torch.from_numpy(rs.randint(-1, 8, size=(B, S, G, n)).astype(np.int32))
    inv, _, cnt, _ = selection_index(sel, torch.arange(S), l_sel, S)
    NB = -(-S // l_sel)
    assert inv.shape == (B, G, NB, S + 1) and cnt.shape == (B, G, NB)
    for b in range(B):
        for g in range(G):
            for j in range(NB):
                want = [s for s in range(S) if j in sel[b, s, g].tolist() and j * l_sel <= s]
                assert inv[b, g, j, :int(cnt[b, g, j])].tolist() == want


def test_count_distinct_blocks():
    sel = torch.tensor([[0, 3, 3, -1], [2, 2, 2, 2], [-1, -1, -1, -1], [5, 1, 0, 4]])
    assert count_distinct_blocks(sel).tolist() == [2, 1, 0, 4]


def test_wrappers_keep_the_plain_version_for_cpu_tensors_only():
    Q, K, V, dO = (torch.from_numpy(a) for a in _branch_operands(1, 9, 1, 2, 8, 9, seed=1))
    lse = torch.zeros(1, 9, 1, 2)
    got = banded_bwd(Q, K, V, dO, lse, lse, mode="win", w=4, scale=0.3)
    want = banded_bwd_plain(Q, K, V, dO, lse, lse, mode="win", w=4, scale=0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert banded_bwd.launches == 0 and sel_attn_bwd.launches == 0
    with pytest.raises(ValueError, match="mode"):
        banded_bwd(Q, K, V, dO, lse, lse, mode="band", scale=0.3)


# ---------------------------------------------------------------- NSA layer

def _layer_configs(**kw):
    kw = {**BASE, **kw}
    return JNSAConfig(**kw, kernel="reference"), NSAConfig(**kw)


@pytest.mark.parametrize("S,extra", [
    (70, {}),                                   # odd h=3, S not a multiple of l_sel
    (48, {"phi": "conv", "n_heads": 4}),        # learnable ϕ: gradient reaches phi_k/phi_v
    (6, {}),                                    # S < l: no compressed tokens
])
def test_nsa_prefill_grads_match_jax(S, extra):
    jc, tc = _layer_configs(**extra)
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x, g = _rand(2, S, jc.dim, seed=1), _rand(2, S, jc.dim, seed=2)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: (jnsa.nsa_prefill(p, x, jc)[0] * g).sum(),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in tts.param_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    out, _ = tnsa.nsa_prefill(tp, xt, tc)
    grads = torch.autograd.grad((out * _t(g)).sum(), [xt] + leaves)
    _close_rel(grads[0], jgx, 2e-5)
    tg = params_to_numpy(tts.tree_from_leaves(tp, list(grads[1:])))
    assert sorted(jax.tree.leaves(jax.tree.map(lambda a: a.shape, tg))) == \
        sorted(jax.tree.leaves(jax.tree.map(lambda a: a.shape, jgp)))
    for k, want in jax.tree_util.tree_leaves_with_path(jgp):
        got = tg
        for key in k:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=2e-5 * max(np.abs(np.asarray(want)).max(), 1e-12),
                                   rtol=0, err_msg=str(k))


# ---------------------------------------------------------------- TinyLM

def _models(n_layers=2, remat=False, vocab=64, varlen_exact=False):
    kw = dict(BASE)
    jm = JModelConfig(vocab_size=vocab, n_layers=n_layers, remat=remat,
                      nsa=JNSAConfig(**kw, kernel="reference", varlen_exact=varlen_exact))
    tm = ModelConfig(vocab_size=vocab, n_layers=n_layers, remat=remat, nsa=NSAConfig(**kw))
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_tree_close(tree, jtree, rel):
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jtree))
    assert len(flat_t) == len(flat_j)
    for k, a in flat_t:
        b = np.asarray(flat_j[k])
        np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-12), rtol=0,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("remat", [False, True, "mlp"])
def test_tinylm_loss_and_grads_match_jax(remat):
    jm, tm, jp, tp = _models(remat=remat)
    toks = np.random.RandomState(5).randint(0, 64, size=(2, 41)).astype(np.int32)

    def jloss(p, t):
        logits, _ = jtiny.model_forward(p, t[:, :-1], jm)
        return jtiny.cross_entropy_loss(logits, t[:, 1:])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(toks))
    tts.init_train_state(tp, TrainConfig())
    loss, grads, _ = tts.loss_and_grads(tp, _t(toks).long(), tm)
    assert abs(float(loss) - float(jl)) <= 1e-5
    _assert_tree_close(params_to_numpy(tts.tree_from_leaves(tp, grads)), jg, 5e-5)


def test_cross_entropy_numden_matches_jax_with_mask():
    logits = _rand(2, 7, 11, seed=3)
    tgt = np.random.RandomState(4).randint(0, 11, size=(2, 7)).astype(np.int32)
    mask = (np.random.RandomState(5).rand(2, 7) > 0.3).astype(np.float32)
    for m in (None, mask):
        jn, jd = jtiny.cross_entropy_numden(jnp.asarray(logits), jnp.asarray(tgt),
                                            None if m is None else jnp.asarray(m))
        tn, td = ttiny.cross_entropy_numden(_t(logits), _t(tgt), None if m is None else _t(m))
        assert abs(float(tn) - float(jn)) <= 1e-4 and float(td) == float(jd)


# ---------------------------------------------------------------- train step

def _train_configs(**kw):
    base = dict(lr=1e-2, warmup_steps=1, steps=10, batch_size=2, seq_len=40,
                weight_decay=0.01)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _run_both(jm, tm, jp, tp, jt, tt, batches):
    jstate = jts.init_train_state(jp, jt)
    jstep = jax.jit(jts.make_train_step(jm, jt))
    tstate = tts.init_train_state(tp, tt)
    tstep = tts.make_train_step(tm, tt)
    for i, toks in enumerate(batches):
        before = params_to_numpy(tstate.params)
        jstate, jmet = jstep(jstate, jnp.asarray(toks))
        tstate, tmet = tstep(tstate, _t(toks).long())
        for k in ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac",
                  "sel_k_mean", "sel_k_max"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-6), k
        np.testing.assert_allclose(tmet["branch_shares"].numpy(),
                                   np.asarray(jmet["branch_shares"]), atol=1e-6)
        assert bool(tmet["good"]) and tmet["tokens"] == int(jmet["tokens"])
        after = params_to_numpy(tstate.params)
        _assert_tree_close(after, jax.tree.map(np.asarray, jstate.params), 1e-5)
        if i == 0:                       # the schedule is 0 at count 0: no change
            for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
                assert np.array_equal(a, b)
    assert int(tstate.step) == int(jstate.step) == len(batches)
    assert int(tstate.opt_state["count"]) == len(batches)
    return tstate


def test_three_train_steps_match_optax():
    jt, tt = _train_configs()
    jm, tm, jp, tp = _models()
    toks = np.random.RandomState(6).randint(0, 64, size=(3, 1, 2, 41)).astype(np.int32)
    _run_both(jm, tm, jp, tp, jt, tt, list(toks))


def test_gradient_accumulation_matches_jax():
    # the port pools avg ϕ window by window (ops/compress.py), the JAX
    # package's window-exact form (varlen_exact); its default running-sum
    # form differs by f32 round-off, which Adam's normalisation lifts past
    # the bound on one embedding element whose gradient is near zero
    jt, tt = _train_configs(accum_steps=2, max_grad_norm=0.5)
    jm, tm, jp, tp = _models(n_layers=1, varlen_exact=True)
    toks = np.random.RandomState(7).randint(0, 64, size=(2, 2, 2, 41)).astype(np.int32)
    _run_both(jm, tm, jp, tp, jt, tt, list(toks))


@pytest.mark.parametrize("count", [0, 1, 3, 9, 10, 11, 40])
def test_schedule_matches_optax(count):
    for warm, steps in ((4, 10), (0, 10), (10, 5)):
        tcfg = TrainConfig(lr=3e-4, warmup_steps=warm, steps=steps)
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=tcfg.lr, warmup_steps=warm,
            decay_steps=max(steps, warm + 1), end_value=tcfg.lr * 0.1)
        got = float(toptim.warmup_cosine_lr(torch.tensor(count, dtype=torch.int32), tcfg))
        assert got == pytest.approx(float(sched(count)), rel=1e-6, abs=1e-12)


def test_nan_batch_leaves_state_bit_unchanged():
    """A non-finite loss skips the whole update: parameters, moments and the
    count keep their bits (the coherent skip); the step counter advances."""
    _, tm, _, tp = _models(n_layers=1)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, steps=10)
    state = tts.init_train_state(tp, tcfg)
    step = tts.make_train_step(tm, tcfg)
    toks = torch.from_numpy(np.random.RandomState(8).randint(0, 64, size=(2, 1, 2, 41)))
    state, m = step(state, toks[0])
    assert bool(m["good"])
    snap = [t.clone() for t in [p for _, p in tts.param_leaves(state.params)]
            + state.opt_state["mu"] + state.opt_state["nu"] + [state.opt_state["count"]]]
    with torch.no_grad():
        state.params["lm_head"][0, 0] = float("nan")
    snap[[k for k, _ in tts.param_leaves(state.params)].index("/lm_head")][0, 0] = float("nan")
    state, m = step(state, toks[1])
    assert not bool(m["good"]) and int(state.step) == 2
    now = ([p for _, p in tts.param_leaves(state.params)] + state.opt_state["mu"]
           + state.opt_state["nu"] + [state.opt_state["count"]])
    for a, b in zip(snap, now):
        assert torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                           b.view(torch.uint8) if b.is_floating_point() else b)


# ---------------------------------------------------------------- data, checkpoint, trainer

def test_synthetic_batches_equal_jax():
    a = tdata.make_batches("synthetic", 64, 3, seed=11)
    b = jdata.make_batches("synthetic", 64, 3, seed=11, native=False)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_local_file_batches_equal_jax(tmp_path):
    p = tmp_path / "c.jsonl"
    p.write_text("\n".join('{"text": "%s"}' % ("doc %d " % i * 13) for i in range(9)))
    got = list(tdata.make_batches(str(p), 16, 2))
    want = list(jdata.make_batches(str(p), 16, 2, native=False))
    assert len(got) == len(want) > 0 and all(np.array_equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="fineweb"):
        next(tdata.make_batches("fineweb", 16, 2))


def test_checkpoint_round_trip_then_resume(tmp_path):
    _, tm, _, tp = _models(n_layers=1)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, steps=10)
    state = tts.init_train_state(tp, tcfg)
    step = tts.make_train_step(tm, tcfg)
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, 64, size=(3, 1, 2, 41)))
    state, _ = step(state, toks[0])
    save_checkpoint(str(tmp_path), 1, state)
    assert latest_step(str(tmp_path)) == 1 and latest_step(str(tmp_path / "none")) is None
    ref_state, _ = step(state, toks[1])               # continue from step 1
    want = params_to_numpy(ref_state.params)
    _, _, _, fresh = _models(n_layers=1)
    resumed = tts.init_train_state(fresh, tcfg)
    restore_checkpoint(str(tmp_path), resumed)
    assert int(resumed.step) == 1 and int(resumed.opt_state["count"]) == 1
    assert resumed.params["blocks"][0]["attn"]["W_Q"].data_ptr() == \
        resumed.params["blocks"][0]["attn"]["W_qkv"].data_ptr()      # views survive restore
    resumed, _ = step(resumed, toks[1])
    for a, b in zip(jax.tree.leaves(params_to_numpy(resumed.params)), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


def test_trainer_writes_csv_and_checkpoint_and_resumes(tmp_path):
    mcfg = ModelConfig(vocab_size=256, n_layers=1, nsa=NSAConfig(**BASE))
    tcfg = TrainConfig(steps=3, batch_size=2, seq_len=32, log_every=2, out_dir=str(tmp_path),
                       lr=1e-3, warmup_steps=1, eval_every=3)
    s = train(mcfg, tcfg, "synthetic", device="cpu")
    assert s["steps"] == 3 and np.isfinite(s["final_loss"]) and s["bad_steps"] == 0
    rows = (tmp_path / "training.csv").read_text().strip().splitlines()
    assert rows[0].startswith("step,loss") and [r.split(",")[0] for r in rows[1:]] == \
        ["1", "2", "3"]
    assert (tmp_path / "val.csv").exists() and (tmp_path / "heartbeat.jsonl").exists()
    assert latest_step(str(tmp_path / "ckpt")) == 3
    s = train(mcfg, dataclasses.replace(tcfg, steps=5), "synthetic", resume=True,
              device="cpu")
    assert s["steps"] == 5 and latest_step(str(tmp_path / "ckpt")) == 5
    (tmp_path / ".HALT").write_text("stop")
    s = train(mcfg, dataclasses.replace(tcfg, steps=9), "synthetic", resume=True,
              device="cpu")
    assert s["steps"] == 5                         # halted before any step


def test_trainer_cli_runs_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "nsa_vibe_tpu_torch.train.trainer", "--config",
         str(ROOT / "configs" / "m7c_125m.yaml"), "--data", "synthetic", "--device", "cpu",
         "--steps", "2", "--n-layers", "1", "--batch-size", "1", "--seq-len", "64",
         "--log-every", "1", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"steps": 2' in out.stdout and (tmp_path / "training.csv").exists()


def test_presets_match_jax_load_config():
    jm, jt, data = jload_config(str(ROOT / "configs" / "m7c_125m.yaml"))
    tm, tt, tdata_src = load_config(str(ROOT / "configs" / "m7c_125m.yaml"))
    assert data == tdata_src == "fineweb"
    assert M7C_125M.remat == jm.remat == tm.remat is True
    for k, v in dataclasses.asdict(jt).items():
        if k in TrainConfig.__dataclass_fields__:
            assert getattr(M7C_125M_TRAIN, k) == v == getattr(tt, k), k
    assert dataclasses.asdict(M7C_125M) == dataclasses.asdict(tm)


def test_trainer_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = ModelConfig(vocab_size=256, n_layers=1, nsa=NSAConfig(**BASE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(mcfg, TrainConfig(steps=1, out_dir=str(tmp_path)), "synthetic")
