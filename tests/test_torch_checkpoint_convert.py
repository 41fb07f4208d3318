"""scripts/convert_checkpoint.py: train-state checkpoints both ways between
the JAX package (orbax) and the port (step_<n>.pt).

Three steps in one package, a converted checkpoint, and the fourth step in
the other package must match the first package's own fourth step within
2e-5 (per leaf, of the leaf's largest |value|; parameters and both
moments, f32); JAX -> port -> JAX returns identical bits (bf16, so the
f32 transit is exercised); unequal optax counts and the pipeline's stacked
layout raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu.parallel.pipeline import stack_blocks
from nsa_vibe_tpu.train.trainer import load_config as jload_config
from nsa_vibe_tpu.utils import checkpoint as jckpt
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.train.trainer import load_config
from nsa_vibe_tpu_torch.utils import checkpoint as tckpt
from scripts import convert_checkpoint as cc

TOL = 2e-5
CONFIG = """model: {vocab_size: 64, n_layers: 2, dtype: DTYPE}
nsa: {dim: 48, n_heads: 6, n_kv_groups: 2, d_k: 16, d_v: 16, l: 8, d: 4, l_sel: 16, n_sel: 4,
      w: 16, varlen_exact: true}
train: {lr: 1.0e-2, warmup_steps: 1, steps: 10, batch_size: 2, seq_len: 40,
        weight_decay: 0.01}
"""


def _config(tmp_path, dtype="float32"):
    path = tmp_path / f"model_{dtype}.yaml"
    path.write_text(CONFIG.replace("DTYPE", dtype))
    return str(path)


def _jax_cfgs(config):
    jm, jt, _ = jload_config(config)
    return dataclasses.replace(jm, nsa=dataclasses.replace(jm.nsa, kernel="reference")), jt


def _close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k, b in want.items():
        a, b = np.asarray(got[k], np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, atol=TOL * max(np.abs(b).max(), 1e-12), rtol=0,
                                   err_msg=f"{what} {k}")


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_flat(state) -> dict:
    adam, sched = cc._optimizer_nodes(state.opt_state)
    assert int(adam.count) == int(sched.count)
    return {"params": _flat(state.params), "mu": _flat(adam.mu), "nu": _flat(adam.nu),
            "count": int(adam.count), "step": int(state.step)}


def _port_flat(state) -> dict:
    return {"params": _flat(params_to_numpy(state.params)),
            **{k: _flat(params_to_numpy(tts.tree_from_leaves(state.params,
                                                             state.opt_state[k])))
               for k in ("mu", "nu")},
            "count": int(state.opt_state["count"]), "step": int(state.step)}


def _same_state(got: dict, want: dict, what: str):
    assert (got["count"], got["step"]) == (want["count"], want["step"]), what
    for k in ("params", "mu", "nu"):
        _close(got[k], want[k], f"{what} {k}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four steps in each package from the same parameters and batches; each
    package's checkpoint after three steps and its state after four."""
    d = tmp_path_factory.mktemp("convert")
    config = _config(d)
    jm, jt = _jax_cfgs(config)
    tm, tt, _ = load_config(config)
    toks = np.random.RandomState(6).randint(0, 64, size=(4, 1, 2, 41)).astype(np.int32)
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    jstep = jax.jit(jts.make_train_step(jm, jt))
    jstate = jts.init_train_state(jp, jt)
    tstate = tts.init_train_state(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                                  tt)
    tstep = tts.make_train_step(tm, tt)
    for i, t in enumerate(toks):
        if i == 3:
            jckpt.save_checkpoint(str(d / "jax"), 3, jstate)
            tckpt.save_checkpoint(str(d / "torch"), 3, tstate)
        jstate, _ = jstep(jstate, jnp.asarray(t))
        tstate, _ = tstep(tstate, torch.from_numpy(t).long())
    return dict(dir=d, config=config, toks=toks, jstep=jstep, tstep=tstep, tm=tm, tt=tt,
                jstate=jstate, jax4=_jax_flat(jstate), torch4=_port_flat(tstate))


def test_jax_checkpoint_then_a_port_step_matches_jax(runs):
    d = runs["dir"]
    path = cc.jax_to_torch(runs["config"], str(d / "jax"), str(d / "j2t"))
    assert path.endswith("step_3.pt") and tckpt.latest_step(str(d / "j2t")) == 3
    params = params_from_numpy(jax.tree.map(np.asarray, jtiny.init_model_params(
        jax.random.PRNGKey(1), _jax_cfgs(runs["config"])[0])), device="cpu")
    state = tckpt.restore_checkpoint(str(d / "j2t"), tts.init_train_state(params, runs["tt"]))
    assert int(state.step) == 3 and int(state.opt_state["count"]) == 3
    state, _ = runs["tstep"](state, torch.from_numpy(runs["toks"][3]).long())
    _same_state(_port_flat(state), runs["jax4"], "port step 4 from JAX's step 3")


def test_port_checkpoint_then_a_jax_step_matches_the_port(runs):
    d = runs["dir"]
    path = cc.torch_to_jax(runs["config"], str(d / "torch"), str(d / "t2j"))
    assert path.endswith("step_3")
    state = jckpt.restore_checkpoint(str(d / "t2j"), runs["jstate"])
    assert int(state.step) == 3
    state, _ = runs["jstep"](state, jnp.asarray(runs["toks"][3]))
    _same_state(_jax_flat(state), runs["torch4"], "JAX step 4 from the port's step 3")


def _bf16_state(config, counts=(3, 3)):
    """A bf16 JAX train state with random moments, adam count and schedule
    count as given, step 5."""
    jm, jt = _jax_cfgs(config)
    state = jts.init_train_state(jtiny.init_model_params(jax.random.PRNGKey(2), jm,
                                                         jnp.bfloat16), jt)
    rng = np.random.RandomState(3)

    def rand(x):
        return jnp.asarray(rng.randn(*x.shape) * 1e-3, x.dtype)

    def fill(node):
        if isinstance(node, optax.ScaleByAdamState):
            return node._replace(count=jnp.int32(counts[0]), mu=jax.tree.map(rand, node.mu),
                                 nu=jax.tree.map(lambda x: jnp.abs(rand(x)), node.nu))
        if isinstance(node, optax.ScaleByScheduleState):
            return node._replace(count=jnp.int32(counts[1]))
        return node

    return state._replace(opt_state=jax.tree.map(fill, state.opt_state, is_leaf=cc._is_state),
                          step=jnp.int32(5))


def test_jax_to_port_to_jax_is_bit_identical(tmp_path):
    config = _config(tmp_path, "bfloat16")
    state = _bf16_state(config)
    jckpt.save_checkpoint(str(tmp_path / "a"), 5, state)
    cc.main(["jax-to-torch", "--config", config, str(tmp_path / "a"), str(tmp_path / "b")])
    cc.main(["torch-to-jax", "--config", config, str(tmp_path / "b"), "--step", "5",
             str(tmp_path / "c")])
    back = jckpt.restore_checkpoint(str(tmp_path / "c"), state)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a, np.float32),
                                                     np.asarray(b, np.float32))
    assert any(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(state.params))


def test_unequal_optax_counts_raise(tmp_path):
    config = _config(tmp_path, "bfloat16")
    jckpt.save_checkpoint(str(tmp_path / "a"), 5, _bf16_state(config, counts=(3, 2)))
    with pytest.raises(ValueError, match="schedule count 2 differ"):
        cc.jax_to_torch(config, str(tmp_path / "a"), str(tmp_path / "b"))
    assert tckpt.latest_step(str(tmp_path / "b")) is None


def test_the_pipeline_layout_raises(tmp_path):
    config = _config(tmp_path)
    jm, jt = _jax_cfgs(config)
    params = stack_blocks(jtiny.init_model_params(jax.random.PRNGKey(0), jm))
    jckpt.save_checkpoint(str(tmp_path / "a"), 1, jts.init_train_state(params, jt))
    with pytest.raises(ValueError, match="stacked"):
        cc.jax_to_torch(config, str(tmp_path / "a"), str(tmp_path / "b"))
