"""The port's pipeline parallelism (nsa_vibe_tpu_torch/parallel/pipeline.py)
vs the JAX package's (CPU, f32, gloo).

The ranks are tests/torch_parallel_worker.py processes under
torch.distributed.run (torch only), one launch of 2 and one of 4 ranks
for the module, concurrent; the JAX side runs here on the 8 virtual CPU
devices of tests/conftest.py, `kernel="reference"` with varlen_exact, the
parameters the same through convert.params_from_numpy. A 4-layer model
(2 blocks a stage). Held, each within 2e-5 (relative for the metrics, of
each leaf's max |value| for gradients and parameters):
  * pp = 2 at M = 2 and 4 micro-batches: the loss and every gradient vs
    jax.value_and_grad of pipeline_model_loss; each stage's gates vs its
    layers of pipeline_model_loss(collect_aux=True), and its selections as
    sets exactly;
  * three AdamW steps under pp = 2, pp x dp = 2 x 2, pp = 2 with fsdp
    over dp = 2, pp = 2 with varlen, pp x sp = 2 x 2 and pp x sp = 2 x 2
    with varlen vs JAX's build_state_and_step on the same mesh and
    batches: loss, grad norm, gate stats and supervised tokens every step,
    every parameter after the last; each fsdp rank holds 1/dp of every
    sharded block leaf and none of the top-level leaves;
  * a checkpoint saved under pp = 2 restores on one process.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.core.config import TrainConfig as JTrainConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.ops import varlen as jvarlen
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu.parallel.mesh import make_mesh as jmake_mesh
from nsa_vibe_tpu.parallel.pipeline import pipeline_model_loss, stack_blocks, unstack_blocks
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import TrainConfig
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.utils.checkpoint import restore_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_worker import flatten, launch, stop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
NSA = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4, w=16)
MODEL = dict(vocab_size=64, n_layers=4, remat=True)
TRAIN = dict(lr=1e-2, warmup_steps=1, steps=10, batch_size=4, seq_len=64, weight_decay=0.01,
             fsdp_min_size=16)
S, B, STEPS = 64, 4, 3
TOL = 2e-5
RUNS = [
    {"name": "pp2_m2", "kind": "pp_grads", "dp": 1, "sp": 1, "pp": 2, "M": 2},
    {"name": "pp2_m4", "kind": "pp_grads", "dp": 1, "sp": 1, "pp": 2, "M": 4},
    {"name": "pp2", "kind": "steps", "dp": 1, "sp": 1, "pp": 2, "ckpt": True},
    {"name": "pp2_varlen", "kind": "varlen_steps", "dp": 1, "sp": 1, "pp": 2, "M": 4},
    {"name": "pp2_dp2", "kind": "steps", "dp": 2, "sp": 1, "pp": 2},
    {"name": "pp2_fsdp", "kind": "steps", "dp": 2, "sp": 1, "pp": 2, "fsdp": True},
    {"name": "pp2_sp2", "kind": "steps", "dp": 1, "sp": 2, "pp": 2, "M": 4},
    {"name": "pp2_sp2_varlen", "kind": "varlen_steps", "dp": 1, "sp": 2, "pp": 2},
]
METRICS = ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac", "sel_k_mean",
           "sel_k_max")


def _jmodel():
    return JModelConfig(nsa=JNSAConfig(**NSA, kernel="reference", varlen_exact=True), **MODEL)


def _varlen_batches():
    """[STEPS, 1, B, ...] packed rows: documents of 5 to 60 tokens, one of
    them across S/2 in every step."""
    rng = np.random.RandomState(9)
    out = []
    for _ in range(STEPS):
        docs = [rng.randint(1, 64, size=n).astype(np.int32) for n in rng.randint(5, 60, 12)]
        toks, ds, lm = (a[:B] for a in jvarlen.pack_documents_aligned(docs, S, NSA["l_sel"], B))
        assert (ds[:, S // 2] < S // 2).any()
        out.append((toks[None], ds[None], lm[None]))
    return [np.stack(a) for a in zip(*out)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Launches the worker with 2 and with 4 ranks (concurrently) and
    returns (dir, JAX parameters, tokens, varlen batches)."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), _jmodel())
    np.savez(d / "params.npz", **{k: v.astype(np.float32) for k, v in
                                  flatten(jax.tree.map(np.asarray, jp)).items()})
    toks = np.random.RandomState(6).randint(0, 64, size=(STEPS, 1, B, S + 1)).astype(np.int32)
    np.save(d / "tokens.npy", toks)
    vtoks, vds, vlm = _varlen_batches()
    np.savez(d / "varlen.npz", tokens=vtoks, seq_start=vds, loss_mask=vlm)
    (d / "job.json").write_text(json.dumps({"model": {**MODEL, "nsa": NSA}, "train": TRAIN,
                                            "runs": RUNS}))
    procs = [launch([str(WORKER), str(d)], n, ROOT) for n in (2, 4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        stop(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return d, jp, toks, (vtoks, vds, vlm)


def _load(d, name, rank=0):
    return np.load(d / f"{name}_rank{rank}.npz")


def _close_rel(a, b, rel, msg=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, atol=rel * max(np.abs(b).max(), 1e-12),
                               rtol=0, err_msg=msg)


def _flat_unstacked(tree):
    return flatten(jax.tree.map(np.asarray, unstack_blocks(tree, MODEL["n_layers"])))


@pytest.mark.parametrize("name,M", [("pp2_m2", 2), ("pp2_m4", 4)])
def test_pp_loss_gradients_and_aux_match_jax(run, name, M):
    d, jp, toks, _ = run
    mesh = jmake_mesh(dp=1, pp=2, devices=jax.devices()[:2])
    tok = jnp.asarray(toks[0, 0])

    def loss(p):
        return pipeline_model_loss(p, tok, _jmodel(), mesh, microbatches=M)[0]

    stacked = stack_blocks(jp)
    jloss, jgrad = jax.jit(jax.value_and_grad(loss))(stacked)
    _, (gates, sel) = jax.jit(lambda p: pipeline_model_loss(p, tok, _jmodel(), mesh,
                                                            microbatches=M,
                                                            collect_aux=True))(stacked)
    ranks = [_load(d, name, r) for r in range(2)]
    for z in ranks:
        assert float(z["loss"]) == pytest.approx(float(jloss), rel=TOL)
        for k, g in _flat_unstacked(jgrad).items():
            _close_rel(z[f"grad:{k}"], g, TOL, k)
    got_gates = np.concatenate([z["gates"] for z in ranks])        # stages in layer order
    np.testing.assert_allclose(got_gates, np.asarray(gates), atol=TOL, rtol=0)
    got_sel = torch.from_numpy(np.concatenate([z["sel_idx"] for z in ranks]))
    assert torch.equal(canonicalize_sel(got_sel), canonicalize_sel(torch.from_numpy(
        np.array(sel))))


@pytest.mark.parametrize("name", [r["name"] for r in RUNS if r["kind"] != "pp_grads"])
def test_three_pp_steps_match_jax_build_state_and_step(run, name):
    d, jp, toks, vbatches = run
    cfg = next(r for r in RUNS if r["name"] == name)
    dp, sp, pp, fsdp = cfg["dp"], cfg["sp"], cfg["pp"], cfg.get("fsdp", False)
    varlen = cfg["kind"] == "varlen_steps"
    jt = JTrainConfig(**TRAIN, dp=dp, sp=sp, pp=pp, pp_microbatches=cfg.get("M", 0), fsdp=fsdp,
                      varlen=varlen)
    mesh = jmake_mesh(dp=dp, pp=pp, sp=sp, devices=jax.devices()[:dp * pp * sp])
    step_fn, state, shard = jts.build_state_and_step(jax.tree.map(np.array, jp), _jmodel(), jt,
                                                     mesh)
    ranks = [_load(d, name, r) for r in range(dp * pp * sp)]
    for i in range(STEPS):
        if varlen:
            batch = tuple(jax.device_put(jnp.asarray(a[i]), shard) for a in vbatches)
        else:
            batch = jax.device_put(jnp.asarray(toks[i]), shard)
        state, met = step_fn(state, batch)
        for z in ranks:
            for k in METRICS:
                assert float(z[f"{k}:{i}"]) == pytest.approx(float(met[k]), rel=TOL,
                                                             abs=1e-6), (k, i)
            np.testing.assert_allclose(z[f"branch_shares:{i}"], np.asarray(met["branch_shares"]),
                                       atol=1e-6)
            assert bool(z[f"good:{i}"]) and int(z[f"tokens:{i}"]) == int(met["tokens"])
    for k, v in _flat_unstacked(state.params).items():
        _close_rel(ranks[0][f"param:{k}"], v, TOL, k)
    for z in ranks:
        assert z["sharded"].any() == fsdp
        want = np.where(z["sharded"], z["full_numel"] // dp, z["full_numel"])
        for key in ("local_numel", "mu_numel", "nu_numel"):
            assert np.array_equal(z[key], want), key
        assert z["top"].sum() == 3 and not z["sharded"][z["top"]].any()


def test_pp_checkpoint_restores_on_one_process(run):
    d, jp, _, _ = run
    tp = params_from_numpy(jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jp),
                           device="cpu")
    state = tts.init_train_state(tp, TrainConfig(**TRAIN))
    restore_checkpoint(str(d / "pp2_ckpt"), state)
    z = _load(d, "pp2")
    assert int(state.step) == STEPS and int(state.opt_state["count"]) == STEPS
    for k, v in flatten(params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, z[f"param:{k}"], err_msg=k)
    assert all(float(m.abs().sum()) > 0 for m in state.opt_state["nu"])   # every stage's moments
