"""The port's tensor parallelism (nsa_vibe_tpu_torch/parallel/, tp) vs the
JAX package (CPU, f32, gloo).

The ranks are tests/torch_parallel_worker.py processes under
torch.distributed.run (torch only), one launch each of 2, 4 and 8 ranks
for the module, and the dry-run twin (parallel/dryrun.py) on 4 ranks; the
JAX side runs here on the 8 virtual CPU devices of tests/conftest.py,
`kernel="reference"` with varlen_exact, the parameters the same through
convert.params_from_numpy. A 4-layer model (dim 48, 6 heads in 2 KV
groups): each tp = 2 member holds one group and 96 of the 192 MLP hidden
units. Held, each within 2e-5 (relative for the metrics, of each leaf's
max |value| for gradients and parameters):
  * tp = 2: the loss and every gradient (gathered over tp) vs one-device
    jax.value_and_grad; the gates (gathered over tp on the group axis) vs
    JAX's, and the selections as sets exactly;
  * three AdamW steps under tp = 2, tp x dp = 2 x 2 with fsdp, tp x sp =
    2 x 2 with varlen, pp x tp = 2 x 2 and pp x sp x tp = 2 x 2 x 2 (eight
    ranks) vs JAX's build_state_and_step on the same mesh and batches:
    loss, grad norm, gate stats and supervised tokens every step; every
    parameter after the last vs JAX's build_state_and_step on one device
    (the same mesh's GSPMD step rounds otherwise: after three steps at lr
    1e-2 its blocks/3/attn/W_V_sel is 2.28e-05 of the leaf's max from its
    own one-device step, where AdamW divides a near-zero gradient by its
    root mean square; the port's tp = 2 is 1.84e-06 from it); each rank
    holds 1/tp of every tp-sharded leaf (1/(tp dp) under fsdp) and all of
    the others;
  * a checkpoint saved under tp = 2 restores on one process, and under
    the mesh into a fresh tp state as the ranks held it;
  * tp = 4 with 2 KV groups raises the JAX pipeline's ValueError;
  * dryrun_multichip(4) runs and prints the JAX run's tail line.
"""

import json
import re
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
from nsa_vibe_tpu.parallel.pipeline import pipeline_model_loss, stack_blocks
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.parallel import train_step as pts
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
    {"name": "tp2_grads", "kind": "pp_grads", "dp": 1, "sp": 1, "tp": 2},
    {"name": "tp2", "kind": "steps", "dp": 1, "sp": 1, "tp": 2, "ckpt": True},
    {"name": "tp2_dp2_fsdp", "kind": "steps", "dp": 2, "sp": 1, "tp": 2, "fsdp": True},
    {"name": "tp2_sp2_varlen", "kind": "varlen_steps", "dp": 1, "sp": 2, "tp": 2},
    {"name": "pp2_tp2", "kind": "steps", "dp": 1, "sp": 1, "pp": 2, "tp": 2, "M": 4},
    {"name": "pp2_sp2_tp2", "kind": "steps", "dp": 1, "sp": 2, "pp": 2, "tp": 2},
]
STEP_RUNS = [r["name"] for r in RUNS if r["kind"] != "pp_grads"]
METRICS = ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac", "sel_k_mean",
           "sel_k_max")


def _jmodel():
    return JModelConfig(nsa=JNSAConfig(**NSA, kernel="reference", varlen_exact=True), **MODEL)


def _varlen_batches():
    """[STEPS, 1, B, ...] packed rows: documents of 5 to 60 tokens, one of
    them across S/2 (the sp shard boundary) in every step."""
    rng = np.random.RandomState(9)
    out = []
    for _ in range(STEPS):
        docs = [rng.randint(1, 64, size=n).astype(np.int32) for n in rng.randint(5, 60, 12)]
        toks, ds, lm = (a[:B] for a in jvarlen.pack_documents_aligned(docs, S, NSA["l_sel"], B))
        assert (ds[:, S // 2] < S // 2).any()
        out.append((toks[None], ds[None], lm[None]))
    return [np.stack(a) for a in zip(*out)]


def _flat(tree):
    return flatten(jax.tree.map(np.asarray, tree))


def _jax_references(jp, toks, vbatches) -> dict:
    """What the ranks are held to, from the JAX package: one-device
    value_and_grad (with the gates and selections) on tokens[0]; the
    parameters after three one-device steps (dense and varlen); each step
    run's metrics on its own mesh."""
    tok = jnp.asarray(toks[0, 0])

    def loss(p):
        logits, auxes = jtiny.model_forward(p, tok[:, :-1], _jmodel(), collect_aux=True)
        return jtiny.cross_entropy_loss(logits, tok[:, 1:]), auxes

    (jloss, auxes), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    ref = {"loss": float(jloss), "grads": _flat(jgrad),
           "gates": np.stack([np.asarray(a["gates"]) for a in auxes]),       # [L, B, S, G, 3]
           "sel_idx": np.stack([np.asarray(a["sel_idx"]) for a in auxes])}

    def batch(i, varlen, shard=None):
        put = (lambda a: jnp.asarray(a)) if shard is None else (
            lambda a: jax.device_put(jnp.asarray(a), shard))
        return tuple(put(a[i]) for a in vbatches) if varlen else put(toks[i])

    for varlen in (False, True):
        jt = JTrainConfig(**TRAIN, varlen=varlen)
        step_fn, state, _ = jts.build_state_and_step(jax.tree.map(np.array, jp), _jmodel(), jt)
        for i in range(STEPS):
            state, _ = step_fn(state, batch(i, varlen))
        ref[f"params:{varlen}"] = _flat(state.params)
    for cfg in RUNS:
        if cfg["kind"] == "pp_grads":
            continue
        dp, sp, pp, tp = cfg["dp"], cfg["sp"], cfg.get("pp", 1), cfg["tp"]
        varlen = cfg["kind"] == "varlen_steps"
        jt = JTrainConfig(**TRAIN, dp=dp, sp=sp, pp=pp, tp=tp, pp_microbatches=cfg.get("M", 0),
                          fsdp=cfg.get("fsdp", False), varlen=varlen)
        mesh = jmake_mesh(dp=dp, tp=tp, sp=sp, pp=pp, devices=jax.devices()[:dp * pp * sp * tp])
        # a copy: the step donates its state, and device_put may alias jp's arrays
        step_fn, state, shard = jts.build_state_and_step(jax.tree.map(np.array, jp), _jmodel(),
                                                         jt, mesh)
        mets = []
        for i in range(STEPS):
            state, met = step_fn(state, batch(i, varlen, shard))
            mets.append({k: np.asarray(v) for k, v in met.items()})
        ref[f"metrics:{cfg['name']}"] = mets
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Launches the worker with 2, 4 and 8 ranks and the dry run with 4
    (concurrently), computes the JAX references while they run, and
    returns (dir, JAX parameters, the references, the dry run's
    output)."""
    d = tmp_path_factory.mktemp("torch_tp")
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), _jmodel())
    np.savez(d / "params.npz", **{k: v.astype(np.float32) for k, v in
                                  flatten(jax.tree.map(np.asarray, jp)).items()})
    toks = np.random.RandomState(6).randint(0, 64, size=(STEPS, 1, B, S + 1)).astype(np.int32)
    np.save(d / "tokens.npy", toks)
    vtoks, vds, vlm = _varlen_batches()
    np.savez(d / "varlen.npz", tokens=vtoks, seq_start=vds, loss_mask=vlm)
    (d / "job.json").write_text(json.dumps({"model": {**MODEL, "nsa": NSA}, "train": TRAIN,
                                            "runs": RUNS}))
    procs = [launch([str(WORKER), str(d)], n, ROOT) for n in (2, 4, 8)]
    procs.append(launch(["-m", "nsa_vibe_tpu_torch.parallel.dryrun", "--device", "cpu"], 4, ROOT))
    try:
        ref = _jax_references(jp, toks, (vtoks, vds, vlm))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        stop(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return d, jp, ref, logs[-1]


def _load(d, name, rank=0):
    return np.load(d / f"{name}_rank{rank}.npz")


def _close_rel(a, b, rel, msg=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, atol=rel * max(np.abs(b).max(), 1e-12),
                               rtol=0, err_msg=msg)


def test_tp_loss_gradients_and_aux_match_jax(run):
    d, _, ref, _ = run
    for r in range(2):   # every tp member: the whole loss, gradients and aux
        z = _load(d, "tp2_grads", r)
        assert float(z["loss"]) == pytest.approx(ref["loss"], rel=TOL)
        for k, g in ref["grads"].items():
            _close_rel(z[f"grad:{k}"], g, TOL, k)
        np.testing.assert_allclose(z["gates"], ref["gates"], atol=TOL, rtol=0)
        assert torch.equal(canonicalize_sel(torch.from_numpy(z["sel_idx"])),
                           canonicalize_sel(torch.from_numpy(ref["sel_idx"])))


@pytest.mark.parametrize("name", STEP_RUNS)
def test_three_tp_steps_match_jax_build_state_and_step(run, name):
    d, _, ref, _ = run
    cfg = next(r for r in RUNS if r["name"] == name)
    dp, sp, pp, tp = cfg["dp"], cfg["sp"], cfg.get("pp", 1), cfg["tp"]
    fsdp, varlen = cfg.get("fsdp", False), cfg["kind"] == "varlen_steps"
    ranks = [_load(d, name, r) for r in range(dp * pp * sp * tp)]
    for i, met in enumerate(ref[f"metrics:{name}"]):
        for z in ranks:
            for k in METRICS:
                assert float(z[f"{k}:{i}"]) == pytest.approx(float(met[k]), rel=TOL,
                                                             abs=1e-6), (k, i)
            np.testing.assert_allclose(z[f"branch_shares:{i}"], met["branch_shares"], atol=1e-6)
            assert bool(z[f"good:{i}"]) and int(z[f"tokens:{i}"]) == int(met["tokens"])
    for k, v in ref[f"params:{varlen}"].items():
        _close_rel(ranks[0][f"param:{k}"], v, TOL, k)
    for z in ranks:   # a rank holds its slices only
        assert z["sharded"].any() == fsdp and z["tp_sharded"].sum() == 4 * MODEL["n_layers"] // pp
        tp_slice = z["whole_numel"] // np.where(z["tp_sharded"], tp, 1)
        assert np.array_equal(z["full_numel"], tp_slice)
        want = tp_slice // np.where(z["sharded"], dp, 1)
        for key in ("local_numel", "mu_numel", "nu_numel"):
            assert np.array_equal(z[key], want), key
        assert not z["tp_sharded"][z["top"]].any()


def test_tp_checkpoint_restores_on_one_process_and_under_the_mesh(run):
    d, jp, _, _ = run
    params = params_from_numpy(jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jp),
                               device="cpu")
    state = tts.init_train_state(params, TrainConfig(**TRAIN))
    restore_checkpoint(str(d / "tp2_ckpt"), state)
    z = _load(d, "tp2")
    assert int(state.step) == STEPS and int(state.opt_state["count"]) == STEPS
    for k, v in flatten(params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, z[f"param:{k}"], err_msg=k)
    assert all(float(m.abs().sum()) > 0 for m in state.opt_state["nu"])   # both members' moments
    assert all(bool(_load(d, "tp2", r)["restored_equal"]) for r in range(2))


def test_tp_that_does_not_divide_the_kv_groups_raises_as_jax():
    jmesh = jmake_mesh(dp=1, pp=2, tp=4, devices=jax.devices()[:8])
    jp = stack_blocks(jtiny.init_model_params(jax.random.PRNGKey(0), _jmodel()))
    tok = jnp.zeros((4, S + 1), jnp.int32)
    with pytest.raises(ValueError) as jerr:
        pipeline_model_loss(jp, tok, _jmodel(), jmesh)
    tm = ModelConfig(nsa=NSAConfig(**NSA), **MODEL)
    with pytest.raises(ValueError) as terr:
        pts.check_config(TrainConfig(**TRAIN, tp=4), mcfg=tm)
    assert str(terr.value) == str(jerr.value)
    pts.check_config(TrainConfig(**TRAIN, tp=2), mcfg=tm)


def test_dryrun_multichip_4_runs(run):
    log = run[-1]
    assert re.search(r"^dryrun_multichip\(4\): mesh 2x2 ok, loss=\d+\.\d{4}; pp train ok; pp x "
                     r"sp train ok; pp x tp train ok; pp x sp x tp train ok; cp prefill sp=4 "
                     r"ok$", log, re.M), log[-2000:]
    assert log.count("[dryrun]") == 3 and "relative gap" in log
