"""The port's parallel training (nsa_vibe_tpu_torch/parallel/) vs the JAX
package (CPU, f32, gloo).

The port's ranks are processes: one fixture launches
tests/torch_parallel_worker.py (torch only, no JAX) under
torch.distributed.run with 2 and with 4 ranks, once for the module; the
inputs and results go through .npy/.npz files. The JAX side runs here on
the virtual CPU devices of tests/conftest.py, `kernel="reference"` with
varlen_exact (the port's avg ϕ is window-exact). Held:
  * sp = 2: context_parallel_model_forward's logits vs JAX's
    context_parallel_model_forward on a 2-device mesh and vs the port's
    single-process model_forward, and one layer's context_parallel_prefill
    vs nsa_prefill (MAE < 2e-5), on both routes (the fused
    scorer, and select_blocks beside compressed_attention); the gradients
    of the global mean cross entropy vs jax.value_and_grad within 2e-5 of
    each leaf's max |value|; the same under varlen (packed documents,
    one crossing the shard boundary at S/2) vs JAX's
    context_parallel_model_forward(seq_start=) and the port's single-process
    model_forward(seq_start=);
  * three AdamW steps under dp = 2, fsdp = 2, dp x sp = 2 x 2, fsdp x sp
    = 2 x 2 and varlen batches under dp = 2 and under dp x sp = 2 x 2 vs
    JAX's build_state_and_step
    on the same mesh and batches: loss, grad norm and gate stats within
    2e-5 relative, every parameter within 2e-5 of its leaf's max |value|
    after the last step; each fsdp rank holds 1/dp of every sharded leaf
    and of both its moments; also fsdp x sp vs the port's dp x sp;
  * varlen batches under dp = 2 vs the port's single-device varlen step
    (the loss is the global masked mean, not a mean of rank means);
  * a checkpoint saved under fsdp restores on one process;
  * load_config reads dp, sp, pp, pp_microbatches, tp, fsdp and varlen with
    sp, and raises on a tp that does not divide the KV groups.
"""

import dataclasses
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
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu.parallel.context import context_parallel_model_forward as jcp_forward
from nsa_vibe_tpu.parallel.mesh import make_mesh as jmake_mesh
from nsa_vibe_tpu.ops import varlen as jvarlen
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.train.trainer import load_config
from nsa_vibe_tpu_torch.utils.checkpoint import restore_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_worker import flatten, launch, stop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
NSA = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4, w=16)
MODEL = dict(vocab_size=64, n_layers=2, remat=True)
TRAIN = dict(lr=1e-2, warmup_steps=1, steps=10, batch_size=4, seq_len=64, weight_decay=0.01,
             fsdp_min_size=16)
S, B, STEPS = 64, 4, 3
TOL = 2e-5
RUNS = [
    {"name": "fwd", "kind": "forward", "dp": 1, "sp": 2},
    {"name": "fwd_long", "kind": "forward", "dp": 1, "sp": 2, "max_s_sel": 2},
    {"name": "fwd_varlen", "kind": "forward", "dp": 1, "sp": 2, "varlen": True},
    {"name": "fwd_varlen_long", "kind": "forward", "dp": 1, "sp": 2, "varlen": True,
     "max_s_sel": 2},
    {"name": "dp2", "kind": "steps", "dp": 2, "sp": 1},
    {"name": "fsdp2", "kind": "steps", "dp": 2, "sp": 1, "fsdp": True, "ckpt": True},
    {"name": "varlen_dp2", "kind": "varlen_steps", "dp": 2, "sp": 1},
    {"name": "dpsp", "kind": "steps", "dp": 2, "sp": 2},
    {"name": "fsdpsp", "kind": "steps", "dp": 2, "sp": 2, "fsdp": True},
    {"name": "varlen_dpsp", "kind": "varlen_steps", "dp": 2, "sp": 2},
]


def _jmodel():
    return JModelConfig(nsa=JNSAConfig(**NSA, kernel="reference", varlen_exact=True), **MODEL)


def _tmodel():
    return ModelConfig(nsa=NSAConfig(**NSA), **MODEL)


def _varlen_batches():
    """[STEPS, 1, B, ...] packed rows: documents of 5 to 60 tokens (every
    step has one that starts before S/2 and goes on past it, on both sp
    ranks' rows)."""
    rng = np.random.RandomState(9)
    out = []
    for _ in range(STEPS):
        docs = [rng.randint(1, 64, size=n).astype(np.int32) for n in rng.randint(5, 60, 12)]
        toks, ds, lm = (a[:B] for a in jvarlen.pack_documents_aligned(docs, S, NSA["l_sel"], B))
        out.append((toks[None], ds[None], lm[None]))
        assert (ds[:, S // 2] < S // 2).any() and lm[:, S // 2].any()
    return [np.stack(a) for a in zip(*out)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Launches the worker with 2 and with 4 ranks (concurrently) and
    returns (dir, JAX parameters, tokens, varlen batches)."""
    d = tmp_path_factory.mktemp("torch_parallel")
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


def _jax_tree_flat(tree):
    return flatten(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name", ["fwd", "fwd_long", "fwd_varlen", "fwd_varlen_long"])
def test_sp_forward_and_gradients_match_jax(run, name):
    d, jp, toks, (vtoks, vds, vlm) = run
    jm = _jmodel()
    mesh = jmake_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    varlen = "varlen" in name
    tok = jnp.asarray(vtoks[0, 0] if varlen else toks[0, 0])
    ds, lm = (jnp.asarray(vds[0, 0]), jnp.asarray(vlm[0, 0])) if varlen else (None, None)

    def loss(p):
        logits = jcp_forward(p, tok[:, :-1], jm, mesh, seq_start=ds)
        return jtiny.cross_entropy_loss(logits, tok[:, 1:], mask=lm), logits

    (_, jlogits), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    ranks = [_load(d, name, r) for r in range(2)]
    logits = np.concatenate([z["logits"] for z in ranks], axis=1)
    assert np.abs(logits - np.asarray(jlogits)).mean() < TOL
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    with torch.no_grad():
        single, _ = ttiny.model_forward(
            tp, torch.from_numpy(np.array(tok)[:, :-1]).long(), _tmodel(),
            seq_start=None if ds is None else torch.from_numpy(np.array(ds)))
    assert np.abs(logits - single.double().numpy()).mean() < TOL
    for k, g in _jax_tree_flat(jgrad).items():
        for z in ranks:               # every rank holds the summed gradients
            _close_rel(z[f"grad:{k}"], g, TOL, k)
    if varlen:
        return
    with torch.no_grad():    # one layer: context_parallel_prefill vs nsa_prefill
        x = tp["embed"][torch.from_numpy(toks[0, 0, :, :-1]).long()]
        layer, _ = tnsa.nsa_prefill(tp["blocks"][0]["attn"], x, _tmodel().nsa)
    got = np.concatenate([z["layer"] for z in ranks], axis=1)
    assert np.abs(got - layer.double().numpy()).mean() < TOL


@pytest.mark.parametrize("name", ["dp2", "fsdp2", "dpsp", "fsdpsp", "varlen_dp2", "varlen_dpsp"])
def test_three_steps_match_jax_build_state_and_step(run, name):
    d, jp, toks, vbatches = run
    cfg = next(r for r in RUNS if r["name"] == name)
    dp, sp, fsdp = cfg["dp"], cfg["sp"], cfg.get("fsdp", False)
    varlen = cfg["kind"] == "varlen_steps"
    jm = _jmodel()
    jt = JTrainConfig(**TRAIN, dp=dp, sp=sp, fsdp=fsdp, varlen=varlen)
    mesh = jmake_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    # a copy: the step donates its state, and device_put may alias the fixture's arrays
    step_fn, state, shard = jts.build_state_and_step(jax.tree.map(np.array, jp), jm, jt, mesh)
    ranks = [_load(d, name, r) for r in range(dp * sp)]
    for i in range(STEPS):
        if varlen:   # (tokens, seq_start, loss_mask), each [1, B, ...] split over dp
            batch = tuple(jax.device_put(jnp.asarray(a[i]), shard) for a in vbatches)
        else:
            batch = jax.device_put(jnp.asarray(toks[i]), shard)
        state, met = step_fn(state, batch)
        for z in ranks:
            for k in ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac",
                      "sel_k_mean", "sel_k_max"):
                assert float(z[f"{k}:{i}"]) == pytest.approx(float(met[k]), rel=TOL,
                                                             abs=1e-6), (k, i)
            np.testing.assert_allclose(z[f"branch_shares:{i}"], np.asarray(met["branch_shares"]),
                                       atol=1e-6)
            assert bool(z[f"good:{i}"]) and int(z[f"tokens:{i}"]) == int(met["tokens"])
    for k, v in _jax_tree_flat(state.params).items():
        _close_rel(ranks[0][f"param:{k}"], v, TOL, k)
    for z in ranks:
        sharded = z["sharded"]
        assert sharded.any() == fsdp
        want = np.where(sharded, z["full_numel"] // dp, z["full_numel"])
        for key in ("local_numel", "mu_numel", "nu_numel"):
            assert np.array_equal(z[key], want), key


def test_fsdp_with_sp_equals_dp_with_sp(run):
    d = run[0]
    a, b = _load(d, "fsdpsp"), _load(d, "dpsp")
    for k in b.files:
        if k.startswith(("param:", "loss:", "grad_norm:")):
            _close_rel(a[k], b[k], TOL, k)   # the sums' order differs
    assert a["sharded"].any() and not b["sharded"].any()


def test_varlen_dp_steps_match_one_device(run):
    d, jp, _, (vtoks, vds, vlm) = run
    tm = _tmodel()
    tcfg = TrainConfig(**TRAIN, varlen=True)
    state = tts.init_train_state(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
                                 tcfg)
    step = tts.make_train_step(tm, tcfg)
    z = _load(d, "varlen_dp2")
    for i in range(STEPS):
        state, met = step(state, (torch.from_numpy(vtoks[i]).long(),
                                  torch.from_numpy(vds[i]).int(),
                                  torch.from_numpy(vlm[i]).float()))
        assert float(z[f"loss:{i}"]) == pytest.approx(float(met["loss"]), rel=TOL), i
        assert int(z[f"tokens:{i}"]) == int(met["tokens"])
    for k, v in flatten(params_to_numpy(state.params)).items():
        _close_rel(z[f"param:{k}"], v, TOL, k)


def test_fsdp_checkpoint_restores_on_one_process(run):
    d, jp, _, _ = run
    tp = params_from_numpy(jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jp),
                           device="cpu")
    state = tts.init_train_state(tp, TrainConfig(**TRAIN))
    restore_checkpoint(str(d / "fsdp2_ckpt"), state)
    z = _load(d, "fsdp2")
    assert int(state.step) == STEPS and int(state.opt_state["count"]) == STEPS
    for k, v in flatten(params_to_numpy(state.params)).items():
        np.testing.assert_array_equal(v, z[f"param:{k}"], err_msg=k)
    assert all(m.shape == t.shape for m, (_, t) in
               zip(state.opt_state["mu"], tts.param_leaves(state.params)))


def test_load_config_reads_the_parallel_keys(tmp_path):
    yaml = pytest.importorskip("yaml")
    base = {"model": {"n_layers": 1}, "train": {"dp": 2, "sp": 2, "fsdp": True,
                                                 "fsdp_min_size": 256}}
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump(base))
    _, tcfg, _ = load_config(str(p))
    assert (tcfg.dp, tcfg.sp, tcfg.fsdp, tcfg.fsdp_min_size) == (2, 2, True, 256)
    jfields = {f.name for f in dataclasses.fields(JTrainConfig)}
    assert {"dp", "sp", "tp", "pp", "fsdp", "fsdp_min_size"} <= jfields
    p.write_text(yaml.safe_dump({"train": {"tp": 2}}))
    assert load_config(str(p))[1].tp == 2
    p.write_text(yaml.safe_dump({"train": {"tp": 4}}))
    with pytest.raises(ValueError, match="tp=4 must divide n_kv_groups=2"):
        load_config(str(p))
    p.write_text(yaml.safe_dump({"train": {"pp": 2, "pp_microbatches": 4, "sp": 2,
                                           "varlen": True}}))
    _, tcfg, _ = load_config(str(p))
    assert (tcfg.pp, tcfg.pp_microbatches, tcfg.sp, tcfg.varlen) == (2, 4, 2, True)
    assert {"pp_microbatches", "varlen"} <= jfields
    _, tcfg, _ = load_config(str(ROOT / "configs" / "m7c_125m_pod.yaml"))
    assert (tcfg.dp, tcfg.fsdp, tcfg.seq_len, tcfg.batch_size) == (4, True, 4096, 32)
