"""One rank of the port's parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_pipeline.py, tests/test_torch_tensor_parallel.py).

Run under torch.distributed.run (gloo, CPU): imports torch and the port
only, never JAX. Reads DIR/job.json (configs and runs), DIR/params.npz
(the JAX package's parameters, path-keyed), DIR/tokens.npy and
DIR/varlen.npz; for each run whose dp * pp * sp * tp is the world size
writes DIR/<run>_rank<r>.npz.

Runs:
  forward: logits of the rank's rows from context_parallel_model_forward,
    the output of one layer's context_parallel_prefill on its embedded
    rows, and the gradients of the global mean cross entropy (each rank's share
    back-propagated, then summed over ranks), from tokens[0, 0]; with
    "varlen" from varlen.npz's first batch (the masked mean, the whole
    rows' seq_start on every sp rank; no single layer);
  pp_grads: the loss, the whole model's gradients (gathered over dp, tp
    and pp) and the rank's layers' gates and selections ([L/pp, B/dp,
    S/sp, G, *], every KV group) of one step (parallel/train_step.py::
    grads_and_stats; under pp its schedule), from tokens[0] (with
    "varlen" from varlen.npz's first batch);
  steps: one AdamW step per tokens[i] through build_state_and_step (each
    rank its local_batch): the metrics of each step, the full parameters
    after the last, the local leaves' and moments' sizes and which leaves
    shard over dp and over tp; with "ckpt" a checkpoint saved under the
    mesh into DIR/<run>_ckpt and restored under it into a fresh state
    (every local leaf and moment equal to the ranks');
  varlen_steps: the same over DIR/varlen.npz's packed batches (tokens,
    seq_start, loss_mask), each rank its local_batch.
A run's "max_s_sel" lowers select_cmp.SELECT_CMP_MAX_S_SEL, forcing the
long route (select_blocks beside compressed_attention); "pp" and "M"
(pp_microbatches) set the pipeline, "tp" the tensor-parallel ranks.

`launch` and `stop` start and end torch.distributed.run for the tests.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_numden
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as select_cmp_mod
from nsa_vibe_tpu_torch.parallel import pipeline
from nsa_vibe_tpu_torch.parallel import train_step as pts
from nsa_vibe_tpu_torch.parallel.context import (
    context_parallel_model_forward, context_parallel_prefill,
)
from nsa_vibe_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from nsa_vibe_tpu_torch.train.train_step import param_leaves, tree_from_leaves
from nsa_vibe_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


def launch(args, n: int, root) -> subprocess.Popen:
    """torch.distributed.run of `args` with n ranks on the CPU (one thread
    each), from `root`, leading a new process group; `stop` ends it."""
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={n}", *args], env=env, cwd=root,
                            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def stop(procs) -> None:
    """Ends each launcher that still runs (after a timeout or a failed
    test) and its ranks, which a kill of the launcher alone would leave
    holding the CPU: SIGTERM first, on which torch.distributed.run stops
    the ranks it started (it may start each in a session of its own, out
    of reach of its process group), then SIGKILL of the launcher's group."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=60)
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def unflatten(flat: dict) -> dict:
    """{"a/b/0/c": array} -> nested dicts and lists."""
    root: dict = {}
    for key, v in flat.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [lists(n[str(i)]) for i in range(len(n))]
            return {k: lists(v) for k, v in n.items()}
        return n
    return lists(root)


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flatten(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, dtype=np.float64)}


def _tensors(batch):
    """A numpy batch (tokens or (tokens, seq_start, loss_mask)) as tensors."""
    if isinstance(batch, (tuple, list)):
        toks, ds, lm = batch
        return (torch.from_numpy(toks).long(), torch.from_numpy(ds).int(),
                torch.from_numpy(lm).float())
    return torch.from_numpy(batch).long()


def forward_run(params_np, batch, mcfg, mesh):
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    varlen = isinstance(batch, tuple)
    row, ds, lm = (pts.local_batch(_tensors(batch), mesh) if varlen
                   else (pts.local_batch(_tensors(batch), mesh), None, None))
    logits, _ = context_parallel_model_forward(params, row[:, :-1], mcfg, mesh, seq_start=ds)
    num, _ = cross_entropy_numden(logits, row[:, 1:], lm)
    if varlen:
        den = lm.sum()
        dist.all_reduce(den)
    else:
        den = float(row[:, 1:].numel() * mesh.world)
    grads = torch.autograd.grad(num / den, leaves)
    for g in grads:
        dist.all_reduce(g)
    out = {"logits": logits.detach().double().numpy()}
    if not varlen:
        with torch.no_grad():   # one layer's sequence-sharded prefill of the embedded rows
            x = params["embed"][row[:, :-1]]
            out["layer"] = context_parallel_prefill(params["blocks"][0]["attn"], x, mcfg.nsa,
                                                    mesh).double().numpy()
    out.update({f"grad:{k}": v for k, v in
                flatten(params_to_numpy(tree_from_leaves(params, list(grads)))).items()})
    return out


def pp_grads_run(params_np, batch, mcfg, tcfg, mesh):
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    state = pts.build_state(params, tcfg, mesh)
    local = pts.local_batch(_tensors(batch), mesh)
    loss, grads, _, _, _, _ = pts.grads_and_stats(state, mcfg, tcfg, mesh, local)
    full = pts.gather_full(state, mesh, grads)
    out = {"loss": np.asarray(float(loss))}
    out.update({f"grad:{k}": v for k, v in
                flatten(params_to_numpy(tree_from_leaves(state.full_template, full))).items()})
    with torch.no_grad():   # the rank's layers' gates and selections, micro-batches in order
        p, block = pts._params_and_block(state, mesh)
        toks, ds, lm = ((a[0] for a in local) if tcfg.varlen else (local[0], None, None))
        if mesh.pp == 1:
            _, auxes = context_parallel_model_forward(p, toks[:, :-1], mcfg, mesh, True, ds,
                                                      block)
            M = 1
        else:
            M = pipeline.microbatches(tcfg, toks.shape[0], mesh.pp)
            _, _, auxes = pipeline.pipeline_loss_and_grads(p, [], mcfg, mesh, toks, M, 1.0, ds,
                                                           lm, collect_aux=True, block=block,
                                                           grad=False)
    n = len(state.layers)
    for key in ("gates", "sel_idx"):
        out[key] = np.stack([torch.cat([auxes[m * n + i][key] for m in range(M)]).numpy()
                             for i in range(n)])
    return out


def steps_run(params_np, batches, mcfg, tcfg, mesh, ckpt_dir=None):
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    step_fn, state = pts.build_state_and_step(params, mcfg, tcfg, mesh)
    out = {}
    for i, batch in enumerate(batches):
        local = pts.local_batch(_tensors(batch), mesh)
        state, met = step_fn(state, local)
        for k in ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac",
                  "sel_k_mean", "sel_k_max", "good"):
            out[f"{k}:{i}"] = np.asarray(float(met[k]))
        out[f"branch_shares:{i}"] = met["branch_shares"].double().numpy()
        out[f"tokens:{i}"] = np.asarray(int(met["tokens"]))
    full = pts.gathered_params(state, mesh)
    out.update({f"param:{k}": v for k, v in flatten(params_to_numpy(full)).items()})
    local = [t for _, t in param_leaves(state.params)]
    out["local_numel"] = np.array([t.numel() for t in local])
    out["full_numel"] = np.array([t.numel() for _, t in param_leaves(state.template)])
    whole = dict(param_leaves(state.full_template))
    out["whole_numel"] = np.array([whole[k].numel() for k in pts.global_names(state)])
    out["mu_numel"] = np.array([t.numel() for t in state.opt_state["mu"]])
    out["nu_numel"] = np.array([t.numel() for t in state.opt_state["nu"]])
    out["sharded"] = np.array([a is not None for a in state.axes])
    out["tp_sharded"] = np.array([a is not None for a in state.tp_axes])
    out["top"] = np.array([not k.startswith("/blocks/") for k, _ in param_leaves(state.params)])
    if ckpt_dir:
        save_checkpoint(ckpt_dir, int(state.step), state, mesh=mesh)
        dist.barrier()   # rank 0 has written; restore it into a fresh state under the mesh
        fresh = pts.build_state(params_from_numpy(params_np, device="cpu", dtype="float32"),
                                tcfg, mesh)
        restore_checkpoint(ckpt_dir, fresh, mesh=mesh)
        out["restored_equal"] = np.array(all(
            torch.equal(a.detach(), b.detach()) for a, b in
            zip(local + state.opt_state["mu"] + state.opt_state["nu"],
                [t for _, t in param_leaves(fresh.params)] + fresh.opt_state["mu"]
                + fresh.opt_state["nu"])))
    return out


def main(job_dir: str) -> None:
    initialize_distributed("gloo")
    torch.manual_seed(0)
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    mkw = dict(job["model"])
    mcfg = ModelConfig(nsa=NSAConfig(**mkw.pop("nsa")), **mkw)
    params_np = unflatten(dict(np.load(os.path.join(job_dir, "params.npz"))))
    tokens = np.load(os.path.join(job_dir, "tokens.npy"))
    world, rank = dist.get_world_size(), dist.get_rank()
    max_s_sel = select_cmp_mod.SELECT_CMP_MAX_S_SEL
    v = np.load(os.path.join(job_dir, "varlen.npz"))
    vbatches = list(zip(v["tokens"], v["seq_start"], v["loss_mask"]))
    for run in job["runs"]:
        pp, tp = run.get("pp", 1), run.get("tp", 1)
        if run["dp"] * run["sp"] * pp * tp != world:
            continue
        mesh = make_mesh(dp=run["dp"], sp=run["sp"], tp=tp, pp=pp)
        varlen = run["kind"] == "varlen_steps" or run.get("varlen", False)
        tcfg = TrainConfig(**{**job["train"], "dp": run["dp"], "sp": run["sp"], "pp": pp, "tp": tp,
                              "pp_microbatches": run.get("M", 0),
                              "fsdp": run.get("fsdp", False), "varlen": varlen})
        select_cmp_mod.SELECT_CMP_MAX_S_SEL = run.get("max_s_sel", max_s_sel)
        batches = vbatches if varlen else tokens
        if run["kind"] == "forward":
            first = tuple(a[0] for a in vbatches[0]) if varlen else tokens[0, 0]
            out = forward_run(params_np, first, mcfg, mesh)
        elif run["kind"] == "pp_grads":
            out = pp_grads_run(params_np, batches[0], mcfg, tcfg, mesh)
        else:
            ckpt = os.path.join(job_dir, f"{run['name']}_ckpt") if run.get("ckpt") else None
            out = steps_run(params_np, batches, mcfg, tcfg, mesh, ckpt)
        np.savez(os.path.join(job_dir, f"{run['name']}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
