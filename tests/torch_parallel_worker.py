"""One rank of the port's parallel CPU tests (tests/test_torch_parallel.py).

Run under torch.distributed.run (gloo, CPU): imports torch and the port
only, never JAX. Reads DIR/job.json (configs and runs), DIR/params.npz
(the JAX package's parameters, path-keyed) and DIR/tokens.npy; for each
run whose dp * sp is the world size writes DIR/<run>_rank<r>.npz.

Runs:
  forward: logits of the rank's rows from context_parallel_model_forward,
    the output of one layer's context_parallel_prefill on its embedded
    rows, and the gradients of the global mean cross entropy (each rank's share
    back-propagated, then summed over ranks), from tokens[0, 0];
  steps: one AdamW step per tokens[i] through build_state_and_step (each
    rank its local_batch): the metrics of each step, the full parameters
    after the last, the local leaves' and moments' sizes; with "ckpt" a
    checkpoint saved under the mesh into DIR/<run>_ckpt;
  varlen_steps: the same over DIR/varlen.npz's packed batches (tokens,
    seq_start, loss_mask; dp only), each rank its dp member's rows.
A run's "max_s_sel" lowers select_cmp.SELECT_CMP_MAX_S_SEL, forcing the
long route (select_blocks beside compressed_attention).
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_numden
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as select_cmp_mod
from nsa_vibe_tpu_torch.parallel import train_step as pts
from nsa_vibe_tpu_torch.parallel.context import (
    context_parallel_model_forward, context_parallel_prefill,
)
from nsa_vibe_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from nsa_vibe_tpu_torch.train.train_step import param_leaves, tree_from_leaves
from nsa_vibe_tpu_torch.utils.checkpoint import save_checkpoint


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


def forward_run(params_np, tokens, mcfg, mesh):
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    row = pts.local_batch(torch.from_numpy(tokens).long(), mesh)
    logits, _ = context_parallel_model_forward(params, row[:, :-1], mcfg, mesh)
    num, _ = cross_entropy_numden(logits, row[:, 1:])
    grads = torch.autograd.grad(num / float(row[:, 1:].numel() * mesh.world), leaves)
    for g in grads:
        dist.all_reduce(g)
    out = {"logits": logits.detach().double().numpy()}
    with torch.no_grad():   # one layer's sequence-sharded prefill of the embedded rows
        x = params["embed"][row[:, :-1]]
        out["layer"] = context_parallel_prefill(params["blocks"][0]["attn"], x, mcfg.nsa,
                                                mesh).double().numpy()
    out.update({f"grad:{k}": v for k, v in
                flatten(params_to_numpy(tree_from_leaves(params, list(grads)))).items()})
    return out


def dp_rows(a: np.ndarray, mesh) -> np.ndarray:
    b = a.shape[1] // mesh.dp
    return a[:, mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def steps_run(params_np, batches, mcfg, tcfg, mesh, ckpt_dir=None):
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    step_fn, state = pts.build_state_and_step(params, mcfg, tcfg, mesh)
    out = {}
    for i, batch in enumerate(batches):
        if tcfg.varlen:
            toks, ds, lm = (dp_rows(a, mesh) for a in batch)
            local = (torch.from_numpy(toks).long(), torch.from_numpy(ds).int(),
                     torch.from_numpy(lm).float())
        else:
            local = pts.local_batch(torch.from_numpy(batch).long(), mesh)
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
    out["mu_numel"] = np.array([t.numel() for t in state.opt_state["mu"]])
    out["nu_numel"] = np.array([t.numel() for t in state.opt_state["nu"]])
    out["sharded"] = np.array([a is not None for a in state.axes])
    if ckpt_dir:
        save_checkpoint(ckpt_dir, int(state.step), state, mesh=mesh)
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
    for run in job["runs"]:
        if run["dp"] * run["sp"] != world:
            continue
        mesh = make_mesh(dp=run["dp"], sp=run["sp"])
        varlen = run["kind"] == "varlen_steps"
        tcfg = TrainConfig(**{**job["train"], "dp": run["dp"], "sp": run["sp"],
                              "fsdp": run.get("fsdp", False), "varlen": varlen})
        select_cmp_mod.SELECT_CMP_MAX_S_SEL = run.get("max_s_sel", max_s_sel)
        if run["kind"] == "forward":
            out = forward_run(params_np, tokens[0, 0], mcfg, mesh)
        else:
            ckpt = os.path.join(job_dir, f"{run['name']}_ckpt") if run.get("ckpt") else None
            if varlen:
                v = np.load(os.path.join(job_dir, "varlen.npz"))
                batches = list(zip(v["tokens"], v["seq_start"], v["loss_mask"]))
            else:
                batches = tokens
            out = steps_run(params_np, batches, mcfg, tcfg, mesh, ckpt)
        np.savez(os.path.join(job_dir, f"{run['name']}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
