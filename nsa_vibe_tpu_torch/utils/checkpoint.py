"""Checkpoint save/restore of the full train state with torch.save.

After nsa_vibe_tpu/utils/checkpoint.py: parameters, optimizer moments and
count, and the step, one file `step_<n>.pt` per checkpoint. Restore
copies into the live state in place, so tensors keep their device, dtype
and views (the projection entries stay views of W_qkv), leaf by name.

Under a mesh (parallel/train_step.py::ParallelState) the file has the
same single-device format, the list of blocks: saving gathers each
fsdp-sharded leaf and its moments over dp, each tp slice over tp (a fused
W_qkv projection by projection, never whole, which would interleave the
projections) and the stages' blocks over pp (every rank must call it) and
rank 0 writes; restoring reads the file on every rank and keeps its own
stage's blocks, its tp slice of each and then its dp chunk. So a
dp/fsdp/pp/sp/tp checkpoint resumes on one device, and the other way
round.
(The JAX package saves the stacked [L, ...] layout under pp; the list
layout is kept on purpose, so one file serves every mesh.)
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from nsa_vibe_tpu_torch.train.train_step import TrainState, param_leaves

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState, mesh=None) -> str:
    """Writes step_<step>.pt and returns its path. With `mesh` (a
    ParallelState) a collective: the full leaves are gathered and rank 0
    writes."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt")
    names = [k for k, _ in param_leaves(state.params)]
    if mesh is not None:
        from nsa_vibe_tpu_torch.parallel.train_step import full_leaves

        params, mu, nu = full_leaves(state, mesh)
        names = [k for k, _ in param_leaves(state.full_template)]
        if mesh.rank != 0:
            return path
    else:
        params = [t.detach() for _, t in param_leaves(state.params)]
        mu, nu = state.opt_state["mu"], state.opt_state["nu"]
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {
        "params": {k: v.cpu() for k, v in zip(names, params)},
        "mu": [t.cpu() for t in mu],
        "nu": [t.cpu() for t in nu],
        "count": state.opt_state["count"].cpu(),
        "step": state.step.cpu(),
    }
    tmp = path + f".{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)   # a reader never sees a partial file
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None,
                       mesh=None) -> TrainState:
    """Copies checkpoint `step` (default: the latest) into `state` in place
    and returns it. With `mesh` (a ParallelState) the rank's stage takes
    its blocks, and each fsdp-sharded leaf and its moments this rank's
    chunk of the saved full leaf (under tp of its own tp slice)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    blob = torch.load(os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt"),
                      map_location="cpu")
    leaves = param_leaves(state.params)
    saved_names = list(blob["params"])
    if mesh is None:
        names = [k for k, _ in leaves]
        full = names
    else:
        from nsa_vibe_tpu_torch.parallel.train_step import global_names

        names = global_names(state)
        full = [k for k, _ in param_leaves(state.full_template)]
    # leaves are matched by name: a state whose dicts hold their keys in
    # another order (convert.params_from_numpy of a JAX tree, which JAX
    # sorts) restores the same checkpoint
    if sorted(full) != sorted(saved_names):
        raise ValueError("checkpoint parameters do not match the model's")
    index = {k: i for i, k in enumerate(saved_names)}
    axes = getattr(state, "axes", None) or [None] * len(leaves)
    tp_axes = getattr(state, "tp_axes", None) or [None] * len(leaves)
    if mesh is None and any(a is not None for a in axes + tp_axes):
        raise ValueError("restore_checkpoint: a sharded state needs its mesh")
    widths = getattr(state, "tp_widths", None) or [None] * len(leaves)

    def mine(t, a, ta, w):
        from nsa_vibe_tpu_torch.parallel.mesh import shard_of, tp_slice

        if ta is not None:
            t = tp_slice(t, ta, mesh.tp_rank, mesh.tp,
                         None if w is None else [x * mesh.tp for x in w])
        return t if a is None else shard_of(t, a, mesh.dp_rank, mesh.dp)

    for k, (_, t), a, ta, w in zip(names, leaves, axes, tp_axes, widths):
        t.copy_(mine(blob["params"][k], a, ta, w))
    for key in ("mu", "nu"):
        for k, live, a, ta, w in zip(names, state.opt_state[key], axes, tp_axes, widths):
            live.copy_(mine(blob[key][index[k]], a, ta, w))
    state.opt_state["count"].copy_(blob["count"])
    state.step.copy_(blob["step"])
    return state
