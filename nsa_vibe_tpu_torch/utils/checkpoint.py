"""Checkpoint save/restore of the full train state with torch.save.

After nsa_vibe_tpu/utils/checkpoint.py: parameters, optimizer moments and
count, and the step, one file `step_<n>.pt` per checkpoint. Restore
copies into the live state in place, so tensors keep their device, dtype
and views (the projection entries stay views of W_qkv).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from nsa_vibe_tpu_torch.train.train_step import TrainState, param_leaves

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt")
    blob = {
        "params": {k: v.detach().cpu() for k, v in param_leaves(state.params)},
        "mu": [t.cpu() for t in state.opt_state["mu"]],
        "nu": [t.cpu() for t in state.opt_state["nu"]],
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
def restore_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Copies checkpoint `step` (default: the latest) into `state` in place
    and returns it."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    blob = torch.load(os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt"),
                      map_location="cpu")
    leaves = param_leaves(state.params)
    if [k for k, _ in leaves] != list(blob["params"]):
        raise ValueError("checkpoint parameters do not match the model's")
    for k, t in leaves:
        t.copy_(blob["params"][k])
    for live, saved in zip(state.opt_state["mu"] + state.opt_state["nu"],
                           blob["mu"] + blob["nu"]):
        live.copy_(saved)
    state.opt_state["count"].copy_(blob["count"])
    state.step.copy_(blob["step"])
    return state
