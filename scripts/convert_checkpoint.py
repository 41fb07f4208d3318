#!/usr/bin/env python3
"""Train-state checkpoints both ways between the JAX package and the port.

    python scripts/convert_checkpoint.py jax-to-torch --config CFG.yaml \\
        ORBAX_CKPT_DIR [--step N] OUT_DIR
    python scripts/convert_checkpoint.py torch-to-jax --config CFG.yaml \\
        TORCH_CKPT_DIR [--step N] OUT_DIR

jax-to-torch reads the orbax step directory ORBAX_CKPT_DIR/step_<N> that
nsa_vibe_tpu/utils/checkpoint.py::save_checkpoint wrote (default: the
latest) and writes OUT_DIR/step_<N>.pt, which the port's
nsa_vibe_tpu_torch/utils/checkpoint.py::restore_checkpoint reads;
torch-to-jax goes the other way. Both build the model of CFG (the
trainers' YAML) and move what the train state holds: the parameters, the
AdamW moments mu and nu, the optimizer count and the step.

  * The projections: the port holds an attention dict's seven projection
    weights as one fused W_qkv (core/nsa.py::fuse_projections, PROJ_KEYS
    order), where JAX holds seven. AdamW is elementwise, so the fused
    moments are the seven moments concatenated along columns, and are
    split back the same way. The parameters go through the port's
    convert.params_from_numpy / params_to_numpy, the moments too (shaped
    as parameters by train_step.tree_from_leaves).
  * The optimizer state: JAX's opt_state is the optax chain of
    nsa_vibe_tpu/parallel/train_step.py::make_optimizer. Its structure is
    read from init_train_state, not written out here: the one
    ScaleByAdamState (count, mu, nu) and the one ScaleByScheduleState
    (count) are found in it, and any other array in it raises. The two
    counts must be equal, and they become (or come from) the port's one
    count; unequal counts raise.
  * bf16 leaves travel through f32, which holds every bf16 value exactly,
    and come back in their own dtype, so JAX -> port -> JAX returns the
    same bits.
  * Only the single-device layout is converted. A JAX checkpoint of a
    pipeline-parallel run stacks the blocks [L, ...]
    (nsa_vibe_tpu/parallel/pipeline.py::stack_blocks); it raises. The
    port's checkpoints have the single-device layout under every mesh.

This script imports JAX, orbax and both packages, so it lives outside the
port package (which imports no JAX).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nsa_vibe_tpu.models.tinylm import init_model_params as jinit_model_params  # noqa: E402
from nsa_vibe_tpu.parallel.train_step import init_train_state as jinit_train_state  # noqa: E402
from nsa_vibe_tpu.train.trainer import load_config as jload_config  # noqa: E402
from nsa_vibe_tpu.utils import checkpoint as jckpt  # noqa: E402
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from nsa_vibe_tpu_torch.models.tinylm import init_model_params  # noqa: E402
from nsa_vibe_tpu_torch.train.train_step import (  # noqa: E402
    init_train_state, param_leaves, tree_from_leaves,
)
from nsa_vibe_tpu_torch.train.trainer import load_config  # noqa: E402
from nsa_vibe_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

_STATES = (optax.ScaleByAdamState, optax.ScaleByScheduleState)


def _is_state(x) -> bool:
    return isinstance(x, _STATES)


def _optimizer_nodes(opt_state) -> tuple:
    """(the ScaleByAdamState, the ScaleByScheduleState) of an optax state;
    raises unless there is exactly one of each and no other array."""
    nodes = jax.tree_util.tree_leaves(opt_state, is_leaf=_is_state)
    adam = [n for n in nodes if isinstance(n, optax.ScaleByAdamState)]
    sched = [n for n in nodes if isinstance(n, optax.ScaleByScheduleState)]
    others = [n for n in nodes if not _is_state(n)]
    if len(adam) != 1 or len(sched) != 1 or others:
        raise ValueError(f"unexpected optimizer state: {len(adam)} adam and {len(sched)} "
                         f"schedule states, {len(others)} other arrays; the converter knows "
                         "make_optimizer's chain (clip, adamw over a schedule)")
    return adam[0], sched[0]


def _jax_template(config: str):
    """The JAX train state of `config`'s model, abstract (shapes, dtypes)."""
    mcfg, tcfg, _ = jload_config(config)
    return jax.eval_shape(lambda: jinit_train_state(
        jinit_model_params(jax.random.PRNGKey(0), mcfg, jnp.dtype(mcfg.dtype)), tcfg))


def _port_state(config: str):
    """The port's train state of `config`'s model on the CPU, to be filled."""
    mcfg, tcfg, _ = load_config(config)
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    return init_train_state(params, tcfg)


def _step_dir(ckpt_dir: str, step: Optional[int], latest) -> int:
    step = latest(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return step


def _f32_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def jax_to_torch(config: str, src_dir: str, out_dir: str, step: Optional[int] = None) -> str:
    """Orbax step directory -> the port's step_<n>.pt; returns its path."""
    step = _step_dir(src_dir, step, jckpt.latest_step)
    path = os.path.join(os.path.abspath(src_dir), f"step_{step}")
    tree = ocp.StandardCheckpointer().metadata(path).item_metadata.tree
    if not isinstance(tree["params"]["blocks"], list):
        raise ValueError(f"{path} holds the blocks stacked [L, ...], the JAX pipeline's layout; "
                         "only the single-device layout is converted")
    jstate = jckpt.restore_checkpoint(src_dir, _jax_template(config), step)
    adam, sched = _optimizer_nodes(jstate.opt_state)
    if int(adam.count) != int(sched.count):
        raise ValueError(f"the adam count {int(adam.count)} and the schedule count "
                         f"{int(sched.count)} differ; the port keeps one count")

    state = _port_state(config)
    live = param_leaves(state.params)

    def port_leaves(jtree) -> list:
        got = dict(param_leaves(params_from_numpy(_f32_numpy(jtree), device="cpu")))
        if sorted(got) != sorted(k for k, _ in live):
            raise ValueError("the checkpoint's parameters are not the config's model's")
        return [got[k] for k, _ in live]

    with torch.no_grad():
        for key, jtree, dest in (("params", jstate.params, [t for _, t in live]),
                                 ("mu", adam.mu, state.opt_state["mu"]),
                                 ("nu", adam.nu, state.opt_state["nu"])):
            for (name, _), t, new in zip(live, dest, port_leaves(jtree)):
                if t.shape != new.shape:
                    raise ValueError(f"{key} {name}: shape {tuple(new.shape)} in the "
                                     f"checkpoint, {tuple(t.shape)} in the config's model")
                t.copy_(new)   # f32 -> the leaf's dtype: exact for bf16 leaves
        state.opt_state["count"].fill_(int(adam.count))
        state.step.fill_(int(jstate.step))
    return tckpt.save_checkpoint(out_dir, step, state)


def torch_to_jax(config: str, src_dir: str, out_dir: str, step: Optional[int] = None) -> str:
    """The port's step_<n>.pt -> an orbax step directory; returns its path."""
    step = _step_dir(src_dir, step, tckpt.latest_step)
    state = tckpt.restore_checkpoint(src_dir, _port_state(config), step)
    template = _jax_template(config)
    adam, _ = _optimizer_nodes(template.opt_state)   # where the port's state goes

    def jax_tree(port_tree, like):
        return jax.tree.map(lambda t, x: jnp.asarray(x, t.dtype), like,
                            params_to_numpy(port_tree))

    count = jnp.asarray(int(state.opt_state["count"]), jnp.int32)
    mu, nu = (jax_tree(tree_from_leaves(state.params, state.opt_state[k]), getattr(adam, k))
              for k in ("mu", "nu"))

    def fill(node):
        if isinstance(node, optax.ScaleByAdamState):
            return node._replace(count=count, mu=mu, nu=nu)
        if isinstance(node, optax.ScaleByScheduleState):
            return node._replace(count=count)
        return node

    jstate = template._replace(
        params=jax_tree(state.params, template.params),
        opt_state=jax.tree.map(fill, template.opt_state, is_leaf=_is_state),
        step=jnp.asarray(int(state.step), jnp.int32))
    return jckpt.save_checkpoint(out_dir, step, jstate)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("direction", choices=("jax-to-torch", "torch-to-jax"))
    ap.add_argument("--config", required=True, help="the trainers' YAML of the model")
    ap.add_argument("src_dir", help="the checkpoint directory to read")
    ap.add_argument("--step", type=int, default=None, help="default: the latest")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    convert = jax_to_torch if args.direction == "jax-to-torch" else torch_to_jax
    print(convert(args.config, args.src_dir, args.out_dir, args.step), flush=True)


if __name__ == "__main__":
    main()
