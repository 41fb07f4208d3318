"""Activation recomputation (remat) of a block: the port's counterpart of
jax.checkpoint in nsa_vibe_tpu/models/tinylm.py and llama_block.py.

`remat(fn, *args)` returns fn(*args) and keeps only the tensors in args
(nested in dicts, lists and tuples) for the backward, which runs fn again
and backpropagates through that second run. Both runs take the path fn
takes with grad on (the kernels' wrappers in ops/attention.py then keep
their lse), so the forward's kernels and outputs are the ones an
unrematerialised step gives; the first run's graph is dropped when it
returns. Integer outputs carry no gradient; an output that the loss does
not reach gets none. fn is recomputed whole, so a caller leaves outside
it what saves nothing for the backward (block_prefill's split: the last
residual add and its tp all-reduce).

It stands in for torch.utils.checkpoint, whose entry points import
torch._dynamo on their first call: ~9 s on the H100 machine
(scripts/trainer_start_probe.sh), paid by every fresh trainer and every
rank at its first step. The port never compiles, so it has no use for
that import.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class _Slot:
    """Where a tensor sat in a flattened structure."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _flatten(tree: Any, leaves: list) -> Any:
    """tree with each tensor replaced by a _Slot; the tensors go to leaves."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Slot(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


def _fill(spec: Any, leaves) -> Any:
    """The inverse of _flatten."""
    if isinstance(spec, _Slot):
        return leaves[spec.i]
    if isinstance(spec, dict):
        return {k: _fill(v, leaves) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(_fill(v, leaves) for v in spec)
    return spec


def _run(fn: Callable, spec: Any, tensors, needs_grad) -> tuple:
    """fn on detached copies of tensors (those in needs_grad requiring
    grad), with grad on: (the copies, fn's output)."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(tensors, needs_grad)]
    with torch.enable_grad():
        return inputs, fn(*_fill(spec, inputs))


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, spec, out_spec: list, *tensors):
        ctx.fn, ctx.spec = fn, spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        _, out = _run(fn, spec, tensors, ctx.needs_input_grad[3:])
        leaves = []
        out_spec.append(_flatten(out, leaves))
        return tuple(t.detach() for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        inputs, out = _run(ctx.fn, ctx.spec, ctx.saved_tensors, needs)
        outs = []
        _flatten(out, outs)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wanted = [t for t, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wanted
                   else [None] * len(wanted))
        return (None, None, None, *(next(got) if n else None for n in needs))


def remat(fn: Callable, *args) -> Any:
    """fn(*args), its intermediates recomputed in the backward."""
    leaves = []
    spec = _flatten(args, leaves)
    out_spec = []
    outs = _Remat.apply(fn, spec, out_spec, *leaves)
    return _fill(out_spec[0], outs)
