"""torch.nn.Module wrappers around the functional NSA core: the port's
counterpart of nsa_vibe_tpu/models/flax_module.py (the JAX package's Flax
Linen modules).

The port's API is functional (parameter dicts + functions); these modules
let nn.Module code drop NSA attention or the whole block into a model,
computing exactly what the functional calls compute. The parameters are
the functional API's dicts: each leaf that train/train_step.py::param_leaves
yields is one nn.Parameter (an attention dict's fused W_qkv is one
parameter), and the seven projection entries are rebuilt at each forward
as column views of it, as train_step.tree_from_leaves does. So
`module.parameters()` feeds torch.optim, and every gradient lands on
exactly one leaf. state_dict keys follow the dict paths ("tree.attn.W_qkv").

Parameters come from a torch.Generator, drawn as init_nsa_params /
init_block_params draw them, or from a given parameter dict (e.g.
convert.params_from_numpy of the JAX package's tree), moved to `device`:
the card by default, the CPU when asked for.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS, init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.models.llama_block import block_prefill, init_block_params
from nsa_vibe_tpu_torch.train.train_step import param_leaves, tree_from_leaves
from nsa_vibe_tpu_torch.utils.device import resolve_device


class _Tree(nn.Module):
    """One dict of a parameter tree: its tensors as parameters, its dicts as
    submodules; an attention dict's projection views are left out."""

    def __init__(self, node: dict, dev: torch.device):
        super().__init__()
        skip = PROJ_KEYS if "W_qkv" in node else ()
        for k, v in node.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v, dev))
            elif k not in skip:
                self.register_parameter(k, nn.Parameter(v.detach().to(dev)))


def _shapes(node):
    """The tree's structure, with meta tensors of the leaves' shapes."""
    if isinstance(node, dict):
        return {k: _shapes(v) for k, v in node.items()}
    return torch.empty(node.shape, device="meta")


class _FunctionalModule(nn.Module):
    """Holds a parameter dict as nn.Parameters; `params()` gives it back."""

    def _hold(self, params: dict, dev: torch.device) -> None:
        self.tree = _Tree(params, dev)
        self._template = _shapes(params)
        self._paths = [k.strip("/").replace("/", ".") for k, _ in param_leaves(params)]

    def params(self) -> dict:
        """The functional parameter dict over this module's parameters."""
        return tree_from_leaves(self._template, [self.tree.get_parameter(p) for p in self._paths])


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("pass the parameters or a torch.Generator to draw them from")
    return generator


class NSAAttention(_FunctionalModule):
    """Three-branch NSA attention (prefill path) as a module:

        mod = NSAAttention(cfg, generator=torch.Generator().manual_seed(0))
        y = mod(x)                        # x: [B, S, dim] on the card

    forward(x, t0=0, gather_kv=None) is core/nsa.py::nsa_prefill(...)[0];
    t0 (the JAX module's pos_offset) with gather_kv shards the sequence, as
    nsa_prefill documents."""

    def __init__(self, cfg: NSAConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_nsa_params(cfg, _generator(generator), device=dev, dtype=dtype)
        self.cfg = cfg
        self._hold(params, dev)

    def forward(self, x: torch.Tensor, t0: int = 0,
                gather_kv: Optional[Callable] = None) -> torch.Tensor:
        return nsa_prefill(self.params(), x, self.cfg, t0=t0, gather_kv=gather_kv)[0]


class LlamaBlockNSA(_FunctionalModule):
    """Pre-norm residual transformer block (NSA attention + SiLU MLP):
    forward(x) is models/llama_block.py::block_prefill(...)[0]."""

    def __init__(self, mcfg: ModelConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            params = init_block_params(_generator(generator), mcfg, dtype, dev)
        self.mcfg = mcfg
        self._hold(params, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return block_prefill(self.params(), x, self.mcfg)[0]
