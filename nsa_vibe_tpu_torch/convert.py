"""Parameters from the JAX package's pytree, as numpy arrays.

The JAX parameters are nested dicts and lists of arrays with weights
[in, out] applied as x @ W; the port keeps that layout, so the conversion
is a copy per leaf with no transposes. Every attention dict also gets its
fused projection weight ("W_qkv", see core.nsa.fuse_projections).
"""

from __future__ import annotations

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS, fuse_projections
from nsa_vibe_tpu_torch.utils.device import resolve_device, torch_dtype


def params_from_numpy(tree, device="cuda", dtype=None):
    """numpy pytree (e.g. jax.tree.map(np.asarray, params)) -> the port's
    parameters on `device` (raises without a card unless device="cpu"),
    floats cast to `dtype` when given."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def conv(node):
        if isinstance(node, dict):
            out = {k: conv(v) for k, v in node.items()}
            return fuse_projections(out) if all(k in out for k in PROJ_KEYS) else out
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        t = torch.from_numpy(np.array(node, copy=True))
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        return t.to(dev)

    return conv(tree)


def params_to(params, device=None, dtype=None):
    """The port's parameters moved/cast leaf by leaf (e.g. a bf16 layer to
    f32 on the CPU), with "W_qkv" rebuilt so the projection entries stay
    its views."""
    if isinstance(params, dict):
        out = {k: params_to(v, device, dtype) for k, v in params.items() if k != "W_qkv"}
        return fuse_projections(out) if "W_qkv" in params else out
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device, dtype) for v in params)
    t = params if device is None else params.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t
