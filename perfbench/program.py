"""What the benchmark takes from the system under test (nsa_vibe_tpu_torch):
its configuration classes, its parameter layout, and the path of the CUDA
library its build made. Imported only after the harness has checked for a
card, so that the module can be read without one."""

from __future__ import annotations

from typing import Dict

import torch

NSA_KEYS = ("dim", "n_heads", "n_kv_groups", "d_k", "d_v", "l", "d", "l_sel", "n_sel", "w",
            "phi", "gate_hidden", "gate_temp", "rope_base", "rope_scale", "force_init",
            "force_local")
MODEL_KEYS = ("vocab_size", "n_layers", "mlp_ratio", "rmsnorm_eps", "dtype", "remat")


def model_config(cfg: dict):
    """The port's ModelConfig for a configuration's numbers."""
    from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig

    nsa = NSAConfig(**{k: cfg[k] for k in NSA_KEYS if k in cfg})
    return ModelConfig(nsa=nsa, **{k: cfg[k] for k in MODEL_KEYS if k in cfg})


def params(flat: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree for the seed's leaves: nested dicts, the
    seven projections of each attention fused into W_qkv (their entries
    become column views of it)."""
    from nsa_vibe_tpu_torch.core.nsa import fuse_projections

    from perfbench.weights import nested

    tree = nested(flat)
    for blk in tree["blocks"]:
        blk["attn"] = fuse_projections(blk["attn"])
    return tree


def library_path():
    """The CUDA library the port built in this checkout (built if absent)."""
    from nsa_vibe_tpu_torch.ops.cuda import build

    return build.build()
