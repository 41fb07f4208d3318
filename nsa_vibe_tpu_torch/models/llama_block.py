"""LLaMA-style pre-norm block around NSA attention (port of
nsa_vibe_tpu/models/llama_block.py): RMSNorm, SiLU MLP, residuals;
batched prefill and cached single-token decode."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from nsa_vibe_tpu_torch.core.cache import NSACache
from nsa_vibe_tpu_torch.core.config import ModelConfig
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill, uniform_linear


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def init_mlp_params(generator: torch.Generator, dim: int, hidden: int, dtype, device) -> dict:
    return {"w_in": uniform_linear(generator, dim, hidden, dtype, device),
            "w_out": uniform_linear(generator, hidden, dim, dtype, device)}


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ params["w_in"]) @ params["w_out"]


def init_block_params(generator: torch.Generator, mcfg: ModelConfig, dtype, device) -> dict:
    cfg = mcfg.nsa
    hidden = int(cfg.dim * mcfg.mlp_ratio)
    return {
        "attn_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "attn": init_nsa_params(cfg, generator, device, dtype),
        "mlp_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "mlp": init_mlp_params(generator, cfg.dim, hidden, dtype, device),
    }


def block_prefill(params: dict, x: torch.Tensor, mcfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Pre-norm residual block, batched prefill. Returns (y, attn aux)."""
    attn_out, aux = nsa_prefill(params["attn"], rmsnorm(x, params["attn_norm"], mcfg.rmsnorm_eps),
                                mcfg.nsa)
    x = x + attn_out
    x = x + mlp(params["mlp"], rmsnorm(x, params["mlp_norm"], mcfg.rmsnorm_eps))
    return x, aux


def block_decode_step(params: dict, x: torch.Tensor, cache: NSACache,
                      mcfg: ModelConfig) -> Tuple[torch.Tensor, NSACache]:
    """Single-token cached decode through the block. x: [B,1,dim]."""
    attn_out, cache, _ = nsa_decode_step(
        params["attn"], rmsnorm(x, params["attn_norm"], mcfg.rmsnorm_eps), cache, mcfg.nsa)
    x = x + attn_out
    x = x + mlp(params["mlp"], rmsnorm(x, params["mlp_norm"], mcfg.rmsnorm_eps))
    return x, cache

