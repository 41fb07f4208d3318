"""LLaMA-style pre-norm block around NSA attention (port of
nsa_vibe_tpu/models/llama_block.py): RMSNorm, SiLU MLP, residuals;
batched prefill (differentiable; remat="mlp" recomputes the MLP in the
backward) and cached single-token decode."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from nsa_vibe_tpu_torch.core.cache import NSACache
from nsa_vibe_tpu_torch.core.config import ModelConfig
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill, uniform_linear
from nsa_vibe_tpu_torch.models.remat import remat


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


def block_prefill(params: dict, x: torch.Tensor, mcfg: ModelConfig, seq_start=None,
                  t0: int = 0, gather_kv: Optional[Callable] = None,
                  seq_start_kv=None, tp_in: Optional[Callable] = None,
                  tp_out: Optional[Callable] = None, split: bool = False) -> tuple:
    """Pre-norm residual block, batched prefill (seq_start [B,S]: packed
    documents, ops/varlen.py; t0, gather_kv, seq_start_kv: sequence
    sharding, see core/nsa.py::nsa_prefill). Tensor parallelism
    (parallel/mesh.py): with a tp member's slice of the weights and mcfg's
    tp-local attention, `tp_in` (copy_to_tp) takes each sub-block's normed
    input and `tp_out` (reduce_from_tp) its partial output before the
    residual add. Returns (y, attn aux); split=True returns (x, m, aux)
    with y = x + tp_out(m), the part a block remat recomputes: the last
    residual add and tp_out's all-reduce save nothing the backward reads."""
    tin, tout = tp_in or (lambda a: a), tp_out or (lambda a: a)
    attn_out, aux = nsa_prefill(params["attn"],
                                tin(rmsnorm(x, params["attn_norm"], mcfg.rmsnorm_eps)),
                                mcfg.nsa, seq_start=seq_start, t0=t0, gather_kv=gather_kv,
                                seq_start_kv=seq_start_kv)
    x = x + tout(attn_out)
    h = tin(rmsnorm(x, params["mlp_norm"], mcfg.rmsnorm_eps))
    m = (remat(mlp, params["mlp"], h) if mcfg.remat == "mlp" and torch.is_grad_enabled()
         else mlp(params["mlp"], h))
    return (x, m, aux) if split else (x + tout(m), aux)


def block_decode_step(params: dict, x: torch.Tensor, cache: NSACache, mcfg: ModelConfig,
                      step=nsa_decode_step, infos: Optional[list] = None
                      ) -> Tuple[torch.Tensor, NSACache]:
    """Single-token cached decode through the block. x: [B,1,dim]. `step`
    is nsa_decode_step (uniform cache) or nsa_decode_step_ragged; the
    step's info is appended to `infos` if given."""
    attn_out, cache, info = step(
        params["attn"], rmsnorm(x, params["attn_norm"], mcfg.rmsnorm_eps), cache, mcfg.nsa)
    if infos is not None:
        infos.append(info)
    x = x + attn_out
    x = x + mlp(params["mlp"], rmsnorm(x, params["mlp_norm"], mcfg.rmsnorm_eps))
    return x, cache

