"""TinyLM: byte-level language model over NSA blocks.

Port of nsa_vibe_tpu/models/tinylm.py: embedding, n x LlamaBlockNSA,
final RMSNorm, untied LM head; the differentiable `model_forward` (with
block remat) and the f32 cross-entropy of the train step; prefill with
per-layer cache seeding and cached single-token decode; `generate`
(greedy, or temperature/top-k/top-p sampling with a torch.Generator).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from nsa_vibe_tpu_torch.core.cache import NSACache, cache_from_prefill
from nsa_vibe_tpu_torch.core.config import ModelConfig
from nsa_vibe_tpu_torch.models.llama_block import (
    block_decode_step, block_prefill, init_block_params, rmsnorm,
)
from nsa_vibe_tpu_torch.utils.device import resolve_device, torch_dtype
from nsa_vibe_tpu_torch.utils.sampling import sample_logits


def init_model_params(mcfg: ModelConfig, generator: torch.Generator, device="cuda",
                      dtype=None) -> dict:
    """Random parameters drawn from `generator` (on the CPU) in the JAX
    package's layout, in `dtype` (default mcfg.dtype) on `device` (raises
    without a card unless device="cpu")."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or mcfg.dtype)
    dim = mcfg.nsa.dim
    embed = torch.randn((mcfg.vocab_size, dim), generator=generator) * 0.02
    blocks = [init_block_params(generator, mcfg, dt, dev) for _ in range(mcfg.n_layers)]
    lim = 1.0 / np.sqrt(dim)
    head = torch.empty((dim, mcfg.vocab_size)).uniform_(-lim, lim, generator=generator)
    return {
        "embed": embed.to(device=dev, dtype=dt),
        "blocks": blocks,
        "final_norm": torch.ones((dim,), dtype=dt, device=dev),
        "lm_head": head.to(device=dev, dtype=dt),
    }


def _embed(params: dict, tokens: torch.Tensor, mcfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(mcfg.dtype))


def _head(params: dict, x: torch.Tensor, mcfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, params["final_norm"], mcfg.rmsnorm_eps) @ params["lm_head"]


def model_forward(params: dict, tokens: torch.Tensor, mcfg: ModelConfig,
                  collect_aux: bool = False) -> Tuple[torch.Tensor, list]:
    """tokens [B, S] -> (logits [B, S, vocab], per-layer gates/selection if
    asked). With remat True/"full" and grad mode on, each block's forward
    is recomputed in the backward (torch.utils.checkpoint); "mlp" remats
    inside the block."""
    x = _embed(params, tokens, mcfg)
    auxes = []
    remat = mcfg.remat in (True, "full") and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if remat:
            x, aux = checkpoint(block_prefill, bp, x, mcfg, use_reentrant=False)
        else:
            x, aux = block_prefill(bp, x, mcfg)
        if collect_aux:
            auxes.append({"gates": aux["gates"], "sel_idx": aux["sel_idx"]})
    return _head(params, x, mcfg), auxes


def cross_entropy_numden(logits: torch.Tensor, targets: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked next-token nll, token count), in f32: the separable
    form of the loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is not None:
        m = mask.float()
        return (nll * m).sum(), m.sum().clamp(min=1.0)
    return nll.sum(), torch.full((), float(nll.numel()), device=nll.device)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 next-token cross entropy (mean over the unmasked tokens)."""
    num, den = cross_entropy_numden(logits, targets, mask)
    return num / den


def model_prefill_with_caches(params: dict, tokens: torch.Tensor, mcfg: ModelConfig,
                              capacity: int) -> Tuple[torch.Tensor, List[NSACache]]:
    """Prefill and seed per-layer decode caches with room for `capacity` tokens."""
    x = _embed(params, tokens, mcfg)
    caches = []
    for bp in params["blocks"]:
        x, aux = block_prefill(bp, x, mcfg)
        caches.append(cache_from_prefill(mcfg.nsa, aux, capacity))
    return _head(params, x, mcfg), caches


def model_decode_step(params: dict, token: torch.Tensor, caches: List[NSACache],
                      mcfg: ModelConfig) -> Tuple[torch.Tensor, List[NSACache]]:
    """token [B, 1] -> (logits [B, 1, vocab], caches updated in place)."""
    x = _embed(params, token, mcfg)
    for i, (bp, cache) in enumerate(zip(params["blocks"], caches)):
        x, caches[i] = block_decode_step(bp, x, cache, mcfg)
    return _head(params, x, mcfg), caches


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, n_new: int, mcfg: ModelConfig,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None,
             capacity: Optional[int] = None, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """prompt [B, S0] int64 on the parameters' device -> [B, S0 + n_new].
    Greedy without a generator; otherwise temperature / top-k / top-p
    sampling drawn from `generator` (on the logits' device)."""
    B, S0 = prompt.shape
    capacity = capacity or S0 + n_new
    if S0 + n_new > capacity:
        raise ValueError(f"capacity {capacity} < prompt+new {S0 + n_new}")
    temp = temperature if generator is not None else 0.0
    logits, caches = model_prefill_with_caches(params, prompt, mcfg, capacity)
    tok = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
    out = [prompt, tok]
    for _ in range(n_new - 1):
        logits, caches = model_decode_step(params, tok, caches, mcfg)
        tok = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
