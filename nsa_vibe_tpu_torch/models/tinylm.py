"""TinyLM: byte-level language model over NSA blocks.

Port of nsa_vibe_tpu/models/tinylm.py: embedding, n x LlamaBlockNSA,
final RMSNorm, untied LM head; the differentiable `model_forward` (with
block remat) and the f32 cross-entropy of the train step; prefill with
per-layer cache seeding and cached single-token decode; `generate`
(greedy, or temperature/top-k/top-p sampling with a torch.Generator); the
ragged step over per-row positions (`model_decode_step_ragged`, with
core/cache.py::admit_row for continuous batching) and the generate
functions that replay it as a CUDA graph on the card (`generate_scan`,
`generate_ragged`; models/decode_graph.py).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.cache import (
    NSACache, cache_from_prefill, cache_tensors, init_cache, ragged_cache,
)
from nsa_vibe_tpu_torch.core.config import ModelConfig
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step_ragged
from nsa_vibe_tpu_torch.models.decode_graph import DecodeGraph
from nsa_vibe_tpu_torch.models.llama_block import (
    block_decode_step, block_prefill, init_block_params, rmsnorm,
)
from nsa_vibe_tpu_torch.models.remat import remat
from nsa_vibe_tpu_torch.utils import trace
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


def embed(params: dict, tokens: torch.Tensor, mcfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(mcfg.dtype))


def head(params: dict, x: torch.Tensor, mcfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, params["final_norm"], mcfg.rmsnorm_eps) @ params["lm_head"]


def model_forward(params: dict, tokens: torch.Tensor, mcfg: ModelConfig,
                  collect_aux: bool = False, seq_start=None) -> Tuple[torch.Tensor, list]:
    """tokens [B, S] -> (logits [B, S, vocab], per-layer gates/selection if
    asked). seq_start [B, S]: packed documents (ops/varlen.py). With remat
    True/"full" and grad mode on, each block's forward is recomputed in the
    backward (models/remat.py); "mlp" remats inside the block."""
    x = embed(params, tokens, mcfg)
    if seq_start is not None:
        seq_start = seq_start.to(device=x.device, dtype=torch.int32).contiguous()
    auxes = []
    rematted = mcfg.remat in (True, "full") and torch.is_grad_enabled()
    for bp in params["blocks"]:
        if rematted:
            x, m, aux = remat(functools.partial(block_prefill, split=True), bp, x, mcfg,
                              seq_start)
            x = x + m
        else:
            x, aux = block_prefill(bp, x, mcfg, seq_start)
        if collect_aux:
            auxes.append({"gates": aux["gates"], "sel_idx": aux["sel_idx"]})
    return head(params, x, mcfg), auxes


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


def init_model_caches(mcfg: ModelConfig, batch: int, capacity: int, dtype=None,
                      device="cuda") -> List[NSACache]:
    """Empty per-layer caches (t = 0) in `dtype` (default mcfg.dtype)."""
    dt = torch_dtype(dtype or mcfg.dtype)
    return [init_cache(mcfg.nsa, batch, capacity, dt, device) for _ in range(mcfg.n_layers)]


def model_prefill_with_caches(params: dict, tokens: torch.Tensor, mcfg: ModelConfig,
                              capacity: int) -> Tuple[torch.Tensor, List[NSACache]]:
    """Prefill and seed per-layer decode caches with room for `capacity`
    tokens. Spans (utils/trace.py): `prefill` around the call, `prefill.cache`
    around each layer's cache seeding, and the counter
    `prefill.device_allocs`: the caching allocator's cudaMalloc calls inside."""
    with trace.span("prefill"), trace.device_allocs("prefill.device_allocs", tokens.device):
        x = embed(params, tokens, mcfg)
        caches = []
        for bp in params["blocks"]:
            x, aux = block_prefill(bp, x, mcfg)
            with trace.span("prefill.cache"):
                caches.append(cache_from_prefill(mcfg.nsa, aux, capacity))
        return head(params, x, mcfg), caches


def model_decode_step(params: dict, token: torch.Tensor, caches: List[NSACache],
                      mcfg: ModelConfig, infos: Optional[list] = None
                      ) -> Tuple[torch.Tensor, List[NSACache]]:
    """token [B, 1] -> (logits [B, 1, vocab], caches updated in place);
    each layer's DecodeInfo is appended to `infos` if given."""
    x = embed(params, token, mcfg)
    for i, (bp, cache) in enumerate(zip(params["blocks"], caches)):
        x, caches[i] = block_decode_step(bp, x, cache, mcfg, infos=infos)
    return head(params, x, mcfg), caches


def model_decode_step_ragged(params: dict, token: torch.Tensor, caches: List[NSACache],
                             mcfg: ModelConfig, infos: Optional[list] = None
                             ) -> Tuple[torch.Tensor, List[NSACache]]:
    """Model-level ragged decode: every layer cache carries per-row
    positions (t: [B], core/cache.py::ragged_cache), the continuous-batching
    step that pairs with admit_row. token [B, 1] -> (logits [B, 1, vocab],
    caches updated in place); each layer's DecodeInfo is appended to
    `infos` if given."""
    x = embed(params, token, mcfg)
    for bp, cache in zip(params["blocks"], caches):
        x, _ = block_decode_step(bp, x, cache, mcfg, step=nsa_decode_step_ragged, infos=infos)
    return head(params, x, mcfg), caches


def _check_capacity(capacity: Optional[int], length: int) -> int:
    capacity = capacity or length
    if length > capacity:
        raise ValueError(f"capacity {capacity} < prompt+new {length}")
    return capacity


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, n_new: int, mcfg: ModelConfig,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None,
             capacity: Optional[int] = None, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """prompt [B, S0] int64 on the parameters' device -> [B, S0 + n_new].
    Greedy without a generator; otherwise temperature / top-k / top-p
    sampling drawn from `generator` (on the logits' device)."""
    B, S0 = prompt.shape
    capacity = _check_capacity(capacity, S0 + n_new)
    temp = temperature if generator is not None else 0.0
    logits, caches = model_prefill_with_caches(params, prompt, mcfg, capacity)
    tok = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
    out = [prompt, tok]
    for _ in range(n_new - 1):
        logits, caches = model_decode_step(params, tok, caches, mcfg)
        tok = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


@torch.no_grad()
def generate_scan(params: dict, prompt: torch.Tensor, n_new: int, mcfg: ModelConfig,
                  temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                  capacity: Optional[int] = None, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """`generate` with its decode loop replayed as one CUDA graph: eager
    prefill and first token, then n_new - 1 replays of one captured tick
    (the ragged step over equal rows, its sampling, the output write), the
    counterpart of the JAX package's one-program `generate_scan`. On CPU
    tensors the same tick runs eagerly. The graph is captured per call on
    this call's caches and dropped at its end. prompt [B, S0] int64 ->
    [B, S0 + n_new]; sampling as in `generate`."""
    B, S0 = prompt.shape
    capacity = _check_capacity(capacity, S0 + n_new)
    temp = temperature if generator is not None else 0.0
    logits, caches = model_prefill_with_caches(params, prompt, mcfg, capacity)
    caches = [ragged_cache(c) for c in caches]
    out = torch.empty((B, n_new), dtype=prompt.dtype, device=prompt.device)
    out[:, :1] = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
    tok = out[:, :1].clone()                                     # [B, 1] the tick's input
    k = torch.ones((1,), dtype=torch.int64, device=prompt.device)   # next column of out

    def tick():
        logits, _ = model_decode_step_ragged(params, tok, caches, mcfg)
        nxt = sample_logits(logits[:, -1], temp, top_k, top_p, generator)[:, None]
        tok.copy_(nxt)
        out.scatter_(1, k.expand(B, 1), nxt.to(out.dtype))
        k.add_(1)

    if n_new > 1:
        state = [tok, out, k] + [x for c in caches for x in cache_tensors(c)]
        graph = DecodeGraph(tick, state, generator)
        for _ in range(n_new - 1):
            graph.replay()
    return torch.cat([prompt, out], dim=1)


@torch.no_grad()
def generate_ragged(params: dict, prompts: torch.Tensor, prompt_lens, n_new: int,
                    mcfg: ModelConfig, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None, capacity: Optional[int] = None,
                    top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Serve a batch of prompts of different lengths, each row consuming
    its own prompt token by token, then its own samples (the JAX package's
    `generate_ragged`). prompts [B, L_max] int64 (rows right-padded past
    their length) on the parameters' device; prompt_lens: B host ints in
    [1, L_max] (a list, numpy array or CPU tensor). Returns [B, n_new]: row
    i's first output continues position prompt_lens[i] - 1.

    Caches start empty at t = 0; each of the L_max + n_new - 1 ticks takes
    `where(k < lens, prompts[:, k], last)`, steps, samples, and writes row
    i's j-th output at tick lens[i] - 1 + j. Every row starts at 0, so the
    JAX version runs its uniform step; this one runs the ragged step with
    equal rows (the same function, JAX's
    test_ragged_decode_matches_per_row_uniform), whose position lives on
    the device, so the tick is captured once and replayed as a CUDA graph
    on the card (eagerly on the CPU). The graph is captured per call."""
    B, L_max = prompts.shape
    capacity = _check_capacity(capacity, L_max + n_new)
    lens_host = torch.as_tensor(prompt_lens, dtype=torch.int64, device="cpu")
    if lens_host.shape != (B,):
        raise ValueError(f"prompt_lens must hold {B} lengths, got shape {tuple(lens_host.shape)}")
    lo, hi = int(lens_host.min()), int(lens_host.max())
    if lo < 1 or hi > L_max:
        raise ValueError(f"prompt_lens must be in [1, {L_max}]; got [{lo}, {hi}]")
    dev = prompts.device
    temp = temperature if generator is not None else 0.0
    lens = lens_host.to(dev)
    rows = torch.arange(B, device=dev)
    caches = [ragged_cache(c) for c in init_model_caches(mcfg, B, capacity, device=dev)]
    out = torch.zeros((B, n_new), dtype=prompts.dtype, device=dev)
    last = prompts[:, 0].clone()
    k = torch.zeros((1,), dtype=torch.int64, device=dev)          # the tick

    def tick():
        prompt_k = prompts.gather(1, torch.clamp(k, max=L_max - 1).expand(B, 1))[:, 0]
        tok_in = torch.where(k < lens, prompt_k, last)
        logits, _ = model_decode_step_ragged(params, tok_in[:, None], caches, mcfg)
        nxt = sample_logits(logits[:, -1], temp, top_k, top_p, generator).to(prompts.dtype)
        j = k - (lens - 1)                     # row i's j-th output is sampled at tick lens[i]-1+j
        write = (j >= 0) & (j < n_new)
        jc = torch.clamp(j, 0, n_new - 1)
        out[rows, jc] = torch.where(write, nxt, out[rows, jc])
        last.copy_(torch.where(write, nxt, last))
        k.add_(1)

    state = [out, last, k] + [x for c in caches for x in cache_tensors(c)]
    graph = DecodeGraph(tick, state, generator)
    for _ in range(L_max + n_new - 1):
        graph.replay()
    return out
