"""Token sampling: greedy, temperature, top-k and nucleus (top-p).

Port of nsa_vibe_tpu/utils/sampling.py with a torch.Generator in place of
a JAX key. Filters compose (top-k first, then nucleus over the
survivors); the highest-probability token is never filtered out.

Nothing here reads a device value, so a CUDA graph can capture it
(models/decode_graph.py): the draw is `torch.multinomial`'s own one-sample
path (argmax of probs / q, q ~ Exp(1) from `generator`) written out,
because `torch.multinomial` checks its input with `.item()`. It draws the
same ids as `torch.multinomial(probs, 1, generator=...)` from the same
generator state.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [..., V] -> ids [...] (int64). temperature <= 0 is argmax
    (greedy; the first maximum on ties); top_k == 0 and top_p >= 1 disable
    their filters. `generator` must live on the logits' device."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    probs = torch.softmax(logits, dim=-1).reshape(-1, V)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    ids = torch.argmax(probs / q, dim=-1, keepdim=True)
    return ids.reshape(logits.shape[:-1])
