"""Inputs made from the seed on the device: training batches and prompts.

Training rows are byte text stand-ins: each row draws its bytes from a
Zipf law (weight 1/(rank+1)^a) over its own random ordering of the 256
byte values, so rows differ from each other as documents do and the
batch's byte counts carry a signal the first steps learn. Every draw is
a tensor operation on the generator's device; nothing is read back.
"""

from __future__ import annotations

import torch

from perfbench.weights import seed_of


class TrainFeed:
    """Batches tokens [accum, B, S+1] int64, one per call, in a fixed
    order from the seed."""

    def __init__(self, seed: int, accum: int, batch: int, seq: int, vocab: int,
                 exponent: float, device):
        self.shape = (accum, batch, seq + 1)
        self.vocab = vocab
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed_of(seed, 1))
        w = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64) ** exponent
        self.cdf = (torch.cumsum(w, 0) / w.sum()).float().to(device)
        self.device = device

    def __call__(self) -> torch.Tensor:
        a, b, s = self.shape
        order = torch.rand((a, b, self.vocab), generator=self.gen,
                           device=self.device).argsort(-1)
        u = torch.rand((a, b, s), generator=self.gen, device=self.device)
        rank = torch.searchsorted(self.cdf, u).clamp(max=self.vocab - 1)
        return order.gather(-1, rank)


def prompt(seed: int, index: int, length: int, vocab: int, device) -> torch.Tensor:
    """Request `index`'s prompt [1, length] int64: uniform bytes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 2, index))
    return torch.randint(0, vocab, (1, length), generator=gen, device=device)
