"""Learned branch gate (GateMLP). Port of nsa_vibe_tpu/core/gate.py.

Two-layer MLP over the group-mean-pooled query, last layer xavier
(gain 0.1) with zero bias so the gate starts near uniform, τ-temperature
softmax over (cmp, sel, win). `force_branch` / `force_uniform` are the
debug overrides.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BRANCH_INDEX = {"cmp": 0, "sel": 1, "win": 2}


def init_gate_params(generator: torch.Generator, d_k: int, hidden: Optional[int] = None,
                     dtype=torch.float32, device="cpu") -> dict:
    hidden = hidden or max(1, d_k // 2)
    lim1 = (6.0 / (d_k + hidden)) ** 0.5
    lim2 = 0.1 * (6.0 / (hidden + 3)) ** 0.5

    def u(shape, lim):
        w = torch.empty(shape, dtype=torch.float32).uniform_(-lim, lim, generator=generator)
        return w.to(device=device, dtype=dtype)

    return {
        "w1": u((d_k, hidden), lim1),
        "b1": torch.zeros((hidden,), dtype=dtype, device=device),
        "w2": u((hidden, 3), lim2),
        "b2": torch.zeros((3,), dtype=dtype, device=device),
    }


def gate_probs(params: dict, q_pooled: torch.Tensor, tau: float = 1.0,
               force_branch: Optional[str] = None,
               force_uniform: bool = False) -> torch.Tensor:
    """q_pooled: [..., Dk] -> gate probabilities [..., 3] (cmp, sel, win)."""
    shape = (*q_pooled.shape[:-1], 3)
    if force_uniform:
        return torch.full(shape, 1.0 / 3.0, dtype=q_pooled.dtype, device=q_pooled.device)
    if force_branch is not None:
        out = torch.zeros(shape, dtype=q_pooled.dtype, device=q_pooled.device)
        out[..., BRANCH_INDEX[force_branch.strip().lower()]] = 1.0
        return out
    x = F.silu(q_pooled @ params["w1"] + params["b1"])
    g = (x @ params["w2"] + params["b2"]) / max(tau, 1e-6)
    return torch.softmax(g.float(), dim=-1).to(q_pooled.dtype)
