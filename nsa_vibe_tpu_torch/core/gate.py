"""Learned branch gate (GateMLP). Port of nsa_vibe_tpu/core/gate.py.

Two-layer MLP over the group-mean-pooled query, last layer xavier
(gain 0.1) with zero bias so the gate starts near uniform, τ-temperature
softmax over (cmp, sel, win). `force_branch` / `force_uniform` are the
debug overrides. `gate_probs_dform` is the gate of the gate-epilogue fold
(nsa.gate_fold, core/nsa.py).
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


class _SoftmaxDForm(torch.autograd.Function):
    """Softmax whose backward takes the D-FORM cotangent D_k = g_k * dg_k in
    place of dg_k (JAX core/gate.py::_softmax_dform). The gated branch
    Functions of the fold (ops/attention.py) return exactly D_k =
    rowsum(dY * Y_k) = g_k * rowsum(dY * O_k) as the gate's gradient, so the
    pair gives the exact softmax-combine gradient

        dz_k = g_k * (dg_k - sum_j g_j dg_j) = D_k - g_k * sum_j D_j

    with no division by a (possibly collapsing, g -> 0) gate. Its output may
    feed only gated-branch Functions: any other consumer (a gate-entropy
    regulariser, say) would get wrong gradients, which is why core/nsa.py
    returns the fold's gates detached."""

    @staticmethod
    def forward(ctx, z):
        g = torch.softmax(z, dim=-1)
        ctx.save_for_backward(g)
        return g

    @staticmethod
    def backward(ctx, D):
        (g,) = ctx.saved_tensors
        return D - g * D.sum(-1, keepdim=True)


def gate_probs_dform(params: dict, q_pooled: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """Gate probabilities [..., 3] in f32 for the gate-epilogue fold: the
    values of gate_probs (no force overrides) before its cast to q_pooled's
    dtype, with the D-form gradient contract of _SoftmaxDForm. Valid only
    when every consumer of a gate column is a gated-branch Function."""
    x = F.silu(q_pooled @ params["w1"] + params["b1"])
    z = (x @ params["w2"] + params["b2"]) / max(tau, 1e-6)
    return _SoftmaxDForm.apply(z.float())
