"""Clipping, AdamW and the warmup-cosine schedule of the train step.

Port of nsa_vibe_tpu/parallel/train_step.py::make_optimizer, which chains
optax.clip_by_global_norm(max_grad_norm) and optax.adamw(schedule,
weight_decay) over optax.warmup_cosine_decay_schedule. The same arithmetic
is written here as tensor ops, in optax's order:

  * clip: g if |g| < max_norm else (g / |g|) * max_norm, |g| the global
    norm (no epsilon, unlike torch.nn.utils.clip_grad_norm_). The norm is
    summed in f32 (optax sums each leaf in the leaf's dtype);
  * adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, in the
    parameters' dtype (no f32 master copy, as the JAX trainer);
    u = mu_hat / (sqrt(nu_hat) + eps) with mu_hat = mu / (1 - b1^c),
    nu_hat = nu / (1 - b2^c), c the count after the increment;
  * decoupled decay on every leaf: u += wd * p;
  * lr: the schedule at the count BEFORE the increment (the first update
    has lr = 0), cast to the leaf's dtype; p += -lr * u.

The count is an int32 device tensor, so a skipped step leaves it (and the
moments and parameters) unchanged without the host reading anything.
"""

from __future__ import annotations

import math
from typing import List

import torch

from nsa_vibe_tpu_torch.core.config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine_lr(count: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """optax.warmup_cosine_decay_schedule(0 -> lr over warmup_steps, cosine
    to 0.1 lr at max(steps, warmup_steps + 1)) at `count`, f32."""
    peak, warm = tcfg.lr, tcfg.warmup_steps
    decay_steps = float(max(tcfg.steps, warm + 1) - warm)
    alpha = 0.0 if peak == 0.0 else (peak * 0.1) / peak
    if warm > 0:
        frac = 1 - count.clamp(0, warm).float() / warm
        warmup = (0.0 - peak) * frac + peak
    else:
        warmup = torch.zeros((), device=count.device)
    c = (count - warm).float().clamp(max=decay_steps)
    cosine = peak * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * c / decay_steps))) + alpha)
    return torch.where(count < warm, warmup, cosine)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, f32."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


def init_optimizer(params: List[torch.Tensor]) -> dict:
    """Zero moments in each parameter's dtype and device, count 0."""
    return {
        "mu": [torch.zeros_like(p) for p in params],
        "nu": [torch.zeros_like(p) for p in params],
        "count": torch.zeros((), dtype=torch.int32, device=params[0].device),
    }


@torch.no_grad()
def apply_update_(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
                  tcfg: TrainConfig, grad_norm: torch.Tensor, good: torch.Tensor) -> None:
    """One clipped AdamW step in place, applied only where `good` (a bool
    device scalar) holds: on a bad step parameters, moments and count keep
    their bits."""
    count = state["count"]
    lr = warmup_cosine_lr(count, tcfg)
    count_inc = count + 1
    bc1 = 1 - torch.pow(B1, count_inc.float())
    bc2 = 1 - torch.pow(B2, count_inc.float())
    trigger = grad_norm < tcfg.max_grad_norm
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        g = torch.where(trigger, g, (g / grad_norm.to(g.dtype)) * tcfg.max_grad_norm)
        mu_new = (1 - B1) * g + B1 * mu
        nu_new = (1 - B2) * g.square() + B2 * nu
        u = (mu_new / bc1.to(mu_new.dtype)) / (torch.sqrt(nu_new / bc2.to(nu_new.dtype)) + EPS)
        u = u + tcfg.weight_decay * p
        u = (-lr).to(u.dtype) * u
        p.copy_(torch.where(good, p + u, p))
        mu.copy_(torch.where(good, mu_new, mu))
        nu.copy_(torch.where(good, nu_new, nu))
    count.copy_(torch.where(good, count_inc, count))
