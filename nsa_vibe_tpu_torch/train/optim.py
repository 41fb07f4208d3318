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

On the card `norm_and_good` and `apply_update_` run the multi-tensor
kernels of ops/cuda/adamw_mt.py: three launches a step over every leaf of
one dtype (a launch group a dtype), the same bits as the tensor ops here,
and the schedule's ~25 0-dim ops. Their plan of the leaves is built at the
first step and kept in the state (`state["plan"]`, beside mu and nu); they
raise on leaves they do not take (a dtype other than bf16 and f32, a
non-contiguous parameter). On the CPU apply_update_plain_'s tensor ops run;
they are also the reference the card tests hold the kernels to.
apply_update_ counts the leaves each path updated in the recorder's
`optimizer.fused_leaves` and `optimizer.plain_leaves` (utils/trace.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from nsa_vibe_tpu_torch.core.config import TrainConfig
from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
from nsa_vibe_tpu_torch.utils import trace

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


def _plan(params: List[torch.Tensor], state: dict) -> adamw_mt.Plan:
    """The kernels' plan of these leaves: state["plan"], built at the first
    step (and again if the state is given other parameter tensors)."""
    pl = state.get("plan")
    if pl is None or not pl.holds(params, state["mu"], state["nu"]):
        pl = state["plan"] = adamw_mt.Plan(params, state["mu"], state["nu"])
    return pl


def norm_and_good(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
                  loss: torch.Tensor,
                  inv_accum: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global norm of the gradients as the optimizer receives them (each
    g * inv_accum, a micro-batch sum times 1/accum) and good =
    isfinite(loss) & isfinite(norm). On the card the kernels' norm is a
    sum in another order than global_norm's (a few f32 ulps apart)."""
    if state["count"].is_cuda:
        return adamw_mt.norm_and_good(_plan(params, state), grads, loss, inv_accum)
    if inv_accum != 1.0:
        grads = [g * inv_accum for g in grads]
    grad_norm = global_norm(grads)
    return grad_norm, torch.isfinite(loss) & torch.isfinite(grad_norm)


def init_optimizer(params: List[torch.Tensor]) -> dict:
    """Zero moments in each parameter's dtype and device, count 0 (on the
    card the first step adds the kernels' "plan")."""
    return {
        "mu": [torch.zeros_like(p) for p in params],
        "nu": [torch.zeros_like(p) for p in params],
        "count": torch.zeros((), dtype=torch.int32, device=params[0].device),
    }


def _step_scalars(count: torch.Tensor, tcfg: TrainConfig):
    """lr (the schedule at the count before the increment), count + 1 and the
    bias corrections 1 - b^(count + 1): f32 device tensors, elementwise over
    the int32 `count`."""
    count_inc = count + 1
    return (warmup_cosine_lr(count, tcfg), count_inc, 1 - torch.pow(B1, count_inc.float()),
            1 - torch.pow(B2, count_inc.float()))


@torch.no_grad()
def apply_update_(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
                  tcfg: TrainConfig, grad_norm: torch.Tensor, good: torch.Tensor,
                  inv_accum: float = 1.0) -> None:
    """One clipped AdamW step in place on the gradients times inv_accum,
    applied only where `good` (a bool device scalar) holds: on a bad step
    parameters, moments and count keep their bits. The kernels on the card,
    apply_update_plain_'s tensor ops on the CPU."""
    count = state["count"]
    if not count.is_cuda:
        trace.count("optimizer.plain_leaves", len(params))
        apply_update_plain_(params, grads, state, tcfg, grad_norm, good, inv_accum)
        return
    lr, _, bc1, bc2 = _step_scalars(count, tcfg)
    hyper = (inv_accum, tcfg.max_grad_norm, 1 - B1, B1, 1 - B2, B2, EPS, tcfg.weight_decay)
    adamw_mt.update_(_plan(params, state), grads, lr, bc1, bc2, grad_norm, good, hyper)
    count.add_(good)
    trace.count("optimizer.fused_leaves", len(params))


@torch.no_grad()
def apply_update_plain_(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
                        tcfg: TrainConfig, grad_norm: torch.Tensor, good: torch.Tensor,
                        inv_accum: float = 1.0) -> None:
    """apply_update_ as tensor ops on any device: the CPU path, and the
    reference that the card tests hold the kernels to."""
    count = state["count"]
    lr, count_inc, bc1, bc2 = _step_scalars(count, tcfg)
    trigger = grad_norm < tcfg.max_grad_norm
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        if inv_accum != 1.0:
            g = g * inv_accum
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
