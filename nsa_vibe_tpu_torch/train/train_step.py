"""Single-device train step: loss, grads, optimizer, safety rails.

Port of nsa_vibe_tpu/parallel/train_step.py (make_train_step and
make_eval_step without a mesh): f32 cross-entropy; gradient accumulation
over tokens [accum, B, S+1] (grads summed, then scaled by 1/accum inside the
optimizer); global clipping + AdamW + warmup-cosine (train.optim); the
coherent skip: one `good = isfinite(loss) & isfinite(grad_norm)` device flag
gates the whole update, so a bad step leaves parameters, moments and count
unchanged; the 7 gate/selection stats plus sel_k_max. With `tcfg.varlen` a
batch is (tokens [accum, B, S+1], seq_start [accum, B, S], loss_mask [accum,
B, S]): packed documents (ops/varlen.py), the loss masked to the supervised
tokens, whose count is the `tokens` metric.

Parameters are the port's nested dicts. The trainable leaves are every
tensor except the seven projection entries of an attention dict, which
are column views of its fused "W_qkv" (core.nsa.fuse_projections): the
optimizer updates W_qkv in place and the views follow. Nothing here reads
a device value on the host.

Spans (utils/trace.py, recorded only while a profiler runs): `train.step`
around a call, `train.forward` (model_forward and the loss) and
`train.backward` (torch.autograd.grad) for each micro-batch, and
`train.optimizer` from the global norm through apply_update_; the leaves the
optimizer updated, by path, in the counters `optimizer.fused_leaves` and
`optimizer.plain_leaves` (train/optim.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from nsa_vibe_tpu_torch.core.config import ModelConfig, TrainConfig
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_loss, model_forward
from nsa_vibe_tpu_torch.ops.selection import count_distinct_blocks
from nsa_vibe_tpu_torch.train.optim import apply_update_, init_optimizer, norm_and_good
from nsa_vibe_tpu_torch.utils import trace


def param_leaves(params: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every trainable leaf, in a fixed order; projection
    views of a fused attention dict are skipped."""
    if isinstance(params, dict):
        skip = PROJ_KEYS if "W_qkv" in params else ()
        return [leaf for k, v in params.items() if k not in skip
                for leaf in param_leaves(v, f"{path}/{k}")]
    if isinstance(params, (list, tuple)):
        return [leaf for i, v in enumerate(params) for leaf in param_leaves(v, f"{path}/{i}")]
    return [(path, params)]


def tree_from_leaves(params: Any, leaves: List[torch.Tensor]) -> Any:
    """A tree shaped like `params` holding `leaves` (in param_leaves order);
    an attention dict's projection entries become column views of its new
    W_qkv, at the offsets of the old ones."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            skip = PROJ_KEYS if "W_qkv" in node else ()
            out = {k: build(v) for k, v in node.items() if k not in skip}
            o = 0
            for k in skip:
                n = node[k].shape[1]
                out[k] = out["W_qkv"][:, o:o + n]
                o += n
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(params)


@dataclass
class TrainState:
    params: dict
    opt_state: dict       # {"mu": [...], "nu": [...], "count": int32 scalar[, "plan"]}
    step: torch.Tensor    # int32 scalar on the parameters' device


def init_train_state(params: dict, tcfg: TrainConfig) -> TrainState:
    """Marks the trainable leaves as requiring grad and zeroes the moments."""
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    return TrainState(params=params, opt_state=init_optimizer(leaves),
                      step=torch.zeros((), dtype=torch.int32, device=leaves[0].device))


def gate_stats(auxes: list) -> Tuple[torch.Tensor, torch.Tensor]:
    """[entropy, max, collapse fraction, share cmp/sel/win, mean distinct
    selected blocks per row] (f32 [7]) and the max distinct blocks of a row."""
    g = torch.stack([a["gates"] for a in auxes]).detach().float().reshape(-1, 3)
    entropy = -(g * torch.log(g + 1e-8)).sum(-1)
    max_gate = g.amax(-1)
    k_per_row = count_distinct_blocks(torch.stack([a["sel_idx"] for a in auxes])).float()
    collapse = ((entropy < 0.1) & (max_gate > 0.95)).float().mean()
    stats = torch.cat([torch.stack([entropy.mean(), max_gate.mean(), collapse]), g.mean(0),
                       k_per_row.mean()[None]])
    return stats, k_per_row.max()


def loss_and_grads(params: dict, tok_row: torch.Tensor, mcfg: ModelConfig,
                   collect: bool = False, seq_start=None, loss_mask=None):
    """(loss, grads in param_leaves order, per-layer aux) of one batch
    [B, S+1]: logits of tokens[:, :-1] against tokens[:, 1:]; packed
    documents under seq_start [B, S], the loss over loss_mask [B, S]."""
    leaves = [t for _, t in param_leaves(params)]
    with torch.enable_grad():
        with trace.span("train.forward"):
            logits, auxes = model_forward(params, tok_row[:, :-1], mcfg, collect_aux=collect,
                                          seq_start=seq_start)
            loss = cross_entropy_loss(logits, tok_row[:, 1:], mask=loss_mask)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads), auxes


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), batch tokens
    [accum, B, S+1], or with tcfg.varlen (tokens, seq_start [accum, B, S],
    loss_mask [accum, B, S]); the state is updated in place and returned."""
    collect = tcfg.gate_stats

    def run(state: TrainState, batch):
        tokens, seq_start, loss_mask = batch if tcfg.varlen else (batch, None, None)
        accum = tokens.shape[0]
        dev = state.step.device
        grads = None
        loss_sum = torch.zeros((), device=dev)
        stat_sum = torch.zeros((7,), device=dev)
        kmax = torch.zeros((), device=dev)
        for a in range(accum):
            loss, g, auxes = loss_and_grads(
                state.params, tokens[a], mcfg, collect,
                *((seq_start[a], loss_mask[a]) if tcfg.varlen else ()))
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
            del g   # else it holds a second copy of the gradients through the next micro-batch
            loss_sum = loss_sum + loss
            if collect:
                s, k = gate_stats(auxes)
                stat_sum = stat_sum + s
                kmax = torch.maximum(kmax, k)
            del auxes
        inv = 1.0 / float(accum)
        loss = loss_sum * inv
        stats = stat_sum * inv
        with trace.span("train.optimizer"):
            params = [t for _, t in param_leaves(state.params)]
            grad_norm, good = norm_and_good(params, grads, state.opt_state, loss, inv)
            apply_update_(params, grads, state.opt_state, tcfg, grad_norm, good, inv)
        state.step = state.step + 1
        metrics = {
            "loss": loss, "grad_norm": grad_norm, "good": good,
            "gate_entropy": stats[0], "gate_max": stats[1], "gate_collapse_frac": stats[2],
            "branch_shares": stats[3:6], "sel_k_mean": stats[6], "sel_k_max": kmax,
            # varlen: the supervised tokens (a device scalar); else the batch's
            "tokens": (loss_mask.sum().to(torch.int32) if tcfg.varlen
                       else tokens.shape[0] * tokens.shape[1] * (tokens.shape[2] - 1)),
        }
        return state, metrics

    def train_step(state: TrainState, batch):
        with trace.span("train.step"):
            return run(state, batch)

    return train_step


def make_eval_step(mcfg: ModelConfig, varlen: bool = False) -> Callable:
    """eval_step(params, batch) -> loss: batch tokens [B, S+1], or with
    varlen (tokens, seq_start [B, S], loss_mask [B, S])."""
    @torch.no_grad()
    def eval_step(params: dict, batch) -> torch.Tensor:
        tokens, seq_start, loss_mask = batch if varlen else (batch, None, None)
        logits, _ = model_forward(params, tokens[:, :-1], mcfg, seq_start=seq_start)
        return cross_entropy_loss(logits, tokens[:, 1:], mask=loss_mask)

    return eval_step
