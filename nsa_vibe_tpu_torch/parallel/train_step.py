"""Train step over a (dp, sp) mesh: dp, fsdp, sp and their compositions.

Port of the mesh branches of nsa_vibe_tpu/parallel/train_step.py
(make_train_step and build_state_and_step with a mesh, pp and tp aside).
Each rank gets its slice of the global batch (`local_batch`): its dp
member's rows, and under sp its positions [t0, t0 + S/sp] (one more
token, the last target). Then, per micro-batch:
  * the loss: each rank forms cross_entropy_numden over its rows and
    back-propagates its sum over the global token count (all-reduced under
    varlen), so the ranks' gradients add up to the gradient of the global
    mean, the JAX loss;
  * fsdp: a sharded leaf is held as its 1/dp chunk (mesh.param_specs) and
    gathered over dp where its block uses it (inside the remat block, so
    the backward gathers it again), by a gather whose backward
    reduce-scatters over dp;
after the micro-batches (grads summed, scaled by 1/accum):
  * replicated leaves' gradients are all-reduced (sum) over dp x sp in one
    flat buffer per dtype; sharded leaves' over sp;
  * the global norm adds each shard's squares once (all-reduced over dp);
    `good` is formed from all-reduced values, so every rank skips alike;
    train/optim.py::apply_update_ then runs unchanged on the local leaves;
  * gate stats and sel_k_mean are averaged over ranks, sel_k_max max-reduced.
The host reads nothing; the collectives are the only waits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.core.config import ModelConfig, TrainConfig
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_numden
from nsa_vibe_tpu_torch.parallel.context import context_parallel_model_forward
from nsa_vibe_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_, gather_along, gather_dim, param_specs, shard_of,
)
from nsa_vibe_tpu_torch.train.optim import apply_update_, init_optimizer
from nsa_vibe_tpu_torch.train.train_step import (
    TrainState, gate_stats, param_leaves, tree_from_leaves,
)


@dataclass
class ParallelState(TrainState):
    """TrainState of one rank: params holds the rank's leaves (under fsdp a
    tree of chunks, with no projection views), the moments match them.
    specs: each leaf's fsdp axis or None (mesh.param_specs); axes: the same
    in param_leaves order; template: the full tree's shapes (meta
    tensors), for gathers and checkpoints."""

    specs: dict
    axes: list
    template: dict


def check_config(tcfg: TrainConfig, mesh: Optional[Mesh] = None) -> None:
    """The parallel keys the port takes: tp and pp 1, varlen without sp > 1,
    sp and dp matching the mesh."""
    for name in ("tp", "pp"):
        if getattr(tcfg, name) > 1:
            raise ValueError(f"{name}={getattr(tcfg, name)}: not ported yet (ROADMAP Queue 1 "
                             f"item 4)")
    if tcfg.varlen and tcfg.sp > 1:
        raise ValueError("varlen with sp > 1 is not ported yet (ROADMAP Queue 1 item 4)")
    if mesh is not None and (mesh.sp != tcfg.sp or (tcfg.dp and mesh.dp != tcfg.dp)):
        raise ValueError(f"tcfg dp={tcfg.dp}, sp={tcfg.sp} but the mesh is dp={mesh.dp}, "
                         f"sp={mesh.sp}")


def _strip_views(node, leaves):
    """A tree like `node` holding `leaves` (param_leaves order), without the
    projection views of a fused attention dict (under fsdp W_qkv is a
    chunk, whose columns are not the projections)."""
    if isinstance(node, dict):
        skip = PROJ_KEYS if "W_qkv" in node else ()
        return {k: _strip_views(v, leaves) for k, v in node.items() if k not in skip}
    if isinstance(node, (list, tuple)):
        return type(node)(_strip_views(v, leaves) for v in node)
    return next(leaves)


def _axes_of(specs) -> list:
    return [a for _, a in param_leaves(specs)]


def materialize(local, specs, template, mesh: Mesh):
    """The full parameter (sub)tree: each sharded leaf of `local` gathered
    over dp (differentiably), projection views rebuilt from the template."""
    leaves = [t if a is None else gather_along(t, a, mesh.dp_group, mesh.dp)
              for (_, t), a in zip(param_leaves(local), _axes_of(specs))]
    return tree_from_leaves(template, leaves)


def build_state(params: dict, tcfg: TrainConfig, mesh: Mesh) -> ParallelState:
    """This rank's state from the full parameters (the same on every rank,
    e.g. from one seed): under fsdp each sharded leaf becomes its dp
    chunk; leaves require grad; zero moments of the local leaves."""
    template = tree_from_leaves(params, [torch.empty_like(t, device="meta")
                                         for _, t in param_leaves(params)])
    specs = param_specs(template, mesh.dp if tcfg.fsdp else 1, tcfg.fsdp_min_size)
    axes = _axes_of(specs)
    if any(a is not None for a in axes):
        leaves = [shard_of(t.detach(), a, mesh.dp_rank, mesh.dp).clone().requires_grad_(True)
                  for (_, t), a in zip(param_leaves(params), axes)]
        local = _strip_views(params, iter(leaves))
    else:
        leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
        local = params
    return ParallelState(params=local, opt_state=init_optimizer(leaves),
                         step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                         specs=specs, axes=axes, template=template)


def local_batch(batch: torch.Tensor, mesh: Mesh, rows: bool = True) -> torch.Tensor:
    """This rank's slice of a global batch [..., B, S+1]: rows of its dp
    member (rows=False: the batch holds only those already), columns [t0,
    t0 + S/sp + 1) (the last is the last target)."""
    B, S = batch.shape[-2], batch.shape[-1] - 1
    dp = mesh.dp if rows else 1
    if B % dp or S % mesh.sp:
        raise ValueError(f"batch [B={B}, S={S}] does not split over dp={dp}, sp={mesh.sp}")
    b, s = B // dp, S // mesh.sp
    if rows:
        batch = batch[..., mesh.dp_rank * b:(mesh.dp_rank + 1) * b, :]
    return batch[..., mesh.sp_rank * s:mesh.sp_rank * s + s + 1].contiguous()


def _forward(state: ParallelState, mcfg: ModelConfig, mesh: Mesh, tokens, collect: bool,
             seq_start=None):
    """Logits of this rank's rows and the per-layer aux; fsdp gathers the
    top-level leaves here and each block's inside the block."""
    specs = state.specs
    params, block = state.params, None
    if any(a is not None for a in state.axes):
        params = dict(params)
        for k in ("embed", "final_norm", "lm_head"):
            if specs[k] is not None:
                params[k] = gather_along(params[k], specs[k], mesh.dp_group, mesh.dp)

        def block(i, bp):
            return materialize(bp, specs["blocks"][i], state.template["blocks"][i], mesh)
    return context_parallel_model_forward(params, tokens, mcfg, mesh, collect_aux=collect,
                                          seq_start=seq_start, block=block)


def _global_count(targets: torch.Tensor, loss_mask, mesh: Mesh):
    """The supervised tokens of the global batch: every rank holds as
    many (a host number), or under varlen the all-reduced mask sum."""
    if loss_mask is None:
        return float(targets.numel() * mesh.world)
    return all_reduce_(loss_mask.float().sum()).clamp(min=1.0)


def _sum_grads_(grads: List[torch.Tensor], group) -> None:
    """All-reduce (sum) of `grads` in place over `group`, one flat buffer
    per dtype."""
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in gs]), group)
        o = 0
        for g in gs:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()


def grads_and_stats(state: ParallelState, mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                    batch) -> tuple:
    """The step's gradients and metrics before the update: (loss, grads in
    param_leaves order (replicated leaves summed over dp x sp, sharded ones
    over sp), the global grad norm, the 7 gate stats, sel_k_max, the
    supervised tokens (varlen)), all equal on every rank."""
    tokens, seq_start, loss_mask = batch if tcfg.varlen else (batch, None, None)
    accum = tokens.shape[0]
    dev = state.step.device
    leaves = [t for _, t in param_leaves(state.params)]
    grads = None
    small = torch.zeros((8,), device=dev)   # loss sum, the 7 gate stats
    kmax = torch.zeros((), device=dev)
    n_tok = torch.zeros((), device=dev)
    for a in range(accum):
        with torch.enable_grad():
            logits, auxes = _forward(state, mcfg, mesh, tokens[a, :, :-1], tcfg.gate_stats,
                                     None if seq_start is None else seq_start[a])
            mask = None if loss_mask is None else loss_mask[a]
            num, _ = cross_entropy_numden(logits, tokens[a, :, 1:], mask)
            den = _global_count(tokens[a, :, 1:], mask, mesh)
            n_tok = n_tok + den
            loss = num / den
            g = torch.autograd.grad(loss, leaves)
        grads = list(g) if grads is None else [x + y for x, y in zip(grads, g)]
        small[0] += loss.detach()
        if tcfg.gate_stats:
            s, k = gate_stats(auxes)
            small[1:] += s
            kmax = torch.maximum(kmax, k)
        del auxes, logits
    inv = 1.0 / float(accum)
    grads = [g * inv for g in grads]
    rep = [g for g, a in zip(grads, state.axes) if a is None]
    shd = [g for g, a in zip(grads, state.axes) if a is not None]
    if mesh.world > 1:
        _sum_grads_(rep, None)
    if shd and mesh.sp > 1:
        _sum_grads_(shd, mesh.sp_group)
    sq_rep = sum((g.float().square().sum() for g in rep), torch.zeros((), device=dev))
    sq_shd = sum((g.float().square().sum() for g in shd), torch.zeros((), device=dev))
    if shd and mesh.dp > 1:
        all_reduce_(sq_shd, mesh.dp_group)
    all_reduce_(small)                               # loss: the sum of the ranks' shares
    small[1:] /= mesh.world                          # stats: the mean over ranks
    all_reduce_(kmax, op=dist.ReduceOp.MAX)
    return small[0] * inv, grads, (sq_rep + sq_shd).sqrt(), small[1:] * inv, kmax, n_tok


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh) -> Callable:
    """train_step(state, batch) -> (state, metrics) of this rank: batch its
    slice [accum, B/dp, S/sp + 1] (local_batch), or with tcfg.varlen (dp
    only) (tokens [accum, B/dp, S+1], seq_start, loss_mask [accum, B/dp,
    S]). The metrics are the global ones, equal on every rank."""
    check_config(tcfg, mesh)

    def train_step(state: ParallelState, batch):
        tokens = batch[0] if tcfg.varlen else batch
        loss, grads, grad_norm, stats, kmax, n_tok = grads_and_stats(state, mcfg, tcfg, mesh,
                                                                     batch)
        good = torch.isfinite(loss) & torch.isfinite(grad_norm)
        leaves = [t for _, t in param_leaves(state.params)]
        apply_update_(leaves, grads, state.opt_state, tcfg, grad_norm, good)
        state.step = state.step + 1
        metrics = {
            "loss": loss, "grad_norm": grad_norm, "good": good,
            "gate_entropy": stats[0], "gate_max": stats[1], "gate_collapse_frac": stats[2],
            "branch_shares": stats[3:6], "sel_k_mean": stats[6], "sel_k_max": kmax,
            "tokens": (n_tok.to(torch.int32) if tcfg.varlen else
                       tokens.shape[0] * tokens.shape[1] * (tokens.shape[2] - 1) * mesh.world),
        }
        return state, metrics

    return train_step


def make_eval_step(mcfg: ModelConfig, mesh: Mesh, varlen: bool = False) -> Callable:
    """eval_step(state, batch) -> the global mean loss of a batch sliced as
    the train step's (one micro-batch: [B/dp, S/sp + 1], or the varlen
    tuple), equal on every rank."""
    @torch.no_grad()
    def eval_step(state: ParallelState, batch) -> torch.Tensor:
        tokens, seq_start, loss_mask = batch if varlen else (batch, None, None)
        logits, _ = _forward(state, mcfg, mesh, tokens[:, :-1], False, seq_start)
        num = all_reduce_(cross_entropy_numden(logits, tokens[:, 1:], loss_mask)[0])
        return num / _global_count(tokens[:, 1:], loss_mask, mesh)

    return eval_step


def build_state_and_step(params: dict, mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh):
    """(step_fn, state) of this rank: the JAX build_state_and_step with a
    mesh (which also returns the batch's sharding; here `local_batch`
    slices a global batch)."""
    return make_train_step(mcfg, tcfg, mesh), build_state(params, tcfg, mesh)


@torch.no_grad()
def full_leaves(state: ParallelState, mesh: Mesh, moments: bool = True) -> tuple:
    """(params, mu, nu) as full leaves in param_leaves order, on every rank:
    sharded leaves (and their moments) gathered over dp. A collective."""
    def full(ts):
        return [t.detach() if a is None else gather_dim(t.detach(), a, mesh.dp_group, mesh.dp)
                for t, a in zip(ts, state.axes)]
    p = full([t for _, t in param_leaves(state.params)])
    if not moments:
        return p, None, None
    return p, full(state.opt_state["mu"]), full(state.opt_state["nu"])


def gathered_params(state: ParallelState, mesh: Mesh) -> dict:
    """The full parameter tree (projection views included). A collective."""
    return tree_from_leaves(state.template, full_leaves(state, mesh, moments=False)[0])
