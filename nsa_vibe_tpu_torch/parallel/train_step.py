"""Train step over a (dp, pp, sp, tp) mesh: dp, fsdp, sp, pp, tp, varlen
and their compositions.

Port of the mesh branches of nsa_vibe_tpu/parallel/train_step.py
(make_train_step and build_state_and_step with a mesh). Each rank gets
its slice of the global batch (`local_batch`): its dp member's rows, and
under sp its positions [t0, t0 + S/sp] (one more token, the last target);
the tp members of a (dp, pp, sp) index hold the same slice. Under varlen
the whole packed rows' seq_start rides along (ϕ pools every key at its
document-local position) and the loss mask is sliced like the targets.
Then, per micro-batch:
  * the loss: each rank forms cross_entropy_numden over its rows and
    back-propagates its sum over the global token count (all-reduced under
    varlen), so the gradients of the data ranks (dp x sp) add up to the
    gradient of the global mean, the JAX loss;
  * pp: parallel/pipeline.py runs the GPipe schedule over this stage's
    blocks (the state holds them and the replicated embed, final_norm
    and lm_head);
  * tp: the state holds the rank's slice of each block (mesh.tp_shard:
    G/tp KV groups, 1/tp of the MLP hidden dim) and the blocks run with
    the tp hooks (parallel/context.py::run_blocks);
  * fsdp: a sharded leaf is held as its 1/dp chunk (mesh.param_specs, on
    the axis tp did not take; under pp only block leaves, as the JAX
    package's pipeline_param_specs) and gathered over dp where its block
    uses it (inside the remat block, so the backward gathers it again), by
    a gather whose backward reduce-scatters over dp;
after the micro-batches (grads summed, scaled by 1/accum):
  * replicated top-level leaves' gradients are all-reduced (sum) over the
    ranks holding this tp slice (the world at tp = 1; under pp only stage
    0's and the last stage's are not zero): every tp member computes them
    whole. Under pp or tp replicated block leaves' go over the stage's
    dp x sp ranks of this tp index, sharded leaves' over sp, in one flat
    buffer per dtype; under tp the gate's and conv ϕ's then also over tp,
    since each member's covers only its KV groups (the tp-sharded leaves
    and the norms after copy_to_tp are whole on each member);
  * the global norm adds each dp shard's squares once (all-reduced over
    dp), each tp slice's once (over tp) and each stage's blocks once
    (over pp); `good` is formed from all-reduced values, so every rank
    skips alike; train/optim.py::apply_update_ then runs unchanged on the
    local leaves;
  * the loss is summed over the ranks of this tp index (each data rank's
    share once); gate stats and sel_k_mean are averaged over them (each
    holds as many layers x rows, of every KV group), sel_k_max
    max-reduced.
The host reads nothing; the collectives are the only waits.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.core.config import ModelConfig, TrainConfig
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_numden
from nsa_vibe_tpu_torch.parallel import pipeline
from nsa_vibe_tpu_torch.parallel.context import context_parallel_model_forward
from nsa_vibe_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_, gather_along, gather_dim, gather_tp, param_specs, per_group, shard_of,
    tp_axis, tp_shard,
)
from nsa_vibe_tpu_torch.train.optim import apply_update_, init_optimizer
from nsa_vibe_tpu_torch.train.train_step import (
    TrainState, gate_stats, param_leaves, tree_from_leaves,
)

TOP = ("embed", "final_norm", "lm_head")


@dataclass
class ParallelState(TrainState):
    """TrainState of one rank: params holds the rank's leaves (under pp its
    stage's blocks and the replicated top-level leaves; under tp its slice
    of each block; under fsdp a tree of chunks, with no projection views),
    the moments match them. specs: each leaf's fsdp axis or None
    (mesh.param_specs); axes: the same in param_leaves order; template:
    the rank's tree's shapes (meta tensors), for gathers; full_template:
    the whole model's (checkpoints); layers: the global indices of the
    rank's blocks; tp_axes: each leaf's tp axis or None (param_leaves
    order); tp_widths: a fused W_qkv's local projection widths (gathered
    and sliced projection by projection), else None."""

    specs: dict
    axes: list
    template: dict
    full_template: dict
    layers: range
    tp_axes: list
    tp_widths: list


def check_config(tcfg: TrainConfig, mesh: Optional[Mesh] = None,
                 mcfg: Optional[ModelConfig] = None) -> None:
    """The parallel keys: dp, pp, sp and tp matching the mesh; tp dividing
    the model's KV groups and MLP hidden dim."""
    if tcfg.tp < 1:
        raise ValueError(f"tp={tcfg.tp} must be at least 1")
    if mesh is not None and (mesh.sp != tcfg.sp or mesh.pp != tcfg.pp or mesh.tp != tcfg.tp
                             or (tcfg.dp and mesh.dp != tcfg.dp)):
        raise ValueError(f"tcfg dp={tcfg.dp}, pp={tcfg.pp}, sp={tcfg.sp}, tp={tcfg.tp} but the "
                         f"mesh is dp={mesh.dp}, pp={mesh.pp}, sp={mesh.sp}, tp={mesh.tp}")
    if mcfg is not None:   # the JAX pipeline's check and message
        G, hidden = mcfg.nsa.n_kv_groups, int(mcfg.nsa.dim * mcfg.mlp_ratio)
        if G % tcfg.tp or hidden % tcfg.tp:
            raise ValueError(f"tp={tcfg.tp} must divide n_kv_groups={G} and mlp "
                             f"hidden={hidden}")


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


def _tp_widths(node) -> list:
    """Per leaf of `node` (param_leaves order): a fused W_qkv's projection
    widths, else None."""
    if isinstance(node, dict):
        out = []
        for k, v in node.items():
            if "W_qkv" in node and k in PROJ_KEYS:
                continue
            if k == "W_qkv":
                out.append([node[p].shape[1] for p in PROJ_KEYS])
            else:
                out += _tp_widths(v)
        return out
    if isinstance(node, (list, tuple)):
        return [w for v in node for w in _tp_widths(v)]
    return [None]


def _axes_of(specs) -> list:
    return [a for _, a in param_leaves(specs)]


def _meta(params):
    return tree_from_leaves(params, [torch.empty_like(t, device="meta")
                                     for _, t in param_leaves(params)])


def materialize(local, specs, template, mesh: Mesh):
    """The full parameter (sub)tree: each sharded leaf of `local` gathered
    over dp (differentiably), projection views rebuilt from the template."""
    leaves = [t if a is None else gather_along(t, a, mesh.dp_group, mesh.dp)
              for (_, t), a in zip(param_leaves(local), _axes_of(specs))]
    return tree_from_leaves(template, leaves)


def build_state(params: dict, tcfg: TrainConfig, mesh: Mesh) -> ParallelState:
    """This rank's state from the full parameters (the same on every rank,
    e.g. from one seed): under pp its stage's blocks and the top-level
    leaves; under tp its slice of each block (mesh.tp_shard); under fsdp
    each sharded leaf becomes its dp chunk; leaves require grad; zero
    moments of the local leaves."""
    full_template = _meta(params)
    layers = (pipeline.stage_layers(len(params["blocks"]), mesh) if mesh.pp > 1
              else range(len(params["blocks"])))
    if mesh.pp > 1:
        params = pipeline.stage_params(params, mesh)
    params = tp_shard(params, mesh)
    template = _meta(params)
    specs = param_specs(template, mesh.dp if tcfg.fsdp else 1, tcfg.fsdp_min_size, mesh.tp)
    if mesh.pp > 1:   # the JAX package's pipeline keeps the top-level leaves replicated
        specs.update({k: None for k in TOP})
    axes = _axes_of(specs)
    if any(a is not None for a in axes):
        leaves = [shard_of(t.detach(), a, mesh.dp_rank, mesh.dp).clone().requires_grad_(True)
                  for (_, t), a in zip(param_leaves(params), axes)]
        local = _strip_views(params, iter(leaves))
    else:
        leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
        local = params
    names = [k for k, _ in param_leaves(template)]
    return ParallelState(params=local, opt_state=init_optimizer(leaves),
                         step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                         specs=specs, axes=axes, template=template,
                         full_template=full_template, layers=layers,
                         tp_axes=[tp_axis(k) if mesh.tp > 1 else None for k in names],
                         tp_widths=_tp_widths(template))


def local_batch(batch, mesh: Mesh, rows: bool = True):
    """This rank's slice of a global batch [..., B, S+1]: rows of its dp
    member (rows=False: the batch holds only those already), columns [t0,
    t0 + S/sp + 1) (the last is the last target); the same on every tp
    member. A varlen batch (tokens, seq_start, loss_mask) keeps seq_start's
    whole rows (ϕ pools every key at its document-local position) and
    slices loss_mask like the targets."""
    if isinstance(batch, (tuple, list)):
        toks, ds, lm = batch
        s = lm.shape[-1] // mesh.sp
        if rows:
            b = ds.shape[-2] // mesh.dp
            ds, lm = (a[..., mesh.dp_rank * b:(mesh.dp_rank + 1) * b, :] for a in (ds, lm))
        return (local_batch(toks, mesh, rows), ds.contiguous(),
                lm[..., mesh.sp_rank * s:(mesh.sp_rank + 1) * s].contiguous())
    B, S = batch.shape[-2], batch.shape[-1] - 1
    dp = mesh.dp if rows else 1
    if B % dp or S % mesh.sp:
        raise ValueError(f"batch [B={B}, S={S}] does not split over dp={dp}, sp={mesh.sp}")
    b, s = B // dp, S // mesh.sp
    if rows:
        batch = batch[..., mesh.dp_rank * b:(mesh.dp_rank + 1) * b, :]
    return batch[..., mesh.sp_rank * s:mesh.sp_rank * s + s + 1].contiguous()


def _params_and_block(state: ParallelState, mesh: Mesh):
    """The rank's parameters with fsdp-sharded top-level leaves gathered,
    and the block hook that gathers each block's shards inside the block."""
    specs = state.specs
    params, block = state.params, None
    if any(a is not None for a in state.axes):
        params = dict(params)
        for k in TOP:
            if specs[k] is not None:
                params[k] = gather_along(params[k], specs[k], mesh.dp_group, mesh.dp)

        def block(i, bp):
            return materialize(bp, specs["blocks"][i], state.template["blocks"][i], mesh)
    return params, block


def _global_count(targets: torch.Tensor, loss_mask, mesh: Mesh):
    """The supervised tokens of the global batch: every dp x sp rank of a
    stage holds as many (a host number), or under varlen the all-reduced
    mask sum."""
    if loss_mask is None:
        return float(targets.numel() * mesh.dp * mesh.sp)
    return all_reduce_(loss_mask.float().sum(), mesh.data_group).clamp(min=1.0)


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


def _loss_and_grads(state: ParallelState, mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                    leaves, tokens, seq_start, loss_mask):
    """(this rank's share of the loss, its gradients, its per-layer aux,
    the global count) of one accumulation step: tokens [B/dp, S/sp + 1]."""
    params, block = _params_and_block(state, mesh)
    den = _global_count(tokens[:, 1:], loss_mask, mesh)
    if mesh.pp > 1:
        M = pipeline.microbatches(tcfg, tokens.shape[0], mesh.pp)
        loss, g, auxes = pipeline.pipeline_loss_and_grads(
            params, leaves, mcfg, mesh, tokens, M, den, seq_start, loss_mask,
            tcfg.gate_stats, block)
        return loss, g, auxes, den
    with torch.enable_grad():
        logits, auxes = context_parallel_model_forward(params, tokens[:, :-1], mcfg, mesh,
                                                       tcfg.gate_stats, seq_start, block)
        num, _ = cross_entropy_numden(logits, tokens[:, 1:], loss_mask)
        loss = num / den
        g = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(g), auxes, den


def _block_leaf(name: str) -> bool:
    return name.startswith("/blocks/")


def grads_and_stats(state: ParallelState, mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                    batch) -> tuple:
    """The step's gradients and metrics before the update: (loss, grads in
    param_leaves order (summed over the mesh as the module notes say), the
    global grad norm, the 7 gate stats, sel_k_max, the supervised tokens
    (varlen)), all equal on every rank."""
    tokens, seq_start, loss_mask = batch if tcfg.varlen else (batch, None, None)
    accum = tokens.shape[0]
    dev = state.step.device
    named = param_leaves(state.params)
    leaves = [t for _, t in named]
    grads = None
    small = torch.zeros((8,), device=dev)   # loss sum, the 7 gate stats
    kmax = torch.zeros((), device=dev)
    n_tok = torch.zeros((), device=dev)
    for a in range(accum):
        loss, g, auxes, den = _loss_and_grads(
            state, mcfg, tcfg, mesh, leaves, tokens[a],
            None if seq_start is None else seq_start[a],
            None if loss_mask is None else loss_mask[a])
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
        del g   # else it holds a second copy of the gradients through the next micro-batch
        n_tok = n_tok + den
        small[0] += loss
        if tcfg.gate_stats:
            s, k = gate_stats(auxes)
            small[1:] += s
            kmax = torch.maximum(kmax, k)
        del auxes
    inv = 1.0 / float(accum)
    grads = [g * inv for g in grads]
    names = [k for k, _ in named]
    apart = mesh.pp > 1 or mesh.tp > 1   # block leaves summed apart from the top-level ones
    shd = [g for g, a in zip(grads, state.axes) if a is not None]
    rep_top = [g for k, g, a in zip(names, grads, state.axes)
               if a is None and not (apart and _block_leaf(k))]
    rep_blk = [g for k, g, a in zip(names, grads, state.axes)
               if a is None and apart and _block_leaf(k)]
    if mesh.world > 1:
        _sum_grads_(rep_top, mesh.slice_group)
    if rep_blk and mesh.dp * mesh.sp > 1:
        _sum_grads_(rep_blk, mesh.data_group)
    if shd and mesh.sp > 1:
        _sum_grads_(shd, mesh.sp_group)
    if mesh.tp > 1:   # the gate and conv ϕ: a member's gradient covers its KV groups only
        _sum_grads_([g for k, g in zip(names, grads) if per_group(k)], mesh.tp_group)
    zero = torch.zeros((), device=dev)

    def sq(pick) -> torch.Tensor:
        return sum((g.float().square().sum() for k, g, a, t in
                    zip(names, grads, state.axes, state.tp_axes) if pick(k, a, t)), zero)

    sq_top = sq(lambda k, a, t: a is None and not (apart and _block_leaf(k)))
    sq_blk = sq(lambda k, a, t: a is None and apart and _block_leaf(k) and t is None)
    sq_shd = sq(lambda k, a, t: a is not None and t is None)
    if mesh.tp > 1:   # each tp slice's squares once: over dp (its shards), then over tp
        sq_tp = sq(lambda k, a, t: a is None and t is not None)
        sq_tps = sq(lambda k, a, t: a is not None and t is not None)
        if shd and mesh.dp > 1:
            both = all_reduce_(torch.stack([sq_shd, sq_tps]), mesh.dp_group)
            sq_shd, sq_tps = both[0], both[1]
        sq_blk = sq_blk + all_reduce_(sq_tp + sq_tps, mesh.tp_group)
    elif shd and mesh.dp > 1:
        all_reduce_(sq_shd, mesh.dp_group)
    if mesh.pp > 1:   # each stage's blocks once
        sq_blk = all_reduce_(sq_blk + sq_shd, mesh.pp_group)
        sq_shd = zero
    all_reduce_(small, mesh.slice_group)             # loss: the sum of the data ranks' shares
    small[1:] /= mesh.world // mesh.tp               # stats: the mean over those ranks
    all_reduce_(kmax, mesh.group, op=dist.ReduceOp.MAX)
    norm = (sq_top + sq_blk + sq_shd).sqrt()
    return small[0] * inv, grads, norm, small[1:] * inv, kmax, n_tok


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh) -> Callable:
    """train_step(state, batch) -> (state, metrics) of this rank: batch its
    slice [accum, B/dp, S/sp + 1] (local_batch), or with tcfg.varlen
    (tokens [accum, B/dp, S/sp + 1], seq_start [accum, B/dp, S], loss_mask
    [accum, B/dp, S/sp]). The metrics are the global ones, equal on every
    rank."""
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
                       tokens.shape[0] * tokens.shape[1] * (tokens.shape[2] - 1)
                       * mesh.dp * mesh.sp),
        }
        return state, metrics

    return train_step


def make_eval_step(mcfg: ModelConfig, mesh: Mesh, varlen: bool = False,
                   tcfg: Optional[TrainConfig] = None) -> Callable:
    """eval_step(state, batch) -> the global mean loss of a batch sliced as
    the train step's (one micro-batch: [B/dp, S/sp + 1], or the varlen
    tuple), equal on every rank. Under pp tcfg gives the micro-batches."""
    @torch.no_grad()
    def eval_step(state: ParallelState, batch) -> torch.Tensor:
        tokens, seq_start, loss_mask = batch if varlen else (batch, None, None)
        params, block = _params_and_block(state, mesh)
        den = _global_count(tokens[:, 1:], loss_mask, mesh)
        if mesh.pp > 1:
            M = pipeline.microbatches(tcfg or TrainConfig(), tokens.shape[0], mesh.pp)
            share = pipeline.pipeline_loss_and_grads(params, [], mcfg, mesh, tokens, M, den,
                                                     seq_start, loss_mask, block=block,
                                                     grad=False)[0]
            return all_reduce_(share, mesh.slice_group)
        logits, _ = context_parallel_model_forward(params, tokens[:, :-1], mcfg, mesh,
                                                   seq_start=seq_start, block=block)
        num = cross_entropy_numden(logits, tokens[:, 1:], loss_mask)[0]
        return all_reduce_(num, mesh.slice_group) / den

    return eval_step


def build_state_and_step(params: dict, mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh):
    """(step_fn, state) of this rank: the JAX build_state_and_step with a
    mesh (which also returns the batch's sharding; here `local_batch`
    slices a global batch)."""
    return make_train_step(mcfg, tcfg, mesh), build_state(params, tcfg, mesh)


def global_names(state: ParallelState) -> list:
    """The rank's leaves' names in the whole model's tree (param_leaves
    order): block i of the stage is block state.layers[i]."""
    first = state.layers[0] if len(state.layers) else 0
    return [re.sub(r"^/blocks/(\d+)/", lambda m: f"/blocks/{int(m.group(1)) + first}/", k)
            for k, _ in param_leaves(state.template)]


@torch.no_grad()
def gather_full(state: ParallelState, mesh: Mesh, ts: list) -> list:
    """Tensors shaped like the rank's leaves (param_leaves order: the
    leaves, their moments or gradients) as the whole model's, on every
    rank: sharded ones gathered over dp, tp slices over tp (a fused W_qkv
    projection by projection), the stages' blocks over pp. A
    collective."""
    ts = [t.detach() if a is None else gather_dim(t.detach(), a, mesh.dp_group, mesh.dp)
          for t, a in zip(ts, state.axes)]
    if mesh.tp > 1:
        ts = [t if ax is None else gather_tp(t, ax, mesh, w)
              for t, ax, w in zip(ts, state.tp_axes, state.tp_widths)]
    if mesh.pp == 1:
        return ts
    n, by_name = len(state.layers), {}
    for k, t in zip(global_names(state), ts):
        if not _block_leaf(k):
            by_name[k] = t
            continue
        stages = gather_dim(t[None], 0, mesh.pp_group, mesh.pp)
        for q in range(mesh.pp):
            i = int(k.split("/")[2]) - state.layers[0] + q * n
            by_name[re.sub(r"^/blocks/\d+/", f"/blocks/{i}/", k)] = stages[q]
    return [by_name[k] for k, _ in param_leaves(state.full_template)]


def full_leaves(state: ParallelState, mesh: Mesh, moments: bool = True) -> tuple:
    """(params, mu, nu) as the whole model's leaves in param_leaves order,
    on every rank. A collective."""
    p = gather_full(state, mesh, [t for _, t in param_leaves(state.params)])
    if not moments:
        return p, None, None
    return (p, gather_full(state, mesh, state.opt_state["mu"]),
            gather_full(state, mesh, state.opt_state["nu"]))


def gathered_params(state: ParallelState, mesh: Mesh) -> dict:
    """The whole model's parameter tree (projection views included). A
    collective."""
    return tree_from_leaves(state.full_template, full_leaves(state, mesh, moments=False)[0])
