"""Process mesh, collectives and sharding rules over torch.distributed.

Port of nsa_vibe_tpu/parallel/mesh.py. The JAX package lays a (dp, pp, sp,
tp) device mesh and lets GSPMD insert the collectives; here each process
is one member of a (dp, pp, sp, tp) grid in the JAX axis order, rank =
((dp_rank * pp + pp_rank) * sp + sp_rank) * tp + tp_rank (tp the minor
axis), with explicit process groups, each over the ranks that differ in
one axis only: per (pp, sp, tp) index its dp ranks, per (dp, pp, tp) its
sp ranks, per (dp, sp, tp) its pp ranks (the stage neighbours), per (dp,
pp, sp) its tp ranks; under pp or tp per (pp, tp) index its dp x sp ranks
(`data_group`), and under tp per tp index every rank holding that tp
slice (`slice_group`). The collectives are written out
(parallel/context.py, parallel/pipeline.py, parallel/train_step.py):
  * batch rows shard over dp, query positions over sp, blocks over pp
    (stage p holds layers [p L/pp, (p+1) L/pp));
  * tp, one design on every mesh (the JAX pipeline's, written out where
    the JAX package's other paths leave it to GSPMD): each tp member holds
    G/tp KV groups with their heads (the columns of the seven projections,
    which are group-major, and the rows of W_O) and 1/tp of the MLP hidden
    dim (columns of w_in, rows of w_out), `tp_shard`; `copy_to_tp` on a
    sub-block's normed input (identity forward, all-reduce of its gradient
    backward) and `reduce_from_tp` on its partial output (all-reduce
    forward, identity backward) complete each sub-block. Embed, the norms,
    the gate, conv ϕ, final_norm and lm_head stay replicated over tp;
  * with fsdp, parameter leaves shard over dp by the JAX rule
    (`param_specs`): the largest axis that tp did not take, that splits
    evenly and is at least fsdp_min long.

The backend is the caller's choice, never a fallback: "nccl" for one card
a rank, "gloo" for CPU tensors or for several ranks on one card (NCCL
refuses two ranks on one device). Both run the same collectives
(all_gather_into_tensor, reduce_scatter_tensor, all_reduce, send/recv);
gloo stages CUDA tensors through host memory, for send/recv explicitly
(`send_to`, `recv_from`: gloo's point-to-point takes CPU tensors only),
NCCL sends device to device.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS, fuse_projections

BACKENDS = ("nccl", "gloo")


def initialize_distributed(backend: Optional[str] = None, timeout_s: float = 600.0) -> None:
    """torch.distributed.init_process_group from the usual RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT environment (as torchrun sets them), if no
    group exists yet. backend: "nccl" or "gloo"; None takes "nccl" when a
    card is present and "gloo" otherwise (a caller that puts two ranks on
    one card passes "gloo")."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize_distributed: {missing} not set; start the ranks with "
                           f"torchrun (python -m torch.distributed.run)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    import datetime

    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclass
class Mesh:
    """This process's place in the (dp, pp, sp, tp) grid and the groups it
    talks to. A group of None is the world (the whole default group)."""

    dp: int
    sp: int
    rank: int
    dp_rank: int
    sp_rank: int
    dp_group: Any      # the dp ranks of this (pp, sp, tp) index (fsdp gathers, dp sums)
    sp_group: Any      # the sp ranks of this (dp, pp, tp) index (K/V gathers)
    backend: str
    pp: int = 1
    pp_rank: int = 0
    pp_group: Any = None     # the pp ranks of this (dp, sp, tp) index, stage order
    pp_ranks: tuple = ()     # their global ranks (point-to-point between stages)
    data_group: Any = None   # the dp x sp ranks of this (pp, tp) index; None (the world) at
    #                          pp = tp = 1
    tp: int = 1
    tp_rank: int = 0
    tp_group: Any = None     # the tp ranks of this (dp, pp, sp) index (activation all-reduces)
    slice_group: Any = None  # every rank of the mesh with this tp index (sums of what each tp
    #                          member computes whole); None: the world, at tp = 1
    group: Any = None        # every rank of the mesh; None: the world

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.sp * self.tp


def make_mesh(dp: int = 0, sp: int = 1, tp: int = 1, pp: int = 1,
              size: Optional[int] = None) -> Optional[Mesh]:
    """The (dp, pp, sp, tp) mesh over ranks [0, size) of the initialized
    world (size None: the world; dp = 0: size // (pp sp tp)). Every rank of
    the world must call it, in the same order as its other collectives
    (each group is made by every rank); a rank outside [0, size) gets
    None. At tp = 1 on the whole world the ranks and groups are those of
    the (dp, pp, sp) grid."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if size is None else size
    if not 0 < n <= world:
        raise ValueError(f"mesh size {n} must be in [1, world size {world}]")
    if sp < 1 or pp < 1 or tp < 1 or n % (sp * pp * tp):
        raise ValueError(f"mesh size {n} is not a multiple of pp={pp} x sp={sp} x tp={tp}")
    if dp == 0:
        dp = n // (sp * pp * tp)
    if dp * pp * sp * tp != n:
        raise ValueError(f"mesh dp={dp} x pp={pp} x sp={sp} x tp={tp} != {n} ranks")

    def at(i, p, j, k=0):
        return ((i * pp + p) * sp + j) * tp + k

    def groups(keys, members):
        return {key: dist.new_group(members(*key)) for key in keys}

    DP, PP, SP, TP = range(dp), range(pp), range(sp), range(tp)
    inside = rank < n
    dp_rank, pp_rank = rank // (pp * sp * tp), (rank // (sp * tp)) % pp
    sp_rank, tp_rank = (rank // tp) % sp, rank % tp
    dp_groups = groups([(p, j, k) for p in PP for j in SP for k in TP],
                       lambda p, j, k: [at(i, p, j, k) for i in DP])
    sp_groups = groups([(i, p, k) for i in DP for p in PP for k in TP],
                       lambda i, p, k: [at(i, p, j, k) for j in SP])
    pp_group = data_group = tp_group = slice_group = group = None
    pp_ranks = (rank,)
    if pp > 1:
        pp_groups = groups([(i, j, k) for i in DP for j in SP for k in TP],
                           lambda i, j, k: [at(i, p, j, k) for p in PP])
    if pp > 1 or tp > 1:
        data_groups = groups([(p, k) for p in PP for k in TP],
                             lambda p, k: [at(i, p, j, k) for i in DP for j in SP])
    if tp > 1:
        tp_groups = groups([(i, p, j) for i in DP for p in PP for j in SP],
                           lambda i, p, j: [at(i, p, j, k) for k in TP])
        slice_groups = groups([(k,) for k in TP],
                              lambda k: [at(i, p, j, k) for i in DP for p in PP for j in SP])
    if n < world:   # a mesh on part of the world: its own group where the world was meant
        group = slice_group = data_group = dist.new_group(list(range(n)))
    if not inside:
        return None
    if pp > 1:
        pp_group = pp_groups[dp_rank, sp_rank, tp_rank]
        pp_ranks = tuple(at(dp_rank, p, sp_rank, tp_rank) for p in PP)
    if pp > 1 or tp > 1:
        data_group = data_groups[pp_rank, tp_rank]
    if tp > 1:
        tp_group, slice_group = tp_groups[dp_rank, pp_rank, sp_rank], slice_groups[tp_rank,]
    return Mesh(dp=dp, sp=sp, rank=rank, dp_rank=dp_rank, sp_rank=sp_rank,
                dp_group=dp_groups[pp_rank, sp_rank, tp_rank],
                sp_group=sp_groups[dp_rank, pp_rank, tp_rank],
                backend=dist.get_backend(), pp=pp, pp_rank=pp_rank, pp_group=pp_group,
                pp_ranks=pp_ranks, data_group=data_group, tp=tp, tp_rank=tp_rank,
                tp_group=tp_group, slice_group=slice_group, group=group)


# --- collectives -----------------------------------------------------------
# Gathers and reduce-scatters work on a flat, contiguous buffer whose
# leading axis is split across the group (the way the collectives lay
# chunks out); the helpers move the split axis there and back.

def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenation along `dim` of every group member's x (same shape on
    each), in rank order."""
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # newer torch renames the tensor forms
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This member's 1/n slice along `dim` of the sum of every member's x."""
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over `group` (None: the world); returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


def send_to(x: torch.Tensor, dst: int, mesh: Mesh) -> None:
    """Blocking send of x to global rank dst; under gloo a CUDA tensor goes
    through a host copy (gloo's send takes CPU tensors only)."""
    x = x.detach().contiguous()
    if mesh.backend == "gloo" and x.is_cuda:
        x = x.cpu()
    dist.send(x, dst)


def recv_from(shape, dtype, device, src: int, mesh: Mesh) -> torch.Tensor:
    """Blocking receive of a [shape] tensor from global rank src onto
    `device` (under gloo into a host buffer, then copied over)."""
    staged = mesh.backend == "gloo" and torch.device(device).type == "cuda"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
    dist.recv(buf, src)
    return buf.to(device) if staged else buf


class _GatherDim(torch.autograd.Function):
    """All-gather along a dim; its backward reduce-scatters the gradient,
    so each member gets the sum of every member's gradient of its slice."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


def gather_along(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Differentiable all-gather along `dim` over `group` of n members."""
    if n == 1:
        return x
    return _GatherDim.apply(x, dim, group, n)


# bytes of activations this process all-reduced over tp (copy_to_tp's
# backward, reduce_from_tp's forward); a caller that measures resets it
TP_REDUCED = {"bytes": 0}


def _tp_all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A new tensor: the sum of x over the tp group, in x's dtype (as the
    JAX package's psum reduces in the model dtype)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.tp_group)
    TP_REDUCED["bytes"] += y.numel() * y.element_size()
    return y


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over tp (each member
    saw only its KV groups or its slice of the MLP hidden dim)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_all_reduce(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce over tp forward (the partial W_O or w_out products made
    whole); identity backward (every member needs the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _tp_all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A sub-block's normed input on its way into the tp-sharded weights."""
    return x if mesh.tp == 1 else _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A sub-block's partial output, summed over tp before the residual add."""
    return x if mesh.tp == 1 else _ReduceFromTP.apply(x, mesh)


def gather_tp(t: torch.Tensor, axis: int, mesh: Mesh, widths=None) -> torch.Tensor:
    """The whole leaf from every tp member's slice along `axis`; `widths`
    (a fused W_qkv's local projection widths): gathered projection by
    projection, so the whole leaf keeps the projections in order."""
    if widths is None:
        return gather_dim(t, axis, mesh.tp_group, mesh.tp)
    return torch.cat([gather_dim(p, axis, mesh.tp_group, mesh.tp)
                      for p in t.split(list(widths), dim=axis)], dim=axis)


def tp_slice(t: torch.Tensor, axis: int, rank: int, n: int, widths=None) -> torch.Tensor:
    """Member `rank`'s slice of the whole leaf t along `axis` (of each
    projection, with the whole W_qkv's projection `widths`)."""
    parts = [t] if widths is None else t.split(list(widths), dim=axis)
    for p in parts:
        if p.shape[axis] % n:
            raise ValueError(f"a leaf of {p.shape[axis]} along axis {axis} does not split over "
                             f"tp={n}")
    return torch.cat([p.chunk(n, dim=axis)[rank] for p in parts], dim=axis).contiguous()


# --- sharding rules (the JAX package's _spec_for / param_specs) ---------------
# tp takes the columns of the projections (group-major, so an even split
# gives whole KV groups; the port's fused W_qkv is split projection by
# projection) and of w_in, the rows of W_O and w_out. The JAX package's
# GSPMD rule also splits lm_head's vocab; the port keeps embed, final_norm
# and lm_head whole on every tp member, as the JAX pipeline does.

TP_COLS = ("W_qkv", *PROJ_KEYS, "w_in")
TP_ROWS = ("W_O", "w_out")


def tp_axis(name: str) -> Optional[int]:
    """The axis of leaf `name` (a key, or a param_leaves path) that shards
    over tp, or None (replicated)."""
    leaf = name.rsplit("/", 1)[-1]
    return 1 if leaf in TP_COLS else 0 if leaf in TP_ROWS else None


def per_group(name: str) -> bool:
    """Whether a replicated leaf acts on each KV group (the gate, conv ϕ):
    a tp member's gradient of it covers only its groups."""
    return "/attn/gate/" in name or name.rsplit("/", 1)[-1] in ("phi_k", "phi_v")


def _spec_for(name: str, shape, fsdp_size: int, fsdp_min: int, tp: int = 1) -> Optional[int]:
    """The axis of leaf `name` that shards over dp under fsdp (None:
    replicated): the JAX rule, the largest axis that tp did not take (under
    tp > 1, `tp_axis`), that splits evenly over fsdp_size and is at least
    fsdp_min long (ties to the lower axis)."""
    if fsdp_size <= 1:
        return None
    skip = tp_axis(name) if tp > 1 else None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != skip and shape[i] >= fsdp_min and shape[i] % fsdp_size == 0:
            return i
    return None


def param_specs(params, fsdp_size: int = 1, fsdp_min: int = 512, tp: int = 1):
    """A tree like `params` holding each leaf's fsdp axis (or None), by
    leaf name. The port's leaves (train_step.param_leaves) include each
    attention dict's fused W_qkv, which the rule shards like any leaf
    (under tp on the axis its columns did not take)."""
    if isinstance(params, dict):
        return {k: (_spec_for(k, v.shape, fsdp_size, fsdp_min, tp) if torch.is_tensor(v)
                    else param_specs(v, fsdp_size, fsdp_min, tp)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(param_specs(v, fsdp_size, fsdp_min, tp) for v in params)
    return None


def shard_of(t: torch.Tensor, axis: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Member `rank`'s contiguous 1/n chunk of t along `axis` (t itself when
    axis is None)."""
    if axis is None or n == 1:
        return t
    return t.chunk(n, dim=axis)[rank].contiguous()


def tp_shard(params: dict, mesh: Mesh) -> dict:
    """This rank's tp slice of a whole parameter tree (the same on every
    rank): each block's seven projections (W_qkv fused again from the
    slices, in PROJ_KEYS order), W_O, w_in and w_out sliced, copied; every
    other leaf as it is. The tree itself at tp = 1."""
    if mesh.tp == 1:
        return params

    def cut(t, axis):
        return tp_slice(t.detach(), axis, mesh.tp_rank, mesh.tp).clone()

    def block(bp):
        attn = {k: (cut(v, tp_axis(k)) if tp_axis(k) is not None else v)
                for k, v in bp["attn"].items() if k != "W_qkv"}
        mlp = {k: cut(v, tp_axis(k)) for k, v in bp["mlp"].items()}
        return {**bp, "attn": fuse_projections(attn), "mlp": mlp}

    return {**params, "blocks": [block(bp) for bp in params["blocks"]]}
