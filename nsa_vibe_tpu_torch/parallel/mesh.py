"""Process mesh, collectives and sharding rules over torch.distributed.

Port of nsa_vibe_tpu/parallel/mesh.py. The JAX package lays a (dp, pp, sp,
tp) device mesh and lets GSPMD insert the collectives; here each process
is one member of a (dp, pp, sp) grid in the JAX axis order, rank =
(dp_rank * pp + pp_rank) * sp + sp_rank (sp the minor axis), with explicit
process groups: per (pp, sp) index its dp ranks, per (dp, pp) index its sp
ranks, per (dp, sp) index its pp ranks (the stage neighbours), and under
pp per stage its dp x sp ranks. The collectives are written out
(parallel/context.py, parallel/pipeline.py, parallel/train_step.py):
  * batch rows shard over dp, query positions over sp, blocks over pp
    (stage p holds layers [p L/pp, (p+1) L/pp));
  * with fsdp, parameter leaves shard over dp by the JAX rule
    (`param_specs`): the largest axis that splits evenly and is at least
    fsdp_min long.
tp > 1 raises (ROADMAP Queue 1 item 4: tensor parallelism as explicit
collectives, the next slice).

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
    """This process's place in the (dp, pp, sp) grid and the groups it talks to."""

    dp: int
    sp: int
    rank: int
    dp_rank: int
    sp_rank: int
    dp_group: Any      # the dp ranks of this (pp, sp) index (fsdp gathers, dp sums)
    sp_group: Any      # the sp ranks of this (dp, pp) index (K/V gathers)
    backend: str
    pp: int = 1
    pp_rank: int = 0
    pp_group: Any = None     # the pp ranks of this (dp, sp) index, stage order
    pp_ranks: tuple = ()     # their global ranks (point-to-point between stages)
    data_group: Any = None   # the dp x sp ranks of this stage; None (the world) at pp = 1

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.sp


def make_mesh(dp: int = 0, sp: int = 1, tp: int = 1, pp: int = 1) -> Mesh:
    """The (dp, pp, sp) mesh over the initialized world (dp = 0: world //
    (pp sp)). Every rank must call it, in the same order as its other
    collectives."""
    if tp > 1:
        raise ValueError(f"tp={tp}: the port has no tensor parallelism yet (ROADMAP Queue 1 "
                         f"item 4, the next slice)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if sp < 1 or pp < 1 or world % (sp * pp):
        raise ValueError(f"world size {world} is not a multiple of pp={pp} x sp={sp}")
    if dp == 0:
        dp = world // (sp * pp)
    if dp * pp * sp != world:
        raise ValueError(f"mesh dp={dp} x pp={pp} x sp={sp} != world size {world}")

    def at(i, p, j):
        return (i * pp + p) * sp + j

    dp_rank, pp_rank, sp_rank = rank // (pp * sp), (rank // sp) % pp, rank % sp
    dp_groups = {(p, j): dist.new_group([at(i, p, j) for i in range(dp)])
                 for p in range(pp) for j in range(sp)}
    sp_groups = {(i, p): dist.new_group([at(i, p, j) for j in range(sp)])
                 for i in range(dp) for p in range(pp)}
    pp_group = data_group = None
    pp_ranks = (rank,)
    if pp > 1:
        pp_groups = {(i, j): dist.new_group([at(i, p, j) for p in range(pp)])
                     for i in range(dp) for j in range(sp)}
        data_groups = {p: dist.new_group([at(i, p, j) for i in range(dp) for j in range(sp)])
                       for p in range(pp)}
        pp_group, data_group = pp_groups[dp_rank, sp_rank], data_groups[pp_rank]
        pp_ranks = tuple(at(dp_rank, p, sp_rank) for p in range(pp))
    return Mesh(dp=dp, sp=sp, rank=rank, dp_rank=dp_rank, sp_rank=sp_rank,
                dp_group=dp_groups[pp_rank, sp_rank], sp_group=sp_groups[dp_rank, pp_rank],
                backend=dist.get_backend(), pp=pp, pp_rank=pp_rank, pp_group=pp_group,
                pp_ranks=pp_ranks, data_group=data_group)


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


# --- sharding rules (the JAX package's _spec_for / param_specs) ---------------

def _spec_for(name: str, shape, fsdp_size: int, fsdp_min: int) -> Optional[int]:
    """The axis of leaf `name` that shards over dp under fsdp (None:
    replicated): the JAX rule with tp = 1, the largest axis that splits
    evenly over fsdp_size and is at least fsdp_min long (ties to the lower
    axis). Under tp the JAX rule first gives the projections, w_in and
    lm_head their column axis and W_O, w_out their row axis; the port has
    no tp yet."""
    if fsdp_size <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] >= fsdp_min and shape[i] % fsdp_size == 0:
            return i
    return None


def param_specs(params, fsdp_size: int = 1, fsdp_min: int = 512):
    """A tree like `params` holding each leaf's fsdp axis (or None), by
    leaf name. The port's leaves (train_step.param_leaves) include each
    attention dict's fused W_qkv, which the rule shards like any leaf."""
    if isinstance(params, dict):
        return {k: (_spec_for(k, v.shape, fsdp_size, fsdp_min) if torch.is_tensor(v)
                    else param_specs(v, fsdp_size, fsdp_min)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(param_specs(v, fsdp_size, fsdp_min) for v in params)
    return None


def shard_of(t: torch.Tensor, axis: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Member `rank`'s contiguous 1/n chunk of t along `axis` (t itself when
    axis is None)."""
    if axis is None or n == 1:
        return t
    return t.chunk(n, dim=axis)[rank].contiguous()
