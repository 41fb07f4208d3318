"""Pipeline parallelism over the mesh's pp ranks: GPipe micro-batches sent
stage to stage by point-to-point over torch.distributed.

Port of nsa_vibe_tpu/parallel/pipeline.py (pipeline_model_loss,
_pipeline_local). The JAX package runs one SPMD program: a scan over M +
pp - 1 ticks in which stage p computes micro-batch t - p (bubble ticks
compute on zeros, their outputs sliced away), ppermute hands each tick's
activation on, and autodiff of the scan gives the backward. Here each
stage is a process and the schedule is written out, fill-drain GPipe:
  * forward, micro-batches m = 0 .. M-1: stage 0 embeds m's tokens, any
    other stage receives m's activation [Bm, S/sp, dim] (model dtype) from
    stage p - 1; the stage runs its blocks (remat, sp, varlen and fsdp as
    parallel/context.py::run_blocks runs them) and sends the result to
    stage p + 1; the last stage runs the head and cross_entropy_numden and
    keeps num_m / den (den: the global supervised count);
  * backward, m = M-1 .. 0: the last stage back-propagates num_m / den,
    any other stage the gradient it receives from stage p + 1 (autograd
    of y_m against it), and every stage but the first sends its input's
    gradient back to stage p - 1.
Bubbles compute nothing (the JAX package computes zeros there and slices
them away: the same math). Stage p holds blocks [p L/pp, (p+1) L/pp)
(L % pp == 0, else it raises, as the JAX package does); embed,
final_norm and lm_head are replicated on every stage (only stage 0's and
the last stage's get gradient). Under tp each stage's tp member runs its
slice of the stage's blocks (run_blocks' tp hooks) and sends to, and
receives from, the member of its own tp index in the neighbouring stages;
the per-layer gates and selections come back gathered over tp on the
group axis (the JAX pipeline's all_gather over tp). A stage's
micro-batch gradients add up in f32 and are cast to the leaves' dtype
once. The sums over the mesh, the norm and the metrics are
parallel/train_step.py's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from nsa_vibe_tpu_torch.core.config import ModelConfig, TrainConfig
from nsa_vibe_tpu_torch.models.tinylm import cross_entropy_numden, embed, head
from nsa_vibe_tpu_torch.parallel.context import run_blocks
from nsa_vibe_tpu_torch.parallel.mesh import Mesh, recv_from, send_to
from nsa_vibe_tpu_torch.utils.device import torch_dtype

# bytes this process sent to its stage neighbours (activations forward,
# their gradients back); a caller that measures resets it
SENT = {"bytes": 0}


def stage_layers(n_layers: int, mesh: Mesh) -> range:
    """The global indices of the blocks stage mesh.pp_rank holds."""
    if n_layers % mesh.pp:
        raise ValueError(f"n_layers={n_layers} not divisible by pp={mesh.pp}")
    n = n_layers // mesh.pp
    return range(mesh.pp_rank * n, (mesh.pp_rank + 1) * n)


def stage_params(params: dict, mesh: Mesh) -> dict:
    """This stage's tree: its blocks and the replicated top-level leaves."""
    return {**params, "blocks": [params["blocks"][i]
                                 for i in stage_layers(len(params["blocks"]), mesh)]}


def microbatches(tcfg: TrainConfig, rows: int, pp: int) -> int:
    """M = tcfg.pp_microbatches or pp; it must divide a dp member's rows."""
    M = tcfg.pp_microbatches or pp
    if rows % M:
        raise ValueError(f"per-dp-shard batch {rows} not divisible by microbatches={M}")
    return M


def _send(x: torch.Tensor, dst: int, mesh: Mesh) -> None:
    send_to(x, dst, mesh)
    SENT["bytes"] += x.numel() * x.element_size()


def pipeline_loss_and_grads(params: dict, leaves: list, mcfg: ModelConfig, mesh: Mesh,
                            tokens: torch.Tensor, M: int, den, seq_start=None,
                            loss_mask=None, collect_aux: bool = False,
                            block: Optional[Callable] = None, grad: bool = True):
    """One pass of the schedule on this rank: tokens [B/dp, S/sp + 1] (its
    positions of its dp member's rows, as parallel/train_step.py::
    local_batch slices them), seq_start [B/dp, S] (the whole rows' starts)
    and loss_mask [B/dp, S/sp] under varlen, den the global supervised
    count. `leaves`: this rank's trainable leaves, `block` as run_blocks.
    Returns (this rank's share of the loss: the sum of its micro-batches'
    num / den on the last stage, 0 elsewhere; the gradients of that share
    plus the gradients received, in the order of `leaves`, or None with
    grad=False; the per-layer aux of its blocks, micro-batch by
    micro-batch, if asked)."""
    p = mesh.pp_rank
    first, last = p == 0, p == mesh.pp - 1
    B, S_loc = tokens.shape[0], tokens.shape[1] - 1
    Bm = B // M
    shape = (Bm, S_loc, mcfg.nsa.dim)
    dtype, dev = torch_dtype(mcfg.dtype), tokens.device
    share = torch.zeros((), device=dev)
    saved, auxes = [], []
    for m in range(M):
        r = slice(m * Bm, (m + 1) * Bm)
        with torch.set_grad_enabled(grad):
            if first:
                x_in, x = None, embed(params, tokens[r, :-1], mcfg)
            else:
                x_in = x = recv_from(shape, dtype, dev, mesh.pp_ranks[p - 1],
                                     mesh).requires_grad_(grad)
            y, aux = run_blocks(params["blocks"], x, mcfg, mesh, collect_aux,
                                None if seq_start is None else seq_start[r], block)
            if last:
                mask = None if loss_mask is None else loss_mask[r]
                num, _ = cross_entropy_numden(head(params, y, mcfg), tokens[r, 1:], mask)
                out = num / den
                share = share + out.detach()
            else:
                _send(y, mesh.pp_ranks[p + 1], mesh)
                out = y
        saved.append((x_in, out))
        auxes += [{"gates": a["gates"].detach(), "sel_idx": a["sel_idx"]} for a in aux]
    if not grad:
        return share, None, auxes
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    for m in reversed(range(M)):
        x_in, out = saved[m]
        saved[m] = None
        g_out = None if last else recv_from(out.shape, out.dtype, dev, mesh.pp_ranks[p + 1],
                                            mesh)
        inputs = list(leaves) + ([] if first else [x_in])
        gs = torch.autograd.grad(out, inputs, g_out, allow_unused=True)
        if not first:
            _send(gs[-1], mesh.pp_ranks[p - 1], mesh)
        for a, g in zip(acc, gs[:len(leaves)]):
            if g is not None:
                a.add_(g)
    return share, [a.to(t.dtype) for a, t in zip(acc, leaves)], auxes
