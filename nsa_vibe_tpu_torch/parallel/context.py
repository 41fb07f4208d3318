"""Context (sequence) parallel NSA over the mesh's sp ranks.

Port of nsa_vibe_tpu/parallel/context.py. Each sp rank holds S / sp
consecutive query positions of every row (t0 = sp_rank * S / sp) and runs
core/nsa.py::nsa_prefill on them with t0 and a K/V gather: RoPE at
positions t0 + s; the six K/V streams (selection, window, raw compressed)
all-gathered over the sp group by a differentiable gather whose backward
reduce-scatters (parallel/mesh.py::gather_along), so each rank gets the
sum of every rank's gradient of its own K/V rows; ϕ pooling over the
gathered raw stream (windows straddle shard boundaries); the route chosen
by shape as on one device, every kernel (and its backward) at offset t0.
Embedding, norms, MLP and LM head act per token on the local rows.

Packed documents (varlen) under sp: every sp rank of a dp member holds
the same packed rows and their whole seq_start [B, S]; a rank passes its
own rows' starts (packed positions, which the kernels read at the offset
t0) and the whole rows' (ϕ's document-local pooling positions of every
key) to nsa_prefill (`varlen_kwargs`), as the JAX package's
nsa_attention_cp_local takes seq_start_full.

Tensor parallelism (parallel/mesh.py): `run_blocks` hands each block
the tp-local attention configuration (core/nsa.py::tp_local) and the tp
hooks, copy_to_tp and reduce_from_tp, beside the sp and varlen arguments,
so one call serves dp x sp x tp (a rank's K/V gathers over sp move its
own KV groups only), and gathers the per-layer gates and selections over
tp on the group axis, so the gate stats see every group.

Every rank must run the same collectives in the same order: under remat
a block's forward (with its gathers) is recomputed in the backward on
every rank, in the same order, since every rank runs the same graph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.core.nsa import nsa_prefill, tp_local
from nsa_vibe_tpu_torch.models.llama_block import block_prefill
from nsa_vibe_tpu_torch.models.remat import remat
from nsa_vibe_tpu_torch.models.tinylm import embed, head
from nsa_vibe_tpu_torch.parallel.mesh import (
    Mesh, copy_to_tp, gather_along, gather_dim, reduce_from_tp,
)


def check_shards(S: int, sp: int, l_sel: int) -> int:
    """S / sp, which must be a multiple of l_sel (a selection block never
    straddles two ranks' rows)."""
    if S % sp or (S // sp) % l_sel:
        raise ValueError(f"S={S} must split into sp={sp} shards of a multiple of l_sel={l_sel}")
    return S // sp


def sp_kwargs(mesh: Mesh, S_local: int, l_sel: int) -> dict:
    """nsa_prefill's sequence-sharding arguments on this rank: its rows'
    offset t0 and the K/V gather over the sp group."""
    check_shards(S_local * mesh.sp, mesh.sp, l_sel)
    return dict(t0=mesh.sp_rank * S_local,
                gather_kv=lambda a: gather_along(a, 2, mesh.sp_group, mesh.sp))


def context_parallel_prefill(params: dict, x_local: torch.Tensor, cfg: NSAConfig,
                             mesh: Mesh) -> torch.Tensor:
    """Sequence-sharded batched prefill of one NSA layer (the JAX package's
    nsa_attention_cp_local): x_local [B, S/sp, dim], the rows at positions
    [t0, t0 + S/sp), t0 = sp_rank * S/sp -> out [B, S/sp, dim].
    Differentiable."""
    return nsa_prefill(params, x_local, cfg, **sp_kwargs(mesh, x_local.shape[1], cfg.l_sel))[0]


def varlen_kwargs(seq_start, mesh: Mesh, S_local: int) -> dict:
    """block_prefill's packed-document arguments on this rank from the
    whole rows' seq_start [B, S] (each sp rank of a dp member holds the
    same packed rows): its own rows' starts and, under sp, every key's
    (ϕ's pooling positions). {} without documents."""
    if seq_start is None:
        return {}
    if mesh.sp == 1:
        return dict(seq_start=seq_start)
    if seq_start.shape[1] != S_local * mesh.sp:
        raise ValueError(f"seq_start {tuple(seq_start.shape)} must hold the whole rows "
                         f"(S = {S_local * mesh.sp}) under sp = {mesh.sp}")
    t0 = mesh.sp_rank * S_local
    return dict(seq_start=seq_start[:, t0:t0 + S_local].contiguous(), seq_start_kv=seq_start)


def tp_kwargs(mesh: Mesh) -> dict:
    """block_prefill's tensor-parallel hooks on this rank ({} at tp = 1)."""
    if mesh.tp == 1:
        return {}
    return dict(tp_in=lambda a: copy_to_tp(a, mesh), tp_out=lambda a: reduce_from_tp(a, mesh))


def _gather_aux_tp(auxes: list, mesh: Mesh) -> list:
    """The layers' gates [B,S,G/tp,3] and selections [B,S,G/tp,n] of every
    tp member, on the group axis (one gather each, no gradient)."""
    if mesh.tp == 1 or not auxes:
        return auxes
    out = [gather_dim(torch.stack([a[k].detach() for a in auxes]), 3, mesh.tp_group, mesh.tp)
           for k in ("gates", "sel_idx")]
    return [{"gates": g, "sel_idx": s} for g, s in zip(*out)]


def run_blocks(blocks: list, x: torch.Tensor, mcfg: ModelConfig, mesh: Mesh,
               collect_aux: bool = False, seq_start=None,
               block: Optional[Callable] = None) -> Tuple[torch.Tensor, list]:
    """The blocks of parameter dicts `blocks` in order over
    this rank's rows x [B, S/sp, dim] -> (x, per-layer {"gates",
    "sel_idx"} of every KV group if asked). seq_start: the whole rows'
    [B, S] starts or None. Under tp the blocks are the rank's slices
    (mesh.tp_shard). `block(i, bp)`, if given, makes the parameter dict of
    blocks[i] inside the (remat) block, where fsdp gathers its shards
    (parallel/train_step.py). The remat contract is model_forward's:
    True/"full" recomputes each block in the backward, its collectives
    included but for the last residual add's tp all-reduce
    (block_prefill's split); "mlp" only the MLP."""
    if seq_start is not None:
        seq_start = seq_start.to(device=x.device, dtype=torch.int32).contiguous()
    make = block or (lambda i, bp: bp)
    kw = sp_kwargs(mesh, x.shape[1], mcfg.nsa.l_sel) if mesh.sp > 1 else {}
    kw.update(varlen_kwargs(seq_start, mesh, x.shape[1]))
    kw.update(tp_kwargs(mesh))
    if mesh.tp > 1:
        mcfg = dataclasses.replace(mcfg, nsa=tp_local(mcfg.nsa, mesh.tp))

    def run(i, bp, x, split=False):
        return block_prefill(make(i, bp), x, mcfg, split=split, **kw)

    rematted = mcfg.remat in (True, "full") and torch.is_grad_enabled()
    tout = kw.get("tp_out") or (lambda a: a)
    auxes = []
    for i, bp in enumerate(blocks):
        if rematted:
            x, m, aux = remat(functools.partial(run, split=True), i, bp, x)
            x = x + tout(m)
        else:
            x, aux = run(i, bp, x)
        if collect_aux:
            auxes.append({"gates": aux["gates"], "sel_idx": aux["sel_idx"]})
    return x, _gather_aux_tp(auxes, mesh)


def context_parallel_model_forward(params: dict, tokens: torch.Tensor, mcfg: ModelConfig,
                                   mesh: Mesh, collect_aux: bool = False, seq_start=None,
                                   block: Optional[Callable] = None) -> Tuple[torch.Tensor, list]:
    """TinyLM forward over this rank's rows (dp x sp x tp; under tp its
    params hold its slice of the blocks): tokens [B, S/sp] (positions
    [t0, t0 + S/sp) of the rank's dp rows) -> (logits [B, S/sp, vocab],
    per-layer {"gates", "sel_idx"} of the local rows if asked). seq_start
    [B, S]: packed documents, the whole rows' starts (under sp every rank
    of a dp member passes the same, as the JAX package's replicated
    seq_start). `block` and remat: run_blocks."""
    x, auxes = run_blocks(params["blocks"], embed(params, tokens, mcfg), mcfg, mesh,
                          collect_aux, seq_start, block)
    return head(params, x, mcfg), auxes
