"""Functional NSA attention: parameters, projections, batched prefill.

Port of nsa_vibe_tpu/core/nsa.py. The prefill
runs the fused scorer (`fused_select_cmp`: selection indices and the cmp
branch in one kernel) when it fits, by the JAX package's rule: at least
one compressed token and `select_cmp_fits(h, S_sel)` (at m7c, prompts up
to 16384 tokens). Otherwise the scorer runs alone (`select_blocks`) and
the cmp branch through the banded kernel (`compressed_attention`); either
route runs inside the span `prefill.score` (utils/trace.py). The
JAX package's own non-fused selection is XLA code chunked by
`prefill_chunk`; the port's scorer kernel computes the same sets without
a [chunk, S_cmp] score tensor, so the port has no `prefill_chunk`. Then
the selection and window branches, then the gated combine. It is
differentiable (the training hot path): each branch has a backward
kernel (ops.attention), the selection indices carry no gradient,
gradients reach W_K_cmp/W_V_cmp (and ϕ) through the pooling and the gate
through the combine. Decode lives in core/decode.py (it does not fold).

Gate-epilogue fold (ops/tuning.py `nsa.gate_fold`, default 0; JAX
core/nsa.py:218-245, :300-335): unless a force override is set, the gates
come from core/gate.py::gate_probs_dform (f32, the D-form gradient), each
branch kernel takes its gate column and emits g * O (ops/attention.py),
and the combine is the plain sum O_cmp + O_sel + O_win before W_O; the
gates in aux are detached. `nsa.flat_io` has no effect here (ops/tuning.py).

Packed documents (`seq_start`, ops/varlen.py): positions restart at each
document (RoPE of Q, K_sel, K_win and ϕ at t - seq_start) and every
branch stays inside the row's document. Both routes stay on kernels: the
JAX package's non-fused varlen route is XLA code
(`selection_scores_varlen`), the port's is the scorer kernel
`select_blocks` beside `compressed_attention`, as for dense rows.

Layouts: x [B, S, dim] -> out [B, S, dim];
  Q: [B, S, G, h, Dk] (RoPE'd);  per-branch K/V: [B, G, S, D*].
Parameters are a dict with the JAX package's keys, weights [in, out]
applied as x @ W, plus "W_qkv": the seven projection weights concatenated
once at construction (`fuse_projections`), whose column slices the seven
per-branch entries are (views, no second copy).

Tensor parallelism (parallel/mesh.py): a tp member runs nsa_prefill on
`tp_local(cfg, tp)` (G/tp KV groups, n_heads/tp heads) with its slices of
the projections (its W_qkv fuses them, in PROJ_KEYS order) and the rows of
W_O for its heads, so `combine_branches` returns its partial W_O product;
the caller sums the partials over tp. At tp = 1 nothing changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.core.gate import gate_probs, gate_probs_dform, init_gate_params
from nsa_vibe_tpu_torch.ops import attention as attn_ops
from nsa_vibe_tpu_torch.ops import tuning
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on
from nsa_vibe_tpu_torch.ops.compress import init_conv_phi_weight, pool_phi_rope_kv
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as select_cmp_mod
from nsa_vibe_tpu_torch.ops.rope import apply_rope
from nsa_vibe_tpu_torch.ops.selection import select_topn_blocks
from nsa_vibe_tpu_torch.ops.varlen import select_topn_blocks_varlen
from nsa_vibe_tpu_torch.utils import trace
from nsa_vibe_tpu_torch.utils.device import resolve_device

PROJ_KEYS = ("W_Q", "W_K_sel", "W_V_sel", "W_K_win", "W_V_win", "W_K_cmp", "W_V_cmp")


def tp_local(cfg: NSAConfig, tp: int) -> NSAConfig:
    """The attention configuration of one of tp members: n_kv_groups / tp
    groups, each with its h_per_group heads (the JAX pipeline's
    dataclasses.replace)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_groups=cfg.n_kv_groups // tp)


def uniform_linear(generator: torch.Generator, fan_in: int, fan_out: int, dtype,
                   device) -> torch.Tensor:
    lim = 1.0 / np.sqrt(fan_in)
    w = torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(-lim, lim,
                                                                     generator=generator)
    return w.to(device=device, dtype=dtype)


def fuse_projections(params: dict) -> dict:
    """Concatenate the seven projection weights once into "W_qkv" and make
    the seven per-branch entries column views of it."""
    W = torch.cat([params[k] for k in PROJ_KEYS], dim=1).contiguous()
    out = dict(params, W_qkv=W)
    o = 0
    for k in PROJ_KEYS:
        n = params[k].shape[1]
        out[k] = W[:, o:o + n]
        o += n
    return out


def init_nsa_params(cfg: NSAConfig, generator: torch.Generator, device="cuda",
                    dtype=torch.float32) -> dict:
    """7 projections + out + gate (+ conv ϕ weights), drawn from `generator`
    on the CPU and moved to `device` (raises without a card unless
    device="cpu")."""
    dev = resolve_device(device)
    H, G = cfg.n_heads, cfg.n_kv_groups

    def lin(fi, fo):
        return uniform_linear(generator, fi, fo, dtype, dev)

    params = {
        "W_Q": lin(cfg.dim, H * cfg.d_k),
        "W_K_sel": lin(cfg.dim, G * cfg.d_k),
        "W_V_sel": lin(cfg.dim, G * cfg.d_v),
        "W_K_win": lin(cfg.dim, G * cfg.d_k),
        "W_V_win": lin(cfg.dim, G * cfg.d_v),
        "W_K_cmp": lin(cfg.dim, G * cfg.d_k),
        "W_V_cmp": lin(cfg.dim, G * cfg.d_v),
        "W_O": lin(H * cfg.d_v, cfg.dim),
        "gate": init_gate_params(generator, cfg.d_k, cfg.gate_hidden, dtype, dev),
    }
    if cfg.phi == "conv":
        params["phi_k"] = init_conv_phi_weight(cfg.d_k, cfg.l, dtype, dev)
        params["phi_v"] = init_conv_phi_weight(cfg.d_v, cfg.l, dtype, dev)
    return fuse_projections(params)


def project_qkv(params: dict, x: torch.Tensor, cfg: NSAConfig, fused: bool = True):
    """All 7 projections. Returns Q [B,S,H,Dk] and per-branch K/V [B,G,S,D*]
    (no RoPE yet). fused=True runs one matmul against "W_qkv"; the output
    columns are independent, so slicing it equals the seven separate
    products."""
    B, S, _ = x.shape
    G, dk, dv = cfg.n_kv_groups, cfg.d_k, cfg.d_v

    def kv(y, dd):
        return y.reshape(B, S, G, dd).transpose(1, 2)

    if fused:
        if "W_qkv" not in params:
            raise KeyError("params lack 'W_qkv'; build them with init_nsa_params, "
                           "params_from_numpy or fuse_projections")
        Y = x @ params["W_qkv"]
        nq = cfg.n_heads * dk
        outs, o = [], nq
        for dd in (dk, dv, dk, dv, dk, dv):   # sel K/V, win K/V, cmp K/V
            outs.append(kv(Y[..., o:o + G * dd], dd))
            o += G * dd
        return (Y[..., :nq].reshape(B, S, cfg.n_heads, dk), *outs)
    Q = (x @ params["W_Q"]).reshape(B, S, cfg.n_heads, dk)
    return (Q,
            kv(x @ params["W_K_sel"], dk), kv(x @ params["W_V_sel"], dv),
            kv(x @ params["W_K_win"], dk), kv(x @ params["W_V_win"], dv),
            kv(x @ params["W_K_cmp"], dk), kv(x @ params["W_V_cmp"], dv))


def combine_branches(params: dict, cfg: NSAConfig, Q: torch.Tensor, O_cmp: torch.Tensor,
                     O_sel: torch.Tensor, O_win: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate over the group-mean-pooled query, weighted branch sum, output
    projection. Q: [B,S,G,h,Dk]; O_*: [B,S,G,h,Dv]. Returns (out, gates);
    with a tp member's G groups and rows of W_O, out is its partial
    product."""
    B, S = Q.shape[:2]
    gates = gate_probs(params["gate"], Q.mean(dim=3), cfg.gate_temp,
                       force_branch=cfg.force_branch, force_uniform=cfg.force_uniform_gate)
    w_cmp, w_sel, w_win = (gates[..., i, None, None] for i in range(3))   # [B,S,G,1,1]
    O = w_cmp * O_cmp + w_sel * O_sel + w_win * O_win
    return O.reshape(B, S, cfg.n_heads * cfg.d_v) @ params["W_O"], gates


def nsa_prefill(params: dict, x: torch.Tensor, cfg: NSAConfig, seq_start=None, t0: int = 0,
                gather_kv: Optional[Callable] = None,
                seq_start_kv=None) -> Tuple[torch.Tensor, dict]:
    """Batched prefill forward. x: [B, S, dim] -> (out [B, S, dim], aux);
    aux carries the raw/compressed K/V (for cache seeding), the selection
    (scorer set form) and the gates. seq_start [B, S] int (optional):
    each token's document start in a packed row (ops/varlen.py; starts
    l_sel-aligned and non-decreasing along a row, as
    varlen.pack_documents_aligned makes them).

    Sequence sharding (parallel/context.py): x holds the rows at positions
    [t0, t0 + S) and `gather_kv` maps each of the six K/V streams of those
    rows, after RoPE, to the whole sequence's [B, G, S_kv, D] (an
    all-gather over the sp ranks); ϕ then pools the gathered raw stream at
    positions 0..S_kv-1 and every kernel takes the offset t0. Packed
    documents under sequence sharding: seq_start [B, S] holds the local
    rows' starts (packed positions, as the kernels read them at the offset)
    and seq_start_kv [B, S_kv] every key's, for ϕ's pooling positions
    (the JAX package's seq_start_full). It is an argument, not a gather:
    every sp rank of a dp member holds the whole packed row already, and a
    gather would cost one collective per layer (twice under remat)."""
    B, S, _ = x.shape
    G, h = cfg.n_kv_groups, cfg.h_per_group
    scale = 1.0 / float(np.sqrt(cfg.d_k))
    dev = x.device
    if t0 and gather_kv is None:
        raise ValueError("t0 > 0 needs gather_kv: the keys must cover positions 0..t0+S-1")
    if seq_start is not None and gather_kv is not None and seq_start_kv is None:
        raise ValueError("seq_start with gather_kv needs seq_start_kv, the starts of every key")
    t_pos = torch.arange(t0, t0 + S, device=dev)
    if seq_start is not None:
        seq_start = seq_start.to(device=dev, dtype=torch.int32).contiguous()
        t_local = t_pos[None, :] - seq_start                       # [B,S] doc-local
        q_pos, k_pos = t_local[:, :, None], t_local[:, None, :]    # -> [B,S,H], [B,G,S]
    else:
        q_pos, k_pos = t_pos[:, None], t_pos

    Q, K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw = project_qkv(params, x, cfg)
    Q = apply_rope(Q, q_pos, cfg.rope_base, cfg.rope_scale).reshape(B, S, G, h, cfg.d_k)
    K_sel = apply_rope(K_sel, k_pos, cfg.rope_base, cfg.rope_scale)
    K_win = apply_rope(K_win, k_pos, cfg.rope_base, cfg.rope_scale)
    if gather_kv is not None:
        K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw = (
            gather_kv(a) for a in (K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw))
        k_pos = torch.arange(K_sel.shape[2], device=dev)
        if seq_start is not None:   # document-local pooling positions of every key
            k_pos = (k_pos[None, :] - seq_start_kv.to(device=dev, dtype=torch.int32))[:, None, :]
    S_kv = K_sel.shape[2]
    K_cmp, V_cmp = pool_phi_rope_kv(
        K_cmp_raw, V_cmp_raw, cfg.l, cfg.d, pos=k_pos,
        k_weight=params.get("phi_k"), v_weight=params.get("phi_v"),
        rope_base=cfg.rope_base, rope_scale=cfg.rope_scale)
    S_cmp = K_cmp.shape[2]
    S_sel = -(-S_kv // cfg.l_sel)
    sel_kw = dict(scale=scale, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel,
                  force_init=cfg.force_init, force_local=cfg.force_local, pos_offset=t0)
    # the gate-epilogue fold (module docstring); force overrides keep the
    # gated combine of combine_branches
    use_fold = (bool(tuning.tuned("nsa.gate_fold")) and cfg.force_branch is None
                and not cfg.force_uniform_gate)
    g_cmp = g_sel = g_win = gates_fold = None
    if use_fold:
        gates_fold = gate_probs_dform(params["gate"], Q.mean(dim=3), cfg.gate_temp)   # [B,S,G,3]
        # the kernels take each column contiguous
        g_cmp, g_sel, g_win = gates_fold.movedim(-1, 0).contiguous()

    with trace.span("prefill.score"):   # the scorer, and the cmp branch it yields
        if S_cmp > 0 and select_cmp_mod.select_cmp_fits(h, S_sel):
            # one pass: selection scores and the cmp branch share softmax(Q K_cmp^T)
            M = build_M_csl_on(S_kv, cfg.l, cfg.d, cfg.l_sel, dev)
            sel_idx, O_cmp = attn_ops.fused_select_cmp(Q, K_cmp, V_cmp, M, **sel_kw,
                                                       seq_start=seq_start, gate=g_cmp)
        elif S_cmp > 0:
            # too many selection blocks for the fused scorer: two kernels
            sel_idx = attn_ops.select_blocks(Q, K_cmp, S_sel=S_sel, **sel_kw, seq_start=seq_start)
            O_cmp = attn_ops.compressed_attention(Q, K_cmp, V_cmp, l=cfg.l, d=cfg.d, scale=scale,
                                                  t_start=t0, seq_start=seq_start, gate=g_cmp)
        else:
            # no compressed tokens (S < l): all scores are 0, so the top-n keeps
            # the forced blocks plus the lowest-index candidates, as in JAX; the
            # scorer is not launched and the cmp branch is zero
            p_grp = torch.zeros((B, S, G, S_sel), dtype=torch.float32, device=dev)
            if seq_start is not None:
                sel_idx = select_topn_blocks_varlen(p_grp, cfg.n_sel, t_pos, seq_start, cfg.l_sel,
                                                    cfg.force_init, cfg.force_local)
            else:
                sel_idx = select_topn_blocks(p_grp, cfg.n_sel, t_pos, cfg.l_sel,
                                             cfg.force_init, cfg.force_local)
            # (under the fold too: the gated branch is zero and carries no gate
            # gradient, its true gradient D = rowsum(dY * 0) = 0)
            O_cmp = torch.zeros((B, S, G, h, cfg.d_v), dtype=Q.dtype, device=dev)
    sel_idx = sel_idx.detach()
    O_sel = attn_ops.selection_attention(Q, K_sel, V_sel, sel_idx, t_pos, cfg.l_sel, scale,
                                         gate=g_sel)
    O_win = attn_ops.sliding_window_attention(Q, K_win, V_win, cfg.w, scale,
                                              seq_start=seq_start, t_start=t0, gate=g_win)
    if use_fold:
        O = O_cmp + O_sel + O_win   # the branches are pre-gated
        out = O.reshape(B, S, cfg.n_heads * cfg.d_v) @ params["W_O"]
        gates = gates_fold.detach()   # their gradient contract is the D form
    else:
        out, gates = combine_branches(params, cfg, Q, O_cmp, O_sel, O_win)
    aux = {
        "gates": gates,
        "sel_idx": sel_idx,
        "K_sel": K_sel, "V_sel": V_sel,
        "K_win": K_win, "V_win": V_win,
        "K_cmp_raw": K_cmp_raw, "V_cmp_raw": V_cmp_raw,
        "K_cmp": K_cmp, "V_cmp": V_cmp,
    }
    return out, aux
