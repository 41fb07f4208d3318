"""Functional NSA attention: parameters, projections, batched prefill.

Port of nsa_vibe_tpu/core/nsa.py (forward; no varlen, no gate fold). The
prefill runs the fused scorer (`fused_select_cmp`: selection indices and
the cmp branch in one kernel), then the selection and window branches,
then the gated combine. Decode lives in core/decode.py.

Layouts: x [B, S, dim] -> out [B, S, dim];
  Q: [B, S, G, h, Dk] (RoPE'd);  per-branch K/V: [B, G, S, D*].
Parameters are a dict with the JAX package's keys, weights [in, out]
applied as x @ W, plus "W_qkv": the seven projection weights concatenated
once at construction (`fuse_projections`), whose column slices the seven
per-branch entries are (views, no second copy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.core.gate import gate_probs, init_gate_params
from nsa_vibe_tpu_torch.ops import attention as attn_ops
from nsa_vibe_tpu_torch.ops.block_index import build_block_meta, build_M_csl_on
from nsa_vibe_tpu_torch.ops.compress import init_conv_phi_weight, pool_phi_rope_kv
from nsa_vibe_tpu_torch.ops.rope import apply_rope
from nsa_vibe_tpu_torch.ops.selection import select_topn_blocks
from nsa_vibe_tpu_torch.utils.device import resolve_device

PROJ_KEYS = ("W_Q", "W_K_sel", "W_V_sel", "W_K_win", "W_V_win", "W_K_cmp", "W_V_cmp")


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
    projection. Q: [B,S,G,h,Dk]; O_*: [B,S,G,h,Dv]. Returns (out, gates)."""
    B, S = Q.shape[:2]
    gates = gate_probs(params["gate"], Q.mean(dim=3), cfg.gate_temp,
                       force_branch=cfg.force_branch, force_uniform=cfg.force_uniform_gate)
    w_cmp, w_sel, w_win = (gates[..., i, None, None] for i in range(3))   # [B,S,G,1,1]
    O = w_cmp * O_cmp + w_sel * O_sel + w_win * O_win
    return O.reshape(B, S, cfg.n_heads * cfg.d_v) @ params["W_O"], gates


def nsa_prefill(params: dict, x: torch.Tensor, cfg: NSAConfig) -> Tuple[torch.Tensor, dict]:
    """Batched prefill forward. x: [B, S, dim] -> (out [B, S, dim], aux);
    aux carries the raw/compressed K/V (for cache seeding), the selection
    (scorer set form) and the gates."""
    B, S, _ = x.shape
    G, h = cfg.n_kv_groups, cfg.h_per_group
    scale = 1.0 / float(np.sqrt(cfg.d_k))
    dev = x.device
    t_pos = torch.arange(S, device=dev)

    Q, K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw = project_qkv(params, x, cfg)
    Q = apply_rope(Q, t_pos[:, None], cfg.rope_base, cfg.rope_scale).reshape(B, S, G, h, cfg.d_k)
    K_sel = apply_rope(K_sel, t_pos, cfg.rope_base, cfg.rope_scale)
    K_win = apply_rope(K_win, t_pos, cfg.rope_base, cfg.rope_scale)
    K_cmp, V_cmp = pool_phi_rope_kv(
        K_cmp_raw, V_cmp_raw, cfg.l, cfg.d, pos=t_pos,
        k_weight=params.get("phi_k"), v_weight=params.get("phi_v"),
        rope_base=cfg.rope_base, rope_scale=cfg.rope_scale)
    S_cmp = K_cmp.shape[2]

    if S_cmp > 0:
        # one pass: selection scores and the cmp branch share softmax(Q K_cmp^T)
        M = build_M_csl_on(S, cfg.l, cfg.d, cfg.l_sel, dev)
        sel_idx, O_cmp = attn_ops.fused_select_cmp(
            Q, K_cmp, V_cmp, M, scale=scale, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel,
            n_top=cfg.n_sel, force_init=cfg.force_init, force_local=cfg.force_local)
    else:
        # no compressed tokens (S < l): all scores are 0, so the top-n keeps
        # the forced blocks plus the lowest-index candidates, as in JAX; the
        # scorer is not launched and the cmp branch is zero
        S_sel = build_block_meta(S, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w).S_sel
        p_grp = torch.zeros((B, S, G, S_sel), dtype=torch.float32, device=dev)
        sel_idx = select_topn_blocks(p_grp, cfg.n_sel, t_pos, cfg.l_sel,
                                     cfg.force_init, cfg.force_local)
        O_cmp = torch.zeros((B, S, G, h, cfg.d_v), dtype=Q.dtype, device=dev)
    O_sel = attn_ops.selection_attention(Q, K_sel, V_sel, sel_idx, t_pos, cfg.l_sel, scale)
    O_win = attn_ops.sliding_window_attention(Q, K_win, V_win, cfg.w, scale)
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
