"""Single-token decode steps with O(reads) work. Port of
nsa_vibe_tpu/core/decode.py: the uniform step (`nsa_decode_step`, one
host-int position for the batch) and the ragged step
(`nsa_decode_step_ragged`, a position per row on the device).

Per step: append the token to the selection, window and raw-cmp caches;
emit one compressed token every d steps after warm-up l ((S_raw - l) % d
== 0), ϕ over the last l raw tokens; score selection against the emitted
stream (plain tensor code, Eq. 8-12); run the three branches for one
query. As in the JAX package, decode cmp and win are plain tensor code;
only the selection gather is a kernel (ops/cuda/sel_attn.py).

The cache is updated in place (see core/cache.py). The uniform step's
position `cache.t` is a host int, so stepping needs no device sync; it
branches on it in Python and raises past capacity. The ragged step keeps
t on the device and has no Python branch on a device value, no boolean
mask indexing and no read of a device value, so it can be captured in a
CUDA graph (models/decode_graph.py): every row is scattered at its own
slot, the emission is written at every step through `where`, and
capacity is reported per row (`overflow`), not raised. `DecodeInfo`
carries the read counters that must equal
`ops.block_index.expected_decode_reads`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.cache import NSACache, cmp_capacity
from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.core.nsa import combine_branches, project_qkv
from nsa_vibe_tpu_torch.ops import attention as attn_ops
from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.rope import apply_rope
from nsa_vibe_tpu_torch.ops.selection import select_topn_blocks, selection_scores

Count = Union[int, bool, torch.Tensor]


class DecodeInfo(NamedTuple):
    """Per-step read accounting (formula and actual, from the masks applied).
    The uniform step gives host ints where it can (counts shared by the
    batch) and raises past capacity (overflow False); the ragged step gives
    every counter as a [B] tensor on the device and overflow per row."""

    reads_pred: Count             # num_cmp + n*l' + min(w, S_raw)
    reads_cmp: Count              # num_cmp(S_raw)
    reads_sel: Count              # n*l' (selection gather width)
    reads_win: Count              # min(w, S_raw)
    sel_valid_tokens: torch.Tensor   # un-masked gathered tokens (mean over G, and B if uniform)
    reads_actual: torch.Tensor    # cmp + sel + win actuals
    reads_actual_cmp: Count
    reads_actual_sel: torch.Tensor
    reads_actual_win: Count
    sel_idx: torch.Tensor         # [B,1,G,n] selected blocks (sorted, unique, -1 tail)
    gates: torch.Tensor           # [B,1,G,3]
    overflow: Count               # this step's row(s) at t >= capacity
    p_grp: torch.Tensor           # [B,1,G,S_sel] f32 group scores sel_idx ranks


def nsa_decode_step(params: dict, x: torch.Tensor, cache: NSACache,
                    cfg: NSAConfig) -> Tuple[torch.Tensor, NSACache, DecodeInfo]:
    """One decode step. x: [B, 1, dim] -> (out [B,1,dim], cache, info).
    Writes this token into `cache` in place and returns it."""
    B = x.shape[0]
    G, h = cfg.n_kv_groups, cfg.h_per_group
    C = cache.capacity
    t = cache.t                           # this token's position
    if t >= C:
        raise ValueError(f"decode past cache capacity {C} (t={t})")
    C_cmp = cmp_capacity(C, cfg.l, cfg.d)
    scale = 1.0 / float(np.sqrt(cfg.d_k))
    s_raw = t + 1
    dev = x.device
    pos = torch.full((1,), t, dtype=torch.int64, device=dev)

    Q, K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw = project_qkv(params, x, cfg)
    Q = apply_rope(Q, pos[:, None], cfg.rope_base, cfg.rope_scale).reshape(B, 1, G, h, cfg.d_k)
    rope = (lambda k: apply_rope(k, pos, cfg.rope_base, cfg.rope_scale)[:, :, 0])

    cache.k_sel[:, :, t] = rope(K_sel)
    cache.v_sel[:, :, t] = V_sel[:, :, 0]
    cache.k_win[:, :, t % cfg.w] = rope(K_win)
    cache.v_win[:, :, t % cfg.w] = V_win[:, :, 0]
    cache.k_cmp_raw[:, :, t % cfg.l] = rope(K_cmp_raw)
    cache.v_cmp_raw[:, :, t % cfg.l] = V_cmp_raw[:, :, 0]

    # compressed emission: every d steps after warm-up l
    num_cmp = (s_raw - cfg.l) // cfg.d + 1 if s_raw >= cfg.l else 0
    if s_raw >= cfg.l and (s_raw - cfg.l) % cfg.d == 0:
        e_slot = min(num_cmp - 1, C_cmp - 1)
        if cfg.phi == "conv":
            # ordered window: positions s_raw-l .. s_raw-1 live at slots pos % l
            order = (torch.arange(cfg.l, device=dev) + s_raw) % cfg.l
            kw, vw = cache.k_cmp_raw[:, :, order], cache.v_cmp_raw[:, :, order]
            k_new = torch.einsum("bgld,dl->bgd", kw, params["phi_k"].to(kw.dtype))
            v_new = torch.einsum("bgld,dl->bgd", vw, params["phi_v"].to(vw.dtype))
        else:
            k_new, v_new = cache.k_cmp_raw.mean(dim=2), cache.v_cmp_raw.mean(dim=2)
        cache.k_cmp[:, :, e_slot] = k_new
        cache.v_cmp[:, :, e_slot] = v_new

    # selection scoring (Eq. 8-12) over the emitted compressed stream
    p_grp = selection_scores(Q, cache.k_cmp, cache.m_csl, scale,
                             torch.full((1,), num_cmp, device=dev))   # [B,1,G,S_sel]
    sel_idx = select_topn_blocks(p_grp, cfg.n_sel, pos, cfg.l_sel,
                                 cfg.force_init, cfg.force_local)     # [B,1,G,n]
    n_eff = sel_idx.shape[-1]

    # three branches for the single query; a forced branch skips the others
    # (their gate is exactly 0)
    fb = cfg.force_branch.strip().lower() if cfg.force_branch else None
    O_zero = torch.zeros((B, 1, G, h, cfg.d_v), dtype=Q.dtype, device=dev)
    if fb in (None, "sel"):
        O_sel = attn_ops.selection_attention(Q, cache.k_sel, cache.v_sel, sel_idx, pos,
                                             cfg.l_sel, scale)
        blocks = sel_idx[:, 0].to(torch.int64)                        # [B,G,n]
        tok = blocks[..., None] * cfg.l_sel + torch.arange(cfg.l_sel, device=dev)
        sel_actual = ((blocks[..., None] >= 0) & (tok <= t) & (tok < C)).sum(
            dim=(-1, -2)).float().mean()
    else:
        O_sel, sel_actual = O_zero, torch.zeros((), device=dev)
    reads_win = min(cfg.w, s_raw)
    if fb in (None, "win"):
        win_valid = (torch.arange(cfg.w, device=dev) <= t) | (t >= cfg.w)
        O_win = ref.attend_masked(Q, cache.k_win, cache.v_win, win_valid, scale)
        win_actual = reads_win
    else:
        O_win, win_actual = O_zero, 0
    if fb in (None, "cmp"):
        cmp_valid = torch.arange(C_cmp, device=dev) < num_cmp
        O_cmp = ref.attend_masked(Q, cache.k_cmp, cache.v_cmp, cmp_valid, scale)
        cmp_actual = min(num_cmp, C_cmp)
    else:
        O_cmp, cmp_actual = O_zero, 0

    out, gates = combine_branches(params, cfg, Q, O_cmp, O_sel, O_win)
    cache.t = t + 1
    info = DecodeInfo(
        reads_pred=num_cmp + n_eff * cfg.l_sel + reads_win,
        reads_cmp=num_cmp,
        reads_sel=n_eff * cfg.l_sel,
        reads_win=reads_win,
        sel_valid_tokens=sel_actual,
        reads_actual=sel_actual + (cmp_actual + win_actual),
        reads_actual_cmp=cmp_actual,
        reads_actual_sel=sel_actual,
        reads_actual_win=win_actual,
        sel_idx=sel_idx,
        gates=gates,
        overflow=False,
        p_grp=p_grp,
    )
    return out, cache, info


def nsa_prefill_via_decode(params: dict, x: torch.Tensor, cache: NSACache,
                           cfg: NSAConfig) -> Tuple[torch.Tensor, NSACache]:
    """Prefill by stepping the decode step over the tokens: the per-token
    parity oracle for nsa_prefill. x: [B, S, dim]; cache needs room for
    cache.t + S tokens. Returns (out [B, S, dim], cache)."""
    outs = []
    for i in range(x.shape[1]):
        out_t, cache, _ = nsa_decode_step(params, x[:, i:i + 1], cache, cfg)
        outs.append(out_t)
    return torch.cat(outs, dim=1), cache


def nsa_decode_step_ragged(params: dict, x: torch.Tensor, cache: NSACache,
                           cfg: NSAConfig) -> Tuple[torch.Tensor, NSACache, DecodeInfo]:
    """One decode step with per-row positions: cache.t is an int32 tensor
    [B] (core/cache.py::ragged_cache), each row at its own depth (the
    continuous-batching shape, with cache.admit_row). Per row the same
    function as nsa_decode_step: per-row scatters, each row's emission on
    its own (s_raw - l) % d schedule, selection over each row's own
    compressed stream, and the same selection kernel with per-row t_pos.

    x: [B, 1, dim] -> (out [B,1,dim], cache, info). Writes the token into
    `cache` in place, t += 1 included. A row at t >= capacity writes its
    last slot and gives garbage, flagged by info.overflow; callers check
    capacity on the host before stepping."""
    B = x.shape[0]
    G, h = cfg.n_kv_groups, cfg.h_per_group
    C = cache.capacity
    C_cmp = cmp_capacity(C, cfg.l, cfg.d)
    scale = 1.0 / float(np.sqrt(cfg.d_k))
    dev = x.device
    t = cache.t.to(torch.int64)                 # [B] per-row positions (a copy)
    s_raw = t + 1
    rows = torch.arange(B, device=dev)

    Q, K_sel, V_sel, K_win, V_win, K_cmp_raw, V_cmp_raw = project_qkv(params, x, cfg)
    pos = t[:, None, None]                      # broadcasts to [B,{S=1|G},1]
    Q = apply_rope(Q, pos, cfg.rope_base, cfg.rope_scale).reshape(B, 1, G, h, cfg.d_k)
    rope = (lambda k: apply_rope(k, pos, cfg.rope_base, cfg.rope_scale)[:, :, 0])

    # cache writes: per-row scatters (a row past capacity writes its last slot)
    tw = torch.clamp(t, max=C - 1)
    cache.k_sel[rows, :, tw] = rope(K_sel)
    cache.v_sel[rows, :, tw] = V_sel[:, :, 0]
    cache.k_win[rows, :, t % cfg.w] = rope(K_win)
    cache.v_win[rows, :, t % cfg.w] = V_win[:, :, 0]
    cache.k_cmp_raw[rows, :, t % cfg.l] = rope(K_cmp_raw)
    cache.v_cmp_raw[rows, :, t % cfg.l] = V_cmp_raw[:, :, 0]

    # compressed emission: per-row schedule, written at every step (the old
    # value where a row does not emit)
    emit = (s_raw >= cfg.l) & ((s_raw - cfg.l) % cfg.d == 0)                 # [B]
    num_cmp = torch.where(s_raw >= cfg.l, (s_raw - cfg.l) // cfg.d + 1, 0)   # [B]
    e_slot = torch.clamp(num_cmp - 1, 0, C_cmp - 1)
    if cfg.phi == "conv":
        # ordered window: positions s_raw-l .. s_raw-1 live at slots pos % l
        order = (torch.arange(cfg.l, device=dev)[None, :] + s_raw[:, None]) % cfg.l
        kw = torch.gather(cache.k_cmp_raw, 2, order[:, None, :, None].expand(
            B, G, cfg.l, cfg.d_k))
        vw = torch.gather(cache.v_cmp_raw, 2, order[:, None, :, None].expand(
            B, G, cfg.l, cfg.d_v))
        k_new = torch.einsum("bgld,dl->bgd", kw, params["phi_k"].to(kw.dtype))
        v_new = torch.einsum("bgld,dl->bgd", vw, params["phi_v"].to(vw.dtype))
    else:
        k_new, v_new = cache.k_cmp_raw.mean(dim=2), cache.v_cmp_raw.mean(dim=2)
    em = emit[:, None, None]
    cache.k_cmp[rows, :, e_slot] = torch.where(em, k_new, cache.k_cmp[rows, :, e_slot])
    cache.v_cmp[rows, :, e_slot] = torch.where(em, v_new, cache.v_cmp[rows, :, e_slot])

    # selection scoring over each row's own compressed stream
    p_grp = selection_scores(Q, cache.k_cmp, cache.m_csl, scale, num_cmp[:, None])
    sel_idx = select_topn_blocks(p_grp, cfg.n_sel, t[:, None], cfg.l_sel,
                                 cfg.force_init, cfg.force_local)     # [B,1,G,n]
    n_eff = sel_idx.shape[-1]

    # three branches for the single query, per-row visibility
    fb = cfg.force_branch.strip().lower() if cfg.force_branch else None
    O_zero = torch.zeros((B, 1, G, h, cfg.d_v), dtype=Q.dtype, device=dev)
    zero_b = torch.zeros((B,), dtype=torch.int64, device=dev)
    if fb in (None, "sel"):
        O_sel = attn_ops.selection_attention(Q, cache.k_sel, cache.v_sel, sel_idx, t[:, None],
                                             cfg.l_sel, scale)
        blocks = sel_idx[:, 0].to(torch.int64)                        # [B,G,n]
        tok = blocks[..., None] * cfg.l_sel + torch.arange(cfg.l_sel, device=dev)
        sel_actual = ((blocks[..., None] >= 0) & (tok <= t[:, None, None, None])
                      & (tok < C)).sum(dim=(-1, -2)).float().mean(dim=-1)
    else:
        O_sel, sel_actual = O_zero, zero_b.float()
    if fb in (None, "win"):
        win_valid = ((torch.arange(cfg.w, device=dev)[None, :] <= t[:, None])
                     | (t[:, None] >= cfg.w))                                 # [B,w]
        O_win = ref.attend_masked(Q, cache.k_win, cache.v_win,
                                  win_valid[:, None, None, None, :], scale)
        win_actual = win_valid.sum(dim=-1)
    else:
        O_win, win_actual = O_zero, zero_b
    if fb in (None, "cmp"):
        cmp_valid = torch.arange(C_cmp, device=dev)[None, :] < num_cmp[:, None]   # [B,C_cmp]
        O_cmp = ref.attend_masked(Q, cache.k_cmp, cache.v_cmp,
                                  cmp_valid[:, None, None, None, :], scale)
        cmp_actual = cmp_valid.sum(dim=-1)
    else:
        O_cmp, cmp_actual = O_zero, zero_b

    out, gates = combine_branches(params, cfg, Q, O_cmp, O_sel, O_win)
    cache.t.add_(1)
    reads_win = torch.clamp(s_raw, max=cfg.w)
    info = DecodeInfo(
        reads_pred=num_cmp + n_eff * cfg.l_sel + reads_win,
        reads_cmp=num_cmp,
        reads_sel=torch.full((B,), n_eff * cfg.l_sel, dtype=torch.int64, device=dev),
        reads_win=reads_win,
        sel_valid_tokens=sel_actual,
        reads_actual=(cmp_actual + win_actual).float() + sel_actual,
        reads_actual_cmp=cmp_actual,
        reads_actual_sel=sel_actual,
        reads_actual_win=win_actual,
        sel_idx=sel_idx,
        gates=gates,
        overflow=t >= C,
        p_grp=p_grp,
    )
    return out, cache, info
