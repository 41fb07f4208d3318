"""Selection scoring pipeline: Eq. 8-12 of the NSA paper, shape-static.

Port of nsa_vibe_tpu/ops/selection.py:
  p_cmp   = softmax(Q · K_cmp^T)          (Eq. 8, per-row prefix visibility)
  p_slc   = p_cmp @ M_csl                 (Eq. 9, dense matmul)
  p_grp   = sum_h p_slc                   (Eq. 10, GQA-consistent)
  blocks  = deterministic top-n with forced init/local blocks (Eq. 11-12)

The top-n ranks `score - 1e-8 * index` in float32 and prefers the lower
index on exact ties (a stable descending sort, like `lax.top_k`).
`topn_forced_first` gives the fused scorer's output contract (forced
slots first, possibly repeated, then the picks in rank order, -1 when no
candidate is left); `select_topn_blocks` gives its canonical form, sorted
ascending, unique, -1 padded (`canonicalize_sel`).

Rows at a position offset (a query slice, the needle's last row) pass
their positions t_pos = pos_offset + arange(S) and their visible counts
`ops.reference.num_cmp_per_token(..., t_start=pos_offset)`; the forced
blocks and the causal clamp follow t_pos.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def compute_pcmp_masked(Q: torch.Tensor, K_cmp: torch.Tensor, scale: float,
                        num_cmp_t: torch.Tensor) -> torch.Tensor:
    """Eq. 8 with per-row visibility: token t sees the first num_cmp(t)
    compressed tokens; rows with num_cmp(t) == 0 are all zero.
    num_cmp_t: [S], or [B,S] for per-row depths. Returns f32 [B,S,G,h,S_cmp]."""
    S_cmp = K_cmp.shape[2]
    logits = torch.einsum("bsghd,bgcd->bsghc", Q.float(), K_cmp.float()) * scale
    c_idx = torch.arange(S_cmp, device=Q.device)
    if num_cmp_t.dim() == 1:
        vis = (c_idx[None, :] < num_cmp_t[:, None])[None, :, None, None, :]
        any_vis = (num_cmp_t > 0)[None, :, None, None, None]
    else:
        vis = (c_idx[None, None, :] < num_cmp_t[..., None])[:, :, None, None, :]
        any_vis = (num_cmp_t > 0)[:, :, None, None, None]
    p = torch.softmax(logits.masked_fill(~vis, NEG_INF), dim=-1)
    return torch.where(any_vis, p, torch.zeros((), device=p.device))


def map_pcmp_to_pslc(p_cmp: torch.Tensor, M_csl: torch.Tensor) -> torch.Tensor:
    """Eq. 9: p_slc = p_cmp @ M. p_cmp [..., S_cmp], M [S_cmp, S_sel]."""
    return torch.matmul(p_cmp, M_csl.to(p_cmp.dtype))


def group_reduce(p_slc: torch.Tensor) -> torch.Tensor:
    """Eq. 10: sum over heads in each GQA group. [B,S,G,h,S_sel] -> [B,S,G,S_sel]."""
    return p_slc.sum(dim=3)


def selection_scores(Q: torch.Tensor, K_cmp: torch.Tensor, M_csl: torch.Tensor,
                     scale: float, num_cmp_t: torch.Tensor) -> torch.Tensor:
    """Fused Eq. 8-10: Q, K_cmp -> group scores [B,S,G,S_sel] (float32)."""
    return group_reduce(map_pcmp_to_pslc(compute_pcmp_masked(Q, K_cmp, scale, num_cmp_t), M_csl))


def forced_block_ids(t_pos: torch.Tensor, l_sel: int, force_init: bool,
                     force_local: int) -> torch.Tensor:
    """Forced slots per query position: block 0 and the last `force_local`
    blocks containing/preceding t. [S] -> [S, n_forced] int32."""
    cols = []
    if force_init:
        cols.append(torch.zeros_like(t_pos))
    last = torch.div(t_pos, l_sel, rounding_mode="floor")
    for i in range(force_local):
        cols.append(torch.clamp(last - i, min=0))
    if not cols:
        return torch.zeros((t_pos.shape[0], 0), dtype=torch.int32, device=t_pos.device)
    return torch.stack(cols, dim=-1).to(torch.int32)


def effective_sel_blocks(n_top: int, force_init: bool = True, force_local: int = 2) -> int:
    """Width of the sel_idx block set: max(n_top, n_forced)."""
    return max(n_top, (1 if force_init else 0) + force_local)


def tie_break_scores(scores: torch.Tensor) -> torch.Tensor:
    """score - 1e-8 * block index, in float32 (two roundings, as in the
    reference and the kernel: the product, then the difference)."""
    blk = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.float32)
    return scores.float() - blk * 1e-8


def canonicalize_sel(sel: torch.Tensor) -> torch.Tensor:
    """Sort each row's block ids ascending, drop duplicates and pad with -1
    at the tail. Maps the kernel's forced-first form and the reference's
    sorted form to the same tensor."""
    big = torch.iinfo(torch.int32).max
    x = torch.where(sel < 0, torch.full_like(sel, big), sel).to(torch.int32)
    x = torch.sort(x, dim=-1).values
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    x = torch.sort(torch.where(dup, torch.full_like(x, big), x), dim=-1).values
    return torch.where(x == big, torch.full_like(x, -1), x)


def count_distinct_blocks(sel: torch.Tensor) -> torch.Tensor:
    """Distinct non-negative block ids per row of sel [..., n] (any form:
    forced-first with repeats or canonical) -> [...] int64."""
    x = torch.sort(sel, dim=-1).values
    new = torch.ones_like(x, dtype=torch.bool)
    new[..., 1:] = x[..., 1:] != x[..., :-1]
    return ((x >= 0) & new).sum(-1)


def topn_forced_first(p_grp: torch.Tensor, n_top: int, t_pos: torch.Tensor,
                      l_sel: int, force_init: bool = True,
                      force_local: int = 2) -> torch.Tensor:
    """Deterministic top-n selection-block choice (Eq. 11-12) in the fused
    scorer's form. p_grp: [B,S,G,S_sel]; t_pos: [S], or [B,S] for per-row
    depths. Returns sel_idx [B,S,G,max(n_top,n_forced)] int32: the forced
    slots, then the non-forced blocks with start <= t in descending
    `p_grp - 1e-8 * index` order, -1 when none is left."""
    B, S, G, S_sel = p_grp.shape
    t_pos = t_pos.to(torch.int64)
    dev = p_grp.device
    blk = torch.arange(S_sel, device=dev)

    def bx(m):  # [S, S_sel] or [B, S, S_sel] -> broadcast over [B,S,G,S_sel]
        return m[None, :, None, :] if t_pos.dim() == 1 else m[:, :, None, :]

    valid = (blk * l_sel) <= t_pos[..., None]
    scores = torch.where(bx(valid), p_grp.float(), torch.full((), NEG_INF, device=dev))
    forced = forced_block_ids(t_pos.reshape(-1), l_sel, force_init, force_local)
    forced = forced.reshape(*t_pos.shape, -1)
    F_ = forced.shape[-1]
    if F_ > 0:
        fmask = (blk[:, None] == forced[..., None, :]).any(dim=-1)
        scores = scores.masked_fill(bx(fmask), NEG_INF)
    k_rest = max(0, n_top - F_)
    fexp = forced[None, :, None, :] if t_pos.dim() == 1 else forced[:, :, None, :]
    picks = [fexp.expand(B, S, G, F_).to(torch.int32)] if F_ else []
    if k_rest > 0:
        composite = tie_break_scores(scores)
        k_actual = min(k_rest, S_sel)
        srt = torch.sort(composite, dim=-1, descending=True, stable=True)
        top_val, top_idx = srt.values[..., :k_actual], srt.indices[..., :k_actual]
        picks.append(torch.where(torch.isfinite(top_val), top_idx.to(torch.int32),
                                 torch.full_like(top_idx, -1, dtype=torch.int32)))
        if k_rest > k_actual:
            picks.append(torch.full((B, S, G, k_rest - k_actual), -1,
                                    dtype=torch.int32, device=dev))
    return (torch.cat(picks, dim=-1) if picks
            else torch.full((B, S, G, n_top), -1, dtype=torch.int32, device=dev))


def select_topn_blocks(p_grp: torch.Tensor, n_top: int, t_pos: torch.Tensor,
                       l_sel: int, force_init: bool = True,
                       force_local: int = 2) -> torch.Tensor:
    """`topn_forced_first` in canonical form: unique block ids sorted
    ascending, -1 padding at the tail."""
    return canonicalize_sel(topn_forced_first(p_grp, n_top, t_pos, l_sel, force_init,
                                              force_local))


def selection_token_mask(sel_idx: torch.Tensor, t_pos: torch.Tensor, l_sel: int,
                         S_kv: int) -> torch.Tensor:
    """Selected blocks -> per-token mask [B,S,G,S_kv]: the union of the
    row's selected blocks (a set: repeats and -1 add nothing), clamped to
    key positions <= t. t_pos: [S] or [B,S]."""
    B, S, G, _ = sel_idx.shape
    n_blk = -(-S_kv // l_sel)
    ids = sel_idx.to(torch.int64)
    ids = torch.where((ids < 0) | (ids >= n_blk), torch.full_like(ids, n_blk), ids)
    onehot = torch.zeros((B, S, G, n_blk + 1), dtype=torch.bool, device=sel_idx.device)
    onehot.scatter_(-1, ids, True)
    tok = onehot[..., :n_blk].repeat_interleave(l_sel, dim=-1)[..., :S_kv]
    kpos = torch.arange(S_kv, device=sel_idx.device)
    if t_pos.dim() == 1:
        causal = (kpos[None, :] <= t_pos[:, None])[None, :, None, :]
    else:
        causal = (kpos[None, None, :] <= t_pos[..., None])[:, :, None, :]
    return tok & causal
