"""Fused selection scorer + compressed-branch forward (csrc/select_cmp.cu).

Replaces nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_and_cmp_pallas.
Bound on the H100 and design: see the note at the top of the CUDA source.

Output contract (as the TPU kernel): sel_idx [B,S,G,max(n_top,n_forced)]
int32 with the forced slots first (block 0, t//l_sel, t//l_sel-1, clamped
at 0, may repeat), then the picks in descending `p_grp - 1e-8*index`
order, -1 when no candidate is left; O_cmp [B,S,G,h,Dv]. Consumers treat
sel_idx as a set (`ops.selection.canonicalize_sel` gives the sorted form).
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, ptr, raise_on_error, resolve_kernel,
    stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import (
    compute_pcmp_masked, effective_sel_blocks, group_reduce, map_pcmp_to_pslc, topn_forced_first,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) one block aims to hold


def select_cmp_plain(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int,
                     n_top: int, force_init: bool = True, force_local: int = 2,
                     return_scores: bool = False):
    """Plain PyTorch version: the same function and output contract.
    With return_scores, also returns the group scores p_grp [B,S,G,S_sel]."""
    S = Q.shape[1]
    S_cmp = M.shape[0]
    t_pos = torch.arange(S, device=Q.device)
    s_raw = t_pos + 1
    num_cmp_t = torch.where(s_raw >= l, torch.div(s_raw - l, d, rounding_mode="floor") + 1,
                            torch.zeros_like(s_raw)).clamp(max=S_cmp)
    p_cmp = compute_pcmp_masked(Q, K_cmp, scale, num_cmp_t)          # f32, 0 rows w/o tokens
    O = torch.einsum("bsghc,bgcv->bsghv", p_cmp, V_cmp.float()).to(Q.dtype)
    p_grp = group_reduce(map_pcmp_to_pslc(p_cmp, M))                 # [B,S,G,S_sel]
    sel = topn_forced_first(p_grp, n_top, t_pos, l_sel, force_init, force_local)
    return (sel, O, p_grp) if return_scores else (sel, O)


def select_cmp(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int, n_top: int,
               force_init: bool = True, force_local: int = 2):
    """Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk], V_cmp [B,G,S_cmp,Dv], M [S_cmp,S_sel]
    f32 -> (sel_idx [B,S,G,n_out] int32, O_cmp [B,S,G,h,Dv]). Query row s is
    at position s. CPU tensors take the plain version."""
    if resolve_kernel(Q) == "plain":
        return select_cmp_plain(Q, K_cmp, V_cmp, M, scale=scale, l=l, d=d, l_sel=l_sel,
                                n_top=n_top, force_init=force_init,
                                force_local=force_local)
    code = check_operands("select_cmp", {"Q": Q, "K_cmp": K_cmp, "V_cmp": V_cmp})
    check_operands("select_cmp", {"M": M})
    if M.dtype != torch.float32:
        raise TypeError("select_cmp: M_csl must be float32")
    B, S, G, h, Dk = Q.shape
    S_cmp, S_sel = M.shape
    Dv = V_cmp.shape[3]
    if K_cmp.shape != (B, G, S_cmp, Dk) or V_cmp.shape[:3] != (B, G, S_cmp):
        raise ValueError(f"select_cmp: K_cmp {tuple(K_cmp.shape)} / V_cmp "
                         f"{tuple(V_cmp.shape)} do not match Q {tuple(Q.shape)} and M "
                         f"{tuple(M.shape)}")
    check_vector_rows("select_cmp", Q=Q, K_cmp=K_cmp, V_cmp=V_cmp)
    if S_cmp == 0:
        raise ValueError("select_cmp: no compressed tokens (S_cmp == 0); the caller "
                         "selects the forced blocks without the scorer")
    lib = library()
    max_s_sel = lib.nsa_select_cmp_max_s_sel()   # width of the kernel's p_slc accumulator
    if S_sel > max_s_sel:
        raise ValueError(f"select_cmp: S_sel={S_sel} selection blocks exceed the kernel's "
                         f"limit {max_s_sel}")
    tq = max(1, ROWS_PER_BLOCK // h)
    check_smem("select_cmp", lib.nsa_select_cmp_smem_bytes(tq, h, Dk, Dv, S_sel))
    n_out = effective_sel_blocks(n_top, force_init, force_local)
    sel = torch.empty((B, S, G, n_out), dtype=torch.int32, device=Q.device)
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_select_cmp(code, ptr(Q), ptr(K_cmp), ptr(V_cmp), ptr(M), ptr(sel), ptr(O),
                                 B, S, G, h, Dk, Dv, S_cmp, S_sel, l, d, l_sel, n_top,
                                 int(force_init), force_local, float(scale), tq,
                                 stream_of(Q))
    raise_on_error(lib, "select_cmp", err)
    select_cmp.launches += 1
    return sel, O


select_cmp.launches = 0
