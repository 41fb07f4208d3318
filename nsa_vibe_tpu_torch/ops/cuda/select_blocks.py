"""Selection scorer without the compressed branch (csrc/select_blocks.cu).

Replaces nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_pallas. The prefill
runs it when the fused scorer does not fit (`select_cmp_fits`: more than
SELECT_CMP_MAX_S_SEL selection blocks, i.e. prompts above 16384 tokens at
m7c); the needle smoke runs it on one query row. Bound on the H100 and
design: see the note at the top of the CUDA source.

Output contract (as select_cmp): sel_idx [B,S,G,max(n_top,n_forced)]
int32, forced slots first (may repeat), then the picks in descending
`p_grp - 1e-8*index` order, -1 when no candidate is left. Query row s sits
at position t = pos_offset + s. The Eq. 9 map is the fractional overlap of
ops/block_index.py for S_sel selection blocks (`selection_map`); the
kernel computes its entries in closed form and reads no M.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    SMEM_LIMIT, check_operands, check_vector_rows, ptr, raise_on_error, resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import (
    compute_pcmp_masked, effective_sel_blocks, group_reduce, map_pcmp_to_pslc, topn_forced_first,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) one block holds at most


def selection_map(S_cmp: int, S_sel: int, l: int, d: int, l_sel: int, device=None):
    """The Eq. 9 map [S_cmp, S_sel] of S_cmp compressed tokens onto S_sel
    selection blocks: the first S_cmp rows of build_M_csl_on for S_sel*l_sel
    raw tokens (a row depends only on its own token's span)."""
    if (S_cmp - 1) * d + l > S_sel * l_sel:
        raise ValueError(f"select_blocks: {S_cmp} compressed tokens reach past {S_sel} "
                         f"selection blocks of {l_sel}")
    return build_M_csl_on(S_sel * l_sel, l, d, l_sel, device)[:S_cmp]


def select_blocks_plain(Q, K_cmp, *, S_sel: int, scale: float, l: int, d: int, l_sel: int,
                        n_top: int, force_init: bool = True, force_local: int = 2,
                        pos_offset: int = 0, return_scores: bool = False):
    """Plain PyTorch version (Eq. 8-12 pipeline of ops.selection). Returns
    sel_idx, and with return_scores also the group scores p_grp
    [B,S,G,S_sel] f32."""
    S, S_cmp = Q.shape[1], K_cmp.shape[2]
    t_pos = torch.arange(pos_offset, pos_offset + S, device=Q.device)
    num_cmp_t = ref.num_cmp_per_token(S, l, d, S_cmp, Q.device, pos_offset)
    M = selection_map(S_cmp, S_sel, l, d, l_sel, Q.device)
    p_grp = group_reduce(map_pcmp_to_pslc(compute_pcmp_masked(Q, K_cmp, scale, num_cmp_t), M))
    sel = topn_forced_first(p_grp, n_top, t_pos, l_sel, force_init, force_local)
    return (sel, p_grp) if return_scores else sel


def select_blocks(Q, K_cmp, *, S_sel: int, scale: float, l: int, d: int, l_sel: int,
                  n_top: int, force_init: bool = True, force_local: int = 2,
                  pos_offset: int = 0):
    """Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk] -> sel_idx [B,S,G,n_out] int32.
    pos_offset is a host int. CPU tensors take the plain version."""
    if resolve_kernel(Q) == "plain":
        return select_blocks_plain(Q, K_cmp, S_sel=S_sel, scale=scale, l=l, d=d, l_sel=l_sel,
                                   n_top=n_top, force_init=force_init, force_local=force_local,
                                   pos_offset=pos_offset)
    code = check_operands("select_blocks", {"Q": Q, "K_cmp": K_cmp})
    B, S, G, h, Dk = Q.shape
    S_cmp = K_cmp.shape[2]
    if K_cmp.shape != (B, G, S_cmp, Dk):
        raise ValueError(f"select_blocks: K_cmp {tuple(K_cmp.shape)} does not match "
                         f"Q {tuple(Q.shape)}")
    check_vector_rows("select_blocks", Q=Q, K_cmp=K_cmp)
    if S_cmp == 0:
        raise ValueError("select_blocks: no compressed tokens (S_cmp == 0); the caller "
                         "selects the forced blocks without the scorer")
    if (S_cmp - 1) * d + l > S_sel * l_sel or pos_offset < 0 or h > ROWS_PER_BLOCK:
        raise ValueError(f"select_blocks: needs (S_cmp-1)*d + l <= S_sel*l_sel, pos_offset >= 0 "
                         f"and h <= {ROWS_PER_BLOCK}")
    lib = library()
    # the largest tile of tokens whose [TQ, S_sel] score accumulator fits
    tq = max(1, ROWS_PER_BLOCK // h)
    while tq > 1 and lib.nsa_select_blocks_smem_bytes(tq, h, Dk, S_sel) > SMEM_LIMIT:
        tq -= 1
    need = lib.nsa_select_blocks_smem_bytes(tq, h, Dk, S_sel)
    if need > SMEM_LIMIT:
        raise ValueError(f"select_blocks: S_sel={S_sel} selection blocks exceed the kernel's "
                         f"limit: one token's scores need {need} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} an H100 block can use")
    n_out = effective_sel_blocks(n_top, force_init, force_local)
    sel = torch.empty((B, S, G, n_out), dtype=torch.int32, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_select_blocks(code, ptr(Q), ptr(K_cmp), ptr(sel), B, S, G, h, Dk, S_cmp,
                                    S_sel, l, d, l_sel, n_top, int(force_init), force_local,
                                    int(pos_offset), float(scale), tq, stream_of(Q))
    raise_on_error(lib, "select_blocks", err)
    select_blocks.launches += 1
    return sel


select_blocks.launches = 0
