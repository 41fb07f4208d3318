"""Selection scorer without the compressed branch (csrc/select_blocks_mma.cu,
csrc/select_blocks.cu).

Replaces nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_pallas. The prefill
runs it when the fused scorer does not fit (`select_cmp_fits`: more than
SELECT_CMP_MAX_S_SEL selection blocks, i.e. prompts above 16384 tokens at
m7c); the needle smoke runs it on one query row. Two kernels, chosen by
dtype alone: bf16 the tensor-core kernel (select_blocks_mma.cu: CTAs of
MMA_TILE_ROWS rows, logits on mma.sync, p and the Eq. 9 map in f32), f32
the FMA kernel (select_blocks.cu). Bound on the H100 and design: see the
notes at the top of the CUDA sources.

Output contract (as select_cmp): sel_idx [B,S,G,max(n_top,n_forced)]
int32, forced slots first (may repeat), then the picks in descending
`p_grp - 1e-8*index` order, -1 when no candidate is left. Query row s sits
at position t = pos_offset + s. The Eq. 9 map is the fractional overlap of
ops/block_index.py for S_sel selection blocks (`selection_map`); the
kernel computes its entries in closed form and reads no M. With
`seq_start` [B,S] int32 (packed documents, at any pos_offset) a row sees no
pooled token that starts before its document and picks from its document's
blocks (ops/varlen.py::topn_forced_first_varlen's contract).
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops import varlen
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, SMEM_LIMIT, check_offset, check_operands, check_seq_start, check_vector_rows,
    ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import (
    compute_pcmp_masked, effective_sel_blocks, group_reduce, map_pcmp_to_pslc, topn_forced_first,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) one block of the f32 kernel holds at most
# rows (tokens x heads) per CTA of the bf16 tensor-core kernel: 64 or 128; three
# CTAs of 64 share an SM (PERF.md)
MMA_TILE_ROWS = 64
MAX_D = 128           # head width the tensor-core kernel's tiles cover


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
                        pos_offset: int = 0, return_scores: bool = False, seq_start=None):
    """Plain PyTorch version (Eq. 8-12 pipeline of ops.selection, or of
    ops.varlen under seq_start). Returns sel_idx, and with return_scores
    also the group scores p_grp [B,S,G,S_sel] f32."""
    S, S_cmp = Q.shape[1], K_cmp.shape[2]
    t_pos = torch.arange(pos_offset, pos_offset + S, device=Q.device)
    M = selection_map(S_cmp, S_sel, l, d, l_sel, Q.device)
    if seq_start is not None:
        p_grp = varlen.selection_scores_varlen(Q, K_cmp, M, scale, t_pos, seq_start, l, d)
        sel = varlen.topn_forced_first_varlen(p_grp, n_top, t_pos, seq_start, l_sel, force_init,
                                              force_local)
        return (sel, p_grp) if return_scores else sel
    num_cmp_t = ref.num_cmp_per_token(S, l, d, S_cmp, Q.device, pos_offset)
    p_grp = group_reduce(map_pcmp_to_pslc(compute_pcmp_masked(Q, K_cmp, scale, num_cmp_t), M))
    sel = topn_forced_first(p_grp, n_top, t_pos, l_sel, force_init, force_local)
    return (sel, p_grp) if return_scores else sel


def tile_plan(lib, dtype, h: int, Dk: int, S_sel: int) -> int:
    """Tokens per CTA of a launch: bf16 (the tensor-core kernel) from
    MMA_TILE_ROWS // h, f32 from ROWS_PER_BLOCK // h, shrunk until the
    [tokens, S_sel] f32 group scores fit in shared memory. Raises when one
    token does not fit."""
    mma = dtype == torch.bfloat16

    def need(tq):
        return (lib.nsa_select_blocks_mma_smem_bytes(tq, h, Dk, S_sel) if mma
                else lib.nsa_select_blocks_smem_bytes(tq, h, Dk, S_sel))

    for tq in range((MMA_TILE_ROWS if mma else ROWS_PER_BLOCK) // h, 0, -1):
        if need(tq) <= SMEM_LIMIT:
            return tq
    raise ValueError(f"select_blocks: S_sel={S_sel} selection blocks exceed the kernel's limit: "
                     f"one token's scores need {need(1)} bytes of shared memory, more than the "
                     f"{SMEM_LIMIT} an H100 block can use")


def select_blocks(Q, K_cmp, *, S_sel: int, scale: float, l: int, d: int, l_sel: int,
                  n_top: int, force_init: bool = True, force_local: int = 2,
                  pos_offset: int = 0, seq_start=None):
    """Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk] -> sel_idx [B,S,G,n_out] int32.
    pos_offset is a host int; seq_start [B,S] int32 (at any pos_offset) keeps
    each row in its document. CPU tensors take the plain version. Counts
    launches in `select_blocks.launches`."""
    if resolve_kernel(Q) == "plain":
        return select_blocks_plain(Q, K_cmp, S_sel=S_sel, scale=scale, l=l, d=d, l_sel=l_sel,
                                   n_top=n_top, force_init=force_init, force_local=force_local,
                                   pos_offset=pos_offset, seq_start=seq_start)
    code = check_operands("select_blocks", {"Q": Q, "K_cmp": K_cmp})
    B, S, G, h, Dk = Q.shape
    S_cmp = K_cmp.shape[2]
    if K_cmp.shape != (B, G, S_cmp, Dk):
        raise ValueError(f"select_blocks: K_cmp {tuple(K_cmp.shape)} does not match "
                         f"Q {tuple(Q.shape)}")
    check_vector_rows("select_blocks", Q=Q, K_cmp=K_cmp)
    check_seq_start("select_blocks", seq_start, B, S, Q.device)
    check_offset("select_blocks", pos_offset)
    if S_cmp == 0:
        raise ValueError("select_blocks: no compressed tokens (S_cmp == 0); the caller "
                         "selects the forced blocks without the scorer")
    if (S_cmp - 1) * d + l > S_sel * l_sel or pos_offset < 0 or h > ROWS_PER_BLOCK \
            or Dk > MAX_D:
        raise ValueError(f"select_blocks: needs (S_cmp-1)*d + l <= S_sel*l_sel, pos_offset >= 0, "
                         f"h <= {ROWS_PER_BLOCK} and Dk <= {MAX_D}")
    lib = library()
    tq = tile_plan(lib, Q.dtype, h, Dk, S_sel)
    n_out = effective_sel_blocks(n_top, force_init, force_local)
    sel = torch.empty((B, S, G, n_out), dtype=torch.int32, device=Q.device)
    args = (ptr(Q), ptr(K_cmp), ptr_or_null(seq_start), ptr(sel), B, S, G, h, Dk, S_cmp, S_sel,
            l, d, l_sel, n_top, int(force_init), force_local, int(pos_offset), float(scale), tq)
    with torch.cuda.device(Q.device):
        if code == DTYPE_CODES[torch.bfloat16]:
            err = lib.nsa_select_blocks_mma(*args, MMA_TILE_ROWS, stream_of(Q))
        else:
            err = lib.nsa_select_blocks(*args, stream_of(Q))
    raise_on_error(lib, "select_blocks", err)
    select_blocks.launches += 1
    return sel


select_blocks.launches = 0
