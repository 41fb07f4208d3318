"""Fused selection scorer + compressed-branch forward (csrc/select_cmp_mma.cu,
csrc/select_cmp.cu).

Replaces nsa_vibe_tpu/ops/pallas/scorer.py::nsa_select_and_cmp_pallas. Two
kernels, chosen by dtype alone:
- bf16: the tensor-core kernel (select_cmp_mma.cu), CTAs of MMA_TILE_ROWS
  rows: pass 1 is the bf16 banded forward's compressed-prefix walk, so O
  and lse have banded_attn(mode="cmp")'s bits (P rounded to bf16 before P V,
  as the TPU kernel rounds it: its bound is the plain version's unrounded
  f32 result within a multiple of `banded_attn_rss` in cmp mode, not two
  ulps); pass 2 forms p in f32 from each row's lse and maps it through M;
- f32: the FMA kernel (select_cmp.cu).
Bound on the H100 and design: see the notes at the top of the CUDA sources.

Output contract (as the TPU kernel): sel_idx [B,S,G,max(n_top,n_forced)]
int32 with the forced slots first (block 0, t//l_sel, t//l_sel-1, clamped
at 0, may repeat), then the picks in descending `p_grp - 1e-8*index`
order, -1 when no candidate is left; O_cmp [B,S,G,h,Dv] (with `gate`
[B,S,G] f32, the gate-epilogue fold: O_cmp * g, formed in f32 before the
cast, as scorer.py:399; the rest is the ungated output); with return_lse
the cmp rows' f32 statistics lse [B,S,G,h] (EMPTY_LSE for rows t < l-1,
which see no compressed token). Consumers treat sel_idx as a set
(`ops.selection.canonicalize_sel` gives the sorted form). With `seq_start`
[B,S] int32 (packed documents) a row sees no pooled token that starts
before its document (none at all: O = 0, lse EMPTY_LSE, p = 0) and picks
from its document's blocks, the forced slots ds // l_sel and max(t //
l_sel - i, ds // l_sel) (ops/varlen.py::topn_forced_first_varlen).
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops import varlen
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, SMEM_LIMIT, check_gate, check_offset, check_operands, check_seq_start,
    check_smem, check_vector_rows, ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import (
    compute_pcmp_masked, effective_sel_blocks, group_reduce, map_pcmp_to_pslc, topn_forced_first,
)

ROWS_PER_BLOCK = 64   # query rows (tokens x heads) one block of the f32 kernel aims to hold
# rows (tokens x heads) per CTA of the bf16 tensor-core kernel: 64 or 128 (PERF.md)
MMA_TILE_ROWS = 128
MAX_D = 128           # head width the tensor-core kernel's tiles cover
# shared memory of one CTA when two share an H100 SM (228 KB, 1 KB reserved per CTA)
TWO_CTA_SMEM = 115712
# width of the kernel's p_slc accumulator (csrc/select_cmp.cu MAX_S_SEL);
# the wrapper checks the two agree when it launches
SELECT_CMP_MAX_S_SEL = 256


def select_cmp_fits(h: int, S_sel: int) -> bool:
    """Whether the fused scorer takes h heads per group and S_sel selection
    blocks: the port's counterpart of scorer.py::scorer_fits_vmem, decided
    by shape alone (it loads no library), so the prefill takes the same
    route on the CPU and on the card. Within these bounds a block's shared
    memory stays below the H100's 227 KB for head widths up to 128."""
    return h <= ROWS_PER_BLOCK and 0 < S_sel <= SELECT_CMP_MAX_S_SEL


def select_cmp_plain(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int,
                     n_top: int, force_init: bool = True, force_local: int = 2,
                     return_scores: bool = False, return_lse: bool = False, seq_start=None,
                     pos_offset: int = 0, gate=None):
    """Plain PyTorch version: the same function and output contract.
    Returns (sel_idx, O_cmp), then lse [B,S,G,h] with return_lse, then the
    group scores p_grp [B,S,G,S_sel] with return_scores."""
    S = Q.shape[1]
    check_offset("select_cmp", pos_offset)
    t_pos = torch.arange(pos_offset, pos_offset + S, device=Q.device)
    if seq_start is not None:
        p_cmp = varlen.compute_pcmp_varlen(Q, K_cmp, scale, t_pos, seq_start, l, d)
    else:
        num_cmp_t = ref.num_cmp_per_token(S, l, d, M.shape[0], Q.device, pos_offset)
        p_cmp = compute_pcmp_masked(Q, K_cmp, scale, num_cmp_t)      # f32, 0 rows w/o tokens
    O = torch.einsum("bsghc,bgcv->bsghv", p_cmp, V_cmp.float())
    O = (O if gate is None else O * gate[..., None, None]).to(Q.dtype)
    p_grp = group_reduce(map_pcmp_to_pslc(p_cmp, M))                 # [B,S,G,S_sel]
    if seq_start is not None:
        sel = varlen.topn_forced_first_varlen(p_grp, n_top, t_pos, seq_start, l_sel, force_init,
                                              force_local)
    else:
        sel = topn_forced_first(p_grp, n_top, t_pos, l_sel, force_init, force_local)
    out = (sel, O)
    if return_lse:
        lse = (varlen.compressed_attention_varlen(Q, K_cmp, V_cmp, t_pos, seq_start, l, d,
                                                  scale, True)[1] if seq_start is not None
               else ref.compressed_attention(Q, K_cmp, V_cmp, num_cmp_t, scale, True)[1])
        out += (lse,)
    return out + (p_grp,) if return_scores else out


def tile_plan(lib, h: int, Dk: int, Dv: int, S_sel: int, docs: bool = False) -> int:
    """Tokens per CTA of the bf16 kernel: MMA_TILE_ROWS // h, shrunk until
    two CTAs share an SM (TWO_CTA_SMEM), which only the [tokens, S_sel] f32
    group scores of wide selections at small h need. The kernels compiled
    for one CTA an SM, at head widths past 64 and with seq_start (`docs`:
    the DOCS instantiation), take the one-CTA budget, SMEM_LIMIT. Raises
    when one token does not fit."""
    budget = TWO_CTA_SMEM if max(Dk, Dv) <= 64 and not docs else SMEM_LIMIT

    def need(tq):
        return lib.nsa_select_cmp_mma_smem_bytes(MMA_TILE_ROWS, tq, h, Dk, Dv, S_sel)

    for tq in range(MMA_TILE_ROWS // h, 0, -1):
        if need(tq) <= budget:
            return tq
    raise ValueError(f"select_cmp: one token's tile needs {need(1)} bytes of shared memory, "
                     f"more than the {budget} a CTA may use")


def select_cmp(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int, n_top: int,
               force_init: bool = True, force_local: int = 2, return_lse: bool = False,
               seq_start=None, pos_offset: int = 0, gate=None):
    """Q [B,S,G,h,Dk], K_cmp [B,G,S_cmp,Dk], V_cmp [B,G,S_cmp,Dv], M [S_cmp,S_sel]
    f32 -> (sel_idx [B,S,G,n_out] int32, O_cmp [B,S,G,h,Dv][, lse [B,S,G,h]]).
    Query row s is at position pos_offset + s (a host int: sequence
    sharding, where K_cmp and M cover the whole sequence); seq_start [B,S]
    int32 (or None; at any pos_offset) keeps each row in its document; gate
    [B,S,G] f32 (or None) scales O_cmp (the gate-epilogue fold). CPU
    tensors take the plain version. Launches count in `select_cmp.launches`,
    the gated ones also in `select_cmp.gated_launches`. M is the Eq. 9 map
    of ops/block_index.py: the kernels read, for each compressed token c,
    only the entries of the selection blocks its span [c*d, c*d + l)
    overlaps; the other entries, zero in that map, are not read."""
    if resolve_kernel(Q) == "plain":
        return select_cmp_plain(Q, K_cmp, V_cmp, M, scale=scale, l=l, d=d, l_sel=l_sel,
                                n_top=n_top, force_init=force_init,
                                force_local=force_local, return_lse=return_lse,
                                seq_start=seq_start, pos_offset=pos_offset, gate=gate)
    check_offset("select_cmp", pos_offset)
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
    check_seq_start("select_cmp", seq_start, B, S, Q.device)
    check_gate("select_cmp", gate, B, S, G, Q.device)
    if S_cmp == 0:
        raise ValueError("select_cmp: no compressed tokens (S_cmp == 0); the caller "
                         "selects the forced blocks without the scorer")
    lib = library()
    if lib.nsa_select_cmp_max_s_sel() != SELECT_CMP_MAX_S_SEL:
        raise RuntimeError(f"select_cmp: SELECT_CMP_MAX_S_SEL={SELECT_CMP_MAX_S_SEL} differs "
                           f"from the kernel's MAX_S_SEL={lib.nsa_select_cmp_max_s_sel()}")
    if not select_cmp_fits(h, S_sel):
        raise ValueError(f"select_cmp: h={h}, S_sel={S_sel} is past the kernel's limits "
                         f"(h <= {ROWS_PER_BLOCK}, S_sel <= {SELECT_CMP_MAX_S_SEL}); "
                         f"ops.cuda.select_blocks takes wider selections")
    mma = code == DTYPE_CODES[torch.bfloat16]
    if mma and max(Dk, Dv) > MAX_D:
        raise ValueError(f"select_cmp: the bf16 kernel takes Dk, Dv <= {MAX_D}, got Dk={Dk}, "
                         f"Dv={Dv}")
    n_out = effective_sel_blocks(n_top, force_init, force_local)
    sel = torch.empty((B, S, G, n_out), dtype=torch.int32, device=Q.device)
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    lse = (torch.empty((B, S, G, h), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    args = (ptr(Q), ptr(K_cmp), ptr(V_cmp), ptr(M), ptr_or_null(seq_start), ptr_or_null(gate),
            ptr(sel), ptr(O), ptr_or_null(lse), B, S, G, h, Dk, Dv, S_cmp, S_sel, l, d, l_sel,
            n_top, int(force_init), force_local, float(scale), int(pos_offset))
    with torch.cuda.device(Q.device):
        if mma:
            tq = tile_plan(lib, h, Dk, Dv, S_sel, docs=seq_start is not None)
            err = lib.nsa_select_cmp_mma(*args, tq, MMA_TILE_ROWS, stream_of(Q))
        else:
            tq = max(1, ROWS_PER_BLOCK // h)
            check_smem("select_cmp", lib.nsa_select_cmp_smem_bytes(tq, h, Dk, Dv, S_sel))
            err = lib.nsa_select_cmp(*args, tq, stream_of(Q))
    raise_on_error(lib, "select_cmp", err)
    select_cmp.launches += 1
    select_cmp.gated_launches += gate is not None
    return (sel, O, lse) if return_lse else (sel, O)


select_cmp.launches = 0
select_cmp.gated_launches = 0
