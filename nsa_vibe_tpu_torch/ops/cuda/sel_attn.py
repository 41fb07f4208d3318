"""Selection-branch attention for prefill and decode (csrc/sel_attn.cu,
csrc/sel_attn_fwd_mma.cu).

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_pallas
(prefill) and nsa_vibe_tpu/ops/pallas/selection.py::
selection_attention_pallas (decode). Three kernels, chosen by shape and
dtype alone:
- S > 1, bf16: the q-tile union kernel on tensor cores
  (sel_attn_fwd_mma.cu; P rounded to bf16 before P V, as the TPU kernel
  does, so its bound is the plain version's unrounded f32 result within
  a multiple of `sel_attn_rss`, not two ulps);
- S > 1, f32: the per-query FMA kernel (sel_attn.cu);
- S = 1 (decode), either dtype: the split kernel, one CTA per selected
  block and a combine in slot order (sel_attn.cu).
The selection is a set: -1 slots and repeated ids add nothing. With
`gate` [B,S,G] f32 (the gate-epilogue fold, prefill only) the prefill
kernels emit O * g, formed in f32 before the cast (sel_flash.py:169).
Bound on the H100 and design: see the notes at the top of the CUDA
sources.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    DTYPE_CODES, check_gate, check_operands, check_smem, check_vector_rows, ptr, ptr_or_null,
    raise_on_error, resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.selection import selection_token_mask

MAX_H = 16        # heads per group the kernels keep register slices / rows for
MAX_DV = 512      # value width of the FMA kernels: Dv / 4 threads of a block cover one V row
MAX_D_TC = 128    # head widths of the bf16 union kernel (one 128-wide tile)
UNION_ROWS = 64   # rows (tokens x heads) of a q tile of the union kernel


def union_tile_tokens(h: int) -> int:
    """Tokens per q tile of the bf16 union kernel: as many as its 64 rows
    hold (tile sweep at the train and 64k shapes: PERF.md)."""
    return max(1, UNION_ROWS // h)


def sel_attn_plain(Q, K, V, sel_idx, t_pos, *, l_sel: int, scale: float,
                   return_lse: bool = False, gate=None):
    """Plain PyTorch version. t_pos: [S] or [B,S] query positions."""
    return ref.selection_attention(Q, K, V, sel_idx, t_pos, l_sel, scale, return_lse, gate)


def sel_attn_rss(Q, K, V, sel_idx, t_pos, *, l_sel: int, scale: float):
    """O of the plain version in f32 from the operands' values, unrounded,
    and the root sum of squares of each element's terms
    (ops/reference.py::attend_masked_rss): the scale of what rounding P to
    bf16 before P V moves each element."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])[:, :, :, None, :]
    args = [x.float() for x in (Q, K, V)]
    return ref.attend_masked(*args, m, scale), ref.attend_masked_rss(*args, m, scale)


def sel_attn(Q, K, V, sel_idx, t_pos, *, l_sel: int, scale: float, return_lse: bool = False,
             gate=None):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv], sel_idx [B,S,G,n]
    int32, t_pos [S] or [B,S] -> O [B,S,G,h,Dv] (times gate [B,S,G] f32
    where one is given, at S > 1), and with return_lse the f32 row
    statistics lse [B,S,G,h] (ops.reference). CPU tensors take the plain
    version. Counts launches in `sel_attn.launches`, of those with one query
    per row (decode) in `sel_attn.decode_launches` and of the gated ones in
    `sel_attn.gated_launches`; a replay of a captured graph calls no
    wrapper, so it is not counted here."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_plain(Q, K, V, sel_idx, t_pos, l_sel=l_sel, scale=scale,
                              return_lse=return_lse, gate=gate)
    B, S, G, h, Dk = Q.shape
    S_kv, Dv = K.shape[2], V.shape[3]
    tpos = t_pos.to(torch.int32).expand(B, S).contiguous()
    code = check_operands("sel_attn", {"Q": Q, "K": K, "V": V},
                          {"sel_idx": sel_idx, "t_pos": tpos})
    n = sel_idx.shape[-1]
    if K.shape != (B, G, S_kv, Dk) or V.shape[:3] != (B, G, S_kv) \
            or sel_idx.shape[:3] != (B, S, G):
        raise ValueError(f"sel_attn: K {tuple(K.shape)} / V {tuple(V.shape)} / sel_idx "
                         f"{tuple(sel_idx.shape)} do not match Q {tuple(Q.shape)}")
    check_vector_rows("sel_attn", Q=Q, K=K, V=V)
    check_gate("sel_attn", gate, B, S, G, Q.device)
    if gate is not None and S == 1:
        raise ValueError("sel_attn: decode (S = 1) does not fold the gate")
    union = S > 1 and code == DTYPE_CODES[torch.bfloat16]
    max_d = MAX_D_TC if union else MAX_DV
    if h > MAX_H or Dv > max_d or (union and Dk > max_d) or S_kv == 0:
        raise ValueError(f"sel_attn: needs h <= {MAX_H}, S_kv > 0 and Dv <= {max_d}"
                         f"{f', Dk <= {max_d}' if union else ''}, got h={h}, Dk={Dk}, Dv={Dv}")
    lib = library()
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    lse = (torch.empty((B, S, G, h), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    with torch.cuda.device(Q.device):
        if union:
            qT = union_tile_tokens(h)
            check_smem("sel_attn", lib.nsa_sel_attn_union_smem_bytes(S_kv, Dk, Dv, n, l_sel, qT))
            err = lib.nsa_sel_attn_union(ptr(Q), ptr(K), ptr(V), ptr(sel_idx), ptr(tpos),
                                         ptr_or_null(gate), ptr(O), ptr_or_null(lse), B, S, S_kv,
                                         G, h, Dk, Dv, n, l_sel, qT, float(scale), stream_of(Q))
        else:
            check_smem("sel_attn", lib.nsa_sel_attn_smem_bytes(h, Dk, Dv, n, l_sel))
            # the split kernel's per-block partials, summed by the combine
            # kernel. Inside a CUDA graph capture (models/decode_graph.py)
            # this comes from the graph's private pool and stays reserved for
            # its replays (chip_smoke.py phase (g) checks, on the card, that
            # memory allocated after capture is left untouched by replays)
            ws = (torch.empty(B * S * G * n * lib.nsa_sel_attn_ws_floats(h, Dv),
                              dtype=torch.float32, device=Q.device) if S == 1 else None)
            err = lib.nsa_sel_attn(code, ptr(Q), ptr(K), ptr(V), ptr(sel_idx), ptr(tpos),
                                   ptr_or_null(gate), ptr(O), ptr_or_null(lse), ptr_or_null(ws),
                                   B, S, S_kv, G, h, Dk, Dv, n, l_sel, float(scale),
                                   stream_of(Q))
    raise_on_error(lib, "sel_attn", err)
    sel_attn.launches += 1
    sel_attn.gated_launches += gate is not None
    if S == 1:
        sel_attn.decode_launches += 1
    return (O, lse) if return_lse else O


sel_attn.launches = 0
sel_attn.decode_launches = 0
sel_attn.gated_launches = 0
