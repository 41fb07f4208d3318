"""Selection-branch attention for prefill and decode (csrc/sel_attn.cu).

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_pallas
(prefill) and nsa_vibe_tpu/ops/pallas/selection.py::
selection_attention_pallas (decode) with one per-query, group-centric
gather kernel. The selection is a set: -1 slots and repeated ids add
nothing. Bound on the H100 and design: see the note at the top of the
CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_operands, check_smem, check_vector_rows, ptr, raise_on_error, resolve_kernel,
    stream_of,
)

MAX_H = 16      # heads per group the kernel keeps register slices for
MAX_DV = 512    # value width: Dv / 4 threads of a block cover one V row


def sel_attn_plain(Q, K, V, sel_idx, t_pos, *, l_sel: int, scale: float):
    """Plain PyTorch version. t_pos: [S] or [B,S] query positions."""
    return ref.selection_attention(Q, K, V, sel_idx, t_pos, l_sel, scale)


def sel_attn(Q, K, V, sel_idx, t_pos, *, l_sel: int, scale: float):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv], sel_idx [B,S,G,n]
    int32, t_pos [S] or [B,S] -> O [B,S,G,h,Dv]. CPU tensors take the plain
    version. Counts launches in `sel_attn.launches` and, of those with one
    query per row (decode), in `sel_attn.decode_launches`."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_plain(Q, K, V, sel_idx, t_pos, l_sel=l_sel, scale=scale)
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
    if h > MAX_H or Dv > MAX_DV:
        raise ValueError(f"sel_attn: needs h <= {MAX_H} and Dv <= {MAX_DV}, got h={h}, Dv={Dv}")
    lib = library()
    check_smem("sel_attn", lib.nsa_sel_attn_smem_bytes(h, Dk, Dv, n, l_sel))
    O = torch.empty((B, S, G, h, Dv), dtype=Q.dtype, device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_sel_attn(code, ptr(Q), ptr(K), ptr(V), ptr(sel_idx), ptr(tpos), ptr(O),
                               B, S, S_kv, G, h, Dk, Dv, n, l_sel, float(scale),
                               stream_of(Q))
    raise_on_error(lib, "sel_attn", err)
    sel_attn.launches += 1
    if S == 1:
        sel_attn.decode_launches += 1
    return O


sel_attn.launches = 0
sel_attn.decode_launches = 0
