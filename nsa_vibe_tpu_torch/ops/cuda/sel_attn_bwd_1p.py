"""One-pass selection-branch attention backward (csrc/sel_attn_bwd_1p.cu).

Replaces nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd_onepass
(the selection backward of the JAX train step under sel.bwd_onepass = 1).
It computes the same function as sel_attn_bwd (the two-pass design), and
shares its plain version, operand check, index and work list. The
selection is a set: -1 slots and repeated ids add nothing. With `gate`
[B,S,G] f32 (the gate-epilogue fold, sel_flash.py:781) the kernel scales
each staged dO row by its gate and rounds it to dO's dtype before any
product: the bits of the ungated launch on (dO * g).to(dO.dtype). Bound on
the H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.build import library
from nsa_vibe_tpu_torch.ops.cuda.common import (
    check_gate, ptr, ptr_or_null, raise_on_error, resolve_kernel, stream_of,
)
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import (
    check_sel_bwd_operands, kv_pass, sel_attn_bwd_plain,
)


def sel_attn_bwd_1p(Q, K, V, sel_idx, t_pos, dO, lse, delta, *, l_sel: int, scale: float,
                    gate=None):
    """Q, dO [B,S,G,h,D*], K/V [B,G,S_kv,D*], sel_idx [B,S,G,n] int32,
    t_pos [S] or [B,S], lse/delta [B,S,G,h] f32 -> (dQ, dK, dV) in the
    operands' dtype; gate [B,S,G] f32 (the gate-epilogue fold, or None):
    the gradients of Y = g O given dY = dO, delta = rowsum(dY * Y). CPU
    tensors take the plain version. Counts launches in
    `sel_attn_bwd_1p.launches`, the gated ones also in
    `sel_attn_bwd_1p.gated_launches`."""
    if resolve_kernel(Q) == "plain":
        return sel_attn_bwd_plain(Q, K, V, sel_idx, t_pos, dO, lse, delta, l_sel=l_sel,
                                  scale=scale, gate=gate)
    code, tpos = check_sel_bwd_operands("sel_attn_bwd_1p", Q, K, V, sel_idx, t_pos, dO, lse,
                                        delta)
    B, S, G, h, Dk = Q.shape
    check_gate("sel_attn_bwd_1p", gate, B, S, G, Q.device)
    S_kv, Dv = K.shape[2], V.shape[3]
    lib = library()
    kv = kv_pass(lib, "sel_attn_bwd_1p", code, Q, K, V, sel_idx, t_pos, l_sel)
    dQ = torch.empty_like(Q)
    dK = torch.empty_like(K)
    dV = torch.empty_like(V)
    ws = torch.empty(min(sel_idx.shape[-1], kv.NB) * kv.n_sub * Q.numel(), dtype=torch.float32,
                     device=Q.device)
    with torch.cuda.device(Q.device):
        err = lib.nsa_sel_attn_bwd_1p(code, ptr(Q), ptr(K), ptr(V), ptr(dO), ptr(lse),
                                      ptr(delta), ptr_or_null(gate), ptr(tpos), ptr(kv.inv),
                                      ptr(kv.cnt),
                                      ptr(kv.rank), ptr(kv.work), ptr(kv.span), ptr(kv.nblk),
                                      ptr(dQ), ptr(dK), ptr(dV), ptr(kv.part), ptr(ws), B, S,
                                      S_kv, G, h, Dk, Dv, l_sel, kv.inv.shape[-1], kv.n_work,
                                      kv.tq, kv.per, float(scale), stream_of(Q))
    raise_on_error(lib, "sel_attn_bwd_1p", err)
    sel_attn_bwd_1p.launches += 1
    sel_attn_bwd_1p.gated_launches += gate is not None
    return dQ, dK, dV


sel_attn_bwd_1p.launches = 0
sel_attn_bwd_1p.gated_launches = 0
