"""Branch-attention dispatch (port of nsa_vibe_tpu/ops/attention.py, forward).

One rule for every branch: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to the kernel's plain PyTorch version (`resolve_kernel`).
Nothing else is dispatched and nothing falls back. The kernels take any
heads-per-group h, so there is no odd-head padding. This layer makes the
operands contiguous, which the kernel wrappers require.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.cuda.common import resolve_kernel
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import select_cmp
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn

__all__ = ["fused_select_cmp", "resolve_kernel", "selection_attention",
           "sliding_window_attention"]


def fused_select_cmp(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int,
                     n_top: int, force_init: bool, force_local: int):
    """Fused Eq. 8-12 selection + compressed-branch forward. Returns
    (sel_idx [B,S,G,max(n_top,n_forced)] int32 in the scorer's set form,
    O_cmp [B,S,G,h,Dv]). Requires at least one compressed token."""
    return select_cmp(Q.contiguous(), K_cmp.contiguous(), V_cmp.contiguous(),
                      M.to(device=Q.device, dtype=torch.float32).contiguous(),
                      scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top,
                      force_init=force_init, force_local=force_local)


def selection_attention(Q, K, V, sel_idx, t_pos, l_sel: int, scale: float):
    """Selection branch for prefill (S > 1) and decode (S == 1): one
    group-centric gather kernel. t_pos: [S] or [B,S] query positions."""
    return sel_attn(Q.contiguous(), K.contiguous(), V.contiguous(),
                    sel_idx.to(torch.int32).contiguous(), t_pos,
                    l_sel=l_sel, scale=scale)


def sliding_window_attention(Q, K, V, w: int, scale: float):
    """Window branch: query row t sees keys [t-w+1, t]."""
    return win_attn(Q.contiguous(), K.contiguous(), V.contiguous(), w=w, scale=scale)
