"""Compression operator ϕ: overlapped pooling of K/V into compressed tokens.

Port of nsa_vibe_tpu/ops/compress.py. Blocks of length l, stride d; K is
RoPE'd at absolute positions before pooling. Average pooling uses the
O(S) cumulative-sum form (d | l): sum d-sized chunks once, then window j
is csum[j+r] - csum[j] with r = l/d. The learnable ϕ ("conv") is a
depthwise conv over time with kernel l and stride d, initialized to 1/l.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nsa_vibe_tpu_torch.ops.rope import apply_rope


def avg_pool_phi(x: torch.Tensor, l: int, d: int) -> torch.Tensor:
    """x: [..., S, D] -> [..., S_cmp, D], S_cmp = (S - l)//d + 1 (0 if S < l)."""
    S = x.shape[-2]
    if S < l:
        return x[..., :0, :]
    r = l // d
    S_cmp = (S - l) // d + 1
    n_chunks = S_cmp - 1 + r
    chunks = x[..., : n_chunks * d, :].reshape(*x.shape[:-2], n_chunks, d, x.shape[-1])
    csum = torch.cumsum(chunks.sum(dim=-2), dim=-2)
    csum = torch.cat([torch.zeros_like(csum[..., :1, :]), csum], dim=-2)
    return (csum[..., r:, :] - csum[..., :-r, :]) / float(l)


def conv_phi(x: torch.Tensor, weight: torch.Tensor, l: int, d: int) -> torch.Tensor:
    """Learnable depthwise ϕ: per-channel conv over time, kernel l, stride d.

    x: [B, G, S, D]; weight: [D, l] -> [B, G, S_cmp, D]"""
    B, G, S, D = x.shape
    if S < l:
        return x[..., :0, :]
    lhs = x.reshape(B * G, S, D).transpose(1, 2)              # [N, D, S]
    rhs = weight[:, None, :].to(x.dtype)                      # [D, 1, l]
    out = F.conv1d(lhs, rhs, stride=d, groups=D)              # [N, D, S_cmp]
    return out.transpose(1, 2).reshape(B, G, out.shape[-1], D)


def init_conv_phi_weight(d_model: int, l: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity-to-average init: conv ϕ == avg ϕ at initialization."""
    return torch.full((d_model, l), 1.0 / float(l), dtype=dtype, device=device)


def pool_phi_rope_kv(
    K_raw: torch.Tensor,
    V_raw: torch.Tensor,
    l: int,
    d: int,
    pos: Optional[torch.Tensor] = None,
    k_weight: Optional[torch.Tensor] = None,
    v_weight: Optional[torch.Tensor] = None,
    rope_base: float = 10000.0,
    rope_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ϕ over K (RoPE'd at absolute positions) and V.

    K_raw/V_raw: [B, G, S, D*]; pos: [S] (default arange).
    Returns (K_cmp, V_cmp): [B, G, S_cmp, D*]."""
    S = K_raw.shape[2]
    if pos is None:
        pos = torch.arange(S, device=K_raw.device)
    K_rope = apply_rope(K_raw, pos, base=rope_base, scale=rope_scale)
    if k_weight is not None:
        return conv_phi(K_rope, k_weight, l, d), conv_phi(V_raw, v_weight, l, d)
    return avg_pool_phi(K_rope, l, d), avg_pool_phi(V_raw, l, d)
