"""Rotary position embeddings, split-half convention, per head.

Port of nsa_vibe_tpu/ops/rope.py: f32 angles with inv_freq =
base^(-2i/D), NTK-style position scaling pos/scale, rotation pairs
(x[i], x[i+half]), sin/cos cast to the input dtype. The rotation is
applied per head (not to the flattened [S, H*Dk] query as upstream does).
"""

from __future__ import annotations

import torch


def build_inv_freq(dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    if dim % 2 != 0:
        raise ValueError("RoPE requires an even dimension")
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)
    # a Python-scalar base: a tensor made from it would be a host-to-device
    # copy, which waits for the stream on a card
    return base ** (-2.0 * idx / dim)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0,
               scale: float = 1.0) -> torch.Tensor:
    """Apply RoPE along the last dimension.

    x:   [..., S, D] with even D
    pos: [S] or broadcastable-to-[..., S] integer positions
    """
    D = x.shape[-1]
    half = D // 2
    inv_freq = build_inv_freq(D, base, x.device)
    if scale <= 0:
        scale = 1.0
    pos = torch.as_tensor(pos, device=x.device)
    pos = pos.reshape((1,) * (x.dim() - 1 - pos.dim()) + tuple(pos.shape))
    angles = (pos.to(torch.float32) / float(scale)).unsqueeze(-1) * inv_freq
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1)
