"""Plain masked attention for the three NSA branches (the port's oracles).

Port of nsa_vibe_tpu/ops/reference.py: explicit-mask attention with a
float32 softmax; rows with no visible key return zeros. The kernels'
plain versions (ops/cuda/*.py) are built from these.

Layout:
  Q: [B, S, G, h, Dk] (RoPE applied)   K: [B, G, S_kv, Dk]   V: [B, G, S_kv, Dv]
  -> O: [B, S, G, h, Dv]
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.selection import selection_token_mask

NEG_INF = float("-inf")


def attend_masked(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                  mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked grouped attention. mask broadcastable to [B,S,G,h,S_kv];
    True = attend."""
    logits = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    any_visible = mask.any(dim=-1, keepdim=True)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(any_visible, p, torch.zeros((), device=p.device))
    return torch.einsum("bsghk,bgkv->bsghv", p, V.float()).to(Q.dtype)


def sliding_window_mask(t_pos: torch.Tensor, S_kv: int, w: int) -> torch.Tensor:
    """Banded mask: token t attends keys in [t-w+1, t]. [S] -> [S, S_kv]."""
    k = torch.arange(S_kv, device=t_pos.device)[None, :]
    t = t_pos.to(torch.int64)[:, None]
    return (k <= t) & (k > t - w)


def compressed_mask(num_cmp_t: torch.Tensor, S_cmp: int) -> torch.Tensor:
    """Prefix mask over compressed tokens: t sees the first num_cmp(t). [S] -> [S, S_cmp]."""
    c = torch.arange(S_cmp, device=num_cmp_t.device)[None, :]
    return c < num_cmp_t.to(torch.int64)[:, None]


def sliding_window_attention(Q, K, V, t_pos: torch.Tensor, w: int, scale: float):
    m = sliding_window_mask(t_pos, K.shape[2], w)
    return attend_masked(Q, K, V, m[None, :, None, None, :], scale)


def compressed_attention(Q, K_cmp, V_cmp, num_cmp_t: torch.Tensor, scale: float):
    m = compressed_mask(num_cmp_t, K_cmp.shape[2])
    return attend_masked(Q, K_cmp, V_cmp, m[None, :, None, None, :], scale)


def selection_attention(Q, K, V, sel_idx: torch.Tensor, t_pos: torch.Tensor,
                        l_sel: int, scale: float):
    """Softmax over the union of the selected blocks, key positions <= t.
    t_pos: [S] or [B,S] (per-row depths)."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])
    return attend_masked(Q, K, V, m[:, :, :, None, :], scale)
