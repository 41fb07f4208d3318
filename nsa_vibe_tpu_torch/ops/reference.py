"""Plain masked attention for the three NSA branches (the port's oracles).

Port of nsa_vibe_tpu/ops/reference.py: explicit-mask attention with a
float32 softmax; rows with no visible key return zeros. The kernels'
plain versions (ops/cuda/*.py) are built from these, forward and
backward (`attend_masked_bwd`, the dense flash-attention gradient).

Row statistics: lse = logsumexp of a row's visible scaled logits
(natural base), EMPTY_LSE = +1e30 for a row with no visible key, so that
exp(s - lse) is exactly 0 there in the backward.

Gate-epilogue fold (nsa.gate_fold): with gate [B,S,G] f32 (the heads of a
group share it) the forward returns Y = O * g, formed in f32 before the
cast to Q's dtype, and its backward takes `gate_dO(dY, gate)` = (dY *
g).to(dY.dtype) in place of dO, as the TPU kernels scale dO in the
kernel (flash_bwd.py:424) or densely (flash_bwd.py::_apply_gate_dense).

Layout:
  Q: [B, S, G, h, Dk] (RoPE applied)   K: [B, G, S_kv, Dk]   V: [B, G, S_kv, Dv]
  -> O: [B, S, G, h, Dv]
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops.selection import selection_token_mask

NEG_INF = float("-inf")
EMPTY_LSE = 1e30


def gate_dO(dO: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(dO * g).to(dO.dtype), g [B,S,G] f32 broadcast over the heads and
    dims of dO [B,S,G,h,Dv]: the dO that the fold's backward feeds the
    ungated gradient (JAX flash_bwd.py::_apply_gate_dense)."""
    return (dO * gate[..., None, None]).to(dO.dtype)


def attend_masked(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                  mask: torch.Tensor, scale: float, return_lse: bool = False, gate=None):
    """Masked grouped attention. mask broadcastable to [B,S,G,h,S_kv];
    True = attend. With return_lse, also returns the f32 row statistics
    lse [B,S,G,h] (module docstring); with gate [B,S,G] f32, O * g."""
    logits = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    any_visible = mask.any(dim=-1, keepdim=True)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(any_visible, p, torch.zeros((), device=p.device))
    O = torch.einsum("bsghk,bgkv->bsghv", p, V.float())
    O = (O if gate is None else O * gate[..., None, None]).to(Q.dtype)
    if not return_lse:
        return O
    any_visible = any_visible.expand(logits.shape[:-1] + (1,))[..., 0]
    lse = torch.where(any_visible, torch.logsumexp(logits, dim=-1),
                      torch.full((), EMPTY_LSE, device=p.device))
    return O, lse


def attend_masked_rss(Q, K, V, mask, scale: float) -> torch.Tensor:
    """Root sum of squares of the terms each element of attend_masked's
    output sums, f32 [B,S,G,h,Dv]: sqrt(sum_k (p_k v_k)^2) / l, p the
    unnormalised softmax weights and l their sum (0 on rows with no
    visible key). A kernel that rounds each p to bf16 before P V (relative
    error <= 2^-9 per term, of either sign) while l sums the unrounded p,
    as the TPU kernels do, moves an element by a sum of such terms: its
    spread scales with this root sum of squares."""
    logits = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros((), device=p.device))
    return torch.einsum("bsghk,bgkv->bsghv", p * p, V.float() ** 2).sqrt()


def attention_delta(dO: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B,S,G,h]: the backward's per-row
    preprocess (JAX ops/attention.py::_delta, without the TPU stats layout)."""
    return (dO.float() * O.float()).sum(-1)


def attend_masked_bwd(Q, K, V, dO, lse, delta, mask, scale: float):
    """Dense gradient of `attend_masked` from the forward's row statistics:
    P = exp(s - lse) on visible keys (0 elsewhere and on EMPTY_LSE rows),
    dV = P^T dO, dS = P * (dO V^T - delta), dQ = scale dS K,
    dK = scale dS^T Q; f32 throughout, outputs in the operands' dtypes."""
    s = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=s.device))
    dO_f = dO.float()
    dV = torch.einsum("bsghk,bsghv->bgkv", p, dO_f)
    dS = p * (torch.einsum("bsghv,bgkv->bsghk", dO_f, V.float()) - delta[..., None])
    dQ = torch.einsum("bsghk,bgkd->bsghd", dS, K.float()) * scale
    dK = torch.einsum("bsghk,bsghd->bgkd", dS, Q.float()) * scale
    return dQ.to(Q.dtype), dK.to(K.dtype), dV.to(V.dtype)


def attend_masked_bwd_rss(Q, K, V, dO, lse, delta, mask, scale: float):
    """Root sum of squares of the terms each element of attend_masked_bwd's
    gradients sums, f32: sqrt(sum_r (P dO)^2) for dV, scale * sqrt(sum_r
    (dS q)^2) for dK, scale * sqrt(sum_k (dS k)^2) for dQ. A kernel that
    rounds each P and dS to bf16 before these products (relative error <=
    2^-9 per term, of either sign) moves an element by a sum of such
    terms: its spread scales with this root sum of squares."""
    s = torch.einsum("bsghd,bgkd->bsghk", Q.float(), K.float()) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=s.device))
    dO_f = dO.float()
    dS = p * (torch.einsum("bsghv,bgkv->bsghk", dO_f, V.float()) - delta[..., None])
    p2, dS2 = p * p, dS * dS
    rV = torch.einsum("bsghk,bsghv->bgkv", p2, dO_f * dO_f).sqrt()
    rQ = torch.einsum("bsghk,bgkd->bsghd", dS2, K.float() ** 2).sqrt() * scale
    rK = torch.einsum("bsghk,bsghd->bgkd", dS2, Q.float() ** 2).sqrt() * scale
    return rQ, rK, rV


def sliding_window_mask(t_pos: torch.Tensor, S_kv: int, w: int) -> torch.Tensor:
    """Banded mask: token t attends keys in [t-w+1, t]. [S] -> [S, S_kv]."""
    k = torch.arange(S_kv, device=t_pos.device)[None, :]
    t = t_pos.to(torch.int64)[:, None]
    return (k <= t) & (k > t - w)


def compressed_mask(num_cmp_t: torch.Tensor, S_cmp: int) -> torch.Tensor:
    """Prefix mask over compressed tokens: t sees the first num_cmp(t). [S] -> [S, S_cmp]."""
    c = torch.arange(S_cmp, device=num_cmp_t.device)[None, :]
    return c < num_cmp_t.to(torch.int64)[:, None]


def num_cmp_per_token(S: int, l: int, d: int, S_cmp: int, device=None,
                      t_start: int = 0) -> torch.Tensor:
    """Compressed tokens visible to query row s at position t = t_start + s:
    num_cmp(t+1), capped at S_cmp. [S] int64."""
    s_raw = torch.arange(t_start + 1, t_start + S + 1, device=device)
    n = torch.where(s_raw >= l, torch.div(s_raw - l, d, rounding_mode="floor") + 1,
                    torch.zeros_like(s_raw))
    return n.clamp(max=S_cmp)


def sliding_window_attention(Q, K, V, t_pos: torch.Tensor, w: int, scale: float,
                             return_lse: bool = False, gate=None):
    m = sliding_window_mask(t_pos, K.shape[2], w)
    return attend_masked(Q, K, V, m[None, :, None, None, :], scale, return_lse, gate)


def compressed_attention(Q, K_cmp, V_cmp, num_cmp_t: torch.Tensor, scale: float,
                         return_lse: bool = False, gate=None):
    m = compressed_mask(num_cmp_t, K_cmp.shape[2])
    return attend_masked(Q, K_cmp, V_cmp, m[None, :, None, None, :], scale, return_lse, gate)


def selection_attention(Q, K, V, sel_idx: torch.Tensor, t_pos: torch.Tensor,
                        l_sel: int, scale: float, return_lse: bool = False, gate=None):
    """Softmax over the union of the selected blocks, key positions <= t.
    t_pos: [S] or [B,S] (per-row depths)."""
    m = selection_token_mask(sel_idx, t_pos, l_sel, K.shape[2])
    return attend_masked(Q, K, V, m[:, :, :, None, :], scale, return_lse, gate)
