"""Decode-time KV caches: preallocated, fixed capacity, index-addressed.

Port of nsa_vibe_tpu/core/cache.py for a uniform batch:
  * k_sel/v_sel  - prefix buffers [B,G,C,D*], written at index t;
  * k_win/v_win  - ring buffers [B,G,w,D*] at slot t % w (RoPE'd K);
  * k_cmp_raw/v_cmp_raw - ring of the last l raw tokens [B,G,l,D*]
    (K RoPE'd at its absolute position) feeding ϕ emission;
  * k_cmp/v_cmp  - emitted compressed stream [B,G,C_cmp,D*];
  * m_csl        - the Eq. 9 map [C_cmp, S_sel] for capacity C, on device;
  * t            - Python int, tokens cached (host-side: no device sync).

The decode step updates the buffers in place (no per-step copies of the
cache) and raises when asked to decode past capacity, where XLA would
clamp the write index and overwrite the last row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.ops.block_index import build_block_meta, build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.rope import apply_rope
from nsa_vibe_tpu_torch.utils.device import resolve_device


@dataclass
class NSACache:
    k_sel: torch.Tensor      # [B,G,C,Dk] (RoPE'd)
    v_sel: torch.Tensor      # [B,G,C,Dv]
    k_win: torch.Tensor      # [B,G,w,Dk] ring (RoPE'd)
    v_win: torch.Tensor      # [B,G,w,Dv] ring
    k_cmp_raw: torch.Tensor  # [B,G,l,Dk] ring (RoPE'd)
    v_cmp_raw: torch.Tensor  # [B,G,l,Dv] ring
    k_cmp: torch.Tensor      # [B,G,C_cmp,Dk]
    v_cmp: torch.Tensor      # [B,G,C_cmp,Dv]
    m_csl: torch.Tensor      # [C_cmp, S_sel] float32
    t: int                   # number of tokens cached

    @property
    def capacity(self) -> int:
        return self.k_sel.shape[2]


def cmp_capacity(capacity: int, l: int, d: int) -> int:
    return max(int(num_cmp_blocks(capacity, l, d)), 1)


def init_cache(cfg: NSAConfig, batch: int, capacity: int, dtype=torch.float32,
               device="cuda") -> NSACache:
    """Empty cache with room for `capacity` tokens."""
    dev = resolve_device(device)
    B, G = batch, cfg.n_kv_groups
    C_cmp = cmp_capacity(capacity, cfg.l, cfg.d)
    meta = build_block_meta(capacity, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
    m = torch.zeros((C_cmp, meta.S_sel), dtype=torch.float32, device=dev)
    m[: meta.S_cmp] = build_M_csl_on(capacity, cfg.l, cfg.d, cfg.l_sel, dev)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)

    return NSACache(
        k_sel=z(B, G, capacity, cfg.d_k), v_sel=z(B, G, capacity, cfg.d_v),
        k_win=z(B, G, cfg.w, cfg.d_k), v_win=z(B, G, cfg.w, cfg.d_v),
        k_cmp_raw=z(B, G, cfg.l, cfg.d_k), v_cmp_raw=z(B, G, cfg.l, cfg.d_v),
        k_cmp=z(B, G, C_cmp, cfg.d_k), v_cmp=z(B, G, C_cmp, cfg.d_v),
        m_csl=m, t=0,
    )


def cache_from_prefill(cfg: NSAConfig, aux: dict, capacity: int) -> NSACache:
    """Seed a decode cache from the prefill's branch tensors (aux of
    nsa_prefill). K_sel/K_win are already RoPE'd; the raw cmp ring gets
    RoPE at each token's absolute position, as the decode path applies it."""
    K_sel = aux["K_sel"]
    B, G, S, _ = K_sel.shape
    if S > capacity:
        raise ValueError(f"prefill length {S} exceeds cache capacity {capacity}")
    cache = init_cache(cfg, B, capacity, K_sel.dtype, K_sel.device)
    dev = K_sel.device
    cache.k_sel[:, :, :S] = K_sel
    cache.v_sel[:, :, :S] = aux["V_sel"]

    n_win = min(cfg.w, S)
    pos_win = torch.arange(S - n_win, S, device=dev)
    cache.k_win[:, :, pos_win % cfg.w] = aux["K_win"][:, :, S - n_win:]
    cache.v_win[:, :, pos_win % cfg.w] = aux["V_win"][:, :, S - n_win:]

    n_raw = min(cfg.l, S)
    pos_raw = torch.arange(S - n_raw, S, device=dev)
    cache.k_cmp_raw[:, :, pos_raw % cfg.l] = apply_rope(
        aux["K_cmp_raw"][:, :, S - n_raw:], pos_raw, cfg.rope_base, cfg.rope_scale)
    cache.v_cmp_raw[:, :, pos_raw % cfg.l] = aux["V_cmp_raw"][:, :, S - n_raw:]

    n_cmp = aux["K_cmp"].shape[2]
    cache.k_cmp[:, :, :n_cmp] = aux["K_cmp"]
    cache.v_cmp[:, :, :n_cmp] = aux["V_cmp"]
    cache.t = S
    return cache
