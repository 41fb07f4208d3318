"""Decode-time KV caches: preallocated, fixed capacity, index-addressed.

Port of nsa_vibe_tpu/core/cache.py:
  * k_sel/v_sel  - prefix buffers [B,G,C,D*], written at index t;
  * k_win/v_win  - ring buffers [B,G,w,D*] at slot t % w (RoPE'd K);
  * k_cmp_raw/v_cmp_raw - ring of the last l raw tokens [B,G,l,D*]
    (K RoPE'd at its absolute position) feeding ϕ emission;
  * k_cmp/v_cmp  - emitted compressed stream [B,G,C_cmp,D*];
  * m_csl        - the Eq. 9 map [C_cmp, S_sel] for capacity C, on device;
  * t            - tokens cached: a Python int for a uniform batch
    (core/decode.py::nsa_decode_step; host-side, so stepping needs no
    device sync), or an int32 tensor [B] on the cache's device for a
    ragged batch (`ragged_cache`; nsa_decode_step_ragged), one depth a row.

The decode steps update the buffers in place (no per-step copies of the
cache). The uniform step raises when asked to decode past capacity, where
XLA would clamp the write index and overwrite the last row; the ragged
step cannot read t on the host, so it reports `overflow` per row instead
and its callers check capacity on the host before stepping.

In-place contract of a ragged cache: `nsa_decode_step_ragged` and
`admit_row` write into the existing tensors (`copy_`, indexed writes,
`t += 1`) and never rebind a field to a new tensor. A captured CUDA graph
of the step (models/decode_graph.py) holds the buffers' addresses, so a
cache rebound to new tensors would be read stale by its replays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Union

import torch

from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.ops.block_index import build_block_meta, build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.rope import apply_rope
from nsa_vibe_tpu_torch.utils import trace
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
    t: Union[int, torch.Tensor]   # tokens cached: int, or int32 [B] (ragged)

    @property
    def capacity(self) -> int:
        return self.k_sel.shape[2]


BUFFERS = ("k_sel", "v_sel", "k_win", "v_win", "k_cmp_raw", "v_cmp_raw", "k_cmp", "v_cmp")


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


def ragged_cache(cache: NSACache) -> NSACache:
    """Uniform cache -> ragged cache: the same buffers, with t broadcast to
    an int32 tensor [B] on the cache's device (for nsa_decode_step_ragged)."""
    B = cache.k_sel.shape[0]
    t = torch.full((B,), cache.t, dtype=torch.int32, device=cache.k_sel.device)
    return dataclasses.replace(cache, t=t)


def cache_tensors(cache: NSACache) -> list:
    """The tensors a decode step writes (every buffer but m_csl, and a
    ragged cache's t), in field order."""
    out = [getattr(cache, f) for f in BUFFERS]
    return out + [cache.t] if torch.is_tensor(cache.t) else out


def admit_row(cache: NSACache, row: NSACache, i: int) -> NSACache:
    """Mid-stream admission (continuous batching): install row 0 of the
    B = 1 cache `row` (e.g. cache_from_prefill of a new request, uniform or
    ragged) as row i of the running ragged batch `cache`, whose other rows
    keep decoding at their own depths. Writes in place (`copy_`) into
    cache's existing tensors, t[i] included, and returns cache: a captured
    graph of the step sees the new row at its next replay. Raises if the
    two caches differ in capacity, dtype, device or any other buffer shape,
    m_csl's included (its values follow from the capacity and l, d, l_sel);
    no device value is read. The writes run inside the span `cache.admit`
    (utils/trace.py)."""
    if not torch.is_tensor(cache.t):
        raise ValueError("admit_row needs a ragged cache (ragged_cache): its t is a host int")
    if row.k_sel.shape[0] != 1 or not 0 <= i < cache.k_sel.shape[0]:
        raise ValueError(f"admit_row: row must hold one request and i in [0, "
                         f"{cache.k_sel.shape[0]}), got B={row.k_sel.shape[0]}, i={i}")
    for f in BUFFERS + ("m_csl",):
        a, b = getattr(cache, f), getattr(row, f)
        lead = 1 if f in BUFFERS else 0
        if a.shape[lead:] != b.shape[lead:] or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(f"admit_row: {f} differs: {tuple(a.shape)} {a.dtype} {a.device} "
                             f"vs {tuple(b.shape)} {b.dtype} {b.device} (capacity "
                             f"{cache.capacity} vs {row.capacity})")
    with trace.span("cache.admit"):
        for f in BUFFERS:
            getattr(cache, f)[i].copy_(getattr(row, f)[0])
        if torch.is_tensor(row.t):
            cache.t[i].copy_(row.t.reshape(()))
        else:
            cache.t[i] = row.t
    return cache
