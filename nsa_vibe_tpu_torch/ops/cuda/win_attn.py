"""Sliding-window attention forward (csrc/banded_fwd_mma.cu,
csrc/banded_attn.cu in window mode).

Replaces nsa_vibe_tpu/ops/pallas/flash_diag.py::flash_banded_diag (the
win forward that flash.py::flash_banded dispatches to under the shipped
tuning). It is banded_attn in window mode at t_start = 0 (bf16: the
tensor-core kernel; f32: the FMA kernel), counted apart so that a run
shows which branch launched it. Bound on the H100 and design: see the
notes at the top of the CUDA sources.
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import reference as ref
from nsa_vibe_tpu_torch.ops import varlen
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn_rss, launch_banded
from nsa_vibe_tpu_torch.ops.cuda.common import resolve_kernel


def win_attn_plain(Q, K, V, *, w: int, scale: float, return_lse: bool = False,
                   seq_start=None, gate=None):
    """Plain PyTorch version: row t sees keys [t-w+1, t] (and, with
    seq_start, none before its document start: ops/varlen.py); with gate,
    O * g."""
    t_pos = torch.arange(Q.shape[1], device=Q.device)
    if seq_start is not None:
        return varlen.sliding_window_attention_varlen(Q, K, V, t_pos, seq_start, w, scale,
                                                      return_lse, gate)
    return ref.sliding_window_attention(Q, K, V, t_pos, w, scale, return_lse, gate)


def win_attn_rss(Q, K, V, *, w: int, scale: float, seq_start=None):
    """The plain version's unrounded f32 O and the root sum of squares of
    each element's terms (banded_attn_rss in window mode)."""
    return banded_attn_rss(Q, K, V, mode="win", w=w, scale=scale, seq_start=seq_start)


def win_attn(Q, K, V, *, w: int, scale: float, return_lse: bool = False, seq_start=None,
             gate=None):
    """Q [B,S,G,h,Dk], K [B,G,S_kv,Dk], V [B,G,S_kv,Dv] -> O [B,S,G,h,Dv],
    and with return_lse the f32 row statistics lse [B,S,G,h]
    (ops.reference); seq_start [B,S] int32 bounds each row to its
    document; gate [B,S,G] f32 (the gate-epilogue fold, or None) scales O.
    CPU tensors take the plain version. Counts launches in
    `win_attn.launches`, the gated ones also in `win_attn.gated_launches`."""
    if resolve_kernel(Q) == "plain":
        return win_attn_plain(Q, K, V, w=w, scale=scale, return_lse=return_lse,
                              seq_start=seq_start, gate=gate)
    out = launch_banded("win_attn", Q, K, V, mode="win", w=w, l=0, d=1, scale=scale, t_start=0,
                        return_lse=return_lse, seq_start=seq_start, gate=gate)
    win_attn.launches += 1
    win_attn.gated_launches += gate is not None
    return out


win_attn.launches = 0
win_attn.gated_launches = 0
