"""Branch-attention dispatch (port of nsa_vibe_tpu/ops/attention.py).

One rule for every branch: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to the kernel's plain PyTorch version (`resolve_kernel`).
Nothing else is dispatched and nothing falls back. The kernels take any
heads-per-group h, so there is no odd-head padding. This layer makes the
operands contiguous, which the kernel wrappers require.

Training: when autograd records (grad mode on and an operand requires a
gradient) each branch runs as a `torch.autograd.Function` whose forward
asks its kernel for the row statistics lse and saves (Q, K, V, O, lse),
and whose backward computes delta = rowsum(dO * O) and runs the backward
kernel that ops/tuning.py's design keys name (`backward_kernel`): for
win and cmp the one-pass banded_bwd_1p or the two-pass banded_bwd, for
win also the diagonal win_bwd_diag; for the selection sel_attn_bwd_1p or
sel_attn_bwd, as the JAX package's custom_vjp rules do under the same
keys. Otherwise (serving, no_grad) the forward kernels run without lse
and nothing is saved.

Two routes to the selection and the compressed branch, chosen by the
caller (core/nsa.py, `select_cmp_fits`): the fused scorer
(`fused_select_cmp`), or, for selections too wide for it, the scorer
alone (`select_blocks`, no gradient) beside `compressed_attention`.

Sequence sharding (parallel/context.py): `fused_select_cmp` (pos_offset),
`select_blocks` (pos_offset), `compressed_attention` and
`sliding_window_attention` (t_start) take the position of query row 0 as a
host int, with K/V covering the whole sequence; their Functions keep it for
the backward kernels. A zero offset launches what it launched before; a
nonzero window offset runs banded_attn in window mode (win_attn has none).

Packed documents (ops/varlen.py): `fused_select_cmp`, `select_blocks`,
`compressed_attention` and `sliding_window_attention` take an optional
seq_start [B,S] int32 on Q's device (core/nsa.py converts it once),
which their Functions save for the backward kernels (it takes no
gradient). The selection branch takes none, as in the JAX package: its
doc-local sets and key positions <= t keep it inside the document.

Gate-epilogue fold (nsa.gate_fold, core/nsa.py): `fused_select_cmp`,
`compressed_attention`, `selection_attention` and
`sliding_window_attention` take gate=[B,S,G] (a column of
core/gate.py::gate_probs_dform, f32 and contiguous; the heads of a group
share it), as
the JAX package's `_flash_vjp_gated` and `_sel_flash_vjp_gated` do. The
forward kernels then emit Y = g * O and the Function saves (Q, K, V, Y,
lse, g). Its backward forms D = rowsum(dY * Y), the delta of the gated
output, and runs the backward kernel that backward_kernel names on (dY,
D): the one-pass kernels (banded_bwd_1p, sel_attn_bwd_1p) take the gate
and scale each dO row by it in the kernel (flash_bwd.py:422-424,
sel_flash.py:781); the others (banded_bwd, win_bwd_diag, sel_attn_bwd)
are given (dY * g).to(dY.dtype) formed beforehand, as JAX's
_apply_gate_dense (flash_bwd.py:680-681, :509-510; sel_flash.py:549-552).
The gate's gradient is D summed over the heads, [B,S,G]: the D-form
cotangent g * dg that gate_probs_dform's backward expects (JAX
_gate_cotangent).
"""

from __future__ import annotations

import torch

from nsa_vibe_tpu_torch.ops import tuning
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import banded_bwd_1p
from nsa_vibe_tpu_torch.ops.cuda.common import resolve_kernel
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import sel_attn_bwd
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd_1p import sel_attn_bwd_1p
from nsa_vibe_tpu_torch.ops.cuda.select_blocks import select_blocks as _select_blocks
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import select_cmp
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn
from nsa_vibe_tpu_torch.ops.cuda.win_bwd_diag import win_bwd_diag
from nsa_vibe_tpu_torch.ops.reference import attention_delta, gate_dO

__all__ = ["compressed_attention", "fused_select_cmp", "resolve_kernel", "select_blocks",
           "selection_attention", "sliding_window_attention"]


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _gated_grad(dO, O, gate, in_kernel: bool):
    """(dO for the backward kernel, delta, its gate argument, the gate's
    gradient) of a branch whose forward emitted O (with gate: Y = g * O).
    delta = rowsum(dO * O). Under the fold the gate's gradient is delta
    summed over the heads (the D-form cotangent); a kernel that takes the
    gate (`in_kernel`) scales dO itself, the others get gate_dO(dO, g)."""
    dO = dO.contiguous()
    delta = attention_delta(dO, O)
    if gate is None:
        return dO, delta, None, None
    dg = delta.sum(-1)
    return (dO, delta, gate, dg) if in_kernel else (gate_dO(dO, gate), delta, None, dg)


def _banded_grads(saved, dO, mode: str, **kw):
    """dQ, dK, dV and the gate's gradient (None without a gate) of a window
    (mode "win", kw w, scale) or compressed-prefix (mode "cmp", kw l, d,
    scale) branch from its saved (Q, K, V, O, lse, seq_start or None, gate
    or None), through the kernel that tuning.backward_kernel names; kw
    t_start: the position of query row 0."""
    Q, K, V, O, lse, seq_start, gate = saved
    kernel = tuning.backward_kernel(mode, Q.shape[1], kw.get("w", 0))
    dO, delta, kgate, dg = _gated_grad(dO, O, gate, kernel == "banded_bwd_1p")
    args = (Q, K, V, dO, lse, delta)
    kw["seq_start"] = seq_start
    if kernel == "win_bwd_diag":
        return (*win_bwd_diag(*args, **kw), dg)
    if kernel == "banded_bwd_1p":
        return (*banded_bwd_1p(*args, mode=mode, gate=kgate, **kw), dg)
    return (*banded_bwd(*args, mode=mode, **kw), dg)


class _FusedSelectCmp(torch.autograd.Function):
    """sel_idx (no gradient) and O_cmp (with gate: g * O_cmp); M and
    seq_start get no gradient."""

    @staticmethod
    def forward(ctx, Q, K, V, M, seq_start, gate, kw):
        sel, O, lse = select_cmp(Q, K, V, M, return_lse=True, seq_start=seq_start, gate=gate,
                                 **kw)
        ctx.mark_non_differentiable(sel)
        ctx.save_for_backward(Q, K, V, O, lse, seq_start, gate)
        ctx.kw = kw
        return sel, O

    @staticmethod
    def backward(ctx, _dsel, dO):
        kw = ctx.kw
        dQ, dK, dV, dg = _banded_grads(ctx.saved_tensors, dO, "cmp", l=kw["l"], d=kw["d"],
                                       scale=kw["scale"], t_start=kw["pos_offset"])
        return dQ, dK, dV, None, None, dg, None


class _CompressedAttention(torch.autograd.Function):
    """O_cmp (with gate: g * O_cmp) through banded_attn (cmp) with lse;
    backward as _FusedSelectCmp's."""

    @staticmethod
    def forward(ctx, Q, K, V, seq_start, gate, kw):
        O, lse = banded_attn(Q, K, V, mode="cmp", return_lse=True, seq_start=seq_start,
                             gate=gate, **kw)
        ctx.save_for_backward(Q, K, V, O, lse, seq_start, gate)
        ctx.kw = kw
        return O

    @staticmethod
    def backward(ctx, dO):
        kw = ctx.kw
        dQ, dK, dV, dg = _banded_grads(ctx.saved_tensors, dO, "cmp", **kw)
        return dQ, dK, dV, None, dg, None


class _SelectionAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Q, K, V, sel_idx, t_pos, gate, l_sel, scale):
        O, lse = sel_attn(Q, K, V, sel_idx, t_pos, l_sel=l_sel, scale=scale, return_lse=True,
                          gate=gate)
        ctx.save_for_backward(Q, K, V, sel_idx, t_pos, O, lse, gate)
        ctx.l_sel, ctx.scale = l_sel, scale
        return O

    @staticmethod
    def backward(ctx, dO):
        Q, K, V, sel_idx, t_pos, O, lse, gate = ctx.saved_tensors
        onepass = tuning.backward_kernel("sel", Q.shape[1]) == "sel_attn_bwd_1p"
        dO, delta, kgate, dg = _gated_grad(dO, O, gate, onepass)
        args = (Q, K, V, sel_idx, t_pos, dO, lse, delta)
        if onepass:
            dQ, dK, dV = sel_attn_bwd_1p(*args, l_sel=ctx.l_sel, scale=ctx.scale, gate=kgate)
        else:
            dQ, dK, dV = sel_attn_bwd(*args, l_sel=ctx.l_sel, scale=ctx.scale)
        return dQ, dK, dV, None, None, dg, None, None


class _SlidingWindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, Q, K, V, seq_start, gate, w, scale, t_start):
        O, lse = _window_forward(Q, K, V, w, scale, t_start, seq_start, return_lse=True,
                                 gate=gate)
        ctx.save_for_backward(Q, K, V, O, lse, seq_start, gate)
        ctx.w, ctx.scale, ctx.t_start = w, scale, t_start
        return O

    @staticmethod
    def backward(ctx, dO):
        dQ, dK, dV, dg = _banded_grads(ctx.saved_tensors, dO, "win", w=ctx.w, scale=ctx.scale,
                                       t_start=ctx.t_start)
        return dQ, dK, dV, None, dg, None, None, None


def _window_forward(Q, K, V, w: int, scale: float, t_start: int, seq_start, return_lse: bool,
                    gate=None):
    """win_attn at t_start 0 (what the single-device path launches), else
    banded_attn in window mode at the offset."""
    if t_start:
        return banded_attn(Q, K, V, mode="win", w=w, scale=scale, t_start=t_start,
                           return_lse=return_lse, seq_start=seq_start, gate=gate)
    return win_attn(Q, K, V, w=w, scale=scale, return_lse=return_lse, seq_start=seq_start,
                    gate=gate)


def fused_select_cmp(Q, K_cmp, V_cmp, M, *, scale: float, l: int, d: int, l_sel: int,
                     n_top: int, force_init: bool, force_local: int, seq_start=None,
                     pos_offset: int = 0, gate=None):
    """Fused Eq. 8-12 selection + compressed-branch forward. Returns
    (sel_idx [B,S,G,max(n_top,n_forced)] int32 in the scorer's set form,
    O_cmp [B,S,G,h,Dv]; with gate [B,S,G], g * O_cmp). Requires at least
    one compressed token. seq_start [B,S] (packed documents) keeps each row
    in its document; pos_offset: the position of query row 0 (K_cmp and M
    cover the whole sequence)."""
    Q, K_cmp, V_cmp = Q.contiguous(), K_cmp.contiguous(), V_cmp.contiguous()
    M = M.to(device=Q.device, dtype=torch.float32).contiguous()
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top, force_init=force_init,
              force_local=force_local, pos_offset=pos_offset)
    if _records(Q, K_cmp, V_cmp, gate):
        return _FusedSelectCmp.apply(Q, K_cmp, V_cmp, M, seq_start, gate, kw)
    return select_cmp(Q, K_cmp, V_cmp, M, seq_start=seq_start, gate=gate, **kw)


def compressed_attention(Q, K_cmp, V_cmp, *, l: int, d: int, scale: float, t_start: int = 0,
                         seq_start=None, gate=None):
    """Compressed branch alone: query row s at position t_start + s sees
    the first num_cmp(t+1) compressed tokens (with seq_start [B,S], none
    that starts before its document). O [B,S,G,h,Dv] (with gate [B,S,G],
    g * O). Its backward (banded_bwd_1p or banded_bwd) runs at the same
    t_start."""
    Q, K_cmp, V_cmp = Q.contiguous(), K_cmp.contiguous(), V_cmp.contiguous()
    kw = dict(l=l, d=d, scale=scale, t_start=t_start)
    if _records(Q, K_cmp, V_cmp, gate):
        return _CompressedAttention.apply(Q, K_cmp, V_cmp, seq_start, gate, kw)
    return banded_attn(Q, K_cmp, V_cmp, mode="cmp", seq_start=seq_start, gate=gate, **kw)


def select_blocks(Q, K_cmp, *, S_sel: int, scale: float, l: int, d: int, l_sel: int,
                  n_top: int, force_init: bool, force_local: int, pos_offset: int = 0,
                  seq_start=None):
    """Eq. 8-12 selection without O_cmp, for S_sel selection blocks; the
    same set form as fused_select_cmp. Carries no gradient."""
    return _select_blocks(Q.detach().contiguous(), K_cmp.detach().contiguous(), S_sel=S_sel,
                          scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top,
                          force_init=force_init, force_local=force_local,
                          pos_offset=pos_offset, seq_start=seq_start)


def selection_attention(Q, K, V, sel_idx, t_pos, l_sel: int, scale: float, gate=None):
    """Selection branch for prefill (S > 1) and decode (S == 1): one
    group-centric gather kernel. t_pos: [S] or [B,S] query positions;
    gate [B,S,G] (prefill only): g * O."""
    Q, K, V = Q.contiguous(), K.contiguous(), V.contiguous()
    sel_idx = sel_idx.to(torch.int32).contiguous()
    if _records(Q, K, V, gate):
        return _SelectionAttention.apply(Q, K, V, sel_idx, t_pos, gate, l_sel, scale)
    return sel_attn(Q, K, V, sel_idx, t_pos, l_sel=l_sel, scale=scale, gate=gate)


def sliding_window_attention(Q, K, V, w: int, scale: float, seq_start=None, t_start: int = 0,
                             gate=None):
    """Window branch: query row s at position t = t_start + s sees keys
    [t-w+1, t] (with seq_start [B,S], none before its document start); with
    gate [B,S,G], g * O."""
    Q, K, V = Q.contiguous(), K.contiguous(), V.contiguous()
    if _records(Q, K, V, gate):
        return _SlidingWindowAttention.apply(Q, K, V, seq_start, gate, w, scale, t_start)
    return _window_forward(Q, K, V, w, scale, t_start, seq_start, return_lse=False, gate=gate)
