"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips where torch sees no CUDA device. The card
machine has no JAX, and tests/conftest.py imports it, so run them there
without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports no JAX. f32 runs with TF32 off; bounds, per element:
5e-5 absolute in f32 (sum order); in bf16, two bf16 ulps of the plain
value plus 1e-4 (both versions round an f32 result that agrees to ~1e-6,
so they may land one ulp apart, two across a power of two).
Selection is compared as sets; inputs are random normals, whose group
scores are well separated at these sizes (the one-row S_sel = 1024 case
may differ only where the plain scores of the differing blocks are within
1e-5, as in chip_smoke.py). Backward kernels (and the
forward row statistics) are held per tensor to 5e-5 of the tensor's max
|value| in f32 (their sums run over up to S rows, so the order error
scales with the largest terms, not with each element); in bf16 to two
bf16 ulps of the plain value plus that f32 bound (both versions round f32
results that agree within it). The selection backward's bf16 kernels and
the bf16 prefill selection forward run on tensor cores and round P (and
dS) to bf16 before their products, as the TPU kernels do: they are held
to the plain version's unrounded f32 result within one bf16 ulp, plus the
f32 bound, plus 4 * 2^-9 times the root sum of squares of each element's
terms (chip_smoke.py::allowed_tc_err). So are the bf16 banded forward
(win_attn, banded_attn: csrc/banded_fwd_mma.cu on tensor cores) and the
bf16 banded backward of every design (banded_bwd_1p, win_bwd_diag and the
two-pass banded_bwd: csrc/banded_bwd_mma.cu on tensor cores, against
banded_bwd_rss), also against each other, and the bf16 fused scorer's O
(select_cmp: csrc/select_cmp_mma.cu, whose pass 1 is the banded forward's
compressed-prefix walk, so its O and lse also equal banded_attn's in cmp
mode bit for bit); the three form P and dS with
the same instructions and differ in summation order only, so they are
held to each other by the backward bound above (two bf16 ulps plus the f32
bound). The bf16 select-only scorer (select_blocks: csrc/select_blocks_mma.cu
on tensor cores) keeps p and its map in f32 and is held as sets, as the
f32 kernel. Packed documents (varlen): each kernel family that takes
seq_start (the banded forwards, the two scorers, the three banded
backward designs) against its plain version with it, on rows that hold a
document shorter than l and q tiles that straddle document starts, under
the same bounds; each given the dense bound must fail them; and one f32
layer on both prefill routes against the CPU. The gate-epilogue fold
(nsa.gate_fold): the gated forwards (rows 1, 2, 3 and 5) against their
gated plain versions under the same bounds (bf16: the plain unrounded
result and its rss times the gate); the gated one-pass backwards (rows 7
and 9) bit-equal to the ungated launch fed (dO * g).to(dO.dtype), where
the launch with the gate dropped must differ; one f32 folded layer against
the CPU. The multi-tensor AdamW (ops/cuda/adamw_mt.py) is held to the
tensor-op path (train/optim.py::apply_update_plain_) bit for bit in p, mu,
nu and count, its norm to global_norm within 2e-6 of the norm; it raises
on leaves it does not take.
"""

import time

import numpy as np
import pytest
import torch

from nsa_vibe_tpu_torch.core.cache import admit_row, cache_tensors, ragged_cache
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.convert import params_to, params_to_numpy
from nsa_vibe_tpu_torch.models.decode_graph import DecodeGraph
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.models.tinylm import (
    generate, generate_scan, init_model_params, model_decode_step, model_decode_step_ragged,
    model_prefill_with_caches,
)
from nsa_vibe_tpu_torch.ops import cuda as kernels
from nsa_vibe_tpu_torch.ops import tuning
from nsa_vibe_tpu_torch.ops.attention import compressed_attention, fused_select_cmp
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl, build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import banded_attn as ba_mod
from nsa_vibe_tpu_torch.ops.cuda import banded_bwd as bb_mod
from nsa_vibe_tpu_torch.ops.cuda import banded_bwd_1p as b1_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn as sa_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn_bwd as sb_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn_bwd_1p as s1_mod
from nsa_vibe_tpu_torch.ops.cuda import select_blocks as sk_mod
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda import win_attn as wa_mod
from nsa_vibe_tpu_torch.ops.cuda import win_bwd_diag as wd_mod
from nsa_vibe_tpu_torch.ops.reference import attention_delta, gate_dO
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.ops.varlen import pack_documents_aligned
from nsa_vibe_tpu_torch.train.train_step import (
    init_train_state, make_train_step, param_leaves,
)

SCALE = 0.125
F32_TOL = 5e-5
BF16_ULPS, BF16_FLOOR = 2, 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_bound(got, plain):
    """Every element of the kernel's output within its bound of the plain
    version's (module docstring)."""
    err = (got.float() - plain.float()).abs()
    if plain.dtype == torch.float32:
        return bool((err <= F32_TOL).all())
    x = plain.float().abs()
    _, e = torch.frexp(x)                                   # x in [2^(e-1), 2^e)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)            # bf16: 8 significant bits
    allowed = torch.where(x > 0, BF16_ULPS * ulp, torch.zeros_like(x)) + BF16_FLOOR
    return bool((err <= allowed).all())


def _within_rel(got, plain):
    """Backward bound (module docstring): F32_TOL of the tensor's max |value|,
    plus two bf16 ulps of each plain value in bf16."""
    err = (got.float() - plain.float()).abs()
    x = plain.float().abs()
    allowed = F32_TOL * float(x.max())
    if plain.dtype == torch.bfloat16:
        _, e = torch.frexp(x)
        allowed = allowed + torch.where(x > 0, BF16_ULPS * torch.ldexp(torch.ones_like(x), e - 8),
                                        torch.zeros_like(x))
    return bool((err <= allowed).all())


def _within_tc(got, ref, plain32, rss):
    """The selection backward's bf16 bound (module docstring): |got - ref|
    within one bf16 ulp of the unrounded plain value, F32_TOL of its max,
    and 4 * 2^-9 * rss."""
    x = plain32.abs()
    _, e = torch.frexp(x)
    allowed = (torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 8), torch.zeros_like(x))
               + F32_TOL * float(x.max()) + 4 * 2.0 ** -9 * rss)
    return bool(((got.float() - ref.float()).abs() <= allowed).all())


def _sel_fwd_within(got, Q, K, V, sel, t, l_sel, scale):
    """The selection forward's output within its bound: f32 and decode
    (S = 1) _within_bound of the plain version; the bf16 prefill (the
    tensor-core union kernel, P rounded to bf16) _within_tc of the plain
    version's unrounded f32 result."""
    if Q.dtype == torch.float32 or Q.shape[1] == 1:
        return _within_bound(got, sa_mod.sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel,
                                                        scale=scale))
    want, rss = sa_mod.sel_attn_rss(Q, K, V, sel, t, l_sel=l_sel, scale=scale)
    return _within_tc(got, want, want, rss)


def _band_fwd_within(got, Q, K, V, *, mode, scale, t_start=0, **kw):
    """The banded forward's output (win_attn, banded_attn, and select_cmp's
    O in cmp mode) within its bound: f32 _within_bound of the plain
    version; bf16 (the tensor-core kernel, P rounded to bf16) _within_tc of
    the plain version's unrounded f32 result."""
    if Q.dtype == torch.float32:
        return _within_bound(got, ba_mod.banded_attn_plain(Q, K, V, mode=mode, **kw, scale=scale,
                                                           t_start=t_start))
    want, rss = ba_mod.banded_attn_rss(Q, K, V, mode=mode, **kw, scale=scale, t_start=t_start)
    return _within_tc(got, want, want, rss)


def _band_within(args, scale, **kw):
    """within(got, ref, i): gradient i of a one-pass or diagonal banded
    backward kernel is within its bound of ref (f32: _within_rel; bf16, on
    tensor cores: _within_tc against banded_bwd_rss)."""
    if args[0].dtype == torch.float32:
        return lambda g, ref, i: _within_rel(g, ref)
    want, rss = bb_mod.banded_bwd_rss(*args, **kw, scale=scale)
    return lambda g, ref, i: _within_tc(g, ref, want[i], rss[i])


def _sel_within(args, l_sel, scale):
    """within(got, ref, i): gradient i of a selection backward kernel is
    within its bound of ref (f32: _within_rel; bf16: _within_tc)."""
    if args[0].dtype == torch.float32:
        return lambda g, ref, i: _within_rel(g, ref)
    want, rss = sb_mod.sel_attn_bwd_rss(*args, l_sel=l_sel, scale=scale)
    return lambda g, ref, i: _within_tc(g, ref, want[i], rss[i])


def _bwd_operands(dtype, dev, B, S, G, h, D, S_kv, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return r(B, S, G, h, D), r(B, G, S_kv, D), r(B, G, S_kv, D), r(B, S, G, h, D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,h,D,l,d,l_sel,n_top,w", [
    (1, 200, 2, 3, 64, 32, 16, 64, 5, 64),      # odd h, S not a multiple of l_sel
    (2, 130, 1, 6, 16, 8, 4, 16, 4, 40),        # small head width, many blocks
    (1, 70, 2, 1, 32, 16, 8, 16, 8, 512),       # h = 1, window wider than S
    (1, 300, 1, 2, 32, 32, 16, 128, 3, 100),    # l_sel = 128: two kv tiles per block
    (1, 100, 1, 2, 128, 16, 8, 32, 4, 50),      # D = 128: two register slices per thread
    (2, 260, 4, 4, 64, 32, 16, 64, 6, 128),     # G = 4, h = 4: the m7c-350M head layout
])
def test_backward_kernels_match_plain_on_gpu(dtype, B, S, G, h, D, l, d, l_sel, n_top, w):
    """Forward lse and both backward kernels (win, cmp, sel) against their
    plain versions on the same operands; two launches give the same bits."""
    dev = _card()
    scale = D ** -0.5
    S_cmp = num_cmp_blocks(S, l, d)
    Q, K, V, dO = _bwd_operands(dtype, dev, B, S, G, h, D, S)
    _, Kc, Vc, _ = _bwd_operands(dtype, dev, B, S, G, h, D, S_cmp, seed=1)
    M = torch.from_numpy(build_M_csl(S, l, d, l_sel)).to(dev)
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top)
    sel, Oc, lse_c = sc_mod.select_cmp(Q, Kc, Vc, M, **kw, return_lse=True)
    _, pOc, plse_c = sc_mod.select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=True)
    t = torch.arange(S, device=dev)
    Os, lse_s = sa_mod.sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=scale, return_lse=True)
    _, plse_s = sa_mod.sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel, scale=scale, return_lse=True)
    Ow, lse_w = wa_mod.win_attn(Q, K, V, w=w, scale=scale, return_lse=True)
    _, plse_w = wa_mod.win_attn_plain(Q, K, V, w=w, scale=scale, return_lse=True)
    assert _band_fwd_within(Ow, Q, K, V, mode="win", w=w, scale=scale)
    assert bool((lse_c[:, :l - 1] == 1e30).all())                 # rows t < l-1 see no token
    for got, want in ((lse_c, plse_c), (lse_s, plse_s), (lse_w, plse_w)):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)
    sargs = (Q, K, V, sel, t, dO, lse_s, attention_delta(dO, Os))
    cargs = (Q, Kc, Vc, dO, lse_c, attention_delta(dO, Oc))
    wargs = (Q, K, V, dO, lse_w, attention_delta(dO, Ow))
    cmp_ = dict(mode="cmp", l=l, d=d, scale=scale)
    win = dict(mode="win", w=w, scale=scale)
    cases = [   # (kernel, plain version, bound)
        (lambda: bb_mod.banded_bwd(*cargs, **cmp_), lambda: bb_mod.banded_bwd_plain(*cargs, **cmp_),
         _band_within(cargs, scale, mode="cmp", l=l, d=d)),
        (lambda: bb_mod.banded_bwd(*wargs, **win), lambda: bb_mod.banded_bwd_plain(*wargs, **win),
         _band_within(wargs, scale, mode="win", w=w)),
        (lambda: sb_mod.sel_attn_bwd(*sargs, l_sel=l_sel, scale=scale),
         lambda: sb_mod.sel_attn_bwd_plain(*sargs, l_sel=l_sel, scale=scale),
         _sel_within(sargs, l_sel, scale)),
    ]
    for kernel, plain, within in cases:
        got, again, want = kernel(), kernel(), plain()
        for i, (g, a, p) in enumerate(zip(got, again, want)):
            assert g.dtype == p.dtype and g.shape == p.shape
            assert within(g, p, i)
            assert torch.equal(g, a)                               # deterministic
            if dtype == torch.bfloat16:                # a planted 1% fault fails the bound
                assert not within(g.float() * 1.01, p, i)
    # rows that see no compressed token get no gradient
    assert not bool(cases[0][0]()[0][:, :l - 1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,h,D,l,d,l_sel,n_top,w", [
    (1, 200, 2, 3, 64, 32, 16, 64, 5, 64),      # odd h, S not a multiple of l_sel
    (2, 130, 1, 6, 16, 8, 4, 16, 4, 40),        # small head width, many blocks
    (1, 70, 2, 1, 32, 16, 8, 16, 8, 512),       # h = 1, window wider than S
    (1, 300, 1, 2, 32, 32, 16, 128, 3, 100),    # l_sel = 128: two kv tiles per block
    (1, 100, 1, 2, 128, 16, 8, 32, 4, 50),      # D = 128: two register slices per thread
    (2, 260, 4, 4, 64, 32, 16, 64, 6, 128),     # G = 4, h = 4: the m7c-350M head layout
])
def test_backward_designs_match_plain_and_each_other_on_gpu(dtype, B, S, G, h, D, l, d, l_sel,
                                                            n_top, w):
    """The one-pass kernels (banded_bwd_1p win and cmp, sel_attn_bwd_1p)
    and the diagonal window kernel (win_bwd_diag) against their plain
    versions and against the two-pass design of the same function; two
    launches give the same bits."""
    dev = _card()
    scale = D ** -0.5
    S_cmp = num_cmp_blocks(S, l, d)
    Q, K, V, dO = _bwd_operands(dtype, dev, B, S, G, h, D, S)
    _, Kc, Vc, _ = _bwd_operands(dtype, dev, B, S, G, h, D, S_cmp, seed=1)
    M = torch.from_numpy(build_M_csl(S, l, d, l_sel)).to(dev)
    sel, Oc, lse_c = sc_mod.select_cmp(Q, Kc, Vc, M, scale=scale, l=l, d=d, l_sel=l_sel,
                                       n_top=n_top, return_lse=True)
    t = torch.arange(S, device=dev)
    Os, lse_s = sa_mod.sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=scale, return_lse=True)
    Ow, lse_w = wa_mod.win_attn(Q, K, V, w=w, scale=scale, return_lse=True)
    assert _band_fwd_within(Ow, Q, K, V, mode="win", w=w, scale=scale)
    _, plse_w = wa_mod.win_attn_plain(Q, K, V, w=w, scale=scale, return_lse=True)
    assert torch.allclose(lse_w, plse_w, atol=1e-4, rtol=1e-5)
    cargs = (Q, Kc, Vc, dO, lse_c, attention_delta(dO, Oc))
    wargs = (Q, K, V, dO, lse_w, attention_delta(dO, Ow))
    sargs = (Q, K, V, sel, t, dO, lse_s, attention_delta(dO, Os))
    cmp_ = dict(mode="cmp", l=l, d=d, scale=scale)
    win = dict(mode="win", w=w, scale=scale)
    sel_kw = dict(l_sel=l_sel, scale=scale)

    cwithin = _band_within(cargs, scale, mode="cmp", l=l, d=d)
    wwithin = _band_within(wargs, scale, mode="win", w=w)
    cases = [   # (kernel, plain version, two-pass design, bound)
        (lambda: b1_mod.banded_bwd_1p(*cargs, **cmp_), lambda: bb_mod.banded_bwd_plain(
            *cargs, **cmp_), lambda: bb_mod.banded_bwd(*cargs, **cmp_), cwithin),
        (lambda: b1_mod.banded_bwd_1p(*wargs, **win), lambda: bb_mod.banded_bwd_plain(
            *wargs, **win), lambda: bb_mod.banded_bwd(*wargs, **win), wwithin),
        (lambda: s1_mod.sel_attn_bwd_1p(*sargs, **sel_kw), lambda: sb_mod.sel_attn_bwd_plain(
            *sargs, **sel_kw), lambda: sb_mod.sel_attn_bwd(*sargs, **sel_kw),
         _sel_within(sargs, l_sel, scale)),
        (lambda: wd_mod.win_bwd_diag(*wargs, w=w, scale=scale), lambda: bb_mod.banded_bwd_plain(
            *wargs, **win), lambda: bb_mod.banded_bwd(*wargs, **win), wwithin),
    ]
    outs = []
    for kernel, plain, other, within in cases:
        got, again, want, theirs = kernel(), kernel(), plain(), other()
        for i, (g, a, p, o) in enumerate(zip(got, again, want, theirs)):
            assert g.dtype == p.dtype and g.shape == p.shape
            assert within(g, p, i) and within(g, o, i)
            assert torch.equal(g, a)                           # deterministic
            if dtype == torch.bfloat16:                # a planted 1% fault fails the bound
                assert not within(g.float() * 1.01, p, i)
        outs.append(got)
    # the diagonal, one-pass and two-pass window kernels, and the one-pass
    # and two-pass cmp kernels (the same P and dS in bf16): two bf16 ulps
    # plus the f32 bound apart
    two_cmp, two_win = cases[0][2](), cases[1][2]()
    for a, b, c, e, f in zip(outs[3], outs[1], two_win, outs[0], two_cmp):
        assert _within_rel(a, b) and _within_rel(c, b) and _within_rel(c, a)
        assert _within_rel(f, e)
    # rows that see no compressed token get no gradient
    assert not bool(cases[0][0]()[0][:, :l - 1].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_backward_routes_by_dtype(dtype):
    """bf16 operands launch the tensor-core kernels of banded_bwd_mma.cu,
    f32 the FMA kernels (kernel names from torch.profiler); one launch
    counted per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    S, h, D = 150, 6, 64
    Q, K, V, dO = _bwd_operands(dtype, dev, 1, S, 2, h, D, S)
    O, lse = wa_mod.win_attn(Q, K, V, w=64, scale=SCALE, return_lse=True)
    args = (Q, K, V, dO, lse, attention_delta(dO, O))
    kernels.reset_launch_counts()
    names = []
    for fn in (lambda: b1_mod.banded_bwd_1p(*args, mode="win", w=64, scale=SCALE),
               lambda: wd_mod.win_bwd_diag(*args, w=64, scale=SCALE)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names.append([e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA])
    mma = ("banded_bwd_1p_mma_kernel", "win_bwd_diag_mma_kernel")
    fma = ("banded_bwd_1p_kernel", "win_bwd_diag_kernel")
    want, other = (mma, fma) if dtype == torch.bfloat16 else (fma, mma)
    for kernel, not_this, seen in zip(want, other, names):
        assert any(kernel in n for n in seen) and not any(not_this in n for n in seen), seen
    counts = kernels.launch_counts()
    assert counts["banded_bwd_1p"] == 1 and counts["win_bwd_diag"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_pass_backward_and_scorer_route_by_dtype(dtype):
    """bf16 operands launch the tensor-core kernels (banded_bwd: the q-major
    dQ kernel, then the kv-major kernel with no dQ slots, so no slot sum;
    select_blocks: select_blocks_mma_kernel; select_cmp:
    select_cmp_mma_kernel), f32 the FMA kernels (kernel names from
    torch.profiler); one launch counted per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    S, h, D, l, d, l_sel = 150, 6, 64, 16, 8, 16
    Q, K, V, dO = _bwd_operands(dtype, dev, 1, S, 2, h, D, S)
    O, lse = wa_mod.win_attn(Q, K, V, w=64, scale=SCALE, return_lse=True)
    args = (Q, K, V, dO, lse, attention_delta(dO, O))
    Kc = K[:, :, :num_cmp_blocks(S, l, d)].contiguous()
    kernels.reset_launch_counts()
    names = []
    M = build_M_csl_on(S, l, d, l_sel, dev)
    for fn in (lambda: bb_mod.banded_bwd(*args, mode="win", w=64, scale=SCALE),
               lambda: sk_mod.select_blocks(Q, Kc, S_sel=-(-S // l_sel), scale=SCALE, l=l, d=d,
                                            l_sel=l_sel, n_top=4),
               lambda: sc_mod.select_cmp(Q, Kc, V[:, :, :Kc.shape[2]].contiguous(), M,
                                         scale=SCALE, l=l, d=d, l_sel=l_sel, n_top=4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names.append([e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA])
    mma = (("banded_bwd_dq_mma_kernel", "banded_bwd_1p_mma_kernel"), ("select_blocks_mma_kernel",),
           ("select_cmp_mma_kernel",))
    fma = (("banded_bwd_dq_kernel", "banded_bwd_1p_kernel"), ("select_blocks_kernel",),
           ("select_cmp_kernel",))
    want, other = (mma, fma) if dtype == torch.bfloat16 else (fma, mma)
    for kerns, not_these, seen in zip(want, other, names):
        for kernel, not_this in zip(kerns, not_these):
            assert any(kernel in n for n in seen) and not any(not_this in n for n in seen), seen
    assert not any("sum_slots_kernel" in n for n in names[0]), names[0]
    counts = kernels.launch_counts()
    assert counts["banded_bwd"] == 1 and counts["select_blocks"] == 1
    assert counts["select_cmp"] == 1 and counts["banded_bwd_1p"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,D,l_sel,S,n", [
    (1, 64, 64, 200, 5),       # h = 1; S_kv = 200, not a multiple of 64
    (3, 32, 32, 150, 4),       # odd h; l_sel = 32: half a key tile per block
    (6, 64, 64, 300, 16),      # the m7c geometry; n above the blocks a row sees early on
    (16, 64, 128, 330, 3),     # h = 16; l_sel = 128: two key tiles, the last past S_kv
    (6, 128, 64, 140, 4),      # D = 128: the wide tensor-core tiles (32-row chunks)
    (3, 32, 8, 330, 6),        # l_sel = 8: q-tile unions past 32 blocks (two mask words)
    (4, 64, 64, 300, 16),      # h = 4 (m7c-350M): 16-token q tiles
])
def test_selection_backward_designs_on_gpu(dtype, h, D, l_sel, S, n):
    """Both selection backward designs (sel_attn_bwd, sel_attn_bwd_1p)
    against the plain version and each other, with rows whose set is
    empty and repeated ids; two launches give the same bits; one launch
    each."""
    dev = _card()
    scale = D ** -0.5
    Q, K, V, dO = _bwd_operands(dtype, dev, 2, S, 2, h, D, S, seed=h)
    gen = torch.Generator(device=dev).manual_seed(5)
    NB = -(-S // l_sel)
    sel = torch.randint(-1, NB, (2, S, 2, n), generator=gen, device=dev, dtype=torch.int32)
    sel[..., -1] = sel[..., 0]                                   # repeated ids
    sel[:, 7] = -1                                               # rows with an empty set
    t = torch.arange(S, device=dev)
    O, lse = sa_mod.sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=scale, return_lse=True)
    args = (Q, K, V, sel, t, dO, lse, attention_delta(dO, O))
    within = _sel_within(args, l_sel, scale)
    want = sb_mod.sel_attn_bwd_plain(*args, l_sel=l_sel, scale=scale)
    kernels.reset_launch_counts()
    outs = {}
    for fn in (sb_mod.sel_attn_bwd, s1_mod.sel_attn_bwd_1p):
        got, again = fn(*args, l_sel=l_sel, scale=scale), fn(*args, l_sel=l_sel, scale=scale)
        for i, (g, a, p) in enumerate(zip(got, again, want)):
            assert g.dtype == dtype and g.shape == p.shape
            assert within(g, p, i), (fn.__name__, i)
            assert torch.equal(g, a)                             # deterministic
        assert not bool(got[0][:, 7].any())                      # empty rows: no dQ
        outs[fn.__name__] = got
    for i, (a, b) in enumerate(zip(outs["sel_attn_bwd"], outs["sel_attn_bwd_1p"])):
        assert within(a, b, i)
    counts = kernels.launch_counts()
    assert counts["sel_attn_bwd"] == 2 and counts["sel_attn_bwd_1p"] == 2


def _random_selection(dev, B, S, G, n, NB, seed):
    """Ids in [-1, NB) with a repeated id in every row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.randint(-1, NB, (B, S, G, n), generator=gen, device=dev, dtype=torch.int32)
    sel[..., -1] = sel[..., 0]
    return sel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,D,l_sel,S,n", [
    (1, 64, 64, 200, 5),       # 64-token q tiles, S and S_kv not multiples of the tile / block
    (4, 128, 32, 150, 4),      # D = 128: the wide tensor-core tiles; half a key tile per block
    (6, 64, 64, 305, 16),      # the m7c geometry: 10-token q tiles, the last one of 5
    (16, 64, 128, 330, 3),     # h = 16; two key tiles per block, the last one past S_kv
    (16, 128, 16, 77, 6),      # h = 16, D = 128, 4-token tiles
    (1, 64, 8, 330, 5),        # unions past 32 blocks: two membership words
    (4, 64, 64, 305, 16),      # h = 4 (m7c-350M): 16-token q tiles, the last one of 1
])
def test_prefill_selection_forward_on_gpu(dtype, h, D, l_sel, S, n):
    """sel_attn at S > 1 (bf16: the tensor-core union kernel; f32: the FMA
    kernel) against the plain version, O within its bound and lse within
    1e-4, with rows whose set is empty and repeated ids; two launches give
    the same bits."""
    dev = _card()
    scale = D ** -0.5
    Q, K, V, _ = _bwd_operands(dtype, dev, 2, S, 2, h, D, S, seed=h + D)
    sel = _random_selection(dev, 2, S, 2, n, -(-S // l_sel), seed=D)
    sel[:, 7] = -1                                             # rows with an empty set
    t = torch.arange(S, device=dev)
    kernels.reset_launch_counts()
    (O, lse), (O2, lse2) = (sa_mod.sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=scale,
                                            return_lse=True) for _ in range(2))
    assert kernels.launch_counts()["sel_attn"] == 2 and sa_mod.sel_attn.decode_launches == 0
    assert torch.equal(O, O2) and torch.equal(lse, lse2)
    assert O.dtype == dtype and _sel_fwd_within(O, Q, K, V, sel, t, l_sel, scale)
    _, plse = sa_mod.sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel, scale=scale, return_lse=True)
    empty = plse >= 1e29
    assert torch.equal(lse >= 1e29, empty) and bool(empty[:, 7].all())
    assert float(torch.where(empty, 0.0, (lse - plse).abs()).max()) <= 1e-4
    assert not bool(O[:, 7].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,C,l_sel,h", [
    (1, 1, 64, 64, 6),         # one slot
    (3, 5, 100, 16, 3),        # a partial last block (keys 96..99)
    (4, 16, 2080, 64, 6),      # the m7c serve cache
    (2, 16, 333, 8, 16),       # h = 16, more slots than visible blocks early on
    (4, 16, 2080, 64, 4),      # h = 4 (m7c-350M) at the serve cache
])
def test_decode_selection_split_on_gpu(dtype, B, n, C, l_sel, h):
    """sel_attn at S = 1 (the split kernel and its combine) against the
    plain version at per-row depths, with -1 slots, repeated ids and an
    empty row; two launches give the same bits."""
    dev = _card()
    D = 64
    Q, K, V, _ = _bwd_operands(dtype, dev, B, 1, 2, h, D, C, seed=n)
    NB = -(-C // l_sel)
    sel = _random_selection(dev, B, 1, 2, n, NB, seed=B)
    sel[1:, :, :, 0] = NB - 1                                  # the last, partial block
    sel[0] = -1                                                # batch row 0: every set empty
    t = torch.tensor([[C - 1 - 13 * (i // 2)] for i in range(B)], device=dev)
    kernels.reset_launch_counts()
    O, O2 = (sa_mod.sel_attn(Q, K, V, sel, t, l_sel=l_sel, scale=0.125) for _ in range(2))
    assert sa_mod.sel_attn.decode_launches == 2 and torch.equal(O, O2)
    assert O.dtype == dtype and _sel_fwd_within(O, Q, K, V, sel, t, l_sel, 0.125)
    assert not bool(O[0].any())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "compressed"])
def test_cmp_backward_takes_the_one_pass_kernel_behind_both_routes(monkeypatch, route):
    """Under bwd.onepass = 1 the compressed branch's backward behind the
    fused scorer (_FusedSelectCmp) and behind compressed_attention
    (_CompressedAttention) launches banded_bwd_1p in cmp mode, with the
    CPU's gradients; under bwd.onepass = 0 the two-pass kernel."""
    dev = _card()
    B, S, G, h, D, l, d, l_sel = 2, 200, 2, 3, 32, 16, 8, 32
    S_cmp = num_cmp_blocks(S, l, d)
    gen = torch.Generator().manual_seed(4)
    Q, K, V, dO = (torch.randn(shape, generator=gen) for shape in (
        (B, S, G, h, D), (B, G, S_cmp, D), (B, G, S_cmp, D), (B, S, G, h, D)))
    M = torch.from_numpy(build_M_csl(S, l, d, l_sel))

    def grads(dv):
        q, k, v = (x.to(dv).requires_grad_(True) for x in (Q, K, V))
        if route == "fused":
            O = fused_select_cmp(q, k, v, M.to(dv), scale=0.2, l=l, d=d, l_sel=l_sel, n_top=4,
                                 force_init=True, force_local=2)[1]
        else:
            O = compressed_attention(q, k, v, l=l, d=d, scale=0.2)
        return torch.autograd.grad(O, (q, k, v), dO.to(dv))

    want = grads("cpu")
    for onepass, kernel in ((1, "banded_bwd_1p"), (0, "banded_bwd")):
        keys = dict(tuning.DEFAULTS, **{"bwd.onepass": onepass})
        monkeypatch.setattr(tuning, "_load", lambda keys=keys: keys)
        kernels.reset_launch_counts()
        got = grads(dev)
        counts = kernels.launch_counts()
        assert counts[kernel] == 1 and counts["banded_bwd_1p"] + counts["banded_bwd"] == 1
        for g, w_ in zip(got, want):
            assert (g.cpu() - w_).abs().max() <= F32_TOL * max(float(w_.abs().max()), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("keys", [
    {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 0},
    {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 1},
    {"bwd.onepass": 0, "sel.bwd_onepass": 0, "win.bwd_diag": 0},
    {"bwd.onepass": 0, "sel.bwd_onepass": 1, "win.bwd_diag": 1},
])
def test_layer_backward_under_each_design_matches_cpu(monkeypatch, keys):
    """One f32 layer's forward + backward on the card under a setting of
    the design keys: the kernels tuning.backward_kernel names launch, once
    per branch, with the CPU's gradients, and no host sync."""
    dev = _card()
    monkeypatch.setattr(tuning, "_load", lambda: dict(tuning.DEFAULTS, **keys))
    cfg = NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16,
                    n_sel=4, w=32)
    params = init_nsa_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 150, 96, generator=torch.Generator().manual_seed(1))

    def layer(dv):   # parameters and [x, parameter leaves] on dv, as gradient targets
        with torch.no_grad():
            p = params_to(params, device=dv)
        return p, [t.requires_grad_(True) for t in [x.to(dv)] + [t for _, t in param_leaves(p)]]

    def grads(p, wrt):
        out = nsa_prefill(p, wrt[0], cfg)[0]
        return torch.autograd.grad((out * out).sum(), wrt)

    want = grads(*layer("cpu"))
    on_card = layer(dev)
    kernels.reset_launch_counts()
    got = grads(*on_card)
    counts = kernels.launch_counts()
    for branch in ("win", "cmp", "sel"):
        assert counts[tuning.backward_kernel(branch, 150, 32)] >= 1
    assert sum(counts[k] for k in ("banded_bwd", "banded_bwd_1p", "win_bwd_diag",
                                   "sel_attn_bwd", "sel_attn_bwd_1p")) == 3, counts
    for g, w_ in zip(got, want):
        assert (g.cpu() - w_).abs().max() <= 1e-4 * float(w_.abs().max())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_two_layer_train_step_on_card_matches_cpu():
    """Three f32 steps of a 2-layer model (remat on): loss, grad norm and
    every parameter from the kernels equal the plain path's within 1e-4
    of each tensor's scale."""
    dev = _card()
    mcfg = ModelConfig(vocab_size=64, n_layers=2, remat=True,
                       nsa=NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, steps=10)
    sc, sg = (init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                                 device=d), tcfg) for d in ("cpu", dev))
    step = make_train_step(mcfg, tcfg)
    toks = torch.randint(0, 64, (3, 1, 2, 131), generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    for i in range(3):
        sc, mc = step(sc, toks[i])
        sg, mg = step(sg, toks[i].to(dev))
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k])), k
    counts = kernels.launch_counts()
    want = {**dict.fromkeys(counts, 0), "select_cmp": 12, "sel_attn": 12, "win_attn": 12}
    for branch in ("win", "cmp", "sel"):          # the default design keys' kernels
        want[tuning.backward_kernel(branch, 130, 32)] += 6
    assert counts == want, counts
    for a, b in zip(_flat(params_to_numpy(sc.params)), _flat(params_to_numpy(sg.params))):
        assert abs(a - b).max() <= 1e-4 * max(abs(a).max(), 1e-3)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.gpu
def test_layer_backward_issues_without_host_sync():
    """One layer's forward and backward through the kernels never make
    the host wait for the card."""
    dev = _card()
    cfg = NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16,
                    n_sel=4, w=32)
    params = init_nsa_params(cfg, torch.Generator().manual_seed(0), device=dev)
    params["W_qkv"].requires_grad_(True)
    x = torch.randn(2, 90, 96, device=dev, requires_grad=True)
    nsa_prefill(params, x, cfg)[0].sum().backward()              # first use builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nsa_prefill(params, x, cfg)[0].sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,h,D,l,d,l_sel,n_top,w", [
    (2, 300, 2, 6, 64, 32, 16, 64, 5, 128),     # m7c geometry, short
    (1, 130, 1, 3, 16, 8, 4, 16, 4, 40),        # odd h, S not divisible by l_sel
    (1, 70, 3, 1, 32, 16, 8, 16, 8, 512),       # h = 1, window wider than S
    (2, 300, 4, 4, 64, 32, 16, 64, 5, 128),     # G = 4, h = 4: the m7c-350M head layout
])
def test_kernels_match_plain_on_gpu(dtype, B, S, G, h, D, l, d, l_sel, n_top, w):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    S_cmp = num_cmp_blocks(S, l, d)
    Q, Kc, Vc = r(B, S, G, h, D), r(B, G, S_cmp, D), r(B, G, S_cmp, D)
    M = torch.from_numpy(build_M_csl(S, l, d, l_sel)).to(dev)
    kw = dict(scale=SCALE, l=l, d=d, l_sel=l_sel, n_top=n_top)
    sel, O = sc_mod.select_cmp(Q, Kc, Vc, M, **kw)
    psel, pO = sc_mod.select_cmp_plain(Q, Kc, Vc, M, **kw)
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(psel))
    assert _band_fwd_within(O, Q, Kc, Vc, mode="cmp", l=l, d=d, scale=SCALE)

    K, V = r(B, G, S, D), r(B, G, S, D)
    t = torch.arange(S, device=dev)
    for s in (sel, canonicalize_sel(sel)):      # forced-first repeats == the set
        assert _sel_fwd_within(sa_mod.sel_attn(Q, K, V, s, t, l_sel=l_sel, scale=SCALE),
                               Q, K, V, sel, t, l_sel, SCALE)
    assert _band_fwd_within(wa_mod.win_attn(Q, K, V, w=w, scale=SCALE), Q, K, V, mode="win",
                            w=w, scale=SCALE)
    # decode shape: one query per row at its own depth, cache rows past t unread
    Qd = r(B, 1, G, h, D)
    td = torch.tensor([[S - 1 - 7 * i] for i in range(B)], device=dev)
    sd = canonicalize_sel(sel[:, -1:])
    assert _within_bound(sa_mod.sel_attn(Qd, K, V, sd, td, l_sel=l_sel, scale=SCALE),
                         sa_mod.sel_attn_plain(Qd, K, V, sd, td, l_sel=l_sel, scale=SCALE))


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    Q = torch.randn(1, 40, 1, 2, 12, device=dev)            # D not a multiple of 8
    K = torch.randn(1, 1, 40, 12, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        wa_mod.win_attn(Q, K, K, w=8, scale=SCALE)
    Q = torch.randn(1, 40, 1, 2, 16, device=dev)
    K = torch.randn(1, 1, 40, 16, device=dev).transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        wa_mod.win_attn(Q, K, K, w=8, scale=SCALE)
    with pytest.raises(TypeError, match="dtype"):
        wa_mod.win_attn(Q, K.contiguous().half(), K.contiguous(), w=8, scale=SCALE)
    # select_cmp: the bf16 kernel's head width, the fused route's selection width
    kw = dict(scale=SCALE, l=8, d=4, l_sel=16, n_top=4)
    Qw = torch.randn(1, 40, 1, 2, 136, device=dev).bfloat16()
    Kw = torch.randn(1, 1, 9, 136, device=dev).bfloat16()
    with pytest.raises(ValueError, match="Dk, Dv <= 128"):
        sc_mod.select_cmp(Qw, Kw, Kw, torch.zeros(9, 3, device=dev), **kw)
    Qn, Kn = Qw[..., :16].contiguous(), Kw[..., :16].contiguous()
    with pytest.raises(ValueError, match="past the kernel's limits"):
        sc_mod.select_cmp(Qn, Kn, Kn, torch.zeros(9, 257, device=dev), **kw)
    with pytest.raises(TypeError, match="float32"):
        sc_mod.select_cmp(Qn, Kn, Kn, torch.zeros(9, 3, device=dev).bfloat16(), **kw)


@pytest.mark.gpu
def test_small_model_serves_the_same_tokens_on_card_and_cpu():
    """A 2-layer f32 model: greedy tokens from the kernel path equal the
    plain path's, and the launch counters show every kernel on the path."""
    dev = _card()
    mcfg = ModelConfig(vocab_size=64, n_layers=2,
                       nsa=NSAConfig(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, 64, (2, 90), generator=torch.Generator().manual_seed(1))
    want = generate(params, prompt, 6, mcfg)
    kernels.reset_launch_counts()
    got = generate(params_to(params, device=dev), prompt.to(dev), 6, mcfg)
    assert torch.equal(got.cpu(), want)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "select_cmp": 2, "sel_attn": 2 + 2 * 5,
                      "win_attn": 2}


@pytest.mark.gpu
def test_serving_path_issues_without_host_sync():
    """Prefill, cache seeding and a decode step never make the host wait
    for the card (a host-to-device copy or a read of a device value would)."""
    dev = _card()
    mcfg = ModelConfig(vocab_size=64, n_layers=1,
                       nsa=NSAConfig(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev)
    prompt = torch.randint(0, 64, (2, 90), generator=torch.Generator().manual_seed(1)).to(dev)
    model_prefill_with_caches(params, prompt, mcfg, 96)          # first use builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, caches = model_prefill_with_caches(params, prompt, mcfg, 96)
        model_decode_step(params, logits[:, -1:].argmax(-1), caches, mcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _captured_ragged_step(dev, B: int):
    """The 1-layer serving config of test_serving_path_issues_without_host_sync,
    B prompts of 90 tokens prefilled into ragged caches of capacity 96, and
    one captured tick: a ragged step on the static token, logits into a
    static buffer, the greedy token fed back."""
    mcfg = ModelConfig(vocab_size=64, n_layers=1,
                       nsa=NSAConfig(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev)
    prompt = torch.randint(0, 64, (B, 90), generator=torch.Generator().manual_seed(1)).to(dev)
    logits, caches = model_prefill_with_caches(params, prompt, mcfg, 96)
    caches = [ragged_cache(c) for c in caches]
    tok = logits[:, -1:].argmax(-1)
    out = torch.empty_like(logits[:, -1:])

    def tick():
        lg, _ = model_decode_step_ragged(params, tok, caches, mcfg)
        out.copy_(lg)
        tok.copy_(lg[:, -1:].argmax(-1))

    state = [tok, out] + [x for c in caches for x in cache_tensors(c)]
    snap = [x.clone() for x in state]
    graph = DecodeGraph(tick, state)
    assert all(torch.equal(a, b) for a, b in zip(state, snap))   # capture moves no state
    return mcfg, params, caches, tick, graph, state, snap, out


@pytest.mark.gpu
def test_captured_ragged_step_replays_bit_equal_without_host_sync():
    """Four replays of the captured ragged step give the bits of four eager
    ticks from the same state, issue with no host sync, and launch the split
    selection kernel once a replay (the layer's decode; kernel names from
    torch.profiler) while calling no wrapper (launch counts stay 0)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    _, _, _, tick, graph, state, snap, out = _captured_ragged_step(dev, 2)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    got = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)     # the profiler drops kernels timed at its window's edges
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                graph.replay()
                got.append(out.clone())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        time.sleep(0.02)
    split = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "sel_attn_split_kernel" in e.key)
    assert split == 4
    assert not any(kernels.launch_counts().values()) and sa_mod.sel_attn.decode_launches == 0
    torch._foreach_copy_(state, snap)
    for g in got:
        tick()
        assert torch.equal(out, g)


@pytest.mark.gpu
def test_generate_scan_on_gpu_matches_generate():
    """On the card generate_scan replays its captured tick: greedy tokens
    equal generate's; sampled tokens from a seeded CUDA generator (registered
    with the graph) repeat for the seed and equal generate's draws."""
    dev = _card()
    mcfg = ModelConfig(vocab_size=64, n_layers=2,
                       nsa=NSAConfig(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device=dev)
    prompt = torch.randint(0, 64, (2, 90), generator=torch.Generator().manual_seed(1)).to(dev)
    assert torch.equal(generate_scan(params, prompt, 6, mcfg), generate(params, prompt, 6, mcfg))

    def run(fn):
        return fn(params, prompt, 6, mcfg, temperature=0.8, top_k=8, top_p=0.9,
                  generator=torch.Generator(device=dev).manual_seed(5))

    a = run(generate_scan)
    assert torch.equal(a, run(generate_scan)) and torch.equal(a, run(generate))


@pytest.mark.gpu
def test_admit_row_into_captured_batch_changes_that_row_only():
    """admit_row writes a new request into row 1 of the captured caches in
    place: the next replay's logits change in row 1 only, and row 1 equals
    the new request's own eager ragged step."""
    dev = _card()
    mcfg, params, caches, _, graph, state, snap, out = _captured_ragged_step(dev, 3)
    graph.replay()
    before = out.clone()
    torch._foreach_copy_(state, snap)
    new = torch.randint(0, 64, (1, 40), generator=torch.Generator().manual_seed(7)).to(dev)
    _, solo = model_prefill_with_caches(params, new, mcfg, 96)
    ptrs = [x.data_ptr() for x in state]
    for c, s in zip(caches, solo):
        admit_row(c, s, 1)
    assert [x.data_ptr() for x in state] == ptrs and caches[0].t.tolist() == [90, 40, 90]
    tok1 = state[0][1:2].clone()
    graph.replay()
    assert torch.equal(out[0], before[0]) and torch.equal(out[2], before[2])
    assert not torch.equal(out[1], before[1])
    want, _ = model_decode_step_ragged(params, tok1, [ragged_cache(s) for s in solo], mcfg)
    assert float((out[1] - want[0]).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,S,t_start,h,D,kw", [
    ("win", 300, 0, 6, 64, dict(w=128)),
    ("win", 130, 170, 3, 16, dict(w=40)),       # rows at positions 170..299, odd h
    ("cmp", 300, 0, 6, 64, dict(l=32, d=16)),   # rows t < 31 see no compressed token
    ("cmp", 70, 260, 1, 32, dict(l=8, d=4)),
    ("win", 150, 61, 2, 32, dict(w=70)),        # t_start not a multiple of a q tile; S_kv 211
    ("cmp", 200, 333, 6, 64, dict(l=32, d=16)),   # S_kv = 32, one partial key tile
    ("win", 260, 45, 3, 128, dict(w=100)),      # D = 128: the wide tensor-core tiles
    ("cmp", 330, 0, 2, 128, dict(l=16, d=8)),   # D = 128, S_kv = 40
    ("win", 100, 0, 1, 64, dict(w=512)),        # h = 1, window wider than S
])
def test_banded_attn_matches_plain_on_gpu(dtype, mode, S, t_start, h, D, kw, monkeypatch):
    """banded_attn on the card against its plain version (bf16: the
    tensor-core bound), lse, the same rows from the call over every
    position, and in bf16 the same bits at q tiles of 64 and 128 rows."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(2)
    B, G, n_pos = 2, 2, t_start + S
    S_kv = n_pos if mode == "win" else num_cmp_blocks(n_pos, kw["l"], kw["d"])

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    Q, K, V = r(B, S, G, h, D), r(B, G, S_kv, D), r(B, G, S_kv, D)
    O, lse = ba_mod.banded_attn(Q, K, V, mode=mode, **kw, scale=SCALE, t_start=t_start,
                                return_lse=True)
    pO, plse = ba_mod.banded_attn_plain(Q, K, V, mode=mode, **kw, scale=SCALE,
                                        t_start=t_start, return_lse=True)
    assert _band_fwd_within(O, Q, K, V, mode=mode, **kw, scale=SCALE, t_start=t_start)
    empty = plse >= 1e29
    assert torch.equal(lse >= 1e29, empty)
    assert float(torch.where(empty, 0.0, (lse - plse).abs()).max()) <= 1e-4
    if t_start:   # the same rows of one call over every position
        Qf = torch.cat([r(B, t_start, G, h, D), Q], dim=1)
        full = ba_mod.banded_attn(Qf, K, V, mode=mode, **kw, scale=SCALE)
        assert torch.equal(full[:, t_start:], O)
    if dtype == torch.bfloat16:   # a row's bits do not depend on the q tile that holds it
        tiles = []
        for rows in (64, 128):
            monkeypatch.setattr(ba_mod, "MMA_TILE_ROWS", rows)
            tiles.append(ba_mod.banded_attn(Q, K, V, mode=mode, **kw, scale=SCALE,
                                            t_start=t_start, return_lse=True))
        assert all(torch.equal(a, b) for a, b in zip(*tiles))
        assert torch.equal(tiles[0][0], O) and torch.equal(tiles[0][1], lse)


def _sets_equal_but_near_ties(sel, psel, p_grp, tie=1e-5):
    a, b = canonicalize_sel(sel), canonicalize_sel(psel)
    for i in (a != b).any(-1).nonzero().tolist():
        differ = set(a[tuple(i)].tolist()) ^ set(b[tuple(i)].tolist())
        if -1 in differ:                        # one set has more blocks than the other
            return False
        scores = p_grp[tuple(i)][sorted(differ)]
        if float(scores.max() - scores.min()) > tie:
            return False
    return True


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,h,D,l,d,l_sel,n_top,pos_offset", [
    (300, 6, 64, 32, 16, 64, 16, 0),            # S not a multiple of the 21-token tile
    (130, 3, 16, 8, 4, 16, 4, 70),              # rows at positions 70..199, odd h
    (200, 1, 32, 8, 4, 16, 4, 0),               # h = 1: 128 tokens a tile
    (1, 2, 64, 32, 16, 64, 16, 65535),          # one row, S_sel = 1024 (the needle smoke)
    (100, 6, 64, 32, 16, 16, 16, 130972),       # S_sel = 8192: the tile shrinks
    (90, 6, 128, 32, 16, 64, 16, 40),           # D = 128: the wide tiles
])
def test_select_blocks_matches_plain_on_gpu(dtype, S, h, D, l, d, l_sel, n_top, pos_offset):
    """Sets as the plain version's but for near ties; forced slots in
    order; two launches give the same bits; the last rows at their own
    pos_offset give the full call's rows."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    B, G, n_pos = 2, 2, pos_offset + S
    S_cmp, S_sel = num_cmp_blocks(n_pos, l, d), -(-n_pos // l_sel)
    Q = torch.randn((B, S, G, h, D), generator=gen, device=dev).to(dtype)
    Kc = torch.randn((B, G, S_cmp, D), generator=gen, device=dev).to(dtype)
    kw = dict(S_sel=S_sel, scale=SCALE, l=l, d=d, l_sel=l_sel, n_top=n_top)
    sel = sk_mod.select_blocks(Q, Kc, **kw, pos_offset=pos_offset)
    again = sk_mod.select_blocks(Q, Kc, **kw, pos_offset=pos_offset)
    psel, p_grp = sk_mod.select_blocks_plain(Q, Kc, **kw, pos_offset=pos_offset,
                                             return_scores=True)
    assert sel.shape == psel.shape and sel.dtype == torch.int32
    assert torch.equal(sel[..., :3], psel[..., :3])             # forced slots, in order
    assert _sets_equal_but_near_ties(sel, psel, p_grp)
    assert torch.equal(sel, again)
    if S_sel == 8192:
        assert sk_mod.tile_plan(sk_mod.library(), dtype, h, D, S_sel) < (
            sk_mod.MMA_TILE_ROWS if dtype == torch.bfloat16 else sk_mod.ROWS_PER_BLOCK) // h
    a = S // 3
    tail = sk_mod.select_blocks(Q[:, a:].contiguous(), Kc, **kw, pos_offset=pos_offset + a)
    assert torch.equal(tail, sel[:, a:])


@pytest.mark.gpu
def test_small_model_serves_the_same_tokens_on_the_long_route(monkeypatch):
    """With the fused scorer's limit set below this prompt's selection
    width, prefill takes select_blocks + banded_attn on the card and the
    plain versions on the CPU: the same greedy tokens."""
    dev = _card()
    monkeypatch.setattr(sc_mod, "SELECT_CMP_MAX_S_SEL", 4)
    mcfg = ModelConfig(vocab_size=64, n_layers=2,
                       nsa=NSAConfig(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    params = init_model_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, 64, (2, 90), generator=torch.Generator().manual_seed(1))
    want = generate(params, prompt, 6, mcfg)
    kernels.reset_launch_counts()
    got = generate(params_to(params, device=dev), prompt.to(dev), 6, mcfg)
    assert torch.equal(got.cpu(), want)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "sel_attn": 2 + 2 * 5, "win_attn": 2,
                      "banded_attn": 2, "select_blocks": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,h,Dk,Dv,l,d,l_sel,n_top,lse", [
    (4, 2048, 2, 6, 64, 64, 32, 16, 64, 16, False),   # the m7c serve shape
    (8, 2048, 2, 6, 64, 64, 32, 16, 64, 16, True),    # the m7c train shape, with lse
    (2, 200, 2, 1, 32, 32, 16, 8, 16, 8, True),       # h = 1: 128 tokens a CTA
    (1, 300, 2, 3, 64, 64, 32, 16, 64, 5, True),      # odd h; rows t < 31 see no token
    (1, 16384, 2, 6, 64, 64, 32, 16, 64, 16, True),   # S_sel = 256, the fused route's limit
    (1, 16384, 4, 4, 64, 64, 32, 16, 64, 16, True),   # S_sel = 256 at G = 4, h = 4, with lse
    (1, 1024, 1, 1, 16, 16, 8, 4, 4, 16, False),      # S_sel = 256 at h = 1: the tile shrinks
    (1, 150, 2, 5, 128, 128, 16, 8, 32, 4, True),     # D = 128
    (2, 170, 2, 2, 64, 32, 16, 8, 32, 6, True),       # Dk != Dv
])
def test_select_cmp_matches_plain_on_gpu(dtype, B, S, G, h, Dk, Dv, l, d, l_sel, n_top, lse):
    """select_cmp (bf16: the tensor-core kernel; f32: the FMA kernel)
    against its plain version: O within its bound (bf16: _within_tc of the
    unrounded f32 O, where a planted 1% fault fails; f32: 5e-5), lse
    within 1e-4 with the same rows empty, sets as the plain version's but
    for near ties and the forced slots in order; two launches give the same
    bits; in bf16 O and lse are banded_attn's in cmp mode bit for bit."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(h + Dk)
    S_cmp = num_cmp_blocks(S, l, d)
    Q = torch.randn((B, S, G, h, Dk), generator=gen, device=dev).to(dtype)
    Kc = torch.randn((B, G, S_cmp, Dk), generator=gen, device=dev).to(dtype)
    Vc = torch.randn((B, G, S_cmp, Dv), generator=gen, device=dev).to(dtype)
    M = build_M_csl_on(S, l, d, l_sel, dev)
    scale = Dk ** -0.5
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=n_top)
    kernels.reset_launch_counts()
    got, again = (sc_mod.select_cmp(Q, Kc, Vc, M, **kw, return_lse=True) for _ in range(2))
    sel, O = sc_mod.select_cmp(Q, Kc, Vc, M, **kw)
    assert kernels.launch_counts()["select_cmp"] == 3
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(sel, got[0]) and torch.equal(O, got[1])        # lse or not, same bits
    psel, pO, plse, p_grp = sc_mod.select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=True,
                                                   return_scores=True)
    assert sel.shape == psel.shape and O.dtype == dtype
    assert torch.equal(sel[..., :3], psel[..., :3])                   # forced slots, in order
    assert _sets_equal_but_near_ties(sel, psel, p_grp)
    empty = plse >= 1e29
    assert torch.equal(got[2] >= 1e29, empty) and bool(empty[:, :l - 1].all())
    assert float(torch.where(empty, 0.0, (got[2] - plse).abs()).max()) <= 1e-4
    assert _band_fwd_within(O, Q, Kc, Vc, mode="cmp", l=l, d=d, scale=scale)
    assert not bool(O[:, :l - 1].any())
    if dtype == torch.bfloat16:
        assert not _band_fwd_within(O.float() * 1.01, Q, Kc, Vc, mode="cmp", l=l, d=d,
                                    scale=scale)
        Ob, lseb = ba_mod.banded_attn(Q, Kc, Vc, mode="cmp", l=l, d=d, scale=scale,
                                      return_lse=True)
        assert torch.equal(Ob, O) and torch.equal(lseb, got[2])
    else:
        assert _within_bound(O, pO)


# ---------------------------------------------------------------- packed documents (varlen)

# per row, document lengths packed at l_sel = 16: one shorter than l = 8 (no
# visible compressed token), one of exactly l_sel, one longer than w, and a
# row that one document nearly fills; the 128-row q tiles (21 tokens at
# h = 6) straddle the starts
VARLEN_LENS = ((5, 16, 100, 60, 40), (250, 30))
VARLEN = dict(S=300, G=2, h=6, D=64, l=8, d=4, l_sel=16, n_top=4, w=40)


def _doc_starts(dev, S=VARLEN["S"], lens=VARLEN_LENS, align=VARLEN["l_sel"]):
    rows = [pack_documents_aligned([np.ones(n, np.int32) for n in row], S, align, 1)[1][0]
            for row in lens]
    return torch.from_numpy(np.stack(rows)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["win", "cmp"])
def test_varlen_banded_forward_on_gpu(dtype, mode):
    """win_attn / banded_attn (cmp) with seq_start against the plain
    version with it (bf16: _within_tc, where a planted 1% fault fails),
    lse with the same rows empty, two launches bit-equal; the same kernel
    given the dense bound fails the check."""
    dev, c = _card(), VARLEN
    ds = _doc_starts(dev)
    S_kv = c["S"] if mode == "win" else num_cmp_blocks(c["S"], c["l"], c["d"])
    Q, K, V, _ = _bwd_operands(dtype, dev, 2, c["S"], c["G"], c["h"], c["D"], S_kv, seed=5)
    kw = dict(w=c["w"]) if mode == "win" else dict(l=c["l"], d=c["d"])
    scale = c["D"] ** -0.5

    def run(seq_start):
        if mode == "win":
            return wa_mod.win_attn(Q, K, V, **kw, scale=scale, return_lse=True,
                                   seq_start=seq_start)
        return ba_mod.banded_attn(Q, K, V, mode=mode, **kw, scale=scale, return_lse=True,
                                  seq_start=seq_start)

    (O, lse), (O2, lse2) = run(ds), run(ds)
    assert torch.equal(O, O2) and torch.equal(lse, lse2)
    pO, plse = ba_mod.banded_attn_plain(Q, K, V, mode=mode, **kw, scale=scale, return_lse=True,
                                        seq_start=ds)
    if dtype == torch.float32:
        within = lambda o: _within_bound(o, pO)                     # noqa: E731
    else:
        want, rss = ba_mod.banded_attn_rss(Q, K, V, mode=mode, **kw, scale=scale, seq_start=ds)
        within = lambda o: _within_tc(o, want, want, rss)           # noqa: E731
        assert not within(O.float() * 1.01)
    assert within(O)
    empty = plse >= 1e29
    assert torch.equal(lse >= 1e29, empty)
    assert float(torch.where(empty, 0.0, (lse - plse).abs()).max()) <= 1e-4
    if mode == "cmp":     # the 5-token document sees no pooled token
        assert bool(empty[0, :5].all()) and not bool(O[0, :5].any())
    assert not within(run(None)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_scorers_on_gpu(dtype):
    """select_cmp (O, lse, sets) and select_blocks (sets) with seq_start
    against their plain versions with it: sets equal but for near ties,
    forced slots (the document's first block, the local blocks clamped to
    it) in order, every pick inside the row's document; two launches give
    the same bits; the dense bound gives other sets."""
    dev, c = _card(), VARLEN
    ds = _doc_starts(dev)
    S, l, d, l_sel = c["S"], c["l"], c["d"], c["l_sel"]
    S_cmp, S_sel = num_cmp_blocks(S, l, d), -(-S // l_sel)
    Q, Kc, Vc, _ = _bwd_operands(dtype, dev, 2, S, c["G"], c["h"], c["D"], S_cmp, seed=6)
    scale = c["D"] ** -0.5
    kw = dict(scale=scale, l=l, d=d, l_sel=l_sel, n_top=c["n_top"])
    M = build_M_csl_on(S, l, d, l_sel, dev)
    got = sc_mod.select_cmp(Q, Kc, Vc, M, **kw, return_lse=True, seq_start=ds)
    again = sc_mod.select_cmp(Q, Kc, Vc, M, **kw, return_lse=True, seq_start=ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    psel, pO, plse, p_grp = sc_mod.select_cmp_plain(Q, Kc, Vc, M, **kw, return_lse=True,
                                                   return_scores=True, seq_start=ds)
    sel, O, lse = got
    first = (ds // l_sel).long()[:, :, None, None]
    for s, ps in ((sel, psel), (sk_mod.select_blocks(Q, Kc, S_sel=S_sel, **kw, seq_start=ds),
                               sk_mod.select_blocks_plain(Q, Kc, S_sel=S_sel, **kw,
                                                          seq_start=ds))):
        assert torch.equal(s[..., :3], ps[..., :3])
        assert _sets_equal_but_near_ties(s, ps, p_grp)
        assert bool(((s < 0) | (s >= first)).all())
        assert not torch.equal(canonicalize_sel(s), canonicalize_sel(sc_mod.select_cmp(
            Q, Kc, Vc, M, **kw)[0]))
    empty = plse >= 1e29
    assert torch.equal(lse >= 1e29, empty) and bool(empty[0, :5].all())
    assert float(torch.where(empty, 0.0, (lse - plse).abs()).max()) <= 1e-4
    if dtype == torch.float32:
        assert _within_bound(O, pO)
    else:
        want, rss = ba_mod.banded_attn_rss(Q, Kc, Vc, mode="cmp", l=l, d=d, scale=scale,
                                           seq_start=ds)
        assert _within_tc(O, want, want, rss)
        Ob, Lb = ba_mod.banded_attn(Q, Kc, Vc, mode="cmp", l=l, d=d, scale=scale,
                                    return_lse=True, seq_start=ds)
        assert torch.equal(O, Ob) and torch.equal(lse, Lb)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["win", "cmp"])
def test_varlen_banded_backward_designs_on_gpu(dtype, mode):
    """banded_bwd_1p, banded_bwd and (win) win_bwd_diag with seq_start
    against the plain version with it and against each other, two launches
    bit-equal (a dQ slot numbered with another bound, or a strip left stale,
    would fail); the dense bound fails the check."""
    dev, c = _card(), VARLEN
    ds = _doc_starts(dev)
    S_kv = c["S"] if mode == "win" else num_cmp_blocks(c["S"], c["l"], c["d"])
    Q, K, V, dO = _bwd_operands(dtype, dev, 2, c["S"], c["G"], c["h"], c["D"], S_kv, seed=7)
    scale = c["D"] ** -0.5
    kw = dict(mode=mode, **(dict(w=c["w"]) if mode == "win" else dict(l=c["l"], d=c["d"])))
    O, lse = ba_mod.banded_attn(Q, K, V, **kw, scale=scale, return_lse=True, seq_start=ds)
    args = (Q, K, V, dO, lse, attention_delta(dO, O))
    within = _band_within(args, scale, **kw, seq_start=ds)
    want = bb_mod.banded_bwd_plain(*args, **kw, scale=scale, seq_start=ds)
    kernels_ = [lambda s: b1_mod.banded_bwd_1p(*args, **kw, scale=scale, seq_start=s),
                lambda s: bb_mod.banded_bwd(*args, **kw, scale=scale, seq_start=s)]
    if mode == "win":
        kernels_.append(lambda s: wd_mod.win_bwd_diag(*args, w=c["w"], scale=scale,
                                                      seq_start=s))
    outs = []
    for kern in kernels_:
        got, again = kern(ds), kern(ds)
        for i, (g, a, p) in enumerate(zip(got, again, want)):
            assert within(g, p, i) and torch.equal(g, a)
        assert not all(within(g, p, i) for i, (g, p) in enumerate(zip(kern(None), want)))
        outs.append(got)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert _within_rel(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "select_blocks"])
def test_varlen_layer_on_card_matches_cpu(monkeypatch, route):
    """One f32 layer's forward + backward on packed documents: the kernels'
    output and gradients equal the plain path's within 1e-4 of each
    tensor's max, and the card issues it without a host sync."""
    dev = _card()
    if route == "select_blocks":
        monkeypatch.setattr(sc_mod, "SELECT_CMP_MAX_S_SEL", 4)
    cfg = NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16,
                    n_sel=4, w=32)
    params = init_nsa_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 300, 96, generator=torch.Generator().manual_seed(1))
    ds = _doc_starts("cpu")

    def layer(dv):
        with torch.no_grad():
            p = params_to(params, device=dv)
        return p, [t.requires_grad_(True) for t in [x.to(dv)] + [t for _, t in param_leaves(p)]]

    def grads(p, wrt, s):
        out = nsa_prefill(p, wrt[0], cfg, seq_start=s)[0]
        return [out.detach()] + list(torch.autograd.grad((out * out).sum(), wrt))

    want = grads(*layer("cpu"), ds)
    on_card = layer(dev)
    kernels.reset_launch_counts()
    got = grads(*on_card, ds.to(dev))
    counts = kernels.launch_counts()
    assert counts["win_attn"] == 1 and (counts["select_cmp"] if route == "fused"
                                        else counts["select_blocks"]) == 1
    for g, w_ in zip(got, want):
        assert (g.cpu() - w_).abs().max() <= 1e-4 * float(w_.abs().max())
    dsc = ds.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads(*on_card, dsc)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------- gate-epilogue fold

# S, t_start, h, D, seq_start, l, d, l_sel, w, n_top
FOLD_CASES = [
    (300, 0, 6, 64, False, 32, 16, 64, 128, 5),     # m7c geometry
    (130, 170, 3, 16, True, 8, 4, 16, 40, 4),       # at an offset with seq_start, odd h
    (200, 0, 2, 128, True, 16, 8, 16, 100, 4),      # D = 128: the wide tiles; seq_start
]


def _fold_operands(dtype, dev, S, t_start, h, D, docs, l, d, seed=5):
    """Q [2,S,2,h,D] at positions t_start.., window K/V and compressed K/V
    over every position, dO, the gate [2,S,2] in [0.05, 1) and, with docs,
    the rows' document starts (packed positions, multiples of 16)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, G, n_pos = 2, 2, t_start + S

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    S_cmp = num_cmp_blocks(n_pos, l, d)
    x = dict(Q=r(B, S, G, h, D), K=r(B, G, n_pos, D), V=r(B, G, n_pos, D), Kc=r(B, G, S_cmp, D),
             Vc=r(B, G, S_cmp, D), dO=r(B, S, G, h, D),
             g=torch.rand((B, S, G), generator=gen, device=dev) * 0.95 + 0.05)
    pos = torch.arange(t_start, n_pos, device=dev)
    x["ds"] = (torch.where(pos < 96, 0, torch.where(pos < 208, 96, 208)).to(torch.int32)
               .expand(B, S).contiguous() if docs else None)
    x["t"] = pos
    return x


def _gated_within(got, g, plain, rss_fn):
    """A gated forward's output within its bound: f32 _within_bound of the
    gated plain version `plain()`; bf16 _within_tc of the unrounded plain
    result and its rss (`rss_fn()`), each times the gate."""
    if got.dtype == torch.float32:
        return _within_bound(got, plain())
    want, rss = rss_fn()
    gg = g[..., None, None]
    return _within_tc(got, want * gg, want * gg, rss * gg)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,t_start,h,D,docs,l,d,l_sel,w,n_top", FOLD_CASES)
def test_gated_forwards_match_plain_on_gpu(dtype, S, t_start, h, D, docs, l, d, l_sel, w, n_top):
    """Rows 1, 2, 3 and 5 under the fold: O * g within the bounds of the
    gated plain versions, lse and the selection the ungated launch's bits,
    and in bf16 select_cmp's O the gated banded_attn's (cmp) bits."""
    dev = _card()
    x = _fold_operands(dtype, dev, S, t_start, h, D, docs, l, d)
    Q, g, ds, t = x["Q"], x["g"], x["ds"], x["t"]
    cmp = dict(mode="cmp", l=l, d=d, scale=SCALE, t_start=t_start, seq_start=ds)
    win = dict(mode="win", w=w, scale=SCALE, t_start=t_start, seq_start=ds)
    kernels.reset_launch_counts()
    M = build_M_csl_on(t_start + S, l, d, l_sel, dev)
    kw = dict(scale=SCALE, l=l, d=d, l_sel=l_sel, n_top=n_top, seq_start=ds, pos_offset=t_start)
    sel, O, lse = sc_mod.select_cmp(Q, x["Kc"], x["Vc"], M, **kw, gate=g, return_lse=True)
    usel, _, ulse = sc_mod.select_cmp(Q, x["Kc"], x["Vc"], M, **kw, return_lse=True)
    assert torch.equal(sel, usel) and torch.equal(lse, ulse)
    assert _gated_within(O, g, lambda: ba_mod.banded_attn_plain(Q, x["Kc"], x["Vc"], **cmp,
                                                                gate=g),
                         lambda: ba_mod.banded_attn_rss(Q, x["Kc"], x["Vc"], **cmp))
    Ob, lb = ba_mod.banded_attn(Q, x["Kc"], x["Vc"], **cmp, gate=g, return_lse=True)
    assert torch.equal(lb, ba_mod.banded_attn(Q, x["Kc"], x["Vc"], **cmp, return_lse=True)[1])
    if dtype == torch.bfloat16:   # pass 1 of the fused scorer is the banded forward's walk
        assert torch.equal(Ob, O) and torch.equal(lb, lse)
    else:
        assert _within_bound(Ob, ba_mod.banded_attn_plain(Q, x["Kc"], x["Vc"], **cmp, gate=g))
    Os = sa_mod.sel_attn(Q, x["K"], x["V"], sel, t, l_sel=l_sel, scale=SCALE, gate=g)
    assert _gated_within(Os, g, lambda: sa_mod.sel_attn_plain(Q, x["K"], x["V"], sel, t,
                                                              l_sel=l_sel, scale=SCALE, gate=g),
                         lambda: sa_mod.sel_attn_rss(Q, x["K"], x["V"], sel, t, l_sel=l_sel,
                                                     scale=SCALE))
    if t_start == 0:
        Ow = wa_mod.win_attn(Q, x["K"], x["V"], w=w, scale=SCALE, seq_start=ds, gate=g)
    else:
        Ow = ba_mod.banded_attn(Q, x["K"], x["V"], **win, gate=g)
    assert _gated_within(Ow, g, lambda: ba_mod.banded_attn_plain(Q, x["K"], x["V"], **win,
                                                                 gate=g),
                         lambda: ba_mod.banded_attn_rss(Q, x["K"], x["V"], **win))
    gated = kernels.gated_launch_counts()
    assert gated["select_cmp"] == 1 and gated["banded_attn"] == 1 + (t_start > 0)
    assert gated["sel_attn"] == 1 and gated["win_attn"] == (t_start == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,t_start,h,D,docs,l,d,l_sel,w,n_top", FOLD_CASES)
def test_gated_one_pass_backwards_equal_the_dense_gate_on_gpu(dtype, S, t_start, h, D, docs, l,
                                                             d, l_sel, w, n_top):
    """Rows 7 (win, cmp) and 9 given the gate: bit-equal to the ungated
    launch on (dO * g).to(dO.dtype), within the ungated bound of the plain
    version on it, and not equal to the launch with the gate dropped."""
    dev = _card()
    x = _fold_operands(dtype, dev, S, t_start, h, D, docs, l, d)
    Q, dO, g, ds, t = x["Q"], x["dO"], x["g"], x["ds"], x["t"]
    gdO = gate_dO(dO, g)
    M = build_M_csl_on(t_start + S, l, d, l_sel, dev)
    sel = sc_mod.select_cmp(Q, x["Kc"], x["Vc"], M, scale=SCALE, l=l, d=d, l_sel=l_sel,
                            n_top=n_top, seq_start=ds, pos_offset=t_start)[0]
    for mode, K, V, kw in (("win", x["K"], x["V"], dict(w=w)),
                           ("cmp", x["Kc"], x["Vc"], dict(l=l, d=d))):
        Y, lse = ba_mod.banded_attn(Q, K, V, mode=mode, **kw, scale=SCALE, t_start=t_start,
                                    seq_start=ds, gate=g, return_lse=True)
        args = (Q, K, V, dO, lse, attention_delta(dO, Y))
        both = dict(mode=mode, **kw, scale=SCALE, t_start=t_start, seq_start=ds)
        got = b1_mod.banded_bwd_1p(*args, **both, gate=g)
        dense = b1_mod.banded_bwd_1p(Q, K, V, gdO, *args[4:], **both)
        dropped = b1_mod.banded_bwd_1p(*args, **both)
        assert all(torch.equal(a, b) for a, b in zip(got, dense)), mode
        assert not all(torch.equal(a, b) for a, b in zip(got, dropped)), mode
        within = _band_within((Q, K, V, gdO, *args[4:]), SCALE, mode=mode, **kw,
                              t_start=t_start, seq_start=ds)
        plain = bb_mod.banded_bwd_plain(*args, **both, gate=g)
        assert all(within(a, b, i) for i, (a, b) in enumerate(zip(got, plain))), mode
    Y, lse = sa_mod.sel_attn(Q, x["K"], x["V"], sel, t, l_sel=l_sel, scale=SCALE, gate=g,
                             return_lse=True)
    args = (Q, x["K"], x["V"], sel, t, dO, lse, attention_delta(dO, Y))
    got = s1_mod.sel_attn_bwd_1p(*args, l_sel=l_sel, scale=SCALE, gate=g)
    dense = s1_mod.sel_attn_bwd_1p(*args[:5], gdO, *args[6:], l_sel=l_sel, scale=SCALE)
    dropped = s1_mod.sel_attn_bwd_1p(*args, l_sel=l_sel, scale=SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    assert not all(torch.equal(a, b) for a, b in zip(got, dropped))
    within = _sel_within((*args[:5], gdO, *args[6:]), l_sel, SCALE)
    plain = sb_mod.sel_attn_bwd_plain(*args, l_sel=l_sel, scale=SCALE, gate=g)
    assert all(within(a, b, i) for i, (a, b) in enumerate(zip(got, plain)))


@pytest.mark.gpu
@pytest.mark.parametrize("keys", [
    {"nsa.gate_fold": 1},
    {"nsa.gate_fold": 1, "nsa.flat_io": 1, "bwd.onepass": 0, "sel.bwd_onepass": 0,
     "win.bwd_diag": 0},
])
def test_layer_under_the_fold_matches_cpu(monkeypatch, keys):
    """One f32 layer's forward + backward under the fold on the card: the
    gated kernels launch (rows 1, 2, 3; rows 7 and 9 where the one-pass
    design runs), with the CPU's output and gradients, and no host sync."""
    dev = _card()
    monkeypatch.setattr(tuning, "_load", lambda: dict(tuning.DEFAULTS, **keys))
    cfg = NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16,
                    n_sel=4, w=32)
    params = init_nsa_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 150, 96, generator=torch.Generator().manual_seed(1))

    def layer(dv):
        with torch.no_grad():
            p = params_to(params, device=dv)
        return p, [t.requires_grad_(True) for t in [x.to(dv)] + [t for _, t in param_leaves(p)]]

    def grads(p, wrt):
        out = nsa_prefill(p, wrt[0], cfg)[0]
        return [out.detach()] + list(torch.autograd.grad((out * out).sum(), wrt))

    want = grads(*layer("cpu"))
    on_card = layer(dev)
    kernels.reset_launch_counts()
    got = grads(*on_card)
    gated = kernels.gated_launch_counts()
    onepass = tuning.backward_kernel("sel", 150) == "sel_attn_bwd_1p"
    assert gated == {"select_cmp": 1, "sel_attn": 1, "win_attn": 1, "banded_attn": 0,
                     "banded_bwd_1p": int(onepass) * (1 + (tuning.backward_kernel(
                         "win", 150, 32) == "banded_bwd_1p")),
                     "sel_attn_bwd_1p": int(onepass)}, gated
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= 1e-4 * float(b.abs().max())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------- multi-tensor AdamW

def _adamw_leaves(dtype, dev):
    """m7c-125M's 123 trainable leaves as the train step holds them, then
    leaves of 1, 3 and 4097 elements and one 4097-element leaf at an odd
    element offset (every pointer of it misaligned), as (params, mu, nu).
    dtype a list: the leaves' dtypes in turn (a launch group each)."""
    from nsa_vibe_tpu_torch.core.config import M7C_125M

    dtypes = dtype if isinstance(dtype, list) else [dtype]
    gen = torch.Generator().manual_seed(11)
    tree = init_model_params(M7C_125M, gen, device=dev, dtype=dtypes[0])
    params = [t for _, t in param_leaves(tree)]
    assert len(params) == 123
    params += [torch.randn(n, device=dev) for n in (1, 3, 4097)]
    params = [p.detach().to(dtypes[i % len(dtypes)]) for i, p in enumerate(params)]

    def odd(n):
        return torch.empty(n + 1, dtype=params[-1].dtype, device=dev)[1:]

    params.append(odd(4097).copy_(torch.randn(4097, device=dev)))
    mu = [(torch.randn_like(p, dtype=torch.float32) * 1e-3).to(p.dtype) for p in params]
    nu = [(torch.rand_like(p, dtype=torch.float32) * 1e-6).to(p.dtype) for p in params]
    mu[-1], nu[-1] = odd(4097).copy_(mu[-1]), odd(4097).copy_(nu[-1])
    return params, mu, nu


def _bits(t):
    return t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   [torch.bfloat16, torch.float32]],
                         ids=["bf16", "f32", "bf16 and f32"])
def test_adamw_mt_update_bit_equal_to_the_tensor_ops(dtype):
    """ops/cuda/adamw_mt.py's update over m7c-125M's leaves plus leaves of 1,
    3 and 4097 elements and a misaligned one (in bf16, in f32, and in both
    dtypes by turns: two launch groups): p, mu, nu and count bit for bit
    those of train/optim.py's tensor ops, given the same gradients, state and
    grad_norm, through a first step (lr 0), a clipped step at accum 2, an
    unclipped one, a skipped one (NaN loss: every bit kept) and one past
    warm-up."""
    from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
    from nsa_vibe_tpu_torch.train import optim

    dev = _card()
    tcfg = TrainConfig(lr=1e-3, warmup_steps=3, steps=10, max_grad_norm=1.0, weight_decay=0.1)
    params, mu, nu = _adamw_leaves(dtype, dev)
    groups = 1 if isinstance(dtype, torch.dtype) else len(dtype)
    fused = {"mu": mu, "nu": nu, "count": torch.zeros((), dtype=torch.int32, device=dev)}
    plain = {"mu": [t.clone() for t in mu], "nu": [t.clone() for t in nu],
             "count": fused["count"].clone()}
    params_plain = [t.clone() for t in params]
    gen = torch.Generator(device=dev).manual_seed(12)
    steps = [("first (lr 0)", 1e-3, 1.0, 1.0, True), ("clipped, accum 2", 1e-3, 0.5, 1.0, True),
             ("unclipped", 1e-6, 1.0, 1.0, False), ("skipped", 1e-3, 1.0, float("nan"), True),
             ("past warm-up", 1e-6, 1.0, 1.0, False)]
    count = 0
    for name, scale, inv, loss, clipped in steps:
        grads = [(torch.randn(p.shape, generator=gen, device=dev) * scale).to(p.dtype)
                 for p in params]
        grads[-1] = torch.empty(4098, dtype=grads[-1].dtype, device=dev)[1:].copy_(grads[-1])
        norm = optim.global_norm([g * inv for g in grads])
        good = torch.isfinite(torch.tensor(loss, device=dev)) & torch.isfinite(norm)
        assert bool(norm >= tcfg.max_grad_norm) == clipped, name
        n0 = adamw_mt.update_.launches
        optim.apply_update_(params, grads, fused, tcfg, norm, good, inv)
        assert adamw_mt.update_.launches == n0 + groups, name
        optim.apply_update_plain_(params_plain, grads, plain, tcfg, norm, good, inv)
        torch.cuda.synchronize()
        count += name != "skipped"
        assert int(fused["count"]) == int(plain["count"]) == count, name
        for a, b in zip(params + fused["mu"] + fused["nu"],
                        params_plain + plain["mu"] + plain["nu"]):
            assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   [torch.bfloat16, torch.float32]],
                         ids=["bf16", "f32", "bf16 and f32"])
def test_adamw_mt_norm_is_global_norm_and_repeats_its_bits(dtype):
    """The kernels' norm of g * inv_accum within 2e-6 of global_norm's (a sum
    in another order), the same bits on a second call, and good =
    isfinite(loss) & isfinite(norm); a non-contiguous gradient is read as
    its contiguous copy."""
    from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
    from nsa_vibe_tpu_torch.train import optim

    dev = _card()
    params, mu, nu = _adamw_leaves(dtype, dev)
    groups = 1 if isinstance(dtype, torch.dtype) else len(dtype)
    state = {"mu": mu, "nu": nu, "count": torch.zeros((), dtype=torch.int32, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(13)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype) for p in params]
    loss = torch.tensor(2.5, device=dev)
    for inv in (1.0, 1 / 3):
        want = optim.global_norm([g * inv for g in grads])
        n0 = adamw_mt.norm_and_good.launches
        norm, good = optim.norm_and_good(params, grads, state, loss, inv)
        assert adamw_mt.norm_and_good.launches == n0 + groups + 1
        again, _ = optim.norm_and_good(params, grads, state, loss, inv)
        assert abs(float(norm) - float(want)) <= 2e-6 * float(want)
        assert torch.equal(_bits(norm), _bits(again)) and bool(good)
    w = grads[0]                                       # the embedding [vocab, dim], transposed
    grads[0] = w.t().contiguous().t()
    assert not grads[0].is_contiguous()
    assert torch.equal(_bits(optim.norm_and_good(params, grads, state, loss, inv)[0]),
                       _bits(norm))
    grads[0] = w
    assert not bool(optim.norm_and_good(params, grads, state,
                                        torch.tensor(float("nan"), device=dev))[1])
    grads[5].view(-1)[7] = float("inf")
    assert not bool(optim.norm_and_good(params, grads, state, loss)[1])


@pytest.mark.gpu
def test_adamw_mt_raises_on_leaves_it_cannot_take_and_issues_no_host_sync():
    """On the card the optimizer runs the kernels or raises: a
    non-contiguous parameter, an f16 leaf, a gradient of another dtype each
    raise ValueError with nothing launched; the train step's counter reads
    every leaf as fused, and its optimizer issues no host sync."""
    from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
    from nsa_vibe_tpu_torch.train import optim
    from nsa_vibe_tpu_torch.utils import trace

    dev = _card()
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, steps=10)
    loss = torch.tensor(1.0, device=dev)
    for params in ([torch.randn(64, 32, device=dev).t(), torch.randn(100, device=dev)],
                   [torch.randn(64, 32, device=dev), torch.randn(100, device=dev).half()]):
        grads = [torch.randn_like(p) for p in params]
        state = optim.init_optimizer(params)
        n0 = adamw_mt.norm_and_good.launches, adamw_mt.update_.launches
        with pytest.raises(ValueError):
            optim.norm_and_good(params, grads, state, loss)
        with pytest.raises(ValueError):
            optim.apply_update_(params, grads, state, tcfg, loss, torch.tensor(True, device=dev))
        assert (adamw_mt.norm_and_good.launches, adamw_mt.update_.launches) == n0
        assert int(state["count"]) == 0
    params = [torch.randn(64, 32, device=dev), torch.randn(100, device=dev)]
    state = optim.init_optimizer(params)
    with pytest.raises(ValueError):
        optim.norm_and_good(params, [torch.randn_like(params[0]).bfloat16(),
                                     torch.randn_like(params[1])], state, loss)
    mcfg = ModelConfig(vocab_size=64, n_layers=2,
                       nsa=NSAConfig(dim=96, n_heads=6, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    st = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                            device=dev), tcfg)
    n = len(param_leaves(st.params))
    step = make_train_step(mcfg, tcfg)
    toks = torch.randint(0, 64, (1, 2, 131), device=dev)
    st, m = step(st, toks)                            # builds the kernels and the plan
    leaves = [t for _, t in param_leaves(st.params)]
    loss, grads = m["loss"], [torch.randn_like(t) for t in leaves]
    trace.reset()
    trace.enable()
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            norm, good = optim.norm_and_good(leaves, grads, st.opt_state, loss)
            optim.apply_update_(leaves, grads, st.opt_state, tcfg, norm, good)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert trace.counters() == {"optimizer.fused_leaves": n}
    finally:
        trace.disable()
        trace.reset()
