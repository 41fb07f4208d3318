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
scores are well separated at these sizes.
"""

import pytest
import torch

from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.convert import params_to
from nsa_vibe_tpu_torch.models.tinylm import (
    generate, init_model_params, model_decode_step, model_prefill_with_caches,
)
from nsa_vibe_tpu_torch.ops import cuda as kernels
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import sel_attn as sa_mod
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda import win_attn as wa_mod
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,h,D,l,d,l_sel,n_top,w", [
    (2, 300, 2, 6, 64, 32, 16, 64, 5, 128),     # m7c geometry, short
    (1, 130, 1, 3, 16, 8, 4, 16, 4, 40),        # odd h, S not divisible by l_sel
    (1, 70, 3, 1, 32, 16, 8, 16, 8, 512),       # h = 1, window wider than S
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
    assert _within_bound(O, pO)

    K, V = r(B, G, S, D), r(B, G, S, D)
    t = torch.arange(S, device=dev)
    for s in (sel, canonicalize_sel(sel)):      # forced-first repeats == the set
        assert _within_bound(sa_mod.sel_attn(Q, K, V, s, t, l_sel=l_sel, scale=SCALE),
                             sa_mod.sel_attn_plain(Q, K, V, sel, t, l_sel=l_sel, scale=SCALE))
    assert _within_bound(wa_mod.win_attn(Q, K, V, w=w, scale=SCALE),
                         wa_mod.win_attn_plain(Q, K, V, w=w, scale=SCALE))
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
    assert kernels.launch_counts() == {"select_cmp": 2, "sel_attn": 2 + 2 * 5, "win_attn": 2}


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
