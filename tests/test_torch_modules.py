"""The port's nn.Module wrappers (models/nn_module.py) against the
functional calls and the JAX package's Linen modules (after
tests/test_flax_module.py).

The modules must be bit-equal to nsa_prefill / block_prefill on the same
parameters, forward and gradients (through module.parameters()), and
within 2e-5 (f32, absolute) of the Linen modules given the same
parameters; their gradients within 5e-5 of each leaf's largest |value| of
jax.grad's, as tests/test_torch_train.py holds the functional ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.core.nsa import init_nsa_params as jinit_nsa_params
from nsa_vibe_tpu.models.flax_module import LlamaBlockNSA as JLlamaBlockNSA
from nsa_vibe_tpu.models.flax_module import NSAAttention as JNSAAttention
from nsa_vibe_tpu.models.llama_block import init_block_params as jinit_block_params
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.models.llama_block import block_prefill, init_block_params
from nsa_vibe_tpu_torch.models.nn_module import LlamaBlockNSA, NSAAttention
from nsa_vibe_tpu_torch.train.train_step import param_leaves, tree_from_leaves

KW = dict(dim=64, n_heads=4, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4, w=16)
CFG, JCFG = NSAConfig(**KW), JNSAConfig(**KW, kernel="reference")
MCFG = ModelConfig(vocab_size=256, n_layers=1, nsa=CFG)
JMCFG = JModelConfig(vocab_size=256, n_layers=1, nsa=JCFG)
OUT_TOL, GRAD_REL = 2e-5, 5e-5


def _x(B=2, S=48, seed=1):
    return np.random.RandomState(seed).randn(B, S, CFG.dim).astype(np.float32)


def _loss(y):
    return y.float().square().mean()


def _functional_grads(params, fn):
    leaves = [t.detach().requires_grad_(True) for _, t in param_leaves(params)]
    p = tree_from_leaves(params, leaves)
    y = fn(p)
    return y, torch.autograd.grad(_loss(y), leaves)


CASES = {
    "attention": (NSAAttention, CFG, lambda k: jinit_nsa_params(k, JCFG), JNSAAttention(cfg=JCFG),
                  "nsa", lambda p, x: nsa_prefill(p, x, CFG)[0]),
    "block": (LlamaBlockNSA, MCFG, lambda k: jinit_block_params(k, JMCFG),
              JLlamaBlockNSA(mcfg=JMCFG), "block", lambda p, x: block_prefill(p, x, MCFG)[0]),
}


@pytest.mark.parametrize("name", CASES)
def test_module_equals_functional_call_and_linen(name):
    cls, cfg, jinit, jmod, jkey, functional = CASES[name]
    jp = jinit(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    mod = cls(cfg, params, device="cpu")
    x = _x()
    y = mod(torch.from_numpy(x))
    _loss(y).backward()

    want, grads = _functional_grads(params, lambda p: functional(p, torch.from_numpy(x)))
    assert torch.equal(y, want)
    names = [k.strip("/").replace("/", ".") for k, _ in param_leaves(params)]
    assert sorted(n for n, _ in mod.tree.named_parameters()) == sorted(names)
    assert len(list(mod.parameters())) == len(grads)
    for n, g in zip(names, grads):
        assert torch.equal(mod.tree.get_parameter(n).grad, g), n

    def jloss(v):
        return jnp.mean(jmod.apply(v, jnp.asarray(x)).astype(jnp.float32) ** 2)

    variables = {"params": {jkey: jp}}
    jy = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=OUT_TOL, rtol=0)
    jg = jax.jit(jax.grad(jloss))(variables)["params"][jkey]
    got = params_to_numpy(tree_from_leaves(params, list(grads)))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=GRAD_REL * max(np.abs(b).max(), 1e-12), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_parameters_from_a_generator_are_the_functional_init():
    att = NSAAttention(CFG, generator=torch.Generator().manual_seed(3), device="cpu")
    want = init_nsa_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    for k, t in param_leaves(want):
        assert torch.equal(att.tree.get_parameter(k.strip("/").replace("/", ".")), t), k
    blk = LlamaBlockNSA(MCFG, generator=torch.Generator().manual_seed(4), device="cpu",
                        dtype=torch.bfloat16)
    want = init_block_params(torch.Generator().manual_seed(4), MCFG, torch.bfloat16, "cpu")
    got = blk.params()
    for (k, a), (_, b) in zip(param_leaves(got), param_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k
    assert got["attn"]["W_Q"].data_ptr() == got["attn"]["W_qkv"].data_ptr()   # views
    with pytest.raises(ValueError, match="Generator"):
        NSAAttention(CFG, device="cpu")


def test_modules_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NSAAttention(CFG, generator=torch.Generator().manual_seed(0))


def test_attention_at_an_offset_equals_the_whole_sequence():
    mod = NSAAttention(CFG, generator=torch.Generator().manual_seed(5), device="cpu")
    x = torch.from_numpy(_x(B=1, S=64, seed=2))
    whole = mod(x)
    _, aux = nsa_prefill(mod.params(), x[:, :32], CFG)
    first = iter([aux[k] for k in ("K_sel", "V_sel", "K_win", "V_win", "K_cmp_raw",
                                   "V_cmp_raw")])
    second = mod(x[:, 32:], t0=32, gather_kv=lambda a: torch.cat([next(first), a], dim=2))
    torch.testing.assert_close(second, whole[:, 32:], atol=OUT_TOL, rtol=0)


def test_block_trains_with_torch_optim():
    torch.manual_seed(0)
    blk = LlamaBlockNSA(MCFG, generator=torch.Generator().manual_seed(6), device="cpu")
    opt = torch.optim.AdamW(blk.parameters(), lr=3e-3)
    x = torch.from_numpy(_x(B=1, S=32, seed=7))
    target = torch.from_numpy(_x(B=1, S=32, seed=8)) * 0.1
    losses = []
    for _ in range(6):
        opt.zero_grad()
        loss = (blk(x) - target).square().mean()
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in blk.parameters())
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] and np.all(np.isfinite(losses))
    p = blk.params()["attn"]   # the trained W_qkv's views
    assert torch.equal(p["W_Q"], blk.tree.attn.W_qkv[:, :p["W_Q"].shape[1]])
