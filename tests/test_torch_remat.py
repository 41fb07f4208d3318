"""models/remat.py: the port's block remat, held to the unrematerialised
port bit for bit, to torch.utils.checkpoint (the mechanism it replaces)
bit for bit, and to the JAX package's jax.checkpoint'd model (within
5e-5 of each gradient's largest entry, as test_torch_train); and a remat
step in a fresh process imports no torch._dynamo."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.models import remat as tremat
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.train import train_step as tts

ROOT = Path(__file__).resolve().parents[1]
NSA = dict(dim=64, n_heads=4, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=8, n_sel=2, w=16)


def _setup(remat, dtype="float32"):
    jm = JModelConfig(vocab_size=64, n_layers=2, remat=bool(remat),
                      nsa=JNSAConfig(**NSA, kernel="reference"))
    jp = jtiny.init_model_params(jax.random.PRNGKey(3), jm)
    tm = ModelConfig(vocab_size=64, n_layers=2, remat=remat, dtype=dtype, nsa=NSAConfig(**NSA))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if dtype != "float32":
        tp = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, 64, size=(2, 33))).long()
    return jm, jp, tm, tp, toks


def _loss_and_grads(tp, toks, tm, seq_start=None):
    leaves = [t.detach().requires_grad_(True) for _, t in tts.param_leaves(tp)]
    logits, _ = ttiny.model_forward(tts.tree_from_leaves(tp, leaves), toks[:, :-1], tm,
                                    seq_start=seq_start)
    loss = ttiny.cross_entropy_loss(logits, toks[:, 1:])
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat, dtype, varlen", [(True, "float32", False),
                                                   (True, "bfloat16", True),
                                                   ("mlp", "float32", True),
                                                   ("mlp", "bfloat16", False)])
def test_remat_is_the_unrematerialised_step_bit_for_bit(remat, dtype, varlen):
    _, _, tm, tp, toks = _setup(remat, dtype)
    seq_start = None
    if varlen:   # two documents a row, the second from position 13
        pos = torch.arange(32)
        seq_start = torch.where(pos < 13, 0, 13).expand(2, 32).to(torch.int32)
    loss, grads = _loss_and_grads(tp, toks, tm, seq_start)
    want_loss, want = _loss_and_grads(tp, toks, dataclasses.replace(tm, remat=False), seq_start)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_remat_is_torch_utils_checkpoint_bit_for_bit(monkeypatch):
    from torch.utils.checkpoint import checkpoint
    _, _, tm, tp, toks = _setup(True)
    loss, grads = _loss_and_grads(tp, toks, tm)
    monkeypatch.setattr(ttiny, "remat",
                        lambda fn, *args: checkpoint(fn, *args, use_reentrant=False))
    want_loss, want = _loss_and_grads(tp, toks, tm)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_remat_loss_and_grads_match_jax_checkpoint():
    jm, jp, tm, tp, toks = _setup(True)
    t = toks.numpy().astype(np.int32)

    def jloss(p):
        logits, _ = jtiny.model_forward(p, t[:, :-1], jm)
        return jtiny.cross_entropy_loss(logits, t[:, 1:])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, grads = _loss_and_grads(tp, toks, tm)
    assert abs(float(loss) - float(jl)) <= 1e-5
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_numpy(tts.tree_from_leaves(tp, list(grads)))))
    want = jax.tree_util.tree_leaves_with_path(jg)
    assert len(got) == len(want)
    for k, v in want:
        v = np.asarray(v)
        np.testing.assert_allclose(got[k], v, atol=5e-5 * max(np.abs(v).max(), 1e-12),
                                   rtol=0, err_msg=jax.tree_util.keystr(k))


def test_remat_outputs_without_gradient():
    """An integer output and an output the loss does not reach: no
    gradient through either; the inputs' gradients are fn's."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(5, 3, generator=gen, requires_grad=True)
    w = {"m": torch.randn(3, 3, generator=gen, requires_grad=True), "k": 2}

    def fn(x, p):
        y = torch.tanh(x @ p["m"]) * p["k"]
        return y, {"idx": y.argmax(-1), "unused": [y.exp()]}

    y, aux = tremat.remat(fn, a, w)
    assert aux["idx"].dtype == torch.int64 and not aux["idx"].requires_grad
    got = torch.autograd.grad(y.square().sum(), [a, w["m"]])
    y2, _ = fn(a, w)
    want = torch.autograd.grad(y2.square().sum(), [a, w["m"]])
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert torch.equal(y, y2) and torch.equal(aux["idx"], y2.argmax(-1))


def test_remat_step_imports_no_dynamo(tmp_path):
    """torch.utils.checkpoint imports torch._dynamo at its first call (seconds
    of a fresh process's first step); the port's remat does not."""
    code = (
        "import sys, torch\n"
        "from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig\n"
        "from nsa_vibe_tpu_torch.models.tinylm import init_model_params\n"
        "from nsa_vibe_tpu_torch.train import train_step as tts\n"
        f"nsa = NSAConfig(**{json.dumps(NSA)})\n"
        "m = ModelConfig(vocab_size=64, n_layers=2, remat=True, nsa=nsa)\n"
        "p = init_model_params(m, torch.Generator().manual_seed(0), device='cpu')\n"
        "for _, t in tts.param_leaves(p):\n"
        "    t.requires_grad_(True)\n"
        "toks = torch.randint(0, 64, (1, 33), generator=torch.Generator().manual_seed(1))\n"
        "loss, grads, _ = tts.loss_and_grads(p, toks, m)\n"
        "assert all(torch.isfinite(g).all() for g in grads)\n"
        "print('dynamo' if 'torch._dynamo' in sys.modules else 'none')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.strip().splitlines()[-1] == "none"
