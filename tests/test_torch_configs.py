"""Each training configuration of configs/*.yaml through the port against
the JAX package, on the CPU.

Every file loads through the port's train/trainer.py::load_config to the
fields the JAX load_config gives (apart from `prefill_chunk`,
`varlen_exact` and `kernel`, which the port does not have). Then a model
cut from the configuration runs in f32 on both sides from the same numpy
parameters (convert.params_from_numpy; JAX with kernel="reference" and
its own prefill_chunk, scaled with S):

  * one train step (accumulation included): the port's loss within 1e-5
    relative of JAX's, and the first gradient (the mean over the
    micro-batches) within 2e-5 of each leaf's max |value|;
  * the prefill logits (model_prefill_with_caches) within 1e-4 of their
    max |value| of JAX's model_forward logits;
  * the selection sets of every layer equal after sorting and dropping
    duplicates;
  * 4 greedy decode tokens equal: each token of the port's `generate`
    is the argmax of JAX's logits after the prompt and the tokens before
    it (one JAX forward, so that JAX compiles one function a
    configuration).

Kept from each configuration: n_heads and n_kv_groups (so h), the remat
mode, rope_scale, phi, l, d, l_sel and accum_steps (cut to ACCUM_MAX).
Cut (CUTS): d_k = d_v = 16, dim 64, 2 layers, vocab 64, batch 1, and w,
n_sel and S together, so that S > w and S / l_sel > n_sel (every branch
drops something: the window past w, the selection past n_sel of S / l_sel
blocks); the dtype is f32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.train.trainer import load_config as jload_config
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core.config import ModelConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.train.trainer import load_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))
JAX_ONLY = ("prefill_chunk", "varlen_exact", "kernel")   # NSAConfig fields the port lacks
ACCUM_MAX = 2
CUTS = dict(dim=64, d_k=16, d_v=16, n_layers=2, vocab_size=64, batch_size=1,
            S=320, w=128, n_sel=4)   # S / l_sel = 5 blocks at l_sel 64, 4 selected, S > w
N_NEW = 4


def test_every_config_is_covered():
    assert len(CONFIGS) == 7, CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_and_trains_as_jax(name):
    path = str(ROOT / "configs" / name)
    tm, tt, tdata = load_config(path)
    jm, jt, jdata = jload_config(path)
    assert tdata == jdata
    jn = dataclasses.asdict(jm.nsa)
    assert dataclasses.asdict(tm.nsa) == {k: v for k, v in jn.items() if k not in JAX_ONLY}
    assert {k: v for k, v in dataclasses.asdict(tm).items() if k != "nsa"} == \
        {k: v for k, v in dataclasses.asdict(jm).items() if k != "nsa"}
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)

    # the cut model: heads, groups, remat, rope_scale, phi, l, d, l_sel kept
    S, B = CUTS["S"], CUTS["batch_size"]
    accum = min(jt.accum_steps, ACCUM_MAX)
    nsa_cut = dict(dim=CUTS["dim"], d_k=CUTS["d_k"], d_v=CUTS["d_v"], w=CUTS["w"],
                   n_sel=CUTS["n_sel"])
    assert S > nsa_cut["w"] and S // jm.nsa.l_sel > nsa_cut["n_sel"]
    chunk = jm.nsa.prefill_chunk * S // jt.seq_len        # the same share of S
    assert chunk == 0 or S % chunk == 0
    jc = dataclasses.replace(jm, n_layers=CUTS["n_layers"], vocab_size=CUTS["vocab_size"],
                             dtype="float32",
                             nsa=jm.nsa.replace(**nsa_cut, kernel="reference",
                                                prefill_chunk=chunk))
    tc = dataclasses.replace(tm, n_layers=CUTS["n_layers"], vocab_size=CUTS["vocab_size"],
                             dtype="float32", nsa=dataclasses.replace(tm.nsa, **nsa_cut))
    assert isinstance(jc, JModelConfig) and isinstance(tc, ModelConfig)
    ttc = dataclasses.replace(tt, batch_size=B, seq_len=S, accum_steps=accum)

    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(11).randint(0, tc.vocab_size,
                                             size=(accum, B, S + 1)).astype(np.int32)

    # the port: one train step (accumulation included) for the loss; the
    # gradient of the same batch, summed and scaled as the step does; micro-
    # batch 0's selection sets; prefill logits and greedy tokens from the
    # step's initial parameters
    state = tts.init_train_state(tp, ttc)
    grads, aux = None, None
    for a in range(accum):
        _, g, auxes = tts.loss_and_grads(state.params, torch.from_numpy(toks[a]).long(), tc,
                                         collect=a == 0)
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
        aux = aux or auxes
    grads = [g / accum for g in grads]
    tgrads = params_to_numpy(tts.tree_from_leaves(state.params, grads))
    tp0 = params_from_numpy(params_to_numpy(state.params), device="cpu")
    _, met = tts.make_train_step(tc, ttc)(state, torch.from_numpy(toks).long())
    assert bool(met["good"])
    prompt = torch.from_numpy(toks[0, :, :-1]).long()
    with torch.no_grad():
        tlogits, _ = ttiny.model_prefill_with_caches(tp0, prompt, tc, S + N_NEW)
    tgen = ttiny.generate(tp0, prompt, N_NEW, tc)

    # JAX, one compile: the loss and gradient of the whole batch (the mean
    # over micro-batches of equal size is the mean over all rows) with
    # micro-batch 0's logits and sets (its rows), and the logits of the
    # prompt followed by the port's greedy tokens, whose argmax each new
    # token must be
    def jfn(p, t, ext):
        def loss(p):
            logits, auxes = jtiny.model_forward(p, t[:, :-1], jc, collect_aux=True)
            return jtiny.cross_entropy_loss(logits, t[:, 1:]), (logits[:B],
                                                                [x["sel_idx"][:B] for x in auxes])

        (l, (logits, sels)), g = jax.value_and_grad(loss, has_aux=True)(p)
        return l, g, logits, sels, jtiny.model_forward(p, ext, jc)[0]

    ext = tgen[:, :-1].numpy().astype(np.int32)              # prompt + the first N_NEW - 1
    jl, jg, jlogits, jsel, jext = jax.jit(jfn)(jp, jnp.asarray(toks.reshape(accum * B, S + 1)),
                                               jnp.asarray(ext))

    assert abs(float(met["loss"]) - float(jl)) <= 1e-5 * abs(float(jl))
    flat_t = jax.tree_util.tree_leaves_with_path(tgrads)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j)
    for k, got in flat_t:
        want = np.asarray(flat_j[k])
        np.testing.assert_allclose(got, want, atol=2e-5 * max(np.abs(want).max(), 1e-12),
                                   rtol=0, err_msg=jax.tree_util.keystr(k))
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, atol=1e-4 * np.abs(jlogits).max(),
                               rtol=0)
    assert len(aux) == len(jsel) == tc.n_layers
    for layer, (a, js) in enumerate(zip(aux, jsel)):
        assert torch.equal(canonicalize_sel(a["sel_idx"]),
                           canonicalize_sel(torch.from_numpy(np.array(js)))), layer
    # greedy decode: each of the port's N_NEW tokens is JAX's argmax after its prefix
    np.testing.assert_array_equal(tgen[:, :S].numpy(), toks[0, :, :-1])
    np.testing.assert_array_equal(tgen[:, S:].numpy(),
                                  np.asarray(jext)[:, S - 1:].argmax(-1))
