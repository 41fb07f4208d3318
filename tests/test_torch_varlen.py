"""The port's varlen (packed-document) slice vs the JAX package (CPU, f32).

Inputs are numpy arrays from a seed; JAX parameters come in through
`convert.params_from_numpy`. Documents are packed by both packages'
`pack_documents_aligned` (l_sel-aligned starts) from lengths that include
one shorter than l (no visible compressed token), one of exactly l_sel,
one longer than w and one that fills most of a row, so q tiles straddle
document starts. The plain versions of the kernels that take seq_start
(rows 1, 3, 5, 6, 7, 8 and 11 of PERF.md's table) are held against the
Pallas kernels they replace, run with seq_start in interpret mode as the
JAX package's own tests run them (scale_on_q off, as the port's other
tests run them), and each must fail the same check without seq_start.

Tolerances: forward outputs and lse 1e-5 absolute; gradients 2e-5 of each
tensor's max |value|; selection sets exactly equal; the three train steps
as tests/test_torch_train.py holds them; packed documents against each
document alone 3e-5 (f32 sum order over different shapes); cross-document
influence exactly 0.0.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core import nsa as jnsa
from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.core.config import TrainConfig as JTrainConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops import varlen as jvarlen
from nsa_vibe_tpu.ops.pallas import flash_bwd as jflash_bwd
from nsa_vibe_tpu.ops.pallas import scorer as jscorer
from nsa_vibe_tpu.ops.pallas.flash import flash_banded, stats_rows
from nsa_vibe_tpu.ops.pallas.flash_diag import flash_banded_bwd_diag, flash_banded_diag
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu.train import data as jdata
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models import tinylm as ttiny
from nsa_vibe_tpu_torch.ops import varlen as tvarlen
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import banded_bwd_1p
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn_plain
from nsa_vibe_tpu_torch.ops.cuda.select_blocks import select_blocks, selection_map
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import select_cmp
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn
from nsa_vibe_tpu_torch.ops.cuda.win_bwd_diag import win_bwd_diag
from nsa_vibe_tpu_torch.ops.reference import attention_delta
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.train import data as tdata
from nsa_vibe_tpu_torch.train import train_step as tts
from nsa_vibe_tpu_torch.train import trainer as ttrainer

# test_varlen.py's geometry: l=8, d=4, l_sel=16, n_sel=4, w=24
BASE = dict(dim=64, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
            w=24)
S = 128
# per packed row: a document shorter than l, one of exactly l_sel, one
# longer than w, and one that fills most of a row
DOC_LENS = ((5, 16, 40, 30), (100, 20))
LOG2E = np.float32(1.4426950408889634)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(t, j, rel, msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t), j,
                               atol=rel * max(np.abs(j).max(), 1e-12), rtol=0, err_msg=msg)


def _docs(seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.randint(1, 64, size=n).astype(np.int32) for n in row] for row in DOC_LENS]


def _seq_start():
    """[B, S] int32 document starts of DOC_LENS packed one row each."""
    rows = [jvarlen.pack_documents_aligned(docs, S, BASE["l_sel"], 1)[1][0]
            for docs in _docs()]
    return np.stack(rows).astype(np.int32)


# ---------------------------------------------------------------- data


def test_packing_batches_and_collate_equal_jax():
    rng = np.random.RandomState(1)
    docs = [rng.randint(0, 256, size=n).astype(np.int32)
            for n in (1, 5, 16, 40, 300, 129, 7, 64, 2, 90)]
    for seq_len, align, bsz in ((128, 16, 2), (64, 8, 3), (256, 64, 1)):
        got = tvarlen.pack_documents_aligned(docs, seq_len, align, bsz)
        want = jvarlen.pack_documents_aligned(docs, seq_len, align, bsz)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        toks, ds, lm = got
        assert (ds % align == 0).all() and (np.diff(ds, axis=1) >= 0).all()
        assert (ds <= np.arange(seq_len)).all()
    with pytest.raises(ValueError):
        tvarlen.pack_documents_aligned([np.zeros(1, np.int32)], 16, 8, 1)
    tb = tvarlen.make_varlen_batches("synthetic", 96, 2, align=16, seed=3)
    jb = jvarlen.make_varlen_batches("synthetic", 96, 2, align=16, seed=3)
    for _ in range(4):
        for a, b in zip(next(tb), next(jb)):
            assert np.array_equal(a, b)
    got, want = tdata.collate_varlen(docs[:4], 32), jdata.collate_varlen(docs[:4], 32)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k


def test_masks_and_doc_local_topn_equal_jax():
    ds = _seq_start()
    B, cfg = ds.shape[0], BASE
    t = np.arange(S)
    S_cmp = num_cmp_blocks(S, cfg["l"], cfg["d"])
    S_sel = S // cfg["l_sel"]
    assert np.array_equal(tvarlen.win_mask_varlen(_t(t), _t(ds), S, cfg["w"]).numpy(),
                          np.asarray(jvarlen.win_mask_varlen(t, ds, S, cfg["w"])))
    assert np.array_equal(
        tvarlen.cmp_mask_varlen(_t(t), _t(ds), S_cmp, cfg["l"], cfg["d"]).numpy(),
        np.asarray(jvarlen.cmp_mask_varlen(t, ds, S_cmp, cfg["l"], cfg["d"])))
    # scores with exact ties (a coarse grid) and rows of all zeros
    rng = np.random.RandomState(2)
    p = (rng.randint(0, 4, size=(B, S, 2, S_sel)) / 4.0).astype(np.float32)
    p[:, :7] = 0.0
    for n_top, fi, fl in ((4, True, 2), (6, False, 1), (2, True, 2)):
        got = tvarlen.select_topn_blocks_varlen(_t(p), n_top, _t(t), _t(ds), cfg["l_sel"],
                                                fi, fl)
        want = jvarlen.select_topn_blocks_varlen(jnp.asarray(p), n_top, t, ds, cfg["l_sel"],
                                                 fi, fl)
        assert np.array_equal(got.numpy(), np.asarray(want))
        first = (ds // cfg["l_sel"])[:, :, None, None]
        live = got.numpy()
        assert ((live < 0) | ((live >= first) & (live * cfg["l_sel"] <= t[None, :, None, None]))
                ).all()
    sel = tvarlen.topn_forced_first_varlen(_t(p), 4, _t(t), _t(ds), cfg["l_sel"])
    assert np.array_equal(
        tvarlen.sel_token_mask_varlen(sel, _t(t), _t(ds), cfg["l_sel"], S).numpy(),
        np.asarray(jvarlen.sel_token_mask_varlen(jnp.asarray(sel.numpy()), t, ds,
                                                 cfg["l_sel"], S)))


def test_plain_varlen_branches_equal_jax_and_the_selection_needs_no_seq_start():
    """The three *_varlen oracles against JAX's (f32, 1e-5); on doc-local
    sets the selection's plain version without seq_start (what its kernels
    run) equals the varlen oracle, as the JAX package's selection kernels
    take no seq_start."""
    ds = _seq_start()
    B, G, h, D = ds.shape[0], 2, 3, 16
    c = BASE
    S_cmp = num_cmp_blocks(S, c["l"], c["d"])
    Q, K, V, Kc, Vc = (_rand(*shp, seed=40 + i) for i, shp in enumerate(
        ((B, S, G, h, D), (B, G, S, D), (B, G, S, D), (B, G, S_cmp, D), (B, G, S_cmp, D))))
    t, scale = np.arange(S), D ** -0.5
    p = np.abs(_rand(B, S, G, S // c["l_sel"], seed=45))
    sel = tvarlen.topn_forced_first_varlen(_t(p), c["n_sel"], _t(t), _t(ds), c["l_sel"])
    pairs = [
        (tvarlen.sliding_window_attention_varlen(*map(_t, (Q, K, V, t, ds)), c["w"], scale),
         jvarlen.sliding_window_attention_varlen(*map(jnp.asarray, (Q, K, V, t, ds)), c["w"],
                                                 scale)),
        (tvarlen.compressed_attention_varlen(*map(_t, (Q, Kc, Vc, t, ds)), c["l"], c["d"], scale),
         jvarlen.compressed_attention_varlen(*map(jnp.asarray, (Q, Kc, Vc, t, ds)), c["l"],
                                             c["d"], scale)),
        (tvarlen.selection_attention_varlen(_t(Q), _t(K), _t(V), sel, _t(t), _t(ds), c["l_sel"],
                                            scale),
         jvarlen.selection_attention_varlen(*map(jnp.asarray, (Q, K, V, sel.numpy(), t, ds)),
                                            c["l_sel"], scale)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    plain = sel_attn_plain(_t(Q), _t(K), _t(V), sel, _t(t), l_sel=c["l_sel"], scale=scale)
    np.testing.assert_array_equal(plain.numpy(), pairs[2][0].numpy())


# ---------------------------------------------------------------- kernels' plain versions


def _flat(x, fill):
    """[B,S,G,h] -> the TPU kernels' [B*G, 1, stats_rows(S, h)] row statistics."""
    B, S_, G, h = x.shape
    flat = np.asarray(x, np.float32).transpose(0, 2, 1, 3).reshape(B * G, 1, S_ * h)
    return jnp.pad(jnp.asarray(flat), ((0, 0), (0, 0), (0, stats_rows(S_, h) - S_ * h)),
                   constant_values=fill)


def _unflat(x, B, G, h):
    x = np.asarray(x)[:, 0, :S * h]
    return x.reshape(B, G, S, h).transpose(0, 2, 1, 3)


def _band_operands(mode, seed):
    ds = _seq_start()
    B, G, h, D = ds.shape[0], 2, 3, 16
    S_kv = S if mode == "win" else num_cmp_blocks(S, BASE["l"], BASE["d"])
    Q, K, V, dO = (_rand(*s, seed=seed + i) for i, s in enumerate(
        ((B, S, G, h, D), (B, G, S_kv, D), (B, G, S_kv, D), (B, S, G, h, D))))
    kw = dict(w=BASE["w"]) if mode == "win" else dict(l=BASE["l"], d=BASE["d"])
    return ds, (Q, K, V, dO), kw, D ** -0.5


@pytest.mark.parametrize("row,mode", [("3", "win"), ("5", "win"), ("5", "cmp")])
def test_banded_forward_plain_matches_the_tpu_kernel_with_seq_start(row, mode):
    """Rows 3 (flash_banded_diag) and 5 (flash_banded, both modes)."""
    ds, (Q, K, V, _), kw, scale = _band_operands(mode, seed=10)
    B, _, G, h, _ = Q.shape
    if row == "3":
        jO, jl = flash_banded_diag(*map(jnp.asarray, (Q, K, V)), w=kw["w"], scale=scale,
                                   block_q=32, interpret=True, return_lse=True,
                                   seq_start=jnp.asarray(ds), scale_on_q=False)
        port = win_attn
    else:
        jO, jl = flash_banded(*map(jnp.asarray, (Q, K, V)), mode=mode, **kw, scale=scale,
                              block_q=32, block_k=32, interpret=True, return_lse=True,
                              seq_start=jnp.asarray(ds), scale_on_q=False)
        port = banded_attn
    pkw = kw if row == "3" else dict(mode=mode, **kw)
    O, lse = port(*map(_t, (Q, K, V)), **pkw, scale=scale, return_lse=True, seq_start=_t(ds))
    np.testing.assert_allclose(O.numpy(), np.asarray(jO), atol=1e-5, rtol=0)
    jl = _unflat(jl, B, G, h) / LOG2E
    empty = lse.numpy() >= 1e29
    assert np.array_equal(empty, jl >= 1e29)
    if mode == "cmp":   # the document shorter than l sees no pooled token
        assert empty[0, :5].all() and not O[0, :5].any()
    np.testing.assert_allclose(np.where(empty, 0, lse.numpy()), np.where(empty, 0, jl),
                               atol=1e-5, rtol=0)
    dense = port(*map(_t, (Q, K, V)), **pkw, scale=scale)    # the planted dense bound
    assert np.abs(dense.numpy() - np.asarray(jO)).max() > 1e-2


@pytest.fixture
def jax_scorers_scale_off_q(monkeypatch):
    """The JAX scorers with flash.scale_on_q off, their traces cleared."""
    for f in (jscorer.nsa_select_and_cmp_pallas, jscorer.nsa_select_pallas):
        f.clear_cache()
    monkeypatch.setattr(jscorer, "_scale_on_q", lambda: False)
    yield
    for f in (jscorer.nsa_select_and_cmp_pallas, jscorer.nsa_select_pallas):
        f.clear_cache()


def _sets(sel):
    return canonicalize_sel(torch.as_tensor(np.array(sel)))


@pytest.mark.parametrize("row", ["1", "6"])
def test_scorer_plain_matches_the_tpu_kernel_with_seq_start(row, jax_scorers_scale_off_q):
    """Row 1 (nsa_select_and_cmp_pallas: sets, forced slots in order, O,
    lse) and row 6 (nsa_select_pallas: sets)."""
    ds, (Q, Kc, Vc, _), _, scale = _band_operands("cmp", seed=20)
    B, _, G, h, _ = Q.shape
    c = BASE
    kw = dict(scale=scale, l=c["l"], d=c["d"], l_sel=c["l_sel"], n_top=c["n_sel"])
    if row == "1":
        M = build_M_csl_on(S, c["l"], c["d"], c["l_sel"], "cpu")
        sel, O, lse = select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw, return_lse=True,
                                 seq_start=_t(ds))
        jsel, jO, jl = jscorer.nsa_select_and_cmp_pallas(
            *map(jnp.asarray, (Q, Kc, Vc)), jnp.asarray(M.numpy()), **kw, block_q=32,
            cmp_chunk=16, interpret=True, seq_start=jnp.asarray(ds))
        np.testing.assert_allclose(O.numpy(), np.asarray(jO), atol=1e-5, rtol=0)
        jl = _unflat(jl, B, G, h)
        empty = lse.numpy() >= 1e29
        assert np.array_equal(empty, jl >= 1e29) and empty[0, :5].all()
        np.testing.assert_allclose(np.where(empty, 0, lse.numpy()),
                                   np.where(empty, 0, jl / LOG2E), atol=1e-5, rtol=0)
        dense = select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw)[1]
        assert np.abs(dense.numpy() - np.asarray(jO)).max() > 1e-2
    else:
        S_sel = S // c["l_sel"]
        M = selection_map(Kc.shape[2], S_sel, c["l"], c["d"], c["l_sel"])
        sel = select_blocks(*map(_t, (Q, Kc)), S_sel=S_sel, **kw, seq_start=_t(ds))
        jsel = jscorer.nsa_select_pallas(*map(jnp.asarray, (Q, Kc)), jnp.asarray(M.numpy()),
                                         **kw, block_q=16, cmp_chunk=16, interpret=True,
                                         seq_start=jnp.asarray(ds))
    jsel = torch.from_numpy(np.array(jsel))
    assert torch.equal(_sets(sel), _sets(jsel))
    assert torch.equal(sel[..., :3], jsel[..., :3])           # forced slots, in order
    first = _t(ds // c["l_sel"])[:, :, None, None]
    assert bool(((sel < 0) | (sel >= first)).all())
    dense = (select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw)[0] if row == "1"
             else select_blocks(*map(_t, (Q, Kc)), S_sel=S // c["l_sel"], **kw))
    assert not torch.equal(_sets(dense), _sets(jsel))


@pytest.mark.parametrize("row,mode", [("7", "win"), ("7", "cmp"), ("8", "win"), ("8", "cmp"),
                                      ("11", "win")])
def test_banded_backward_plain_matches_the_tpu_kernel_with_seq_start(row, mode, monkeypatch):
    """Rows 7 (flash_banded_bwd_onepass), 8 (flash_banded_bwd) and 11
    (flash_banded_bwd_diag), fed the port's row statistics."""
    ds, (Q, K, V, dO), kw, scale = _band_operands(mode, seed=30)
    B, _, G, h, _ = Q.shape
    O, lse = banded_attn(*map(_t, (Q, K, V)), mode=mode, **kw, scale=scale, return_lse=True,
                         seq_start=_t(ds))
    delta = attention_delta(_t(dO), O)
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jkeys = dict(jtuning._load(), **{"win.bwd_diag": 0})   # row 7's kernel itself
    monkeypatch.setattr(jtuning, "_load", lambda: jkeys)
    jargs = [jnp.asarray(x) for x in (Q, K, V, dO)]
    jstats = (_flat(lse.numpy() * LOG2E, 1e30), _flat(delta.numpy(), 0.0))
    jds = jnp.asarray(ds)
    if row == "11":
        jg = flash_banded_bwd_diag(*jargs, *jstats, w=kw["w"], scale=scale, block_q=64,
                                   interpret=True, seq_start=jds, scale_on_q=False)
        port = win_bwd_diag
    elif row == "8":
        jg = jflash_bwd.flash_banded_bwd(*jargs, *jstats, mode=mode, **kw, scale=scale,
                                         block_q=32, block_k=64, interpret=True,
                                         seq_start=jds, scale_on_q=False)
        port = banded_bwd
    else:
        jg = jflash_bwd.flash_banded_bwd_onepass(*jargs, *jstats, mode=mode, **kw, scale=scale,
                                                 block_q=32, block_k=64, interpret=True,
                                                 seq_start=jds, scale_on_q=False,
                                                 fastpath=False)
        port = banded_bwd_1p
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    pkw = dict(w=kw["w"]) if row == "11" else dict(mode=mode, **kw)
    args = (*map(_t, (Q, K, V, dO)), lse, delta)
    grads = port(*args, **pkw, scale=scale, seq_start=_t(ds))
    for name, g, j in zip("QKV", grads, jg):
        _close_rel(g, j, 2e-5, f"d{name}")
    dense = port(*args, **pkw, scale=scale)                  # the planted dense bound
    assert max(float(np.abs(g.numpy() - np.asarray(j)).max()) for g, j in zip(dense, jg)) > 1e-2


# ---------------------------------------------------------------- layer and model


def _configs(**kw):
    kw = {**BASE, **kw}
    return JNSAConfig(**kw, kernel="reference", varlen_exact=True), NSAConfig(**kw)


@pytest.mark.parametrize("route", ["fused", "select_blocks"])
def test_nsa_prefill_with_seq_start_matches_jax(route, monkeypatch):
    """Both routes: the fused scorer, and select_blocks beside
    compressed_attention (forced by a lower fused-scorer limit); output,
    selection sets and every gradient against JAX `kernel="reference"`."""
    if route == "select_blocks":
        monkeypatch.setattr(sc_mod, "SELECT_CMP_MAX_S_SEL", 4)
    jc, tc = _configs()
    ds = _seq_start()
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x, g = _rand(2, S, jc.dim, seed=1), _rand(2, S, jc.dim, seed=2)

    def jloss(p, x):
        out, aux = jnsa.nsa_prefill(p, x, jc, seq_start=jnp.asarray(ds))
        return (out * g).sum(), (out, aux["sel_idx"])

    (_, (jout, jsel)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                               has_aux=True))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in tts.param_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    out, aux = tnsa.nsa_prefill(tp, xt, tc, seq_start=_t(ds))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    assert torch.equal(canonicalize_sel(aux["sel_idx"]), _sets(jsel))
    grads = torch.autograd.grad((out * _t(g)).sum(), [xt] + leaves)
    _close_rel(grads[0], jgx, 2e-5, "x")
    tg = params_to_numpy(tts.tree_from_leaves(tp, list(grads[1:])))
    for k, want in jax.tree_util.tree_leaves_with_path(jgp):
        got = tg
        for key in k:
            got = got[key.key]
        _close_rel(got, want, 2e-5, str(k))


def _models(n_layers=2, vocab=64):
    jc, tc = _configs()
    jm = JModelConfig(vocab_size=vocab, n_layers=n_layers, nsa=jc)
    tm = ModelConfig(vocab_size=vocab, n_layers=n_layers, nsa=tc)
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _packed_batches(n, bsz=2, seq_len=S, seed=4):
    """n varlen batches [1, bsz, ...] of documents from a seed."""
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, 64, size=int(k)).astype(np.int32)
            for k in rng.choice([5, 16, 30, 40, 70, 100], size=6 * n * bsz)]
    toks, ds, lm = jvarlen.pack_documents_aligned(docs, seq_len, BASE["l_sel"], bsz)
    return [(toks[i:i + bsz][None], ds[i:i + bsz][None], lm[i:i + bsz][None])
            for i in range(0, n * bsz, bsz)]


def test_three_varlen_train_steps_match_jax():
    base = dict(lr=1e-2, warmup_steps=1, steps=10, batch_size=2, seq_len=S, weight_decay=0.01)
    jt, tt = JTrainConfig(**base, varlen=True), TrainConfig(**base, varlen=True)
    jm, tm, jp, tp = _models()
    jstate = jts.init_train_state(jp, jt)
    jstep = jax.jit(jts.make_train_step(jm, jt))
    tstate = tts.init_train_state(tp, tt)
    tstep = tts.make_train_step(tm, tt)
    for toks, ds, lm in _packed_batches(3):
        jstate, jmet = jstep(jstate, tuple(jnp.asarray(a) for a in (toks, ds, lm)))
        tstate, tmet = tstep(tstate, (_t(toks).long(), _t(ds), _t(lm)))
        for k in ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac",
                  "sel_k_mean", "sel_k_max"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-6), k
        assert bool(tmet["good"]) and int(tmet["tokens"]) == int(jmet["tokens"]) == lm.sum()
        got = params_to_numpy(tstate.params)
        want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                     jstate.params)))
        for k, a in jax.tree_util.tree_leaves_with_path(got):
            _close_rel(a, want[k], 1e-5, jax.tree_util.keystr(k))
    ev = tts.make_eval_step(tm, varlen=True)(tstate.params, (_t(toks[0]).long(), _t(ds[0]),
                                                             _t(lm[0])))
    jev = jts.make_eval_step(jm, varlen=True)(jstate.params, tuple(jnp.asarray(a[0])
                                                                   for a in (toks, ds, lm)))
    assert float(ev) == pytest.approx(float(jev), rel=1e-5)


def test_packed_documents_equal_each_document_alone_and_never_leak():
    """model_forward on a packed row: each document's logits equal the same
    document run alone in its own row (no seq_start); perturbing one
    document's tokens leaves every other document's logits bit-identical."""
    _, tm, _, tp = _models()
    docs = _docs()[0]
    toks, ds, _ = tvarlen.pack_documents_aligned(docs, S, BASE["l_sel"], 1)
    with torch.no_grad():
        logits, _ = ttiny.model_forward(tp, _t(toks[:, :-1]).long(), tm, seq_start=_t(ds))
        starts = np.unique(ds[0])
        for doc, s0 in zip(docs, starts):
            alone, _ = ttiny.model_forward(tp, _t(doc[None]).long(), tm)
            np.testing.assert_allclose(logits[0, s0:s0 + len(doc)].numpy(), alone[0].numpy(),
                                       atol=3e-5, rtol=0, err_msg=f"document at {s0}")
        s1, n1 = starts[2], len(docs[2])                       # the document longer than w
        pert = toks.copy()
        pert[0, s1:s1 + n1] = (pert[0, s1:s1 + n1] + 7) % 64
        moved, _ = ttiny.model_forward(tp, _t(pert[:, :-1]).long(), tm, seq_start=_t(ds))
    diff = (moved - logits).abs()[0].amax(-1).numpy()
    inside = ds[0] == s1                # the document and the padding up to the next start
    assert diff[inside].max() > 0.0
    assert diff[~inside].max() == 0.0


# ---------------------------------------------------------------- trainer


@pytest.mark.parametrize("exact", [True, False])
def test_load_config_reads_varlen_keys(tmp_path, exact):
    yaml = pytest.importorskip("yaml")
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump({"nsa": dict(BASE, varlen_exact=exact),
                                 "train": {"varlen": True, "seq_len": 64}}))
    if not exact:    # the port's avg phi is always window-exact: false is refused
        with pytest.raises(ValueError, match="varlen_exact"):
            ttrainer.load_config(str(p))
        return
    mcfg, tcfg, _ = ttrainer.load_config(str(p))
    assert mcfg.nsa == NSAConfig(**BASE) and tcfg.varlen and tcfg.seq_len == 64


def test_trainer_cli_varlen_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "trainer", "--data", "synthetic", "--device", "cpu", "--varlen", "--steps", "3",
        "--n-layers", "1", "--batch-size", "2", "--seq-len", "64", "--log-every", "1",
        "--eval-every", "3", "--out-dir", str(tmp_path)])
    ttrainer.main()
    out = capsys.readouterr().out
    assert '"steps": 3' in out and '"bad_steps": 0' in out
    rows = (tmp_path / "training.csv").read_text().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2", "3"]
    assert np.isfinite(float((tmp_path / "val.csv").read_text().split(",")[1]))
    env = (tmp_path / "env.json").read_text()
    assert '"varlen": true' in env

