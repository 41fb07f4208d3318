"""The gate-epilogue fold (nsa.gate_fold) and flat-IO (nsa.flat_io) of the
port vs the JAX package (CPU, f32).

Under the fold the branch kernels emit Y = g * O, the combine is a plain
sum and the gate logits' gradient rides the delta preprocess through the
D-form softmax backward (core/gate.py::gate_probs_dform). Each case of
tests/test_gate_fold.py is mirrored: the port's folded nsa_prefill is held
to JAX's folded nsa_prefill (kernel="pallas", interpret mode; its
jax.grad) and to the port's unfolded path, at that file's tolerances
(forward 1e-5, gates 1e-6; gradients atol 2e-4, rtol 2e-3). The keys are
set in both packages by replacing each one's loaded dict, as
tests/test_gate_fold.py and tests/test_torch_bwd_designs.py do; JAX reads
them while tracing, so every JAX run is a fresh jit and the jitted
one-pass backward's cache is cleared. Each JAX configuration runs once per
module (`_jax_prefill`, cached).

Then the gated branch Functions (ops/attention.py) against JAX's
_flash_vjp_gated / _sel_flash_vjp_gated: at an offset, with seq_start, and
under bwd.onepass 0 (rows 8 and 10) and win.bwd_diag 1 (row 11), whose
backward takes the dense (dY * g).to(dY.dtype); outputs within 1e-5,
gradients (the gate's included) within 2e-5 of each one's max |value|.
And one TinyLM train step under the fold against JAX's.
"""

import contextlib
import functools

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
from nsa_vibe_tpu.ops import attention as jattn
from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops.pallas import flash_bwd as jflash_bwd
from nsa_vibe_tpu.ops.pallas import scorer as jscorer
from nsa_vibe_tpu.ops.pallas.flash import _as_t0
from nsa_vibe_tpu.parallel import train_step as jts
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.core.gate import _SoftmaxDForm
from nsa_vibe_tpu_torch.ops import attention as tattn
from nsa_vibe_tpu_torch.ops import tuning as ttuning
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as tselect_cmp
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel
from nsa_vibe_tpu_torch.train import train_step as tts

KW = dict(dim=32, n_heads=4, n_kv_groups=2, d_k=8, d_v=8, l=4, d=2, l_sel=8, n_sel=3, w=8)
FWD_TOL, GATE_TOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
BRANCH_TOL = 2e-5
FOLD = {"nsa.gate_fold": 1}
FLAT = {"nsa.gate_fold": 1, "nsa.flat_io": 1}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@contextlib.contextmanager
def _keys(**keys):
    """Both packages under `keys` (the others at their defaults)."""
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jload, tload = jtuning._load, ttuning._load
    jkeys = dict(jload())
    jkeys.update({k: v for k, v in keys.items() if v is not None})
    for k, v in keys.items():
        if v is None:
            jkeys.pop(k, None)
    jtuning._load = lambda: jkeys
    ttuning._load = lambda: dict(ttuning.DEFAULTS, **keys)
    try:
        yield
    finally:
        jtuning._load, ttuning._load = jload, tload
        jflash_bwd.flash_banded_bwd_onepass.clear_cache()


def _cfgs(**kw):
    kw = {**KW, **kw}
    return JNSAConfig(**kw, kernel="pallas"), NSAConfig(**kw)


def _params(jc, b2=None):
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    if b2 is not None:   # near-collapsed gates: g ~ 1e-22 on two branches
        jp = dict(jp, gate=dict(jp["gate"], b2=jnp.asarray(b2, jnp.float32)))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(B=2, S=16):
    return _rand(B, S, KW["dim"], seed=1) * 0.5


def _seq_start(B=2, S=16):
    """Two documents a row, l_sel-aligned starts."""
    return np.repeat(np.where(np.arange(S) < 8, 0, 8)[None, :], B, 0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_prefill(case: str):
    """(out, gates, sel_idx, grads of sum(out ** 2)) of JAX's nsa_prefill
    under the keys and inputs `case` names (CASES), as numpy."""
    keys, cfg_kw, b2, varlen, fused = CASES[case]
    jc, _ = _cfgs(**cfg_kw)
    jp, _ = _params(jc, b2)
    B = 1 if cfg_kw else 2
    x, ds = jnp.asarray(_x(B)), (jnp.asarray(_seq_start(B)) if varlen else None)

    def loss(p):
        out, aux = jnsa.nsa_prefill(p, x, jc, seq_start=ds)
        return jnp.sum(out.astype(jnp.float32) ** 2), (out, aux["gates"], aux["sel_idx"])

    real = jscorer.scorer_fits_vmem
    if not fused:
        jscorer.scorer_fits_vmem = lambda *a, **k: False
    try:
        with _keys(**keys):
            (_, (out, gates, sel)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    finally:
        jscorer.scorer_fits_vmem = real
    return (np.asarray(out), np.asarray(gates), np.asarray(sel),
            jax.tree.map(np.asarray, g))


# name -> (keys, config changes, gate bias b2, varlen, fused scorer)
CASES = {
    "fold": (FOLD, {}, None, False, True),
    "fold collapsed": (FOLD, {}, (50.0, 0.0, 0.0), False, True),
    "fold varlen": (FOLD, {}, None, True, True),
    "fold nonfused": (FOLD, {}, None, False, False),
    "flat odd h": (FLAT, {"n_heads": 6}, None, False, True),
}


def _port_prefill(keys, cfg_kw=None, b2=None, varlen=False, fused=True):
    """The port's nsa_prefill under `keys`: (out, gates, sel_idx, grads of
    sum(out ** 2) in the JAX layout), as numpy."""
    cfg_kw = cfg_kw or {}
    jc, tc = _cfgs(**cfg_kw)
    _, tp = _params(jc, b2)
    B = 1 if cfg_kw else 2
    leaves = [t.detach().clone().requires_grad_(True) for _, t in tts.param_leaves(tp)]
    p = tts.tree_from_leaves(tp, leaves)
    ds = _t(_seq_start(B)) if varlen else None
    real = tselect_cmp.SELECT_CMP_MAX_S_SEL
    if not fused:   # the scorer alone beside compressed_attention (the long route)
        tselect_cmp.SELECT_CMP_MAX_S_SEL = 1
    try:
        with _keys(**keys):
            out, aux = tnsa.nsa_prefill(p, _t(_x(B)), tc, seq_start=ds)
            grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    finally:
        tselect_cmp.SELECT_CMP_MAX_S_SEL = real
    g = params_to_numpy(tts.tree_from_leaves(tp, list(grads)))
    return out.detach().numpy(), aux["gates"].detach().numpy(), aux["sel_idx"], g


def _tree_close(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        a = got
        for k in path:
            a = a[k.key]
        np.testing.assert_allclose(a, np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.all(np.isfinite(a)), jax.tree_util.keystr(path)


def _held(case: str, keys=None):
    """The port's folded prefill under `case` (or its inputs under `keys`)
    against JAX's and against the port's unfolded path (same inputs, the
    fold keys off)."""
    case_keys, cfg_kw, b2, varlen, fused = CASES[case]
    out, gates, sel, g = _port_prefill(keys or case_keys, cfg_kw, b2, varlen, fused)
    jout, jgates, jsel, jg = _jax_prefill(case)
    np.testing.assert_allclose(out, jout, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(gates, jgates, atol=GATE_TOL, rtol=GATE_TOL)
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(_t(jsel)))
    _tree_close(g, jg)
    uout, ugates, usel, ug = _port_prefill({}, cfg_kw, b2, varlen, fused)
    np.testing.assert_allclose(out, uout, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(gates, ugates, atol=GATE_TOL, rtol=GATE_TOL)
    assert torch.equal(sel, usel)
    _tree_close(g, ug)
    return out, g


# ---------------------------------------------------------------- tests/test_gate_fold.py

def test_fold_forward_and_grads_match_jax_and_unfused():
    _held("fold")


def test_fold_grads_match_with_collapsed_gates():
    """g ~ 1e-22 on two branches: the D-form path stays finite and exact,
    where a recovery dg = D / g would be 0 / 0."""
    _held("fold collapsed")


def test_fold_grads_match_varlen():
    _held("fold varlen")


def test_fold_grads_match_on_the_nonfused_scorer_route():
    """The scorer alone (select_blocks) beside the gated compressed branch
    (banded_attn), as the JAX package's non-fused route."""
    _held("fold nonfused")


def test_fold_force_branch_keeps_the_standard_combine():
    """A force override bypasses the fold: the same bits as the fold off."""
    for override in ({"force_branch": "win"}, {"force_uniform_gate": True}):
        jc, tc = _cfgs(**override)
        _, tp = _params(jc)
        with _keys(**FOLD):
            out, aux = tnsa.nsa_prefill(tp, _t(_x()), tc)
        with _keys():
            ref, ref_aux = tnsa.nsa_prefill(tp, _t(_x()), tc)
        assert torch.equal(out, ref) and torch.equal(aux["gates"], ref_aux["gates"])


def test_softmax_dform_pairs_to_the_exact_softmax_grad():
    """out = sum_k g_k c_k, g = softmax(z): gated branches that return D_k =
    rowsum(dY * Y_k) as the gate's gradient, through _SoftmaxDForm, give
    plain autodiff's dz."""
    z, c, dO = _t(_rand(5, 3, seed=2) * 3), _t(_rand(5, 3, 7, seed=3)), _t(_rand(5, 7, seed=4))

    class Gated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gk, ck):
            Y = gk[:, None] * ck
            ctx.save_for_backward(gk, Y)
            return Y

        @staticmethod
        def backward(ctx, dY):
            gk, Y = ctx.saved_tensors
            return (dY * Y).sum(-1), gk[:, None] * dY

    zp = z.clone().requires_grad_(True)
    (torch.einsum("bk,bkd->bd", torch.softmax(zp, -1), c) * dO).sum().backward()
    zd = z.clone().requires_grad_(True)
    g = _SoftmaxDForm.apply(zd)
    (sum(Gated.apply(g[:, k], c[:, k]) for k in range(3)) * dO).sum().backward()
    np.testing.assert_allclose(zd.grad.numpy(), zp.grad.numpy(), atol=1e-5, rtol=1e-5)


def _bit_equal_trees(a, b):
    for path, w in jax.tree_util.tree_leaves_with_path(b):
        x = a
        for k in path:
            x = x[k.key]
        assert np.array_equal(x, w), jax.tree_util.keystr(path)


@pytest.mark.parametrize("case", ["fold", "fold varlen"])
def test_flat_io_forward_and_grads_match(case):
    """flat-IO under the fold: held to JAX's folded prefill (which
    tests/test_gate_fold.py holds to its flat-IO one) and to the port's
    unfolded path, and bit-equal to the fold without it (the port accepts
    the key and it has no effect)."""
    out, g = _held(case, keys=FLAT)
    fout, _, _, fg = _port_prefill(FOLD, varlen=case.endswith("varlen"))
    assert np.array_equal(out, fout)
    _bit_equal_trees(g, fg)


def test_flat_io_odd_h_falls_back():
    """h = 3 under flat-IO (which JAX turns off at odd h): the fold stays
    on, held to JAX's."""
    _held("flat odd h")


# ---------------------------------------------------------------- gated branch Functions

BB, GG, HH, DD = 1, 2, 2, 16
LB, DB, LSEL, WB = 8, 4, 16, 24


def _branch_operands(mode, S, S_kv, seed):
    Q, K, V, U = (_rand(*s, seed=seed + i) for i, s in enumerate(
        ((BB, S, GG, HH, DD), (BB, GG, S_kv, DD), (BB, GG, S_kv, DD), (BB, S, GG, HH, DD))))
    g = np.random.RandomState(seed + 9).uniform(0.05, 1.0, (BB, S, GG)).astype(np.float32)
    return Q, K, V, U, g


def _sel_idx(S, t0, S_kv, seed):
    """Random selections of blocks at or before each row's position."""
    rs = np.random.RandomState(seed)
    NB = -(-S_kv // LSEL)
    t = np.arange(t0, t0 + S)
    idx = rs.randint(0, NB, size=(BB, S, GG, 3))
    idx = np.where(idx * LSEL <= t[None, :, None, None], idx, (t // LSEL)[None, :, None, None])
    return idx.astype(np.int32)


def _jax_branch(mode, keys, t0, ds, args, sel=None):
    """Y and (dQ, dK, dV, dg) of JAX's gated vjp on args (Q, K, V, U, g)."""
    Q, K, V, U, g = map(jnp.asarray, args)
    scale = DD ** -0.5
    with _keys(**keys):
        if mode == "sel":
            f = jattn._sel_flash_vjp_gated(LSEL, scale, True, S_kv=K.shape[2])
            lead = (jnp.asarray(sel), _as_t0(t0))
        else:
            kw = (WB, 0, 1) if mode == "win" else (0, LB, DB)
            f = jattn._flash_vjp_gated(mode, *kw, scale, True, varlen=ds is not None)
            lead = (_as_t0(t0),) if ds is None else (_as_t0(t0), jnp.asarray(ds))

        def loss(q, k, v, gg):
            Y = f(*lead, gg, q, k, v)
            return jnp.sum(Y * U), Y

        (_, Y), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            Q, K, V, g)
    return np.asarray(Y), [np.asarray(x) for x in grads]


def _port_branch(mode, keys, t0, ds, args, sel=None):
    Q, K, V, U, g = (_t(a).requires_grad_(True) for a in args)
    scale = DD ** -0.5
    with _keys(**keys):
        if mode == "sel":
            Y = tattn.selection_attention(Q, K, V, _t(sel), torch.arange(t0, t0 + Q.shape[1]),
                                          LSEL, scale, gate=g)
        elif mode == "win":
            Y = tattn.sliding_window_attention(Q, K, V, WB, scale, t_start=t0, gate=g,
                                               seq_start=None if ds is None else _t(ds))
        else:
            Y = tattn.compressed_attention(Q, K, V, l=LB, d=DB, scale=scale, t_start=t0, gate=g,
                                           seq_start=None if ds is None else _t(ds))
        grads = torch.autograd.grad((Y * U).sum(), (Q, K, V, g))
    return Y.detach().numpy(), [x.numpy() for x in grads]


# name -> (mode, keys, t0, S rows, varlen, the port's backward kernel)
BRANCH_CASES = {
    "win at an offset, seq_start": ("win", {"win.bwd_diag": 0}, 40, 64, True, "banded_bwd_1p"),
    "cmp at an offset, seq_start": ("cmp", {}, 40, 64, True, "banded_bwd_1p"),
    "sel at an offset": ("sel", {}, 40, 32, False, "sel_attn_bwd_1p"),
    "win two-pass (row 8)": ("win", {"bwd.onepass": 0}, 0, 64, False, "banded_bwd"),
    "cmp two-pass (row 8)": ("cmp", {"bwd.onepass": 0}, 0, 64, False, "banded_bwd"),
    "sel two-pass (row 10)": ("sel", {"bwd.onepass": 0, "sel.bwd_onepass": 0}, 0, 64, False,
                              "sel_attn_bwd"),
    "win diagonal (row 11)": ("win", {"bwd.onepass": 1, "win.bwd_diag": 1}, 0, 128, False,
                              "win_bwd_diag"),
}


@pytest.mark.parametrize("case", list(BRANCH_CASES))
def test_gated_branch_matches_jax_gated_vjp(case):
    mode, keys, t0, S, varlen, kernel = BRANCH_CASES[case]
    with _keys(**keys):
        assert ttuning.backward_kernel(mode, S, WB) == kernel
    S_kv = t0 + S if mode != "cmp" else (t0 + S - LB) // DB + 1
    args = _branch_operands(mode, S, S_kv, seed=30)
    sel = _sel_idx(S, t0, S_kv, seed=31) if mode == "sel" else None
    ds = None
    if varlen:   # a document from before the offset to position 80, one after: packed starts
        ds = np.repeat(np.where(np.arange(t0, t0 + S) < 80, 16, 80)[None, :], BB, 0)
        ds = ds.astype(np.int32)
    Y, grads = _port_branch(mode, keys, t0, ds, args, sel)
    jY, jgrads = _jax_branch(mode, keys, t0, ds, args, sel)
    np.testing.assert_allclose(Y, jY, atol=1e-5, rtol=0)
    for name, a, b in zip(("dQ", "dK", "dV", "dg"), grads, jgrads):
        np.testing.assert_allclose(a, b, atol=BRANCH_TOL * max(np.abs(b).max(), 1e-12), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------- TinyLM

def test_tinylm_train_step_under_the_fold_matches_jax():
    """One train step of a one-layer TinyLM under the fold: loss, gradient
    norm and gate statistics (the folded gates) against JAX's within 1e-5."""
    kw = dict(dim=48, n_heads=4, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
              w=32)
    jm = JModelConfig(vocab_size=64, n_layers=1, nsa=JNSAConfig(**kw, kernel="pallas"))
    tm = ModelConfig(vocab_size=64, n_layers=1, nsa=NSAConfig(**kw))
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    base = dict(lr=1e-2, warmup_steps=1, steps=10, batch_size=2, seq_len=40, weight_decay=0.01)
    jt, tt = JTrainConfig(**base), TrainConfig(**base)
    toks = np.random.RandomState(6).randint(0, 64, size=(1, 2, 41)).astype(np.int32)
    with _keys(**FOLD):
        _, jmet = jax.jit(jts.make_train_step(jm, jt))(jts.init_train_state(jp, jt),
                                                       jnp.asarray(toks))
        tstate, tmet = tts.make_train_step(tm, tt)(tts.init_train_state(tp, tt),
                                                    _t(toks).long())
    for k in ("loss", "grad_norm", "gate_entropy", "gate_max", "gate_collapse_frac"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(tmet["branch_shares"].numpy(), np.asarray(jmet["branch_shares"]),
                               atol=1e-6)
    assert bool(tmet["good"]) and int(tstate.step) == 1
