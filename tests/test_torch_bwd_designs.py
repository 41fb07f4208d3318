"""The port's backward designs vs the JAX package's under the same keys (CPU, f32).

Both packages pick a backward kernel for each branch from three design
keys (bwd.onepass, sel.bwd_onepass, win.bwd_diag): the JAX package from
nsa_vibe_tpu/ops/tuning.py, the port from its own copy,
nsa_vibe_tpu_torch/ops/tuning.py. Each test sets one setting in both, by
replacing each package's loaded dict as tests/test_flash_diag.py does,
then runs JAX with kernel="pallas" (interpret mode on the CPU, so the
Pallas backward kernels that setting selects run) and the port on CPU
tensors (the kernels' plain versions), and holds them together. JAX reads
the keys while tracing, so each setting starts with jax.clear_caches().
The tests also record which backward kernel each package called and
require the same design.

Tolerances (f32; sum order and the TPU kernels' exp2 / scale folding are
the only differences): branch gradients 2e-5 of each gradient's max
|value|; nsa_prefill gradients 2e-5 of each gradient's max |value|;
TinyLM loss 1e-5 absolute, gradients 5e-5 of each gradient's max |value|;
integer work lists exactly equal.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.core import nsa as jnsa
from nsa_vibe_tpu.core.config import ModelConfig as JModelConfig
from nsa_vibe_tpu.core.config import NSAConfig as JNSAConfig
from nsa_vibe_tpu.models import tinylm as jtiny
from nsa_vibe_tpu.ops import attention as jattn
from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops.pallas import flash_bwd as jflash_bwd
from nsa_vibe_tpu.ops.pallas import flash_diag as jflash_diag
from nsa_vibe_tpu.ops.selection import select_topn_blocks
from nsa_vibe_tpu_torch.convert import params_from_numpy, params_to_numpy
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.ops import attention as tattn
from nsa_vibe_tpu_torch.ops import tuning as ttuning
from nsa_vibe_tpu_torch.ops.cuda.sel_attn_bwd import selection_index
from nsa_vibe_tpu_torch.train import train_step as tts

SETTINGS = {   # the settings chip_smoke.py's phase (f) trains under
    "onepass": {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 0},
    "onepass+diag": {"bwd.onepass": 1, "sel.bwd_onepass": None, "win.bwd_diag": 1},
    "twopass": {"bwd.onepass": 0, "sel.bwd_onepass": 0, "win.bwd_diag": 0},
}
# JAX backward function -> the port kernel of the same design
JAX_TO_PORT = {"flash_banded_bwd_onepass": "banded_bwd_1p", "flash_banded_bwd": "banded_bwd",
               "flash_banded_bwd_diag": "win_bwd_diag",
               "selection_flash_bwd_onepass": "sel_attn_bwd_1p",
               "selection_flash_bwd": "sel_attn_bwd"}
BASE = dict(dim=48, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=8, d=4, l_sel=16, n_sel=4,
            w=32)
S_LAYER = 160    # >= 128 query rows, so win.bwd_diag engages


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(np.abs(want).max(), 1e-12), rtol=0)


def _use(monkeypatch, setting: dict) -> None:
    """Both packages under `setting`; an unset (None) sel.bwd_onepass is
    absent from the JAX dict, where the JAX rule falls back to bwd.onepass.
    Of the JAX functions that read the keys, only the jitted one-pass entry
    point (the diagonal hand-over) keeps a trace across calls: its cache
    is cleared."""
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jkeys = dict(jtuning._load())
    for k, v in setting.items():
        if v is None:
            jkeys.pop(k, None)
        else:
            jkeys[k] = v
    monkeypatch.setattr(jtuning, "_load", lambda: jkeys)
    tkeys = dict(ttuning.DEFAULTS, **setting)
    monkeypatch.setattr(ttuning, "_load", lambda: tkeys)


def _record(monkeypatch) -> tuple:
    """Wraps both packages' backward entry points to record, in call
    order, which ran: (jax names mapped to port names, port names)."""
    jcalls, tcalls = [], []

    def wrap(module, name, log, as_name):
        fn = getattr(module, name)

        def recorded(*a, **k):
            log.append(as_name)
            return fn(*a, **k)

        monkeypatch.setattr(module, name, recorded)

    for name in ("flash_banded_bwd_onepass", "flash_banded_bwd", "selection_flash_bwd_onepass",
                 "selection_flash_bwd"):
        wrap(jattn, name, jcalls, JAX_TO_PORT[name])
    wrap(jflash_diag, "flash_banded_bwd_diag", jcalls, "win_bwd_diag")
    for name in ("banded_bwd", "banded_bwd_1p", "win_bwd_diag", "sel_attn_bwd",
                 "sel_attn_bwd_1p"):
        wrap(tattn, name, tcalls, name)
    return jcalls, tcalls


def _designs(jcalls) -> list:
    """The JAX kernels that computed gradients: the one-pass entry point
    hands the window to the diagonal kernel, so a diagonal call replaces
    the one-pass call before it."""
    out = []
    for name in jcalls:
        if name == "win_bwd_diag" and out and out[-1] == "banded_bwd_1p":
            out[-1] = name
        else:
            out.append(name)
    return out


# ---------------------------------------------------------------- the tuning reader

def test_tuning_defaults_and_override(monkeypatch, tmp_path):
    monkeypatch.delenv(ttuning.ENV_VAR, raising=False)
    ttuning._load.cache_clear()
    try:
        assert ttuning._load() == ttuning.DEFAULTS
        assert ttuning._load()["sel.bwd_onepass"] is None
        path = tmp_path / "tuning.json"
        path.write_text(json.dumps({"bwd.onepass": 0, "win.bwd_diag": 1}))
        monkeypatch.setenv(ttuning.ENV_VAR, str(path))
        ttuning._load.cache_clear()
        assert ttuning._load() == dict(ttuning.DEFAULTS, **{"bwd.onepass": 0, "win.bwd_diag": 1})
        assert ttuning.backward_kernel("win", 256, 64) == "banded_bwd"    # diag needs one-pass
        assert ttuning.backward_kernel("sel", 256) == "sel_attn_bwd"      # follows bwd.onepass
    finally:
        monkeypatch.delenv(ttuning.ENV_VAR, raising=False)
        ttuning._load.cache_clear()


def test_tuning_rejects_an_unknown_key(monkeypatch, tmp_path):
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"win.block_k": 512}))       # a JAX key the port does not read
    monkeypatch.setenv(ttuning.ENV_VAR, str(path))
    ttuning._load.cache_clear()
    try:
        with pytest.raises(ValueError, match="unknown keys"):
            ttuning._load()
        # a known key with a value that is not a design: "0" would read as true
        for bad in ({"bwd.onepass": "0"}, {"win.bwd_diag": 2}, {"bwd.onepass": None},
                    {"sel.bwd_onepass": "1"}):
            path.write_text(json.dumps(bad))
            ttuning._load.cache_clear()
            with pytest.raises(ValueError, match="must be one of"):
                ttuning._load()
        path.write_text(json.dumps({"sel.bwd_onepass": None, "bwd.onepass": 0}))
        ttuning._load.cache_clear()
        assert ttuning._load()["bwd.onepass"] == 0
    finally:
        monkeypatch.delenv(ttuning.ENV_VAR, raising=False)
        ttuning._load.cache_clear()
    with pytest.raises(ValueError, match="branch"):
        ttuning.backward_kernel("band", 256)


# ---------------------------------------------------------------- the dispatch rule

def _jax_banded_kernel(mode: str, S: int, w: int) -> str:
    """The backward kernel the JAX package runs for a banded branch under
    its current keys: _bwd_impl's choice, and inside the one-pass entry
    point (traced abstractly) whether it hands over to the diagonal one."""
    if jattn._bwd_impl() is jflash_bwd.flash_banded_bwd:
        return "banded_bwd"
    B, G, h, D = 1, 1, 2, 16
    l, d = 8, 4
    S_kv = S if mode == "win" else (S - l) // d + 1
    handed = []

    def diag(Q, K, V, *a, **k):
        handed.append(True)
        return Q, K, V

    orig = jflash_diag.flash_banded_bwd_diag
    jflash_diag.flash_banded_bwd_diag = diag
    try:
        rows = -(-S * h // 128) * 128
        jax.eval_shape(
            lambda *a: jflash_bwd.flash_banded_bwd_onepass.__wrapped__(
                *a, mode=mode, w=w, l=l, d=d, scale=0.25, interpret=True),
            jnp.zeros((B, S, G, h, D)), jnp.zeros((B, G, S_kv, D)), jnp.zeros((B, G, S_kv, D)),
            jnp.zeros((B, S, G, h, D)), jnp.zeros((B * G, 1, rows)), jnp.zeros((B * G, 1, rows)))
    finally:
        jflash_diag.flash_banded_bwd_diag = orig
    return "win_bwd_diag" if handed else "banded_bwd_1p"


def _jax_sel_kernel(S: int) -> str:
    """The selection backward the JAX package's vjp rule calls under its
    current keys (traced abstractly, the kernels stubbed)."""
    called = []

    def stub(name):
        def f(Q, K, V, *a, **k):
            called.append(name)
            return Q, K, V
        return f

    orig = jattn.selection_flash_bwd_onepass, jattn.selection_flash_bwd
    jattn.selection_flash_bwd_onepass = stub("sel_attn_bwd_1p")
    jattn.selection_flash_bwd = stub("sel_attn_bwd")
    try:
        B, G, h, D, l_sel = 1, 1, 2, 16, 16
        f = jattn._sel_flash_vjp(l_sel, 0.25, True, S_kv=S)
        sel = jnp.zeros((B, S, G, 2), jnp.int32)
        q, k = jnp.zeros((B, S, G, h, D)), jnp.zeros((B, G, S, D))
        t0 = jnp.zeros((1,), jnp.int32)
        jax.eval_shape(lambda q, k, v: jax.vjp(lambda *x: f(sel, t0, *x), q, k, v)[1](
            jnp.zeros((B, S, G, h, D))), q, k, k)
    finally:
        jattn.selection_flash_bwd_onepass, jattn.selection_flash_bwd = orig
    assert len(called) == 1
    return called[0]


@pytest.mark.parametrize("onepass,sel_onepass,diag",
                         list(itertools.product((0, 1), (None, 0, 1), (0, 1))))
def test_backward_kernel_follows_the_jax_rule(monkeypatch, onepass, sel_onepass, diag):
    """tuning.backward_kernel names the kernel the JAX package runs under
    the same keys, for both banded modes and the selection, at S below and
    above DIAG_MIN_S = 128."""
    _use(monkeypatch, {"bwd.onepass": onepass, "sel.bwd_onepass": sel_onepass,
                       "win.bwd_diag": diag})
    for S in (96, 160):
        for mode in ("win", "cmp"):
            assert ttuning.backward_kernel(mode, S, 32) == _jax_banded_kernel(mode, S, 32), \
                (mode, S)
        assert ttuning.backward_kernel("sel", S) == _jax_sel_kernel(S), S


# ---------------------------------------------------------------- branch gradients

def _branch(branch, S, seed):
    """(JAX loss fn, port loss fn, numpy Q, K, V) of one branch at S rows:
    loss = sum(O * U) for a fixed random U."""
    B, G, h, D, scale = 2, 2, 3, 16, 0.25
    l, d, l_sel, w = 8, 4, 16, 48
    S_kv = (S - l) // d + 1 if branch == "cmp" else S
    Q, K, V = _rand(B, S, G, h, D, seed=seed), _rand(B, G, S_kv, D, seed=seed + 1), \
        _rand(B, G, S_kv, D, seed=seed + 2)
    U = _rand(B, S, G, h, D, seed=seed + 3)
    t = np.arange(S)
    if branch == "win":
        jf = lambda q, k, v: jattn.sliding_window_attention(  # noqa: E731
            q, k, v, jnp.asarray(t), w, scale, kernel="pallas")
        tf = lambda q, k, v: tattn.sliding_window_attention(q, k, v, w, scale)  # noqa: E731
    elif branch == "cmp":
        ncmp = np.clip(np.where(t + 1 >= l, (t + 1 - l) // d + 1, 0), 0, S_kv)
        jf = lambda q, k, v: jattn.compressed_attention(  # noqa: E731
            q, k, v, jnp.asarray(ncmp), l, d, scale, kernel="pallas")
        tf = lambda q, k, v: tattn.compressed_attention(  # noqa: E731
            q, k, v, l=l, d=d, scale=scale)
    else:
        scores = jnp.asarray(np.random.RandomState(seed + 4).rand(B, S, G, -(-S // l_sel)))
        sel = np.asarray(select_topn_blocks(scores, 3, jnp.asarray(t), l_sel))
        jf = lambda q, k, v: jattn.selection_attention(  # noqa: E731
            q, k, v, jnp.asarray(sel), jnp.asarray(t), l_sel, scale, kernel="pallas")
        tf = lambda q, k, v: tattn.selection_attention(  # noqa: E731
            q, k, v, _t(sel), torch.arange(S), l_sel, scale)
    return ((lambda q, k, v: (jf(q, k, v) * U).sum()),
            (lambda q, k, v: (tf(q, k, v) * _t(U)).sum()), (Q, K, V))


@pytest.mark.parametrize("branch,setting", [
    ("win", "onepass"), ("win", "onepass+diag"), ("win", "twopass"),
    ("cmp", "onepass"), ("cmp", "twopass"), ("sel", "onepass"), ("sel", "twopass"),
])
def test_branch_gradients_match_jax_under_keys(monkeypatch, branch, setting):
    _use(monkeypatch, SETTINGS[setting])
    jcalls, tcalls = _record(monkeypatch)
    S = 160 if branch == "win" else 96       # the diagonal kernel needs S >= 128
    jl, tl, args = _branch(branch, S, seed=30)
    jg = jax.grad(jl, argnums=(0, 1, 2))(*map(jnp.asarray, args))
    xs = [_t(a).requires_grad_(True) for a in args]
    tg = torch.autograd.grad(tl(*xs), xs)
    for g, want in zip(tg, jg):
        _close_rel(g.numpy(), want, 2e-5)
    want = ttuning.backward_kernel(branch, S, 48)
    assert tcalls == [want] and _designs(jcalls) == [want], (jcalls, tcalls)


# ---------------------------------------------------------------- nsa_prefill, TinyLM

@pytest.mark.parametrize("setting", list(SETTINGS))
def test_nsa_prefill_gradients_match_jax_under_keys(monkeypatch, setting):
    _use(monkeypatch, SETTINGS[setting])
    jcalls, tcalls = _record(monkeypatch)
    jc, tc = JNSAConfig(**BASE, kernel="pallas"), NSAConfig(**BASE)
    jp = jnsa.init_nsa_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x, u = _rand(2, S_LAYER, jc.dim, seed=1), _rand(2, S_LAYER, jc.dim, seed=2)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: (jnsa.nsa_prefill(p, x, jc)[0] * u).sum(),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in tts.param_leaves(tp)]
    xt = _t(x).requires_grad_(True)
    out, _ = tnsa.nsa_prefill(tp, xt, tc)
    grads = torch.autograd.grad((out * _t(u)).sum(), [xt] + leaves)
    _close_rel(grads[0].numpy(), jgx, 2e-5)
    tg = params_to_numpy(tts.tree_from_leaves(tp, list(grads[1:])))
    for path, want in jax.tree_util.tree_leaves_with_path(jgp):
        got = tg
        for key in path:
            got = got[key.key]
        _close_rel(got, want, 2e-5)
    assert sorted(tcalls) == sorted(_designs(jcalls)) == sorted(
        ttuning.backward_kernel(b, S_LAYER, BASE["w"]) for b in ("win", "cmp", "sel"))


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_tinylm_loss_and_grads_match_jax_under_keys(monkeypatch, setting):
    """A 2-layer TinyLM (remat off) in f32: loss and every gradient."""
    _use(monkeypatch, SETTINGS[setting])
    jcalls, tcalls = _record(monkeypatch)
    jm = JModelConfig(vocab_size=64, n_layers=2, nsa=JNSAConfig(**BASE, kernel="pallas"))
    tm = ModelConfig(vocab_size=64, n_layers=2, nsa=NSAConfig(**BASE))
    jp = jtiny.init_model_params(jax.random.PRNGKey(0), jm)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(5).randint(0, 64, size=(2, S_LAYER + 1)).astype(np.int32)

    def jloss(p, t):
        logits, _ = jtiny.model_forward(p, t[:, :-1], jm)
        return jtiny.cross_entropy_loss(logits, t[:, 1:])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(toks))
    tts.init_train_state(tp, TrainConfig())
    loss, grads, _ = tts.loss_and_grads(tp, _t(toks).long(), tm)
    assert abs(float(loss) - float(jl)) <= 1e-5
    tg = params_to_numpy(tts.tree_from_leaves(tp, grads))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    for path, got in jax.tree_util.tree_leaves_with_path(tg):
        _close_rel(got, flat_j[path], 5e-5)
    want = sorted(ttuning.backward_kernel(b, S_LAYER, BASE["w"]) for b in ("win", "cmp", "sel"))
    # the second layer's one-pass call can reuse JAX's trace of the first
    # (jit cache), which records no second hand-over: compare the designs
    assert sorted(tcalls) == sorted(want * 2) and set(_designs(jcalls)) == set(want)


# ---------------------------------------------------------------- the selection work list

def test_selection_slot_index_matches_numpy():
    """inv/cnt list each block's member rows (ascending), ranks give the
    block's rank among the row's distinct visible blocks, nblk their
    number: the one-pass kernel's dQ slots."""
    B, S, G, n, l_sel, S_kv = 2, 50, 2, 5, 8, 50
    rs = np.random.RandomState(3)
    sel = rs.randint(-1, 8, size=(B, S, G, n)).astype(np.int32)
    t_pos = np.arange(S)
    inv, ranks, cnt, nblk = selection_index(_t(sel), torch.arange(S), l_sel, S_kv)
    NB = -(-S_kv // l_sel)
    assert inv.shape == ranks.shape == (B, G, NB, S + 1) and nblk.shape == (B, S, G)
    for b in range(B):
        for s in range(S):
            for g in range(G):
                vis = sorted({j for j in sel[b, s, g] if 0 <= j < NB and j * l_sel <= t_pos[s]})
                assert int(nblk[b, s, g]) == len(vis)
    for b in range(B):
        for g in range(G):
            for j in range(NB):
                members = [s for s in range(S) if j in sel[b, s, g] and j * l_sel <= s]
                c = int(cnt[b, g, j])
                assert inv[b, g, j, :c].tolist() == members
                want = [sorted({x for x in sel[b, s, g] if 0 <= x < NB and x * l_sel <= s}).index(j)
                        for s in members]
                assert ranks[b, g, j, :c].tolist() == want
