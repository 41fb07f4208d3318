"""The port's kernel modules vs the JAX package, and the dispatch rule.

On the CPU each wrapper runs its plain PyTorch version; here it is held
against the JAX oracle (`kernel="reference"` functions) and against the
Pallas kernel it replaces, run in interpret mode as the JAX package's
own tests run it. float32, tolerance 1e-5 absolute (sum order differs).
The scorer's sel_idx must equal the Pallas kernel's exactly (same output
contract) and the oracle's as a set; inputs are random normals, whose
group scores are well separated.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops import reference as jref
from nsa_vibe_tpu.ops import selection as jsel
from nsa_vibe_tpu.ops.pallas.flash_diag import flash_banded_diag
from nsa_vibe_tpu.ops.pallas.scorer import nsa_select_and_cmp_pallas
from nsa_vibe_tpu.ops.pallas.sel_flash import selection_flash_pallas
from nsa_vibe_tpu.ops.pallas.selection import selection_attention_pallas
from nsa_vibe_tpu_torch.ops import reference as tref
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda import banded_attn as ba_mod
from nsa_vibe_tpu_torch.ops.cuda import sel_attn as sa_mod
from nsa_vibe_tpu_torch.ops.cuda import select_blocks as sb_mod
from nsa_vibe_tpu_torch.ops.cuda import select_cmp as sc_mod
from nsa_vibe_tpu_torch.ops.cuda import win_attn as wa_mod
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

TOL = 1e-5
SCALE = 0.25


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


def _scorer_case(B, S, G, h, D, l, d, l_sel, seed=0):
    S_cmp = num_cmp_blocks(S, l, d)
    Q = _r(seed, B, S, G, h, D)
    Kc, Vc = _r(seed + 1, B, G, S_cmp, D), _r(seed + 2, B, G, S_cmp, D)
    M = build_M_csl(S, l, d, l_sel)
    return Q, Kc, Vc, M


@pytest.mark.parametrize("B,S,G,h,l,d,l_sel,n_top", [
    (2, 64, 2, 2, 8, 4, 16, 4),
    (1, 70, 2, 3, 8, 4, 16, 5),      # odd h, S not divisible by l_sel
    (1, 96, 1, 3, 16, 8, 16, 2),     # n_top < n_forced: forced slots only
])
def test_select_cmp_plain_matches_jax(B, S, G, h, l, d, l_sel, n_top):
    Q, Kc, Vc, M = _scorer_case(B, S, G, h, 16, l, d, l_sel)
    kw = dict(scale=SCALE, l=l, d=d, l_sel=l_sel, n_top=n_top)
    sel, O = sc_mod.select_cmp(_t(Q), _t(Kc), _t(Vc), _t(M), **kw)
    # the Pallas kernel it replaces (interpret mode): same output contract
    psel, pO, _ = nsa_select_and_cmp_pallas(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(Vc),
                                            jnp.asarray(M), **kw, block_q=32, cmp_chunk=8,
                                            interpret=True)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(psel))
    _close(O, pO)
    # the jnp oracle: cmp branch + Eq. 8-12 pipeline, selection as a set
    t = jnp.arange(S)
    nct = jnp.asarray(np.minimum(num_cmp_blocks(np.arange(1, S + 1), l, d), M.shape[0]))
    want_O = jref.compressed_attention(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(Vc), nct, SCALE)
    _close(O, want_O)
    _close(tref.compressed_attention(_t(Q), _t(Kc), _t(Vc), _t(nct), SCALE), want_O)
    p_grp = jsel.selection_scores(jnp.asarray(Q), jnp.asarray(Kc), jnp.asarray(M), SCALE, nct)
    want = jsel.select_topn_blocks(p_grp, n_top, t, l_sel)
    np.testing.assert_array_equal(canonicalize_sel(sel).numpy(), np.asarray(want))


def _sel_case(B, S, S_kv, G, h, D, l_sel, n_top, seed=3):
    Q = _r(seed, B, S, G, h, D)
    K, V = _r(seed + 1, B, G, S_kv, D), _r(seed + 2, B, G, S_kv, D)
    t = np.arange(S_kv - S, S_kv, dtype=np.int32)
    p = np.random.RandomState(seed + 3).rand(B, S, G, -(-S_kv // l_sel)).astype(np.float32)
    sel = np.asarray(jsel.select_topn_blocks(jnp.asarray(p), n_top, jnp.asarray(t), l_sel))
    return Q, K, V, t, sel


@pytest.mark.parametrize("B,S,G,h,l_sel,n_top", [(2, 64, 2, 2, 8, 4), (1, 70, 2, 3, 16, 3)])
def test_sel_attn_plain_matches_jax_prefill(B, S, G, h, l_sel, n_top):
    Q, K, V, t, sel = _sel_case(B, S, S, G, h, 16, l_sel, n_top)
    got = sa_mod.sel_attn(_t(Q), _t(K), _t(V), _t(sel), _t(t), l_sel=l_sel, scale=SCALE)
    _close(got, jref.selection_attention(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                         jnp.asarray(sel), jnp.asarray(t), l_sel, SCALE))
    pal = selection_flash_pallas(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                 jnp.asarray(sel), l_sel=l_sel, scale=SCALE, block_q=16,
                                 kv_batch=2, interpret=True)
    _close(got, pal)


def test_sel_attn_repeated_ids_are_a_set():
    """The scorer's forced-first form repeats ids ({0,0,0} early on); the
    result must equal that of the canonical sorted-unique form."""
    B, S, G, h, l, d, l_sel = 1, 80, 2, 3, 8, 4, 16
    Q, Kc, Vc, M = _scorer_case(B, S, G, h, 16, l, d, l_sel, seed=7)
    sel, _ = sc_mod.select_cmp(_t(Q), _t(Kc), _t(Vc), _t(M), scale=SCALE, l=l, d=d,
                               l_sel=l_sel, n_top=4)
    assert sel[0, 0, 0].tolist() == [0, 0, 0, -1]             # t=0: forced slots repeat
    K, V = _t(_r(8, B, G, S, 16)), _t(_r(9, B, G, S, 16))
    t = torch.arange(S)
    a = sa_mod.sel_attn(_t(Q), K, V, sel, t, l_sel=l_sel, scale=SCALE)
    b = sa_mod.sel_attn(_t(Q), K, V, canonicalize_sel(sel), t, l_sel=l_sel, scale=SCALE)
    torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    want = jref.selection_attention(jnp.asarray(Q), jnp.asarray(K.numpy()),
                                    jnp.asarray(V.numpy()), jnp.asarray(sel.numpy()),
                                    jnp.arange(S), l_sel, SCALE)
    _close(a, want)


def test_sel_attn_plain_matches_jax_decode():
    """Decode shape: one query per row, per-row depth t, a cache of
    capacity C (rows past t are stale and must not be read)."""
    B, G, h, D, C, l_sel = 3, 2, 3, 16, 100, 16
    Q, K, V = _r(10, B, 1, G, h, D), _r(11, B, G, C, D), _r(12, B, G, C, D)
    t = np.array([[5], [37], [99]], np.int32)
    p = np.random.RandomState(13).rand(B, 1, G, -(-C // l_sel)).astype(np.float32)
    sel = np.asarray(jsel.select_topn_blocks(jnp.asarray(p), 4, jnp.asarray(t), l_sel))
    got = sa_mod.sel_attn(_t(Q), _t(K), _t(V), _t(sel), _t(t), l_sel=l_sel, scale=SCALE)
    pal = selection_attention_pallas(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                     jnp.asarray(sel), jnp.asarray(t), l_sel=l_sel,
                                     scale=SCALE, interpret=True)
    _close(got, pal)
    for i in range(B):
        want = jref.selection_attention(jnp.asarray(Q[i:i + 1]), jnp.asarray(K[i:i + 1]),
                                        jnp.asarray(V[i:i + 1]), jnp.asarray(sel[i:i + 1]),
                                        jnp.asarray(t[i]), l_sel, SCALE)
        _close(got[i:i + 1], want)


@pytest.mark.parametrize("B,S,G,h,w", [(2, 64, 2, 2, 16), (1, 100, 2, 3, 32), (1, 40, 1, 2, 256)])
def test_win_attn_plain_matches_jax(B, S, G, h, w):
    Q, K, V = _r(20, B, S, G, h, 16), _r(21, B, G, S, 16), _r(22, B, G, S, 16)
    got = wa_mod.win_attn(_t(Q), _t(K), _t(V), w=w, scale=SCALE)
    _close(got, jref.sliding_window_attention(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V),
                                              jnp.arange(S), w, SCALE))
    pal = flash_banded_diag(jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V), w=w, scale=SCALE,
                            block_q=32, interpret=True)
    _close(got, pal)


# ------------------------------------------------------------ dispatch rule

WRAPPERS = [(sc_mod, "select_cmp"), (sa_mod, "sel_attn"), (wa_mod, "win_attn"),
            (ba_mod, "banded_attn"), (sb_mod, "select_blocks")]


@pytest.mark.parametrize("mod,name", WRAPPERS)
def test_wrapper_calls_plain_only_under_the_cpu_branch(mod, name):
    """Read the dispatch: the plain version is called only inside
    `if resolve_kernel(...) == "plain": return ...`; everything after that
    branch launches the kernel (or raises)."""
    fn = next(n for n in ast.parse(inspect.getsource(mod)).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    first = fn.body[1] if isinstance(fn.body[0], ast.Expr) else fn.body[0]  # skip docstring
    test = first.test
    assert isinstance(first, ast.If) and isinstance(test, ast.Compare)
    assert test.left.func.id == "resolve_kernel" and test.comparators[0].value == "plain"
    assert isinstance(first.body[-1], ast.Return) and not first.orelse
    plain = f"{name}_plain"
    calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name) and c.func.id == plain]
    inside = [c for c in ast.walk(first) if isinstance(c, ast.Call)
              and isinstance(c.func, ast.Name) and c.func.id == plain]
    assert len(calls) == len(inside) == 1
    if name in ("win_attn", "banded_attn"):
        # both launch through banded_attn.launch_banded, which calls the
        # bf16 and the f32 kernel and no plain version
        launches = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Name) and c.func.id == "launch_banded"]
        helper = next(n for n in ast.parse(inspect.getsource(ba_mod)).body
                      if isinstance(n, ast.FunctionDef) and n.name == "launch_banded")
        called = {c.func.attr if isinstance(c.func, ast.Attribute) else c.func.id
                  for c in ast.walk(helper) if isinstance(c, ast.Call)
                  and isinstance(c.func, (ast.Attribute, ast.Name))}
        assert {"nsa_banded_fwd_mma", "nsa_banded_attn"} <= called
        assert not any(c.endswith("_plain") for c in called)
    else:
        launches = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute) and c.func.attr == f"nsa_{name}"]
    assert len(launches) == 1


@pytest.mark.parametrize("mod,name", WRAPPERS)
def test_wrapper_never_takes_plain_off_the_cpu(mod, name, monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version: a
    meta tensor (neither CPU nor CUDA) makes the wrapper raise."""
    def trap(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(mod, f"{name}_plain", trap)
    m = torch.empty((1, 4, 1, 2, 8), device="meta")
    kv = torch.empty((1, 1, 4, 8), device="meta")
    args = {
        "select_cmp": (m, kv, kv, torch.empty((1, 1), device="meta")),
        "sel_attn": (m, kv, kv, torch.empty((1, 4, 1, 2), dtype=torch.int32, device="meta"),
                     torch.arange(4)),
        "win_attn": (m, kv, kv),
        "banded_attn": (m, kv, kv),
        "select_blocks": (m, kv),
    }[name]
    kw = {"select_cmp": dict(scale=1.0, l=2, d=1, l_sel=2, n_top=2),
          "sel_attn": dict(l_sel=2, scale=1.0), "win_attn": dict(w=2, scale=1.0),
          "banded_attn": dict(mode="cmp", l=2, d=1, scale=1.0),
          "select_blocks": dict(S_sel=2, scale=1.0, l=2, d=1, l_sel=2, n_top=2)}[name]
    with pytest.raises(ValueError, match="device"):
        getattr(mod, name)(*args, **kw)
