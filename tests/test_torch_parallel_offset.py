"""The query offset (t_start / pos_offset) of Pallas rows 1, 7, 8 and 11 vs
the JAX package (CPU, f32).

Under sequence sharding a rank's query row s sits at global position
t_start + s while K/V cover the whole sequence (parallel/context.py). The
JAX package passes that offset to nsa_select_and_cmp_pallas (pos_offset,
row 1), flash_banded_bwd_onepass (row 7), flash_banded_bwd (row 8) and
flash_banded_bwd_diag (row 11); here their plain versions in the port, at
the same offset, are held to those kernels in interpret mode (scale_on_q
off, fed the port's row statistics, as tests/test_torch_varlen.py does
for seq_start), within 1e-5 (absolute for forward outputs, of each
gradient's max |value| for gradients); offsets of 64 and 40 rows (40
straddles the kernels' 64-key tiles). The same call at offset 0 (the
planted fault) must miss JAX by more than 1e-2. Then the dispatch layer:
compressed_attention and sliding_window_attention at an offset equal the
rows of a full call, forward and backward.

Packed documents under sequence sharding (varlen with sp): rows 1, 3, 5
(both modes), 6, 7, 8 and 11 take seq_start together with the offset
(the local rows' starts, packed positions). Their plain versions are held
to the Pallas kernels with both arguments in interpret mode on packings
in which a document starts before the offset and goes on past it,
within 1e-5 (selection sets exactly); two planted faults must each miss
by more than 1e-2 (sets: differ): the call at offset 0 with the same
seq_start, and the call at the offset without seq_start. The dispatch
layer with both equals the rows of the full packed call, forward and
backward; nsa_prefill refuses seq_start under a K/V gather without the
keys' starts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsa_vibe_tpu.ops import tuning as jtuning
from nsa_vibe_tpu.ops.pallas import flash_bwd as jflash_bwd
from nsa_vibe_tpu.ops.pallas import scorer as jscorer
from nsa_vibe_tpu.ops.pallas.flash import flash_banded, stats_rows
from nsa_vibe_tpu.ops.pallas.flash_diag import flash_banded_bwd_diag, flash_banded_diag
from nsa_vibe_tpu_torch.core import nsa as tnsa
from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.ops import attention as tattn
from nsa_vibe_tpu_torch.ops import varlen as tvarlen
from nsa_vibe_tpu_torch.ops.block_index import build_M_csl_on, num_cmp_blocks
from nsa_vibe_tpu_torch.ops.cuda.banded_attn import banded_attn
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd import banded_bwd
from nsa_vibe_tpu_torch.ops.cuda.banded_bwd_1p import banded_bwd_1p
from nsa_vibe_tpu_torch.ops.cuda.select_blocks import select_blocks, selection_map
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import select_cmp
from nsa_vibe_tpu_torch.ops.cuda.win_bwd_diag import win_bwd_diag
from nsa_vibe_tpu_torch.ops.reference import attention_delta
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel

L, D_, L_SEL, N_SEL, W = 8, 4, 16, 4, 24
S_FULL = 128
B, G, H, DH = 2, 2, 3, 16
LOG2E = np.float32(1.4426950408889634)
TOL = 1e-5
OFFSETS = (64, 40)
# per packed row: documents that start before both offsets and go on past
# them (row 0: [32, 82); row 1: [0, 70))
DOC_LENS = ((20, 50, 40), (70, 30))


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(t, j, rel, msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, atol=rel * max(np.abs(j).max(), 1e-12),
                               rtol=0, err_msg=msg)


def _flat(x, fill):
    """[B,S,G,h] -> the TPU kernels' [B*G, 1, stats_rows(S, h)] row statistics."""
    b, s, g, h = x.shape
    flat = np.asarray(x, np.float32).transpose(0, 2, 1, 3).reshape(b * g, 1, s * h)
    return jnp.pad(jnp.asarray(flat), ((0, 0), (0, 0), (0, stats_rows(s, h) - s * h)),
                   constant_values=fill)


def _unflat(x, s):
    return np.asarray(x)[:, 0, :s * H].reshape(B, G, s, H).transpose(0, 2, 1, 3)


def _operands(mode, t_start, seed):
    """Q, dO of the S_FULL - t_start rows at [t_start, S_FULL); K/V of the
    whole sequence (its window keys or its compressed tokens)."""
    s = S_FULL - t_start
    S_kv = S_FULL if mode == "win" else num_cmp_blocks(S_FULL, L, D_)
    Q, K, V, dO = (_rand(*shape, seed=seed + i) for i, shape in enumerate(
        ((B, s, G, H, DH), (B, G, S_kv, DH), (B, G, S_kv, DH), (B, s, G, H, DH))))
    kw = dict(w=W) if mode == "win" else dict(l=L, d=D_)
    return (Q, K, V, dO), kw, DH ** -0.5


@pytest.fixture
def jax_scorer_scale_off_q(monkeypatch):
    jscorer.nsa_select_and_cmp_pallas.clear_cache()
    monkeypatch.setattr(jscorer, "_scale_on_q", lambda: False)
    yield
    jscorer.nsa_select_and_cmp_pallas.clear_cache()


@pytest.mark.parametrize("t_start", OFFSETS)
def test_row1_plain_at_pos_offset_matches_the_tpu_kernel(t_start, jax_scorer_scale_off_q):
    (Q, Kc, Vc, _), _, scale = _operands("cmp", t_start, seed=20)
    s = Q.shape[1]
    kw = dict(scale=scale, l=L, d=D_, l_sel=L_SEL, n_top=N_SEL)
    M = build_M_csl_on(S_FULL, L, D_, L_SEL, "cpu")
    sel, O, lse = select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw, return_lse=True,
                             pos_offset=t_start)
    jsel, jO, jl = jscorer.nsa_select_and_cmp_pallas(
        *map(jnp.asarray, (Q, Kc, Vc)), jnp.asarray(M.numpy()), **kw, block_q=16,
        cmp_chunk=16, interpret=True, pos_offset=t_start)
    np.testing.assert_allclose(O.numpy(), np.asarray(jO), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _unflat(jl, s) / LOG2E, atol=TOL, rtol=0)
    jsel = torch.from_numpy(np.array(jsel))
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(jsel))
    assert torch.equal(sel[..., :3], jsel[..., :3])            # forced slots, in order
    t = torch.arange(t_start, S_FULL)[None, :, None, None]
    assert bool(((sel < 0) | (sel * L_SEL <= t)).all())        # causal at global positions
    O0 = select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw)[1]         # the planted offset 0
    assert np.abs(O0.numpy() - np.asarray(jO)).max() > 1e-2


@pytest.mark.parametrize("t_start", OFFSETS)
@pytest.mark.parametrize("row,mode", [("7", "win"), ("7", "cmp"), ("8", "win"), ("8", "cmp"),
                                      ("11", "win")])
def test_banded_backward_plain_at_t_start_matches_the_tpu_kernel(row, mode, t_start,
                                                                 monkeypatch):
    """Rows 7 (flash_banded_bwd_onepass), 8 (flash_banded_bwd) and 11
    (flash_banded_bwd_diag): dQ, dK, dV at t_start."""
    (Q, K, V, dO), kw, scale = _operands(mode, t_start, seed=30)
    O, lse = banded_attn(*map(_t, (Q, K, V)), mode=mode, **kw, scale=scale, return_lse=True,
                         t_start=t_start)
    delta = attention_delta(_t(dO), O)
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jkeys = dict(jtuning._load(), **{"win.bwd_diag": 0})   # row 7's kernel itself
    monkeypatch.setattr(jtuning, "_load", lambda: jkeys)
    jargs = [jnp.asarray(x) for x in (Q, K, V, dO)]
    jstats = (_flat(lse.numpy() * LOG2E, 1e30), _flat(delta.numpy(), 0.0))
    if row == "11":
        jg = flash_banded_bwd_diag(*jargs, *jstats, w=kw["w"], scale=scale, block_q=32,
                                   interpret=True, t_start=t_start, scale_on_q=False)
        port = win_bwd_diag
    elif row == "8":
        jg = jflash_bwd.flash_banded_bwd(*jargs, *jstats, mode=mode, **kw, scale=scale,
                                         block_q=32, block_k=64, interpret=True,
                                         t_start=t_start, scale_on_q=False)
        port = banded_bwd
    else:
        jg = jflash_bwd.flash_banded_bwd_onepass(*jargs, *jstats, mode=mode, **kw, scale=scale,
                                                 block_q=32, block_k=64, interpret=True,
                                                 t_start=t_start, scale_on_q=False,
                                                 fastpath=False)
        port = banded_bwd_1p
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    pkw = dict(w=kw["w"]) if row == "11" else dict(mode=mode, **kw)
    args = (*map(_t, (Q, K, V, dO)), lse, delta)
    grads = port(*args, **pkw, scale=scale, t_start=t_start)
    for name, g, j in zip("QKV", grads, jg):
        _close_rel(g, j, TOL, f"d{name}")
    at0 = port(*args, **pkw, scale=scale)                      # the planted offset 0
    assert max(float(np.abs(g.numpy() - np.asarray(j)).max()) for g, j in zip(at0, jg)) > 1e-2


@pytest.mark.parametrize("mode", ["win", "cmp"])
def test_dispatch_at_an_offset_equals_the_rows_of_a_full_call(mode):
    """compressed_attention / sliding_window_attention on rows [t0, S) at
    t_start t0 give those rows of the full call, and their gradients."""
    (Q, K, V, _), kw, scale = _operands(mode, 0, seed=40)
    t0 = 48

    def run(q, k, v, t_start):
        if mode == "win":
            return tattn.sliding_window_attention(q, k, v, W, scale, t_start=t_start)
        return tattn.compressed_attention(q, k, v, l=L, d=D_, scale=scale, t_start=t_start)

    full = [_t(x).requires_grad_(True) for x in (Q, K, V)]
    part = [_t(Q[:, t0:]).requires_grad_(True)] + [_t(x).requires_grad_(True) for x in (K, V)]
    Of, Op = run(*full, 0), run(*part, t0)
    np.testing.assert_allclose(Op.detach().numpy(), Of[:, t0:].detach().numpy(), atol=TOL,
                               rtol=0)
    dO = _t(_rand(*Op.shape, seed=41))
    gf = torch.autograd.grad(Of[:, t0:], full, dO)
    gp = torch.autograd.grad(Op, part, dO)
    _close_rel(gp[0], gf[0][:, t0:].numpy(), TOL, "dQ")
    for name, a, b in zip("KV", gp[1:], gf[1:]):
        _close_rel(a, b.numpy(), TOL, f"d{name}")


def _packed_starts(t_start):
    """seq_start [B, S_FULL] of DOC_LENS packed one row each, and its rows
    from t_start on; a document crosses t_start in every row."""
    rng = np.random.RandomState(3)
    ds = np.stack([tvarlen.pack_documents_aligned(
        [rng.randint(1, 64, size=n).astype(np.int32) for n in row], S_FULL, L_SEL, 1)[1][0]
        for row in DOC_LENS]).astype(np.int32)
    assert (ds[:, t_start] < t_start).all()
    return ds, np.ascontiguousarray(ds[:, t_start:])


def _miss(got, want):
    return max(float(np.abs(g.detach().numpy() - np.asarray(w)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("t_start", OFFSETS)
@pytest.mark.parametrize("row,mode", [("3", "win"), ("5", "win"), ("5", "cmp")])
def test_banded_forward_plain_with_seq_start_at_t_start_matches_the_tpu_kernel(row, mode,
                                                                             t_start):
    """Rows 3 (flash_banded_diag) and 5 (flash_banded, both modes): O, lse."""
    (Q, K, V, _), kw, scale = _operands(mode, t_start, seed=60)
    s = Q.shape[1]
    _, ds = _packed_starts(t_start)
    jq = dict(interpret=True, return_lse=True, t_start=t_start, seq_start=jnp.asarray(ds),
              scale_on_q=False)
    if row == "3":
        jO, jl = flash_banded_diag(*map(jnp.asarray, (Q, K, V)), w=kw["w"], scale=scale,
                                   block_q=32, **jq)
    else:
        jO, jl = flash_banded(*map(jnp.asarray, (Q, K, V)), mode=mode, **kw, scale=scale,
                              block_q=32, block_k=32, **jq)
    pkw = dict(mode=mode, **kw, scale=scale, return_lse=True)
    O, lse = banded_attn(*map(_t, (Q, K, V)), **pkw, t_start=t_start, seq_start=_t(ds))
    np.testing.assert_allclose(O.numpy(), np.asarray(jO), atol=TOL, rtol=0)
    jl = _unflat(jl, s) / LOG2E
    empty = lse.numpy() >= 1e29
    assert np.array_equal(empty, jl >= 1e29)
    np.testing.assert_allclose(np.where(empty, 0, lse.numpy()), np.where(empty, 0, jl),
                               atol=TOL, rtol=0)
    args = map(_t, (Q, K, V))
    assert _miss([banded_attn(*args, **pkw, seq_start=_t(ds))[0]], [jO]) > 1e-2   # offset 0
    args = map(_t, (Q, K, V))
    assert _miss([banded_attn(*args, **pkw, t_start=t_start)[0]], [jO]) > 1e-2    # no seq_start


@pytest.mark.parametrize("t_start", OFFSETS)
@pytest.mark.parametrize("row", ["1", "6"])
def test_scorer_plain_with_seq_start_at_pos_offset_matches_the_tpu_kernel(
        row, t_start, jax_scorer_scale_off_q):
    """Row 1 (nsa_select_and_cmp_pallas: sets, forced slots in order, O,
    lse) and row 6 (nsa_select_pallas: sets)."""
    (Q, Kc, Vc, _), _, scale = _operands("cmp", t_start, seed=70)
    s = Q.shape[1]
    _, ds = _packed_starts(t_start)
    kw = dict(scale=scale, l=L, d=D_, l_sel=L_SEL, n_top=N_SEL)
    jq = dict(block_q=16, cmp_chunk=16, interpret=True, pos_offset=t_start,
              seq_start=jnp.asarray(ds))
    S_sel = S_FULL // L_SEL
    if row == "1":
        M = build_M_csl_on(S_FULL, L, D_, L_SEL, "cpu")
        sel, O, lse = select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw, return_lse=True,
                                 pos_offset=t_start, seq_start=_t(ds))
        jsel, jO, jl = jscorer.nsa_select_and_cmp_pallas(*map(jnp.asarray, (Q, Kc, Vc)),
                                                         jnp.asarray(M.numpy()), **kw, **jq)
        np.testing.assert_allclose(O.numpy(), np.asarray(jO), atol=TOL, rtol=0)
        jl = _unflat(jl, s)
        empty = lse.numpy() >= 1e29
        assert np.array_equal(empty, jl >= 1e29)
        np.testing.assert_allclose(np.where(empty, 0, lse.numpy()),
                                   np.where(empty, 0, jl / LOG2E), atol=TOL, rtol=0)
        for fault in (dict(seq_start=_t(ds)), dict(pos_offset=t_start)):
            assert _miss([select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw, **fault)[1]], [jO]) > 1e-2

        def port(**k):
            return select_cmp(*map(_t, (Q, Kc, Vc)), M, **kw, **k)[0]
    else:
        M = selection_map(Kc.shape[2], S_sel, L, D_, L_SEL)
        jsel = jscorer.nsa_select_pallas(*map(jnp.asarray, (Q, Kc)), jnp.asarray(M.numpy()),
                                         **kw, **jq)

        def port(**k):
            return select_blocks(*map(_t, (Q, Kc)), S_sel=S_sel, **kw, **k)
        sel = port(pos_offset=t_start, seq_start=_t(ds))
    jsel = torch.from_numpy(np.array(jsel))
    assert torch.equal(canonicalize_sel(sel), canonicalize_sel(jsel))
    assert torch.equal(sel[..., :3], jsel[..., :3])            # forced slots, in order
    t = torch.arange(t_start, S_FULL)[None, :, None, None]
    first = _t(ds // L_SEL)[:, :, None, None]
    assert bool(((sel < 0) | ((sel * L_SEL <= t) & (sel >= first))).all())
    for fault in (dict(seq_start=_t(ds)), dict(pos_offset=t_start)):   # offset 0; no seq_start
        assert not torch.equal(canonicalize_sel(port(**fault)), canonicalize_sel(jsel))


@pytest.mark.parametrize("t_start", OFFSETS)
@pytest.mark.parametrize("row,mode", [("7", "win"), ("7", "cmp"), ("8", "win"), ("8", "cmp"),
                                      ("11", "win")])
def test_banded_backward_plain_with_seq_start_at_t_start_matches_the_tpu_kernel(
        row, mode, t_start, monkeypatch):
    """Rows 7, 8 and 11 with seq_start at t_start: dQ, dK, dV."""
    (Q, K, V, dO), kw, scale = _operands(mode, t_start, seed=80)
    _, ds = _packed_starts(t_start)
    O, lse = banded_attn(*map(_t, (Q, K, V)), mode=mode, **kw, scale=scale, return_lse=True,
                         t_start=t_start, seq_start=_t(ds))
    delta = attention_delta(_t(dO), O)
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    jkeys = dict(jtuning._load(), **{"win.bwd_diag": 0})   # row 7's kernel itself
    monkeypatch.setattr(jtuning, "_load", lambda: jkeys)
    jargs = [jnp.asarray(x) for x in (Q, K, V, dO)]
    jstats = (_flat(lse.numpy() * LOG2E, 1e30), _flat(delta.numpy(), 0.0))
    jq = dict(scale=scale, interpret=True, t_start=t_start, seq_start=jnp.asarray(ds),
              scale_on_q=False)
    if row == "11":
        jg = flash_banded_bwd_diag(*jargs, *jstats, w=kw["w"], block_q=32, **jq)
        port = win_bwd_diag
    elif row == "8":
        jg = jflash_bwd.flash_banded_bwd(*jargs, *jstats, mode=mode, **kw, block_q=32,
                                         block_k=64, **jq)
        port = banded_bwd
    else:
        jg = jflash_bwd.flash_banded_bwd_onepass(*jargs, *jstats, mode=mode, **kw, block_q=32,
                                                 block_k=64, fastpath=False, **jq)
        port = banded_bwd_1p
    jflash_bwd.flash_banded_bwd_onepass.clear_cache()
    pkw = dict(w=kw["w"]) if row == "11" else dict(mode=mode, **kw)
    args = (*map(_t, (Q, K, V, dO)), lse, delta)
    grads = port(*args, **pkw, scale=scale, t_start=t_start, seq_start=_t(ds))
    for name, g, j in zip("QKV", grads, jg):
        _close_rel(g, j, TOL, f"d{name}")
    assert _miss(port(*args, **pkw, scale=scale, seq_start=_t(ds)), jg) > 1e-2    # offset 0
    assert _miss(port(*args, **pkw, scale=scale, t_start=t_start), jg) > 1e-2     # no seq_start


@pytest.mark.parametrize("mode", ["win", "cmp", "select_cmp"])
def test_dispatch_with_seq_start_at_an_offset_equals_the_rows_of_a_full_call(mode):
    """compressed_attention, sliding_window_attention and fused_select_cmp
    on rows [t0, S) at t0 with those rows' seq_start give those rows of the
    full packed call, and their gradients."""
    (Q, K, V, _), kw, scale = _operands("win" if mode == "win" else "cmp", 0, seed=90)
    t0 = 48
    ds_full, ds = _packed_starts(t0)
    M = build_M_csl_on(S_FULL, L, D_, L_SEL, "cpu")

    def run(q, k, v, t_start, seq):
        if mode == "win":
            return tattn.sliding_window_attention(q, k, v, W, scale, t_start=t_start,
                                                  seq_start=seq)
        if mode == "cmp":
            return tattn.compressed_attention(q, k, v, l=L, d=D_, scale=scale, t_start=t_start,
                                              seq_start=seq)
        return tattn.fused_select_cmp(q, k, v, M, scale=scale, l=L, d=D_, l_sel=L_SEL,
                                      n_top=N_SEL, force_init=True, force_local=2,
                                      seq_start=seq, pos_offset=t_start)[1]

    full = [_t(x).requires_grad_(True) for x in (Q, K, V)]
    part = [_t(Q[:, t0:]).requires_grad_(True)] + [_t(x).requires_grad_(True) for x in (K, V)]
    Of, Op = run(*full, 0, _t(ds_full)), run(*part, t0, _t(ds))
    np.testing.assert_allclose(Op.detach().numpy(), Of[:, t0:].detach().numpy(), atol=TOL,
                               rtol=0)
    dO = _t(_rand(*Op.shape, seed=91))
    gf = torch.autograd.grad(Of[:, t0:], full, dO)
    gp = torch.autograd.grad(Op, part, dO)
    _close_rel(gp[0], gf[0][:, t0:].numpy(), TOL, "dQ")
    for name, a, b in zip("KV", gp[1:], gf[1:]):
        _close_rel(a, b.numpy(), TOL, f"d{name}")


def test_an_offset_with_seq_start_raises():
    """What stays refused with both: a K/V gather without the keys' starts
    (nsa_prefill), and a query offset that is not a host int >= 0."""
    (Q, K, V, dO), kw, scale = _operands("win", 64, seed=50)
    _, ds = _packed_starts(64)
    cfg = NSAConfig(dim=32, n_heads=6, n_kv_groups=2, d_k=16, d_v=16, l=L, d=D_, l_sel=L_SEL,
                    n_sel=N_SEL, w=W)
    params = tnsa.init_nsa_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(B, S_FULL - 64, cfg.dim)
    with pytest.raises(ValueError, match="seq_start_kv"):
        tnsa.nsa_prefill(params, x, cfg, seq_start=_t(ds), t0=64,
                         gather_kv=lambda a: torch.cat([a, a], dim=2))
    with pytest.raises(ValueError, match="offset"):
        win_bwd_diag(*map(_t, (Q, K, V, dO)), torch.zeros(B, Q.shape[1], G, H),
                     torch.zeros(B, Q.shape[1], G, H), w=W, scale=scale, seq_start=_t(ds),
                     t_start=-64)
