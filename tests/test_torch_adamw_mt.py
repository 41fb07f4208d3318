"""The multi-tensor AdamW (ops/cuda/adamw_mt.py, csrc/adamw_mt.cu) on the CPU:
its launch planner against the element coverage the kernels need, its
launch groups a dtype, the kernels' arithmetic (emulated here in f32,
rounded to the leaf's dtype after each operation, as
csrc/adamw_mt.cu::adamw_elem does) against the tensor-op path of
train/optim.py bit for bit, and the dispatch, which keeps CPU tensors on the
tensor ops and counts them as plain. The kernels themselves run in
tests/test_torch_gpu.py on the card."""

import random
from pathlib import Path

import pytest
import torch

from nsa_vibe_tpu_torch.core.config import M7C_125M, ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.core.nsa import fuse_projections
from nsa_vibe_tpu_torch.models.llama_block import init_block_params
from nsa_vibe_tpu_torch.models.tinylm import init_model_params
from nsa_vibe_tpu_torch.ops.cuda import adamw_mt
from nsa_vibe_tpu_torch.train import optim
from nsa_vibe_tpu_torch.train.trainer import load_config
from nsa_vibe_tpu_torch.train.train_step import init_train_state, make_train_step, param_leaves
from nsa_vibe_tpu_torch.utils import trace

H100_CTAS = adamw_mt.CTAS_PER_SM * 132


def _leaf_sizes(mcfg):
    """The trainable leaves' sizes of a model, in param_leaves order (one
    block built, its sizes repeated n_layers times)."""
    blk = init_block_params(torch.Generator().manual_seed(0), mcfg, torch.bfloat16,
                            torch.device("cpu"))
    blk["attn"] = fuse_projections(blk["attn"])
    dim, vocab = mcfg.nsa.dim, mcfg.vocab_size
    tree = {"embed": torch.empty(vocab, dim), "blocks": [blk] * mcfg.n_layers,
            "final_norm": torch.empty(dim), "lm_head": torch.empty(dim, vocab)}
    return [t.numel() for _, t in param_leaves(tree)]


def _m7c_350m():
    """m7c-350M as the trainer reads it (configs/m7c_350m.yaml)."""
    return load_config(str(Path(__file__).resolve().parents[1] / "configs" / "m7c_350m.yaml"))[0]


def segments(launch):
    """(cta, leaf, s, e): the leaf-relative range [s, e) of each leaf that
    each CTA covers, as csrc/adamw_mt.cu::walk finds them."""
    start, n, out = launch.start, len(launch.leaves), []
    for b in range(launch.ctas):
        lo = b * launch.per_cta
        hi = min(lo + launch.per_cta, start[n])
        a, z = 0, n - 1
        while a < z:
            m = (a + z) >> 1
            if start[m + 1] <= lo:
                a = m + 1
            else:
                z = m
        j = a
        while j < n and start[j] < hi:
            s, e = max(lo, start[j]), min(hi, start[j + 1])
            if s < e:
                out.append((b, launch.leaves[j], s - start[j], e - start[j]))
            j += 1
    return out


def _random_sizes(n, seed):
    rng = random.Random(seed)
    return [rng.choice([0, 1, 3, 7, 8, 9, 4097, rng.randrange(1, 300000)]) for _ in range(n)]


@pytest.mark.parametrize("case,vec,max_leaves", [
    ("m7c-125m", 8, adamw_mt.MAX_LEAVES), ("m7c-350m", 8, adamw_mt.MAX_LEAVES),
    ("m7c-125m-f32", 4, adamw_mt.MAX_LEAVES), ("2000 leaves", 8, adamw_mt.MAX_LEAVES),
    ("tiny, 5 a launch", 8, 5), ("90 a launch (CUDA < 12.1)", 8, 90)])
def test_plan_covers_every_element_of_every_leaf_once(case, vec, max_leaves):
    if case.startswith("m7c-125m"):
        sizes = _leaf_sizes(M7C_125M)
        assert len(sizes) == 123 and sum(sizes) == 78_295_332
    elif case == "m7c-350m":
        sizes = _leaf_sizes(_m7c_350m())
        assert len(sizes) == 243 and sum(sizes) == 290_033_736
    elif case == "2000 leaves":
        sizes = _random_sizes(2000, 0)
    else:
        sizes = [1, 3, 4097, 0, 8, 9, 16, 0, 0, 5000, 1, 2, 3] + _random_sizes(40, 1)
    launches = adamw_mt.plan(sizes, vec, H100_CTAS, max_leaves)
    nonempty = [i for i, n in enumerate(sizes) if n]
    assert len(launches) == -(-len(nonempty) // max_leaves)
    assert [i for x in launches for i in x.leaves] == nonempty   # each leaf in one launch
    slot = 0
    for x in launches:
        assert len(x.leaves) <= max_leaves and x.slot == slot and 1 <= x.ctas <= H100_CTAS
        assert x.start == tuple([0] + list(torch.tensor([sizes[i] for i in x.leaves])
                                           .cumsum(0).tolist()))
        assert (x.ctas - 1) * x.per_cta < x.start[-1] <= x.ctas * x.per_cta
        assert x.ctas == H100_CTAS or x.per_cta <= adamw_mt.THREADS * vec
        slot += x.ctas
    pieces = {}
    for x in launches:
        for b, leaf, s, e in segments(x):
            assert 0 <= s < e <= sizes[leaf] and b < x.ctas
            pieces.setdefault(leaf, []).append((s, e))
    assert sorted(pieces) == nonempty
    for leaf, got in pieces.items():            # the pieces tile [0, size) with no overlap
        got.sort()
        assert got[0][0] == 0 and got[-1][1] == sizes[leaf]
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def _r(x, dtype):
    return x.to(dtype).float()


def _kernel_arithmetic(p, g, mu, nu, k):
    """csrc/adamw_mt.cu::adamw_elem over whole tensors: each operation an f32
    one, rounded to the leaf's dtype."""
    dt = p.dtype
    mul = lambda a, b: _r(a * b, dt)                       # noqa: E731
    add = lambda a, b: _r(a + b, dt)                       # noqa: E731
    div = lambda a, b: _r(a / b, dt)                       # noqa: E731
    f = lambda c: torch.tensor(c, dtype=torch.float32)     # noqa: E731  a Python scalar as f32
    p, g, m, v = p.float(), g.float(), mu.float(), nu.float()
    g = mul(g, f(k["inv"]))
    if not k["gn"] < f(k["max_norm"]):
        g = mul(div(g, _r(k["gn"], dt)), f(k["max_norm"]))
    m = add(mul(f(1 - optim.B1), g), mul(f(optim.B1), m))
    v = add(mul(f(1 - optim.B2), mul(g, g)), mul(f(optim.B2), v))
    d = add(_r(torch.sqrt(div(v, _r(k["bc2"], dt))), dt), f(optim.EPS))
    u = div(div(m, _r(k["bc1"], dt)), d)
    u = add(u, mul(f(k["wd"]), p))
    u = mul(_r(-k["lr"], dt), u)
    return add(p, u).to(dt), m.to(dt), v.to(dt)


STEPS = {   # (count, gradient scale, inv_accum, loss, clipped): one step of each kind
    "first (lr 0)": (0, 1.0, 1.0, 1.0, True), "clipped": (1, 50.0, 1.0, 1.0, True),
    "unclipped": (2, 0.005, 1.0, 1.0, False), "accum 3, clipped": (2, 10.0, 1 / 3, 1.0, True),
    "past warm-up": (7, 0.005, 1.0, 1.0, False),
    "skipped (NaN loss)": (2, 1.0, 1.0, float("nan"), True)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", list(STEPS))
def test_kernel_arithmetic_is_the_tensor_ops_bit_for_bit(kind, dtype):
    count, scale, inv, loss, clipped = STEPS[kind]
    tcfg = TrainConfig(lr=3e-3, warmup_steps=4, steps=20, max_grad_norm=1.0, weight_decay=0.1)
    gen = torch.Generator().manual_seed(3)
    shapes = [(64, 48), (1,), (3,), (4097,), (200, 3)]
    params = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    grads = [(torch.randn(s, generator=gen) * scale).to(dtype) for s in shapes]
    state = {"mu": [(torch.randn(s, generator=gen) * 0.01).to(dtype) for s in shapes],
             "nu": [(torch.rand(s, generator=gen) * 1e-4).to(dtype) for s in shapes],
             "count": torch.tensor(count, dtype=torch.int32)}
    before = [t.clone() for t in params + state["mu"] + state["nu"]]
    grad_norm, good = optim.norm_and_good(params, grads, state, torch.tensor(loss), inv)
    lr, _, bc1, bc2 = optim._step_scalars(state["count"], tcfg)
    k = {"inv": inv, "max_norm": tcfg.max_grad_norm, "wd": tcfg.weight_decay, "gn": grad_norm,
         "lr": lr, "bc1": bc1, "bc2": bc2}
    want = [_kernel_arithmetic(p, g, m, v, k)
            for p, g, m, v in zip(params, grads, state["mu"], state["nu"])]
    optim.apply_update_(params, grads, state, tcfg, grad_norm, good, inv)
    assert bool(grad_norm >= tcfg.max_grad_norm) == clipped
    if not bool(good):
        assert kind.startswith("skipped") and int(state["count"]) == count
        want = [(before[i], before[i + 5], before[i + 10]) for i in range(5)]
    else:
        assert int(state["count"]) == count + 1
    for (p, m, v), p1, m1, v1 in zip(want, params, state["mu"], state["nu"]):
        for a, b in ((p, p1), (m, m1), (v, v1)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("case", ["one dtype", "bf16 and f32 interleaved", "three dtypes",
                                  "f32 first"])
def test_launch_groups_cover_each_leaf_once_in_order_within_its_dtype(case):
    """by_dtype's groups, planned as adamw_mt.Plan plans them (slots one
    after another), hold every non-empty leaf in one launch of its dtype's
    group, in order, and give the groups disjoint partial-norm slots."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    rng = random.Random(case)
    dtypes = {"one dtype": [bf] * 123, "bf16 and f32 interleaved": [bf, f32] * 400,
              "three dtypes": [rng.choice([bf, f32, f16]) for _ in range(300)],
              "f32 first": [f32] * 3 + [bf] * 5}[case]
    sizes = [rng.choice([0, 1, 3, 4097, rng.randrange(1, 100000)]) for _ in dtypes]
    groups = adamw_mt.by_dtype(dtypes)
    assert list(groups) == list(dict.fromkeys(dtypes))           # in order of first appearance
    seen, slots, slot = [], [], 0
    for dt, index in groups.items():
        assert all(dtypes[i] == dt for i in index) and index == sorted(index)
        launches = adamw_mt.plan([sizes[i] for i in index], 16 // dt.itemsize, H100_CTAS,
                                 slot=slot)
        for x in launches:
            seen += [index[j] for j in x.leaves]
            slots += range(x.slot, x.slot + x.ctas)
        slot += sum(x.ctas for x in launches)
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]
    assert slots == list(range(slot))


@pytest.mark.parametrize("inv", [1.0, 0.25])
def test_norm_and_good_on_the_cpu_is_global_norm(inv):
    gen = torch.Generator().manual_seed(5)
    grads = [torch.randn(s, generator=gen).to(torch.bfloat16) for s in ((30, 7), (5,), (1,))]
    state = optim.init_optimizer(grads)

    def norm_and_good(loss):
        return optim.norm_and_good(grads, grads, state, torch.tensor(loss), inv)

    norm, good = norm_and_good(2.0)
    assert torch.equal(norm, optim.global_norm([g * inv for g in grads])) and bool(good)
    assert not bool(norm_and_good(float("inf"))[1]) and "plan" not in state
    grads[1][2] = float("nan")
    assert not bool(norm_and_good(2.0)[1])


def test_cpu_tensors_keep_the_tensor_op_path_and_count_as_plain():
    mcfg = ModelConfig(vocab_size=64, n_layers=1,
                       nsa=NSAConfig(dim=64, n_heads=4, n_kv_groups=2, d_k=16, d_v=16,
                                     l=8, d=4, l_sel=16, n_sel=4, w=32))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, steps=10)
    state = init_train_state(init_model_params(mcfg, torch.Generator().manual_seed(0),
                                               device="cpu"), tcfg)
    n = len(param_leaves(state.params))
    step = make_train_step(mcfg, tcfg)
    toks = torch.randint(0, 64, (2, 1, 2, 41), generator=torch.Generator().manual_seed(1))
    launches = adamw_mt.norm_and_good.launches, adamw_mt.update_.launches
    trace.reset()
    trace.enable()
    try:
        for t in toks:
            state, m = step(state, t)
            assert bool(m["good"])
        counted = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert counted == {"optimizer.plain_leaves": 2 * n}
    assert (adamw_mt.norm_and_good.launches, adamw_mt.update_.launches) == launches
    assert int(state.opt_state["count"]) == 2 and "plan" not in state.opt_state
