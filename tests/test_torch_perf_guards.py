"""Static guards over the port's hot modules: the no-Python-loop and
no-host-sync rules of the JAX package's tests/test_perf_guards.py (:53,
:65), on nsa_vibe_tpu_torch.

A Python loop in a decode step's code issues its body's ops once per
iteration from the host; a read of a device value (`.item()`,
`.tolist()`, `.cpu()`, `.numpy()`) or `synchronize()` makes the host wait
for the card, and neither can be captured in the CUDA graph that
models/decode_graph.py replays. The loop rule covers the modules the
ragged decode step and its graph run (the JAX rule's modules and the
graph module); the sync rule also covers core/nsa.py and core/cache.py,
as the JAX rule does. The card-side check of the same property is
`torch.cuda.set_sync_debug_mode("error")` in chip_smoke.py and
tests/test_torch_gpu.py.
"""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "nsa_vibe_tpu_torch"

HOT_MODULES = [
    "core/decode.py",
    "ops/selection.py",
    "ops/attention.py",
    "ops/compress.py",
    "ops/rope.py",
    "models/decode_graph.py",
]

# (module, function) pairs allowed to loop, each over a static bound
LOOP_ALLOW = {
    ("ops/selection.py", "forced_block_ids"),       # force_local static slots
    ("core/decode.py", "nsa_prefill_via_decode"),   # the per-token oracle (JAX: a lax.scan)
}

HOST_SYNC_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _loops_in(fn):
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.While)):
            yield node


@pytest.mark.parametrize("rel", HOT_MODULES)
def test_no_python_loops_in_hot_modules(rel):
    tree = ast.parse((PKG / rel).read_text())
    offenders = []
    for fn in _functions(tree):
        if (rel, fn.name) in LOOP_ALLOW:
            continue
        for loop in _loops_in(fn):
            offenders.append(f"{rel}:{loop.lineno} in {fn.name}")
    assert not offenders, f"Python loops in hot path: {offenders}"


@pytest.mark.parametrize("rel", HOT_MODULES + ["core/nsa.py", "core/cache.py"])
def test_no_host_syncs_in_hot_modules(rel):
    tree = ast.parse((PKG / rel).read_text())
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name in HOST_SYNC_CALLS:
                offenders.append(f"{rel}:{node.lineno} {name}()")
    assert not offenders, f"host syncs in hot path: {offenders}"


def test_hot_modules_exist_and_allow_list_is_used():
    for rel in HOT_MODULES:
        assert (PKG / rel).exists(), rel
    for rel, name in LOOP_ALLOW:
        tree = ast.parse((PKG / rel).read_text())
        fns = [fn for fn in _functions(tree) if fn.name == name]
        assert fns and any(True for fn in fns for _ in _loops_in(fn)), (rel, name)


def test_guards_catch_a_loop_and_a_sync():
    src = "def f(x):\n    for i in range(3):\n        x = x + 1\n    return x.item()\n"
    tree = ast.parse(src)
    assert [loop.lineno for fn in _functions(tree) for loop in _loops_in(fn)] == [2]
    calls = [n.func.attr for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    assert "item" in calls and HOST_SYNC_CALLS & set(calls) == {"item"}
