"""The control and the planted faults, at a size the CPU holds.

The control is the reference with its matmul operands in float8, put in
the system's place: it must read well above the system in bfloat16. The
faults are planted in the system under the rest of a run (the harness's
look for a card skipped), which must then come out not correct under the
cells' own limits: a step that returns its state unchanged, half of the
batch left out (the mean over the rest), a token altered where it is
produced. The exchange between chips does not exist in these one-card
cells."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
spec = importlib.util.spec_from_file_location("perfbench_control", ROOT / "perfbench/control.py")
control = importlib.util.module_from_spec(spec)
spec.loader.exec_module(control)


def limits(workload: str) -> dict:
    return json.loads((ROOT / "perfbench/cells" / f"{workload}.json").read_text())["limits"]


def test_control_reads_far_above_the_system_in_training():
    res = tiny.cell("train", {}, dtype="bfloat16", batch=8, seq=256)
    r = control.readings(res, 11, 0.0, ["program", "fp8"], tiny.CPU)
    # `loss` is the number that both training cells compare and the control fails
    assert r["fp8"]["loss"] >= 3 * r["program"]["loss"], r


def test_control_reads_far_above_the_system_in_serving():
    res = tiny.cell("serve", {}, dtype="bfloat16")
    r = control.readings(res, 12, 1.0, ["program", "fp8"], tiny.CPU)
    assert r["fp8"]["logit_gap"] >= 3 * max(r["program"]["logit_gap"], 1e-3), r


def _wrap_step(monkeypatch, fault):
    from nsa_vibe_tpu_torch.train import train_step as ts
    real = ts.make_train_step

    def make(mcfg, tcfg):
        step = real(mcfg, tcfg)

        def faulty(state, batch):
            if fault == "half_batch":
                return step(state, batch[:, : batch.shape[1] // 2])
            leaves = [t for _, t in ts.param_leaves(state.params)]
            opt = state.opt_state["mu"] + state.opt_state["nu"] + [state.opt_state["count"]]
            keep = [t.detach().clone() for t in leaves + opt]
            state, m = step(state, batch)
            with torch.no_grad():
                for t, k in zip(leaves + opt, keep):
                    t.copy_(k)
            return state, m

        return faulty

    monkeypatch.setattr(ts, "make_train_step", make)


@pytest.mark.parametrize("workload", ["m7c-125m.train-2k", "m7c-350m.train-2k"])
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_faults_come_out_not_correct(monkeypatch, workload, fault):
    _wrap_step(monkeypatch, fault)
    out = tiny.run(tiny.cell("train", limits(workload), dtype="bfloat16", batch=8, seq=256))
    assert not out["correct"], out["checks"]


def test_altered_token_comes_out_not_correct(monkeypatch):
    from nsa_vibe_tpu_torch.utils import sampling
    real = sampling.sample_logits

    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "sample_logits", altered)
    out = tiny.run(tiny.cell("serve", limits("m7c-125m.serve-long"), dtype="bfloat16"),
                   seconds=1.0)
    assert not out["correct"], out["checks"]


def test_unbroken_tiny_runs_are_correct_under_the_cells_limits():
    for kind, w in (("train", "m7c-125m.train-2k"), ("serve", "m7c-125m.serve-long")):
        out = tiny.run(tiny.cell(kind, limits(w), dtype="bfloat16", **(
            {"batch": 8, "seq": 256} if kind == "train" else {})), seconds=1.0)
        assert out["correct"], (w, out["checks"])
