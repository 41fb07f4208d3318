"""optimizer_fused_share.train: the share of leaves the multi-tensor
optimizer updated, read from the port's counters, and its silence where the
port has no such counters (a port from before them)."""

import sys

import pytest

from nsa_vibe_tpu_torch import utils
from nsa_vibe_tpu_torch.utils import trace

from perfbench import harness

MAN = harness.manifest()
NAME = "optimizer_fused_share.train"


def read(monkeypatch, rec, counters):
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    spec = [m for m in MAN["per_layer"] if m["name"] == NAME]
    return {k: v["value"] for k, v in harness.read_metrics(spec, rec, None).items()}


def test_it_lists_the_training_cells():
    (m,) = [m for m in MAN["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["m7c-125m.train-2k", "m7c-350m.train-2k"]
    assert m["layer"] == "optimizer (train/optim.py)" and m["moves"] == "train_tokens_per_s"


@pytest.mark.parametrize("counters,share", [
    ({"optimizer.fused_leaves": 246}, 100.0),
    ({"optimizer.fused_leaves": 123 * 3, "optimizer.plain_leaves": 123}, 75.0),
    ({"optimizer.plain_leaves": 246}, 0.0)])
def test_share_of_leaves(monkeypatch, counters, share):
    assert read(monkeypatch, {"steps": 2}, counters) == pytest.approx({NAME: share})


def test_nothing_to_read_gives_no_metric(monkeypatch):
    assert read(monkeypatch, {"steps": 2}, {"prefill.device_allocs": 3}) == {}
    assert read(monkeypatch, {}, {"optimizer.fused_leaves": 246}) == {}
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "nsa_vibe_tpu_torch.utils.trace", None)
    assert harness.read_metrics(
        [m for m in MAN["per_layer"] if m["name"] == NAME], {"steps": 2}, None) == {}
