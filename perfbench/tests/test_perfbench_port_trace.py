"""The readers of the port's own spans and counters (perfbench/port_trace.py,
metrics/*.py) on a made-up record, and their silence where the port has no
recorder or recorded nothing."""

import sys

import pytest

from nsa_vibe_tpu_torch import utils
from nsa_vibe_tpu_torch.utils import trace

from perfbench import harness

MAN = harness.manifest()
NEW = {"forward_ms.train", "backward_ms.train", "optimizer_ms.train",
       "optimizer_host_ms.train", "step_host_ms.train", "prefill_host_ms.serve",
       "scorer_ms.serve", "cache_ms.serve", "prefill_allocs.serve"}


class Ev:
    """A CUDA event's elapsed_time on a made-up device clock (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def span(name, host, dev=None):
    s = trace.Span(name)
    s.t0, s.t1 = int(host[0] * 1e6), int(host[1] * 1e6)
    if dev is not None:
        s.ev0, s.ev1 = Ev(dev[0]), Ev(dev[1])
    return s


def specs(cell):
    return [m for m in MAN["per_layer"] if m["name"] in NEW and cell in m["workloads"]]


def read(cell, rec, monkeypatch, record, counters=None):
    monkeypatch.setattr(trace, "spans", lambda: list(record))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))
    return {k: v["value"] for k, v in harness.read_metrics(specs(cell), rec, None).items()}


def train_record():
    out = []
    for k in range(2):            # two steps, 100 ms apart on both clocks
        o = 100.0 * k
        out += [span("train.forward", (o + 1, o + 11), (o + 5, o + 35)),
                span("train.backward", (o + 11, o + 16), (o + 35, o + 85)),
                span("train.optimizer", (o + 16, o + 24), (o + 85, o + 97)),
                span("prefill.score", (o + 2, o + 3), (o + 6, o + 9)),
                span("train.step", (o, o + 25), (o + 4, o + 98))]
    return out


@pytest.mark.parametrize("cell", ["m7c-125m.train-2k", "m7c-350m.train-2k"])
def test_training_readers(cell, monkeypatch):
    got = read(cell, {"steps": 2}, monkeypatch, train_record())
    assert got == pytest.approx({"forward_ms.train": 30.0, "backward_ms.train": 50.0,
                                 "optimizer_ms.train": 12.0, "optimizer_host_ms.train": 8.0,
                                 "step_host_ms.train": 25.0})


def test_serving_readers(monkeypatch):
    record = []
    for k in range(4):            # four admissions of two layers each
        o = 200.0 * k
        record += [span("prefill.score", (o + 1, o + 2), (o + 10, o + 40)),
                   span("prefill.cache", (o + 2, o + 3), (o + 40, o + 41)),
                   span("prefill.score", (o + 3, o + 4), (o + 41, o + 71)),
                   span("prefill.cache", (o + 4, o + 5), (o + 71, o + 72)),
                   span("prefill", (o, o + 20), (o + 9, o + 90)),
                   span("cache.admit", (o + 21, o + 22), (o + 90, o + 90.5)),
                   span("cache.admit", (o + 22, o + 23), (o + 90.5, o + 91))]
    got = read("m7c-125m.serve-long", {"admitted": 4, "ttft_ms": [1.0]}, monkeypatch, record,
               {"prefill.device_allocs": 6})
    assert got == pytest.approx({"prefill_host_ms.serve": 20.0, "scorer_ms.serve": 60.0,
                                 "cache_ms.serve": 3.0, "prefill_allocs.serve": 1.5})


def test_every_new_metric_lists_its_cells():
    listed = {m["name"]: m["workloads"] for m in MAN["per_layer"] if m["name"] in NEW}
    assert set(listed) == NEW
    for name, cells in listed.items():
        want = (["m7c-125m.train-2k", "m7c-350m.train-2k"] if name.endswith(".train")
                else ["m7c-125m.serve-long"])
        assert cells == want


@pytest.mark.parametrize("cell,rec", [("m7c-125m.train-2k", {"steps": 2}),
                                      ("m7c-125m.serve-long", {"admitted": 4})])
def test_nothing_to_read_gives_no_metric(cell, rec, monkeypatch):
    # spans without CUDA events: the device readers are silent, the host ones read
    host_only = [span(s.name, (s.t0 * 1e-6, s.t1 * 1e-6)) for s in train_record()]
    got = read(cell, rec, monkeypatch, host_only if "train" in cell else [])
    assert set(got) == ({"optimizer_host_ms.train", "step_host_ms.train"}
                        if "train" in cell else set())
    # no steps or admissions in the record
    assert read(cell, {}, monkeypatch, train_record(), {"prefill.device_allocs": 1}) == {}
    # a port from before the recorder
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "nsa_vibe_tpu_torch.utils.trace", None)
    assert harness.read_metrics(specs(cell), rec, None) == {}
