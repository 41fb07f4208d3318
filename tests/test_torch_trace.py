"""The port's span and counter recorder (nsa_vibe_tpu_torch/utils/trace.py)
and the spans at its layer boundaries, on the CPU: off outside a profiler,
parents and self times under one, a clock shared with the profiler's own
timeline, and the spans a train step, a prefill and an admission leave."""

import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from nsa_vibe_tpu_torch.core.cache import admit_row, init_cache, ragged_cache
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models.tinylm import init_model_params, model_prefill_with_caches
from nsa_vibe_tpu_torch.train.train_step import init_train_state, make_train_step
from nsa_vibe_tpu_torch.utils import trace

NSA = NSAConfig(dim=32, n_heads=2, n_kv_groups=1, d_k=16, d_v=16, l=8, d=4, l_sel=8, n_sel=2,
                w=8)
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_record():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _names(record):
    return [s.name for s in record]


def _profiled(fn):
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        out = fn()
    return prof, out


def test_off_records_nothing_and_returns_one_shared_context():
    assert not trace.on()
    a, b = trace.span("x"), trace.span("y")
    assert a is b
    with a:
        trace.count("n", 3)
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.device_allocs("c", torch.device("cpu")) is a


def test_nested_spans_parents_self_times_counters_and_reset():
    def run():
        with trace.span("outer"):
            time.sleep(0.01)
            with trace.span("inner"):
                time.sleep(0.02)
                trace.count("n", 2)
            with trace.span("inner"):
                trace.count("n", 5)
        return trace.spans()

    _, record = _profiled(run)
    assert not trace.on()
    assert _names(record) == ["inner", "inner", "outer"]        # in closing order
    outer = record[-1]
    assert outer.parent is None and all(s.parent == outer.id for s in record[:2])
    assert {s.thread for s in record} == {threading.get_ident()}
    assert all(s.ev0 is None and s.ev1 is None for s in record)   # no CUDA here
    whole = trace.durations(record, "outer")[0]
    inner = trace.durations(record, "inner")
    own = trace.durations(record, "outer", own=True)[0]
    assert whole >= 30.0 and inner[0] >= 20.0
    assert own == pytest.approx(whole - sum(inner), abs=1e-9) and own >= 10.0
    assert trace.durations(record, "inner", own=True) == inner   # no children
    assert trace.durations(record, "outer", device=True) == []   # no events
    assert trace.counters() == {"n": 7}
    trace.reset()
    assert trace.spans() == [] and trace.counters() == {}


def test_explicit_enable_records_without_a_profiler():
    trace.enable()
    with trace.span("a"):
        trace.count("n")
    trace.disable()
    with trace.span("b"):
        trace.count("n")
    assert _names(trace.spans()) == ["a"] and trace.counters() == {"n": 1}


def test_a_span_on_another_thread_takes_no_parent_from_this_one():
    opened, release = threading.Event(), threading.Event()

    def worker():
        opened.wait()
        with trace.span("other"):
            pass
        release.set()

    t = threading.Thread(target=worker)
    t.start()
    trace.enable()
    with trace.span("main"):
        opened.set()
        release.wait(10)
    t.join(10)
    record = {s.name: s for s in trace.spans()}
    assert record["other"].parent is None and record["main"].parent is None
    assert record["other"].thread != record["main"].thread
    # the main span's self time is its whole: the other thread's span is no child
    assert trace.durations(trace.spans(), "main", own=True) == \
        trace.durations(trace.spans(), "main")


def test_threads_lose_no_span_and_no_count():
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.enable()

        def work():
            for _ in range(n):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("n")
                        trace.count("m", 2)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    record = trace.spans()
    assert len(record) == 2 * n_threads * n and len({s.id for s in record}) == len(record)
    by_id = {s.id: s for s in record}
    assert all(by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
               for s in record if s.name == "inner")
    assert trace.counters() == {"n": n_threads * n, "m": 2 * n_threads * n}


def test_device_self_time_from_the_events():
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    def made(i, parent, name, a, b):
        s = trace.Span(name)
        s.id, s.parent, s.ev0, s.ev1 = i, parent, Ev(a), Ev(b)
        return s

    record = [made(2, 1, "kid", 1.0, 3.0), made(3, 1, "kid", 2.5, 4.0),
              made(4, 1, "late", 9.0, 12.0), made(1, None, "top", 0.0, 10.0)]
    assert trace.durations(record, "top", device=True) == [10.0]
    # children cover [1, 4] and [9, 10] of [0, 10]
    assert trace.durations(record, "top", device=True, own=True) == [6.0]


def test_host_interval_contains_the_profilers_own_event():
    def run():
        with trace.span("clock.check"):
            torch.randn(64, 64) @ torch.randn(64, 64)

    prof, _ = _profiled(run)
    (s,) = trace.spans()
    evs = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.check"]
    assert len(evs) == 1
    a, b = evs[0].start_ns(), evs[0].start_ns() + evs[0].duration_ns()
    assert s.t0 <= a <= b <= s.t1


def _train(remat):
    mcfg = ModelConfig(vocab_size=32, n_layers=1, nsa=NSA, remat=remat)
    tcfg = TrainConfig(batch_size=2, seq_len=32, accum_steps=2, warmup_steps=1)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(init_model_params(mcfg, gen, device="cpu"), tcfg)
    step = make_train_step(mcfg, tcfg)
    tokens = torch.randint(0, 32, (2, 2, 33), generator=gen)
    return lambda: step(state, tokens)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_spans(remat):
    step = _train(remat)
    _profiled(step)
    record = trace.spans()
    train = [n for n in _names(record) if n.startswith("train.")]
    assert sorted(train) == sorted(["train.step", "train.forward", "train.forward",
                                    "train.backward", "train.backward", "train.optimizer"])
    by_id = {s.id: s for s in record}
    root = next(s for s in record if s.name == "train.step")
    assert all(by_id[s.parent] is root for s in record if s.name in
               ("train.forward", "train.backward", "train.optimizer"))
    scores = [by_id[s.parent].name for s in record if s.name == "prefill.score"]
    # one layer's scorer per micro-batch, and again in each backward when rematted
    want = ["train.forward"] * 2 + (["train.backward"] * 2 if remat else [])
    assert sorted(scores) == sorted(want)
    # every span lies inside train.step on one thread: self times add up to it once
    own = sum(x for n in set(_names(record)) for x in trace.durations(record, n, own=True))
    assert own == pytest.approx(trace.durations(record, "train.step")[0], rel=1e-9)
    # outside a profiler the same call records nothing
    trace.reset()
    step()
    assert trace.spans() == []


def test_prefill_and_admission_spans():
    mcfg = ModelConfig(vocab_size=32, n_layers=2, nsa=NSA)
    gen = torch.Generator().manual_seed(1)
    params = init_model_params(mcfg, gen, device="cpu")
    prompt = torch.randint(0, 32, (1, 40), generator=gen)
    batch = ragged_cache(init_cache(NSA, 2, 64, device="cpu"))

    def serve():
        with torch.no_grad():
            _, caches = model_prefill_with_caches(params, prompt, mcfg, 64)
            admit_row(batch, caches[0], 1)

    _profiled(serve)
    record = trace.spans()
    assert sorted(_names(record)) == sorted(["prefill"] + ["prefill.score"] * 2
                                            + ["prefill.cache"] * 2 + ["cache.admit"])
    pre = next(s for s in record if s.name == "prefill")
    by_id = {s.id: s for s in record}
    assert all(s.parent == pre.id for s in record if s.name == "prefill.cache")
    # the scorer runs inside each layer's block, under the prefill
    assert all(by_id[s.parent] is pre for s in record if s.name == "prefill.score")
    assert next(s for s in record if s.name == "cache.admit").parent is None
    assert trace.counters() == {}             # allocator statistics are the card's
    trace.reset()
    serve()
    assert trace.spans() == [] and trace.counters() == {}


def test_device_allocs_counts_the_allocators_calls(monkeypatch):
    stats = iter([{"num_device_alloc": 4, "num_alloc_retries": 1},
                  {"num_device_alloc": 7, "num_alloc_retries": 2}])
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda device: next(stats))
    trace.enable()
    with trace.device_allocs("allocs", SimpleNamespace(type="cuda")):
        pass
    assert trace.counters() == {"allocs": 4}
