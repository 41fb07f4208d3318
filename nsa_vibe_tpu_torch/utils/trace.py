"""Spans and counters at the port's layer boundaries, recorded only while a
profiler runs.

`span(name)` marks a layer boundary (the train step's forward, backward and
optimizer; prefill, its scorer and its cache writes; admission) and
`count(name, n)` adds to a named counter. The recorder is on exactly while a
torch.profiler session is active (torch.autograd.profiler._is_profiler_enabled),
or between `enable()` and `disable()`. Off, `span` reads the flags and returns
one shared no-op context, and `count` returns: nothing is allocated or kept.

On, a span keeps its id, its parent's id, its name, its thread and its host
start and end on time.time_ns, the clock of torch.profiler's timeline. The
parent is the innermost span open on the same thread: autograd's device
thread, which runs remat's recomputation inside the backward, has a stack of
its own, so a span opened there is a root and no span is a child of two. Once
CUDA is initialised, a span also records a timing event on the current stream
at open and at close (not while the stream is being captured into a graph).
It enters torch.profiler.record_function(name) too, so a profiler with CPU
activity (the trainer's --profile) shows it on the same timeline.

The record stays in memory until `reset()`; `spans()` and `counters()` read
it and `durations()` turns it into milliseconds, host or device, whole or
self (a span's duration less the part its children cover).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
_forced = False
_ids = itertools.count(1)
_local = threading.local()
_done: List["Span"] = []
_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def enable() -> None:
    """Record without a profiler, until `disable()`."""
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def on() -> bool:
    """True while the recorder records."""
    return _forced or _profiler._is_profiler_enabled


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _event():
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One span: the context `span` returns while on, and its record."""

    __slots__ = ("id", "parent", "name", "thread", "t0", "t1", "ev0", "ev1", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.id = self.parent = self.ev0 = self.ev1 = self._rf = None
        self.thread = self.t0 = self.t1 = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        self.t0 = time.time_ns()
        self.ev0 = _event()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        if self.ev0 is not None:
            self.ev1 = _event()
        self.t1 = time.time_ns()
        _done.append(self)


def span(name: str):
    """A span around the with-block while the recorder is on; else the shared
    no-op context."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while the recorder is on."""
    if _forced or _profiler._is_profiler_enabled:
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n


class _AllocCount:
    def __init__(self, name: str, device: torch.device):
        self.name, self.device, self.n0 = name, device, 0

    def _allocs(self) -> int:
        s = torch.cuda.memory_stats_as_nested_dict(self.device)
        return s.get("num_device_alloc", 0) + s.get("num_alloc_retries", 0)

    def __enter__(self) -> None:
        self.n0 = self._allocs()

    def __exit__(self, *exc) -> None:
        count(self.name, self._allocs() - self.n0)


def device_allocs(name: str, device: torch.device):
    """Counts into `name` the caching allocator's cudaMalloc calls and
    retries (num_device_alloc + num_alloc_retries) made inside the
    with-block, on a CUDA device while the recorder is on; elsewhere the
    shared no-op context, which reads no allocator statistics."""
    if device.type != "cuda" or not on():
        return _NULL
    return _AllocCount(name, device)


def spans() -> List[Span]:
    """The finished spans, in the order they closed."""
    return list(_done)


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset() -> None:
    """Empty the record."""
    _done.clear()
    _counters.clear()


def _covered(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of `intervals` inside [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def durations(record: List[Span], name: str, device: bool = False,
              own: bool = False) -> List[float]:
    """Milliseconds of each span of `record` named `name`: on the host (end -
    start), or with device=True between its CUDA events (a span without
    events is left out). own=True gives the self time: the duration less
    the part of it that the span's children cover."""
    kids: Dict[Optional[int], list] = defaultdict(list)
    if own:
        for s in record:
            kids[s.parent].append(s)
    out = []
    for s in record:
        if s.name != name or (device and s.ev1 is None):
            continue
        if device:
            ms = s.ev0.elapsed_time(s.ev1)
            inner = [(s.ev0.elapsed_time(c.ev0), s.ev0.elapsed_time(c.ev1))
                     for c in kids[s.id] if c.ev1 is not None]
        else:
            ms = (s.t1 - s.t0) * 1e-6
            inner = [((c.t0 - s.t0) * 1e-6, (c.t1 - s.t0) * 1e-6) for c in kids[s.id]]
        out.append(ms - _covered(inner, 0.0, ms) if own else ms)
    return out
