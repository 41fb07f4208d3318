"""Reading a torch.profiler trace of the measured window.

`Spans` marks the benchmark's own calls into the system: when tracing, it
keeps each call's name, start and end on the wall clock (time.time_ns,
the clock the profiler's timeline is on). The profiler records the
device's activity alone: recording every host-side operation of a 40 s
serving window as well took minutes to read back. After the window,
`summarise` reduces the profiler's raw events to what the per-layer
metrics read:

  * the device's kernel, copy and set intervals inside the window span;
  * busy: the length of their union; idle gaps: the rest of the window,
    each named by the innermost host span open at its middle;
  * device time by operation name, and the part spent in the system's
    own kernels: those named as functions of the CUDA library its build
    made (listed with cuobjdump), and any Triton kernel in its cache.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import subprocess
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Set

import torch

WINDOW = "window"


class Spans:
    """(name, start ns, end ns) of the benchmark's calls, when tracing."""

    def __init__(self, on: bool):
        self.on = on
        self.done: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append((name, t0, time.time_ns()))


def base_name(name: str) -> str:
    """The function's own identifier in a mangled or demangled kernel name."""
    if name.startswith("_Z"):
        s = name[3:] if name.startswith("_ZN") else name[2:]
        parts = []
        while s and s[0].isdigit():
            m = re.match(r"(\d+)", s)
            n = int(m.group(1))
            s = s[m.end():]
            parts.append(s[:n])
            s = s[n:]
            if not name.startswith("_ZN"):
                break
        if parts:
            return parts[-1]
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, 1)[0]
    return s.split("::")[-1].strip()


def library_kernels(lib_path: Path) -> Set[str]:
    """Base names of the kernels in a CUDA shared library (cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    names = {base_name(m) for m in re.findall(r"Function (\S+?):", out)}
    if not names:
        out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                             check=True).stdout
        names = {base_name(m) for m in re.findall(r"Function : (\S+)", out)}
    return names


def triton_kernels(cache_dir: Optional[str]) -> Set[str]:
    """Names of the Triton kernels compiled into the cache directory."""
    names: Set[str] = set()
    if not cache_dir or not os.path.isdir(cache_dir):
        return names
    for path in Path(cache_dir).rglob("*.json"):
        try:
            meta = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        if isinstance(meta, dict) and isinstance(meta.get("name"), str):
            names.add(meta["name"])
    return names


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarise(prof, own: Set[str], spans: List[tuple]) -> Dict:
    """Window, busy, idle gaps by host span, device time by operation and
    the system's own kernels' time (seconds), from a finished profiler and
    the spans kept while it ran."""
    cuda = torch.autograd.DeviceType.CUDA
    device = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events() if ev.device_type() == cuda]
    win = [s for s in spans if s[0] == WINDOW]
    if not win or not device:
        return {}
    w0, w1 = win[0][1], win[0][2]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    union = _union([(a, b) for _, a, b in inside])
    busy = sum(b - a for a, b in union)
    by_op: Dict[str, float] = defaultdict(float)
    own_ns = 0
    for n, a, b in inside:
        by_op[n] += b - a
        if base_name(n) in own:
            own_ns += b - a
    # the innermost open host span, as a step function of time
    marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans) if spans[i][0] != WINDOW]
                   + [(b, 0, i) for i, (_, _, b) in enumerate(spans) if spans[i][0] != WINDOW])
    times, names, stack = [], [], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        times.append(t)
        names.append(spans[stack[-1]][0] if stack else "outside spans")
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in union for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        k = bisect.bisect_right(times, (a + b) / 2) - 1
        gaps[names[k] if k >= 0 else "outside spans"] += b - a
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "own_s": own_ns * 1e-9,
        "device_s": sum(b - a for _, a, b in inside) * 1e-9,
        "device_ops": [[n[:160], v * 1e-9] for n, v in top],
        "idle_gaps": [[n, v * 1e-9] for n, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
