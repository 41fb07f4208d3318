"""One run of one cell of BENCHMARK.json.

The cell names a configuration (perfbench/configs/<name>.json) and a
traffic mix (perfbench/traffic/<mix>.json, which names its driver in
perfbench/drivers/); perfbench/cells/<workload>.json holds the cell's own
settings and the limits of its comparison. Each metric is read by
perfbench/metrics/<metric>.py from the driver's record and, in a traced
run, the trace's summary. A later cell, mix or metric is a new file.

A run: check for the cards the cell asks for; set-up (the driver builds
the system from the seed and warms every shape the cell uses); the window
of `--seconds` (under torch.profiler with `--trace 1`); the peak memory;
the metrics; the system's state freed; the reference, and the comparison
that decides `correct`; a check that nothing loaded JAX or the JAX
package; the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

import torch

from perfbench import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nsa_vibe_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(workload: str, man: Optional[dict] = None) -> SimpleNamespace:
    """Everything a cell names, read from its files."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    settings = load_json(HERE / "cells" / f"{workload}.json")
    cfg = {k: v for k, v in config.items() if not isinstance(v, (dict, list)) or k == "train"}
    cfg.update(settings.get("model", {}))
    hp = dict(config.get("train", {}), **settings.get("train", {}))
    cfg.pop("train", None)
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in man["per_layer"] if workload in m.get("workloads", [workload])]
    return SimpleNamespace(workload=workload, chips=cell["chips"], cfg=cfg, hp=hp,
                           traffic=traffic, cell=settings, e2e=e2e, per_layer=layer)


def driver(name: str) -> ModuleType:
    return load_module(HERE / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def read_metrics(specs: list, rec: dict, summary: Optional[dict]) -> Dict[str, dict]:
    out = {}
    for m in specs:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(rec, summary)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class HostEvent:
    """A CUDA event's interface on the host clock, for runs on the CPU."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other: "HostEvent") -> float:
        return (other.t - self.t) * 1e3

    def synchronize(self) -> None:
        pass


def make_ctx(res: SimpleNamespace, seed: int, seconds: float, tracing: bool, device):
    cuda = device.type == "cuda"

    def event():
        if not cuda:
            return HostEvent()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    return SimpleNamespace(
        workload=res.workload, cfg=res.cfg, hp=res.hp, traffic=res.traffic, cell=res.cell,
        seed=seed, seconds=seconds, trace=tracing, device=device,
        spans=trace.Spans(tracing), event=event,
        sync=(lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None),
        empty_cache=torch.cuda.empty_cache if cuda else (lambda: None))


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(res: SimpleNamespace, seed: int, seconds: float, tracing: bool, device,
        t_start: float) -> dict:
    """Set-up, window, metrics, reference and comparison of one cell."""
    ctx = make_ctx(res, seed, seconds, tracing, device)
    drv = driver(res.traffic["driver"])
    sys_run = drv.setup(ctx)
    setup_s = time.time() - t_start
    prof = None
    if tracing:
        acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with ctx.spans(trace.WINDOW):
            rec = sys_run.window(seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec["setup_s"] = setup_s
    summary = None
    if tracing:
        own = trace.triton_kernels(os.environ.get("TRITON_CACHE_DIR"))
        if device.type == "cuda":
            from perfbench import program
            own |= trace.library_kernels(program.library_path())
        t0 = time.perf_counter()
        summary = trace.summarise(prof, own, ctx.spans.done)
        del prof
        print(f"[trace] read in {time.perf_counter() - t0:.1f} s; {len(own)} kernels of "
              "the port known", file=sys.stderr)
    metrics = read_metrics(res.per_layer if tracing else res.e2e, rec, summary)
    program_readings = getattr(sys_run, "readings", None)
    sys_run.release()
    if program_readings is None:
        program_readings = sys_run.readings
    del sys_run
    gc.collect()
    want = drv.reference(ctx, "float32", program_readings)
    got = drv.compare(program_readings, want, ctx)
    limits = res.cell["limits"]   # the numbers this cell compares, each with its limit
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items() if k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": res.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev_info}
    if summary:
        dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    res = resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < res.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {res.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    print(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(res, args.seed, args.seconds, bool(args.trace), device, t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}: the benchmark may run neither JAX nor the "
              "JAX package", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
