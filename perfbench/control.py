#!/usr/bin/env python3
"""Readings that set a cell's limits: the system against the reference, and
the control (the reference in float8) and planted faults against it.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 10]
        [--variants program,fp8,half_batch]

For each seed, in one process: the cell's set-up (and, for a serving
cell, a window of --seconds at the cell's own load, whose finished
requests are checked), the system's readings, its state freed, then the
float32 reference and each variant put in the system's place, every one
compared with the reference as a run compares it. Prints one JSON line a
seed. The benchmark's own runs never run this; its limits come from it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.caches import use_checkout_caches  # noqa: E402

use_checkout_caches()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def worst_leaves(got: dict, want: dict) -> dict:
    """For readings kept by leaf, the leaf of the largest gap."""
    out = {}
    for k, w in want.items():
        if isinstance(w, dict) and isinstance(got.get(k), dict) and w:
            med = sorted(w.values())[len(w) // 2]
            out[k] = max(w, key=lambda n: abs(got[k][n] - w[n]) / max(w[n], med))
    return out


def readings(res, seed: int, seconds: float, variants, device) -> dict:
    ctx = harness.make_ctx(res, seed, seconds, False, device)
    drv = harness.driver(res.traffic["driver"])
    t0 = time.perf_counter()
    sys_run = drv.setup(ctx)
    if res.traffic["driver"] != "train":
        sys_run.window(seconds)
    prog = getattr(sys_run, "readings", None)
    sys_run.release()
    prog = prog or sys_run.readings
    del sys_run
    gc.collect()
    t1 = time.perf_counter()
    want = drv.reference(ctx, "float32", prog)
    t2 = time.perf_counter()
    out = {"seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1}
    for v in variants:
        got = prog if v == "program" else drv.reference(ctx, v, prog)
        out[v] = drv.compare(got, want, ctx)
        out[v + "_worst"] = worst_leaves(got, want)
        out[v + "_more"] = drv.diagnostics(got, want)
    out["variants_s"] = time.perf_counter() - t2
    if torch.cuda.is_available():
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--variants", default="program,fp8")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    res = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"[card] {harness.card_line()}", flush=True)
    for s in args.seeds.split(","):
        line = json.dumps(readings(res, int(s), args.seconds, args.variants.split(","), device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
