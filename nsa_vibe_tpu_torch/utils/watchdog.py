"""Out-of-process training watchdog (the port's own copy of
nsa_vibe_tpu/utils/watchdog.py).

Tails the run directory's heartbeat.jsonl (utils/heartbeat.py, written by
the trainer at log boundaries) and writes `.anomaly_type` + `.HALT` into
it on: heartbeat stall, throughput flatline, gate collapse (low entropy /
peaked max-gate / high collapsed fraction for N consecutive samples), or
vanishing gradients. The trainer polls `.HALT` each step and exits
gracefully (halt-and-resume, not auto-elastic). `trainer.py --watchdog`
runs `watch` in a thread of the trainer itself.

Run:  python -m nsa_vibe_tpu_torch.utils.watchdog --dir artifacts/train
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class WatchdogPolicy:
    heartbeat_stall_s: float = 180.0
    flatline_samples: int = 5          # consecutive samples with ~0 toks/s
    gate_entropy_min: float = 0.2
    gate_max_gate: float = 0.9
    gate_collapse_frac: float = 0.5
    gate_consecutive: int = 3
    grad_norm_min: float = 1e-8
    grad_consecutive: int = 3
    poll_s: float = 10.0


def _halt(run_dir: str, anomaly: str) -> None:
    with open(os.path.join(run_dir, ".anomaly_type"), "w") as f:
        f.write(anomaly + "\n")
    with open(os.path.join(run_dir, ".HALT"), "w") as f:
        f.write(f"halt requested by watchdog: {anomaly}\n")


def check_once(run_dir: str, policy: WatchdogPolicy, state: dict) -> Optional[str]:
    """One watchdog evaluation. Mutates `state` (consecutive counters);
    returns the anomaly string if a halt should fire.

    Stall baseline: heartbeats older than the watchdog's own start belong
    to a resumed run's previous life, so the stall clock runs from
    max(last heartbeat, watchdog start), and the other checks wait for a
    fresh beat; otherwise a watchdog attached to a resumed run would fire
    `heartbeat_stall` before the resume's first step."""
    start = state.setdefault("watch_start", time.time())
    try:
        with open(os.path.join(run_dir, "heartbeat.jsonl"), "rb") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    except OSError:
        return None
    if not lines:
        return None
    last = json.loads(lines[-1])

    hb_ts = last.get("ts", time.time())
    if time.time() - max(hb_ts, start) > policy.heartbeat_stall_s:
        return "heartbeat_stall"
    if hb_ts < start:
        return None   # no fresh beat since this watchdog started

    recent = [json.loads(ln) for ln in lines[-max(policy.flatline_samples, 8):]]

    # throughput flatline
    tp = [t for t in (r.get("toks_per_s") for r in recent) if t is not None]
    if len(tp) >= policy.flatline_samples and all(
            t <= 1e-3 for t in tp[-policy.flatline_samples:]):
        return "throughput_flatline"

    # gate collapse
    g_bad = (last.get("gate_entropy", 1.0) < policy.gate_entropy_min
             or last.get("gate_max", 0.0) > policy.gate_max_gate
             or last.get("gate_collapse_frac", 0.0) > policy.gate_collapse_frac)
    state["gate_bad"] = state.get("gate_bad", 0) + 1 if g_bad else 0
    if state["gate_bad"] >= policy.gate_consecutive:
        return "gate_collapse"

    # vanishing gradient
    gn = last.get("grad_norm")
    g_zero = gn is not None and gn < policy.grad_norm_min
    state["grad_zero"] = state.get("grad_zero", 0) + 1 if g_zero else 0
    if state["grad_zero"] >= policy.grad_consecutive:
        return "zero_gradient"

    return None


def watch(run_dir: str, policy: Optional[WatchdogPolicy] = None,
          max_iters: Optional[int] = None, stop: Optional[threading.Event] = None) -> None:
    """Polls `check_once` every policy.poll_s until it finds an anomaly
    (then writes `.HALT`), `max_iters` polls have run, or `stop` is set
    (the trainer sets it when its run ends)."""
    policy = policy or WatchdogPolicy()
    stop = stop or threading.Event()
    state: dict = {}
    it = 0
    while (max_iters is None or it < max_iters) and not stop.is_set():
        it += 1
        anomaly = check_once(run_dir, policy, state)
        if anomaly:
            _halt(run_dir, anomaly)
            print(f"watchdog: HALT ({anomaly})", flush=True)
            return
        stop.wait(policy.poll_s)


def main() -> None:
    ap = argparse.ArgumentParser(description="NSA training watchdog")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--stall-s", type=float, default=180.0)
    ap.add_argument("--poll-s", type=float, default=10.0)
    args = ap.parse_args()
    watch(args.dir, WatchdogPolicy(heartbeat_stall_s=args.stall_s, poll_s=args.poll_s))


if __name__ == "__main__":
    main()
