"""The port's host tools against the JAX package's: the watchdog
(utils/watchdog.py, after tests/test_data_ops.py) and the trainer's tool
options (train/trainer.py: the synthetic fallback after
tests/test_trainer_integration.py, --watchdog, --profile with the port's
spans, --mem-dump-every, --detect-anomaly, --tokenizer, TensorBoard); and
the JAX package's debug log (nsa_vibe_tpu/utils/debug.py), which the port
does not copy: nothing in either package calls it.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nsa_vibe_tpu.utils import debug as jdebug
from nsa_vibe_tpu.utils import watchdog as jwatchdog
from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.train import trainer as ttrainer
from nsa_vibe_tpu_torch.utils import watchdog as twatchdog

ROOT = Path(__file__).resolve().parents[1]
NSA = dict(dim=32, n_heads=2, n_kv_groups=1, d_k=16, d_v=16, l=8, d=4, l_sel=8, n_sel=2, w=8)


def _write_hb(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _both(run_dir, policy, state, n=1):
    """n check_once calls in each package, from copies of `state`."""
    out = []
    for mod in (twatchdog, jwatchdog):
        st = dict(state)
        out.append([mod.check_once(str(run_dir), mod.WatchdogPolicy(**policy), st)
                    for _ in range(n)])
    assert out[0] == out[1]
    return out[0]


def test_watchdog_heartbeat_stall(tmp_path):
    _write_hb(tmp_path / "heartbeat.jsonl", [{"ts": time.time() - 1000, "step": 1}])
    got = _both(tmp_path, dict(heartbeat_stall_s=180), {"watch_start": time.time() - 1000})
    assert got == ["heartbeat_stall"]


def test_watchdog_resume_does_not_stall_on_stale_heartbeat(tmp_path):
    _write_hb(tmp_path / "heartbeat.jsonl",
              [{"ts": time.time() - 1000, "step": 2600, "toks_per_s": 0.0,
                "gate_entropy": 0.01, "gate_max": 0.99,
                "gate_collapse_frac": 1.0, "grad_norm": 0.0}] * 8)
    assert _both(tmp_path, dict(heartbeat_stall_s=180), {}, n=5) == [None] * 5
    got = _both(tmp_path, dict(heartbeat_stall_s=180), {"watch_start": time.time() - 300})
    assert got == ["heartbeat_stall"]


@pytest.mark.parametrize("anomaly, record", [
    ("gate_collapse", {"toks_per_s": 100.0, "gate_entropy": 0.05, "gate_max": 0.99,
                       "gate_collapse_frac": 0.9}),
    ("throughput_flatline", {"toks_per_s": 0.0}),
    ("zero_gradient", {"toks_per_s": 100.0, "grad_norm": 1e-12}),
    (None, {"toks_per_s": 500.0, "gate_entropy": 1.0, "gate_max": 0.4,
            "gate_collapse_frac": 0.0, "grad_norm": 0.5}),
])
def test_watchdog_anomalies(tmp_path, anomaly, record):
    now = time.time()
    _write_hb(tmp_path / "heartbeat.jsonl", [{"ts": now, "step": i, **record} for i in range(8)])
    got = _both(tmp_path, dict(gate_consecutive=3, grad_consecutive=3),
                {"watch_start": now - 60}, n=3)
    assert got[-1] == anomaly and not os.path.exists(tmp_path / ".HALT")


def test_watch_halts_like_jax_and_stops_when_asked(tmp_path):
    for mod, d in ((twatchdog, tmp_path / "port"), (jwatchdog, tmp_path / "jax")):
        d.mkdir()
        # beats stamped after the watchdog's start (the first poll), not a previous life's
        _write_hb(d / "heartbeat.jsonl", [{"ts": time.time() + 60, "step": i,
                                           "toks_per_s": 0.0} for i in range(8)])
        mod.watch(str(d), mod.WatchdogPolicy(poll_s=0.01), max_iters=3)
    for name in (".HALT", ".anomaly_type"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    stop = threading.Event()
    t = threading.Thread(target=twatchdog.watch, args=(str(tmp_path / "none"),),
                         kwargs={"stop": stop})
    t.start()
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()


def test_debug_log_gating_and_limit(capsys, monkeypatch):
    jdebug.reset_counts()
    monkeypatch.delenv("NSA_DEBUG_LOG", raising=False)
    monkeypatch.delenv("NSA_LOG_LIMIT", raising=False)
    jdebug.log("decode.reads", total=100)
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("NSA_DEBUG_LOG", "1")
    jdebug.log("decode.reads", total=100, hit=0.5)
    monkeypatch.setenv("NSA_LOG_LIMIT", "2")
    jdebug.reset_counts()
    for a in range(4):
        jdebug.log("x", a=a)
    err = capsys.readouterr().err
    assert "NSA-LOG decode.reads total=100 hit=0.5" in err and err.count("NSA-LOG x") == 2


def _cfgs(out_dir, steps=2):
    mcfg = ModelConfig(vocab_size=256, n_layers=1, nsa=NSAConfig(**NSA))
    tcfg = TrainConfig(steps=steps, batch_size=2, seq_len=32, lr=1e-3, warmup_steps=2,
                       log_every=1, out_dir=str(out_dir))
    return mcfg, tcfg


def test_synthetic_fallback_on_bad_source(tmp_path, capsys):
    s = ttrainer.train(*_cfgs(tmp_path / "a"), "fineweb:no/such-dataset", device="cpu",
                       synthetic_on_fail=True, first_batch_timeout_s=30.0)
    assert "falling back to synthetic" in capsys.readouterr().out
    want = ttrainer.train(*_cfgs(tmp_path / "b"), "synthetic", device="cpu")
    assert s["steps"] == 2 and np.isfinite(s["final_loss"])
    assert s["final_loss"] == want["final_loss"]   # the same synthetic stream


def test_bad_source_raises_without_fallback(tmp_path):
    with pytest.raises(RuntimeError, match="data loader failed"):
        ttrainer.train(*_cfgs(tmp_path), "/no/such/file.jsonl", device="cpu",
                       first_batch_timeout_s=10.0)


def test_hf_tokenizer_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not in the repo"):
        ttrainer.train(*_cfgs(tmp_path), "synthetic", device="cpu", tokenizer="hf:gpt2")
    assert not (tmp_path / "env.json").exists()


def test_anomaly_mode_and_watchdog_last_only_as_long_as_the_run(tmp_path, monkeypatch):
    seen = []
    make = ttrainer.make_train_step

    def spy(mcfg, tcfg):
        step = make(mcfg, tcfg)

        def run(state, batch):
            seen.append(torch.is_anomaly_enabled())
            return step(state, batch)

        return run

    monkeypatch.setattr(ttrainer, "make_train_step", spy)
    assert not torch.is_anomaly_enabled()
    s = ttrainer.train(*_cfgs(tmp_path), "synthetic", device="cpu", detect_anomaly=True,
                       watchdog_in_process=True)
    assert s["steps"] == 2 and seen == [True, True] and not torch.is_anomaly_enabled()
    watchers = [t for t in threading.enumerate() if t.name == "nsa-watchdog"]
    for t in watchers:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in watchers)


def test_trainer_cli_with_every_tool(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(json.dumps({"model": {"vocab_size": 256, "n_layers": 1}, "nsa": NSA}))
    out = tmp_path / "run"
    run = subprocess.run(
        [sys.executable, "-m", "nsa_vibe_tpu_torch.train.trainer", "--config", str(cfg),
         "--data", "synthetic", "--device", "cpu", "--steps", "4", "--batch-size", "1",
         "--seq-len", "64", "--log-every", "1", "--out-dir", str(out), "--watchdog",
         "--profile", "1", "--mem-dump-every", "2", "--detect-anomaly", "--synthetic-on-fail",
         "--tokenizer", "byte"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert run.returncode == 0, run.stderr[-3000:]
    summary = json.loads(run.stdout.strip().splitlines()[-1])["summary"]
    assert summary["steps"] == 4 and summary["bad_steps"] == 0
    assert "[trainer] packer: native C++" in run.stdout
    trace = json.loads((out / "profile" / "trace_steps3-3.json").read_text())
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::mm" for e in ops)
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.forward", "train.backward", "train.optimizer"} <= spans
    events = list((out / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 1 and b"train/loss" in events[0].read_bytes()
    assert not list(out.glob("mem_step*.json"))          # no device memory stats on the CPU
    assert not (out / ".HALT").exists()
