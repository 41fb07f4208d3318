"""Byte-LM trainer (port of nsa_vibe_tpu/train/trainer.py).

  * YAML config (model/nsa/train groups; PyYAML is imported only when
    --config is given) + CLI overrides;
  * the train step of train.train_step on one device (the card unless
    --device cpu); --varlen trains on packed documents (ops/varlen.py:
    l_sel-aligned starts, no attention across a document boundary, the
    loss masked to each document's own next tokens);
  * under torch.distributed (WORLD_SIZE > 1, or dp/sp/pp/tp > 1) the
    parallel step of parallel/train_step.py over a (dp, pp, sp, tp) mesh
    (--dp, --sp, --pp, --pp-microbatches, --tp, --fsdp; --varlen with any
    of them): each dp member reads its own documents (train.data.Shard,
    seeded by the dp member, so the sp, pp and tp ranks of one member read
    the same rows) into
    batch_size / dp rows, each sp rank takes its positions; the
    device is cuda:LOCAL_RANK unless --device names one (two ranks on one
    card: --device cuda:0 --backend gloo); rank 0 logs and writes;
  * training.csv, val.csv, heartbeat.jsonl, `.HALT` polling each step
    (under a mesh the ranks agree on it at log boundaries);
  * the coherent NaN abort: the device `good` flags queue up and are read
    at log boundaries, 3 consecutive bad steps halt the run;
  * periodic + final checkpoints with optimizer state; --resume;
  * the JAX trainer's tools (rank 0): --watchdog runs
    utils/watchdog.py::watch in a thread until the run ends; --profile N
    traces steps [start + 2, start + 2 + N) with torch.profiler (CPU
    activity, and the card's kernels on a card) into
    out_dir/profile/trace_steps<a>-<b>.json (Chrome trace format), which
    holds the port's spans (utils/trace.py) as user annotations;
    --mem-dump-every N writes torch.cuda.memory_stats() to
    out_dir/mem_step<n>.json every N steps (none on the CPU, which has no
    such stats); TensorBoard scalars (the JAX tags) under out_dir/tb when
    the tensorboard package imports (else one line says none are written);
    --detect-anomaly runs the loop under
    torch.autograd.set_detect_anomaly(True); --synthetic-on-fail restarts
    the feed on synthetic data when the first batch of another source
    fails; SIGUSR1 dumps every thread's stack (faulthandler). The packer
    (the C++ one of nsa_vibe_tpu_torch/native when it builds, else Python;
    packed documents always Python) is printed once.

The host reads device values only at log (and eval/save) boundaries, so
the card runs ahead of the Python loop between them.

Run:  python -m nsa_vibe_tpu_torch.train.trainer --steps 50 --data synthetic
      python -m nsa_vibe_tpu_torch.train.trainer --config configs/m7c_125m.yaml \
          --data synthetic --steps 20 [--varlen] [--watchdog] [--profile 2] \
          [--mem-dump-every 4] [--detect-anomaly]
      torchrun --nproc-per-node N -m nsa_vibe_tpu_torch.train.trainer \
          --config configs/m7c_125m_pod.yaml --data synthetic   (N cards)
      torchrun --nproc-per-node 4 -m nsa_vibe_tpu_torch.train.trainer \
          --config configs/m7c_125m_pod.yaml --data synthetic --dp 1 --pp 2 \
          --sp 2 --pp-microbatches 4 --varlen   (4 cards)
      torchrun --nproc-per-node 4 -m nsa_vibe_tpu_torch.train.trainer \
          --config configs/m7c_125m_pod.yaml --data synthetic --dp 2 --tp 2 \
          --fsdp   (4 cards: 2 KV groups, one a tp member)
      torchrun --nproc-per-node 2 -m nsa_vibe_tpu_torch.train.trainer \
          --config configs/m7c_125m.yaml --data synthetic --tp 2 \
          --device cuda:0 --backend gloo   (two ranks sharing one card)
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import faulthandler
import json
import os
import queue
import signal
import sys
import threading
import time
import types
from typing import Optional

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.models.tinylm import init_model_params
from nsa_vibe_tpu_torch.ops.varlen import make_varlen_batches
from nsa_vibe_tpu_torch.parallel import train_step as pts
from nsa_vibe_tpu_torch.parallel.mesh import all_reduce_, initialize_distributed, make_mesh
from nsa_vibe_tpu_torch.native import library_path, native_available
from nsa_vibe_tpu_torch.train.data import Shard, make_batches, make_tokenizer
from nsa_vibe_tpu_torch.train.train_step import init_train_state, make_eval_step, make_train_step
from nsa_vibe_tpu_torch.utils import trace
from nsa_vibe_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from nsa_vibe_tpu_torch.utils.device import resolve_device
from nsa_vibe_tpu_torch.utils.heartbeat import Heartbeat
from nsa_vibe_tpu_torch.utils.watchdog import watch

NAN_ABORT_STREAK = 3
FIRST_BATCH_TIMEOUT_S = 120.0   # a stuck data source fails fast


class _Prefetcher:
    """Background batch generation into a bounded queue; the first get()
    applies a timeout so a stuck source fails fast."""

    def __init__(self, batches, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for b in batches:
                    self._q.put(b)
            except Exception as e:  # surfaced on get()
                self._err = e
            self._q.put(None)

        threading.Thread(target=worker, daemon=True).start()

    def get(self, timeout: Optional[float] = None):
        item = self._q.get(timeout=timeout)
        if item is None:
            if self._err is not None:
                raise RuntimeError(f"data loader failed: {self._err}") from self._err
            raise StopIteration("data source exhausted")
        return item


def load_config(path: Optional[str]) -> tuple[ModelConfig, TrainConfig, str]:
    """YAML with optional model/nsa/train groups; returns (mcfg, tcfg, data).
    train.varlen and the parallel keys (dp, sp, pp, pp_microbatches, tp,
    fsdp, fsdp_min_size) are read; a tp that does not divide the KV groups
    and the MLP hidden dim raises, as do keys the port does not have.
    nsa.varlen_exact may only be true: the port's avg ϕ is always
    window-exact (core/config.py), so `false`, the JAX package's running-sum
    form, raises rather than compute other math unannounced."""
    raw: dict = {}
    if path:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    nsa_kw = dict(raw.get("nsa", {}))
    # the JAX package's prefill chunk bounds its XLA scorer's [chunk, S_cmp]
    # scores; the port's scorer kernels form no such tensor, so it has none
    nsa_kw.pop("prefill_chunk", None)
    if not nsa_kw.pop("varlen_exact", True):
        raise ValueError("nsa.varlen_exact: false is not supported: the port's avg phi is "
                         "always window-exact (the JAX package's varlen_exact: true)")
    nsa = NSAConfig(**nsa_kw)
    model_kw = dict(raw.get("model", {}))
    data = model_kw.pop("data", raw.get("data", "synthetic"))
    tcfg = TrainConfig(**raw.get("train", {}))
    mcfg = ModelConfig(nsa=nsa, **model_kw)
    pts.check_config(tcfg, mcfg=mcfg)
    return mcfg, tcfg, data


def apply_overrides(mcfg: ModelConfig, tcfg: TrainConfig, args) -> tuple[ModelConfig, TrainConfig]:
    t_over = {k: getattr(args, k)
              for k in ("steps", "batch_size", "seq_len", "accum_steps", "lr", "seed",
                        "save_every", "eval_every", "log_every", "out_dir", "varlen", "dp",
                        "sp", "pp", "pp_microbatches", "tp", "fsdp", "fsdp_min_size")
              if getattr(args, k, None) is not None}
    if t_over:
        tcfg = dataclasses.replace(tcfg, **t_over)
    m_over = {}
    if args.n_layers is not None:
        m_over["n_layers"] = args.n_layers
    if args.remat:
        m_over["remat"] = True if args.remat is True else args.remat
    if args.dtype is not None:
        m_over["dtype"] = args.dtype
    if m_over:
        mcfg = dataclasses.replace(mcfg, **m_over)
    pts.check_config(tcfg, mcfg=mcfg)
    return mcfg, tcfg


def _to_device(batch_np: np.ndarray, shape, dev: torch.device, dtype=torch.long
               ) -> torch.Tensor:
    """numpy batch -> `dtype` tensor of `shape` on dev; to a card through
    pinned memory without waiting for the queued work."""
    t = torch.from_numpy(np.ascontiguousarray(batch_np).reshape(shape)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _batch_to_device(batch_np, tcfg: TrainConfig, shape, dev: torch.device):
    """A batch of make_batches (tokens) or, with tcfg.varlen, of
    make_varlen_batches (tokens, seq_start, loss_mask) on dev, each array
    reshaped to `shape` (..., S + 1) or (..., S): tokens int64, seq_start
    int32, loss_mask f32."""
    if not tcfg.varlen:
        return _to_device(batch_np, (*shape, tcfg.seq_len + 1), dev)
    toks, ds, lm = batch_np
    return (_to_device(toks, (*shape, tcfg.seq_len + 1), dev),
            _to_device(ds, (*shape, tcfg.seq_len), dev, torch.int32),
            _to_device(lm, (*shape, tcfg.seq_len), dev, torch.float32))


def _distributed(tcfg: TrainConfig) -> bool:
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1 or tcfg.dp > 1 or tcfg.sp > 1
            or tcfg.pp > 1 or tcfg.tp > 1)


def _rank_device(device: str) -> str:
    """cuda:LOCAL_RANK for the default "cuda"; any other name as given."""
    return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}" if device == "cuda" else device


class _StepProfiler:
    """torch.profiler over the loop's steps [start, start + n): CPU activity,
    and the card's kernels on a card. `at(step)` is called before each step
    runs; the trace goes to run_dir/profile/trace_steps<a>-<b>.json (steps
    numbered as the log numbers them) when the n steps are done or, if the
    loop ends first, at `close()`. The port's spans, recorded while the
    profiler runs, are in it as user annotations; the recorder's own copy
    is dropped at `close()`."""

    def __init__(self, run_dir: str, dev: torch.device, start: int, n: int):
        self.dir, self.dev, self.start, self.n = os.path.join(run_dir, "profile"), dev, start, n
        self.prof = None
        self.last = start

    def at(self, step: int) -> None:
        if step == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif step == self.start + self.n:
            self.close()
        self.last = step

    def close(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)   # the traced steps' kernels end inside the trace
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_steps{self.start + 1}-{self.last + 1}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        trace.reset()
        print(f"[trainer] profile written to {path}", flush=True)


def _tensorboard(run_dir: str):
    """A SummaryWriter on run_dir/tb, or None (with one line saying so) where
    the tensorboard package is not installed."""
    if "tensorflow" not in sys.modules:
        # tensorboard imports TensorFlow where one is installed (seconds of
        # start-up and its memory in every trainer) unless its no-TensorFlow
        # marker module exists; writing event files needs only its stub
        marker = "tensorboard.compat.notf"
        sys.modules.setdefault(marker, types.ModuleType(marker))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("[trainer] the tensorboard package is not installed: no TensorBoard scalars "
              "are written", flush=True)
        return None
    return SummaryWriter(os.path.join(run_dir, "tb"))


def _dump_memory(run_dir: str, step: int, dev: torch.device) -> None:
    """run_dir/mem_step<step>.json from torch.cuda.memory_stats (ints); the
    CPU has no such stats, so nothing is written there."""
    stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
    if stats:
        with open(os.path.join(run_dir, f"mem_step{step}.json"), "w") as f:
            json.dump({k: int(v) for k, v in stats.items()}, f, indent=2)


def train(mcfg: ModelConfig, tcfg: TrainConfig, data_source: str = "synthetic",
          resume: bool = False, device="cuda", backend: Optional[str] = None,
          watchdog_in_process: bool = False, profile_steps: int = 0, tokenizer: str = "byte",
          synthetic_on_fail: bool = False,
          first_batch_timeout_s: float = FIRST_BATCH_TIMEOUT_S,
          detect_anomaly: bool = False, mem_dump_every: int = 0) -> dict:
    """Run training; returns a summary dict (final loss, toks/s, steps done).
    Under torch.distributed (see the module notes) every rank calls it;
    `backend` ("nccl" or "gloo", None: nccl on a card) starts the group.
    The tools (watchdog_in_process, profile_steps, mem_dump_every, the
    TensorBoard scalars) run on rank 0; see the module notes for them,
    synthetic_on_fail and detect_anomaly. tokenizer: "byte" (the only
    tokenizer the port has; "hf:..." raises)."""
    make_tokenizer(tokenizer)   # refuses what the port lacks before any work starts
    with contextlib.suppress(AttributeError, ValueError):   # no SIGUSR1 on this platform
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=True)
    parallel = _distributed(tcfg)
    if parallel:
        initialize_distributed(backend)
        device = _rank_device(device)
    dev = resolve_device(device)
    mesh = None
    if parallel:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_mesh(tcfg.dp, tcfg.sp, tp=tcfg.tp, pp=tcfg.pp)
    lead = mesh is None or mesh.rank == 0
    run_dir = tcfg.out_dir
    os.makedirs(run_dir, exist_ok=True)
    if lead:
        with open(os.path.join(run_dir, "env.json"), "w") as f:
            json.dump({
                "torch": torch.__version__,
                "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
                "model": dataclasses.asdict(mcfg),
                "train": dataclasses.asdict(tcfg),
                "data": data_source,
                "mesh": None if mesh is None else {"dp": mesh.dp, "pp": mesh.pp,
                                                   "sp": mesh.sp, "tp": mesh.tp,
                                                   "backend": mesh.backend},
            }, f, indent=2, default=str)

    params = init_model_params(mcfg, torch.Generator().manual_seed(tcfg.seed), device=dev)
    if mesh is None:
        state = init_train_state(params, tcfg)
        step_fn = make_train_step(mcfg, tcfg)
        eval_fn = make_eval_step(mcfg, varlen=tcfg.varlen)
    else:
        step_fn, state = pts.build_state_and_step(params, mcfg, tcfg, mesh)
        peval = pts.make_eval_step(mcfg, mesh, varlen=tcfg.varlen, tcfg=tcfg)
        eval_fn = lambda _, b: peval(state, b)   # noqa: E731
    del params

    ckpt_dir = os.path.join(run_dir, "ckpt")
    start_step = 0
    if resume and latest_step(ckpt_dir) is not None:
        restore_checkpoint(ckpt_dir, state, mesh=mesh)
        start_step = int(state.step)
        if lead:
            print(f"[trainer] resumed from step {start_step}", flush=True)

    dp = 1 if mesh is None else mesh.dp
    if tcfg.batch_size % dp:
        raise ValueError(f"batch_size {tcfg.batch_size} does not split over dp={dp}")
    A, Bsz, S = tcfg.accum_steps, tcfg.batch_size // dp, tcfg.seq_len
    shard = Shard() if mesh is None else Shard(mesh.dp, mesh.dp_rank)
    native = not tcfg.varlen and native_available()
    if lead:
        print("[trainer] packer: " + (f"native C++ ({library_path()})" if native else
                                      "python" + (" (packed documents, ops/varlen.py)"
                                                  if tcfg.varlen else "")), flush=True)

    def source(src: str):
        if tcfg.varlen:
            return make_varlen_batches(src, S, Bsz * A, align=mcfg.nsa.l_sel, seed=tcfg.seed,
                                       tokenizer=tokenizer, epochs=0, shard=shard)
        return make_batches(src, S, Bsz * A, seed=tcfg.seed, tokenizer=tokenizer, epochs=0,
                            shard=shard, native=native)

    batches = _Prefetcher(source(data_source))
    try:
        first_batch = batches.get(timeout=first_batch_timeout_s)
    except (queue.Empty, RuntimeError, StopIteration) as e:
        if not synthetic_on_fail or data_source == "synthetic":
            raise
        if lead:
            print(f"[trainer] data source {data_source!r} failed ({e}); falling back to "
                  "synthetic", flush=True)
        batches = _Prefetcher(source("synthetic"))
        first_batch = batches.get(timeout=60.0)

    def to_device(batch_np, shape):
        b = _batch_to_device(batch_np, tcfg, shape, dev)
        if mesh is not None:
            b = pts.local_batch(b, mesh, rows=False)   # this sp rank's positions
        return b

    hb = Heartbeat(os.path.join(run_dir, "heartbeat.jsonl")) if lead else None
    csv_path = os.path.join(run_dir, "training.csv")
    val_path = os.path.join(run_dir, "val.csv")
    new_csv = not (resume and os.path.exists(csv_path))
    with contextlib.ExitStack() as stack:
        csv_f = stack.enter_context(open(csv_path if lead else os.devnull,
                                         "w" if new_csv else "a", newline=""))
        csv_w = csv.writer(csv_f)
        if new_csv:
            csv_w.writerow(["step", "loss", "toks_per_s", "grad_norm", "gate_entropy",
                            "gate_max", "gate_collapse_frac", "share_cmp", "share_sel",
                            "share_win", "sel_k_mean", "sel_k_max", "bad_steps"])

        if detect_anomaly:   # the previous setting comes back when the loop ends
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        tb = _tensorboard(run_dir) if lead else None
        if tb is not None:
            stack.callback(tb.close)
        if watchdog_in_process and lead:
            stop_watch = threading.Event()
            stack.callback(stop_watch.set)
            threading.Thread(target=watch, args=(run_dir,), kwargs={"stop": stop_watch},
                             name="nsa-watchdog", daemon=True).start()
        prof = None
        if profile_steps and lead:
            prof = _StepProfiler(run_dir, dev, start_step + 2, profile_steps)
            stack.callback(prof.close)

        halt_path = os.path.join(run_dir, ".HALT")
        bad_streak = total_bad = 0
        tokens_per_step = A * tcfg.batch_size * S
        last_loss = float("nan")
        summary_toks = 0.0
        t_start = time.perf_counter()
        t_window = t_start
        pending_good: list = []
        synced = True   # the host has waited for every queued step

        for step in range(start_step, tcfg.steps):
            halt = os.path.exists(halt_path)
            if mesh is not None:
                # every rank stops at the same step; the ranks agree only
                # where the host already waited for the card (before the
                # first step and after a log boundary), so the card keeps
                # running ahead of the loop in between
                if synced:
                    flag = torch.tensor(float(halt), device=dev)
                    halt = bool(all_reduce_(flag, op=torch.distributed.ReduceOp.MAX))
                else:
                    halt = False
            if halt:
                if lead:
                    print(f"[trainer] .HALT detected at step {step}; exiting gracefully",
                          flush=True)
                break
            if prof is not None:
                prof.at(step)
            if first_batch is not None:
                batch_np, first_batch = first_batch, None
            else:
                batch_np = batches.get(timeout=300.0)
            state, metrics = step_fn(state, to_device(batch_np, (A, Bsz)))
            pending_good.append(metrics["good"])
            sync_now = ((step + 1) % tcfg.log_every == 0 or step == start_step
                        or step == tcfg.steps - 1
                        or (tcfg.eval_every and (step + 1) % tcfg.eval_every == 0)
                        or (tcfg.save_every and (step + 1) % tcfg.save_every == 0))
            synced = sync_now
            if sync_now:
                loss = float(metrics["loss"])   # waits for every queued step
                now = time.perf_counter()
                toks_per_s = tokens_per_step * len(pending_good) / max(now - t_window, 1e-9)
                t_window = now
                summary_toks = toks_per_s
                last_loss = loss
                abort = False
                for g in pending_good:   # `good` is the same on every rank
                    if not bool(g):
                        bad_streak += 1
                        total_bad += 1
                        abort = abort or bad_streak >= NAN_ABORT_STREAK
                    else:
                        bad_streak = 0
                pending_good = []
                if abort:
                    if lead:
                        with open(os.path.join(run_dir, ".anomaly_type"), "w") as f:
                            f.write("nan_loss\n")
                        with open(halt_path, "w") as f:
                            f.write("coherent NaN abort\n")
                        print(f"[trainer] NaN abort at step {step}", flush=True)
                    break
                shares = metrics["branch_shares"].tolist()
                vals = {k: float(metrics[k]) for k in ("grad_norm", "gate_entropy", "gate_max",
                                                       "gate_collapse_frac", "sel_k_mean",
                                                       "sel_k_max")}
                csv_w.writerow([step + 1, f"{loss:.6f}", f"{toks_per_s:.1f}",
                                f"{vals['grad_norm']:.4f}", f"{vals['gate_entropy']:.4f}",
                                f"{vals['gate_max']:.4f}", f"{vals['gate_collapse_frac']:.4f}",
                                f"{shares[0]:.4f}", f"{shares[1]:.4f}", f"{shares[2]:.4f}",
                                f"{vals['sel_k_mean']:.2f}", f"{vals['sel_k_max']:.0f}", total_bad])
                csv_f.flush()
                if lead:
                    hb.beat(step + 1, loss=loss, toks_per_s=toks_per_s,
                            grad_norm=vals["grad_norm"], gate_entropy=vals["gate_entropy"],
                            gate_max=vals["gate_max"],
                            gate_collapse_frac=vals["gate_collapse_frac"])
                    print(f"[trainer] step {step + 1} loss {loss:.4f} {toks_per_s:.0f} toks/s",
                          flush=True)
                if tb is not None:
                    for tag, v in (("train/loss", loss), ("train/toks_per_s", toks_per_s),
                                   ("train/grad_norm", vals["grad_norm"]),
                                   ("gate/entropy", vals["gate_entropy"]),
                                   ("gate/collapse_frac", vals["gate_collapse_frac"]),
                                   ("sel/k_mean", vals["sel_k_mean"])):
                        tb.add_scalar(tag, v, step + 1)

            if tcfg.eval_every and (step + 1) % tcfg.eval_every == 0:
                vb = batches.get(timeout=300.0)
                vb = tuple(a[:Bsz] for a in vb) if tcfg.varlen else vb[:Bsz]
                vl = float(eval_fn(state.params, to_device(vb, (Bsz,))))
                if lead:
                    with open(val_path, "a", newline="") as vf:
                        csv.writer(vf).writerow([step + 1, f"{vl:.6f}", f"{np.exp(vl):.4f}"])

            if tcfg.save_every and (step + 1) % tcfg.save_every == 0:
                save_checkpoint(ckpt_dir, step + 1, state, mesh=mesh)

            if mem_dump_every and (step + 1) % mem_dump_every == 0 and lead:
                _dump_memory(run_dir, step + 1, dev)
    save_checkpoint(ckpt_dir, int(state.step), state, mesh=mesh)
    return {
        "final_loss": last_loss,
        "steps": int(state.step),
        "toks_per_s": summary_toks,
        "wall_s": time.perf_counter() - t_start,
        "bad_steps": total_bad,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description="NSA byte-LM trainer (PyTorch port)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--data", default=None,
                    help="synthetic, or a local .jsonl ({\"text\": ...} a line) or .txt file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; cuda:LOCAL_RANK under torch.distributed), cuda:N or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default: nccl on a card, gloo on the CPU; "
                         "gloo for several ranks on one card)")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel ranks (0: world / (pp sp tp))")
    ap.add_argument("--sp", type=int, default=None, help="sequence-parallel ranks")
    ap.add_argument("--pp", type=int, default=None, help="pipeline stages")
    ap.add_argument("--pp-microbatches", dest="pp_microbatches", type=int, default=None,
                    help="GPipe micro-batches per step under pp (0: pp)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ranks (each holds n_kv_groups / tp KV groups and "
                         "1/tp of the MLP hidden dim)")
    ap.add_argument("--fsdp", action="store_true", default=None,
                    help="shard parameters and moments over dp")
    ap.add_argument("--fsdp-min-size", dest="fsdp_min_size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    ap.add_argument("--seq-len", dest="seq_len", type=int, default=None)
    ap.add_argument("--accum-steps", dest="accum_steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--n-layers", dest="n_layers", type=int, default=None)
    ap.add_argument("--remat", nargs="?", const=True, default=False,
                    help="full block remat; --remat mlp = MLP-only")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--save-every", dest="save_every", type=int, default=None)
    ap.add_argument("--eval-every", dest="eval_every", type=int, default=None)
    ap.add_argument("--log-every", dest="log_every", type=int, default=None)
    ap.add_argument("--out-dir", dest="out_dir", default=None)
    ap.add_argument("--varlen", action="store_true", default=None,
                    help="packed-document batching (no attention across a document "
                         "boundary; loss-masked padding; ops/varlen.py)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--watchdog", action="store_true",
                    help="run utils/watchdog.py in a thread (halts the run on an anomaly)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N steps with torch.profiler into out_dir/profile, "
                    "the port's spans (utils/trace.py) included")
    ap.add_argument("--tokenizer", default="byte",
                    help='"byte" (the port has no other; "hf:..." needs files not in the repo)')
    ap.add_argument("--synthetic-on-fail", dest="synthetic_on_fail", action="store_true",
                    help="fall back to synthetic data if the source's first batch fails")
    ap.add_argument("--detect-anomaly", dest="detect_anomaly", action="store_true",
                    help="torch.autograd.set_detect_anomaly(True): raise at the first "
                         "backward op that makes a NaN")
    ap.add_argument("--mem-dump-every", dest="mem_dump_every", type=int, default=0,
                    metavar="N", help="write torch.cuda.memory_stats() JSON every N steps")
    args = ap.parse_args()

    mcfg, tcfg, data = load_config(args.config)
    mcfg, tcfg = apply_overrides(mcfg, tcfg, args)
    if args.data is not None:
        data = args.data
    summary = train(mcfg, tcfg, data, resume=args.resume, device=args.device,
                    backend=args.backend, watchdog_in_process=args.watchdog,
                    profile_steps=args.profile, tokenizer=args.tokenizer,
                    synthetic_on_fail=args.synthetic_on_fail,
                    detect_anomaly=args.detect_anomaly, mem_dump_every=args.mem_dump_every)
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        print(json.dumps({"summary": summary}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
