"""Training driver: the port's single-device train step
(train/train_step.py::make_train_step) over batches made from the seed.

Set-up builds one train state from the seed's parameters, with the
optimizer's count at the mix's starting step, and drives it through the
first `check_steps` steps by the same call and feed as the window: those
steps are the warm-up and what the reference follows. From them it keeps
each step's loss, the first step's gradient as the optimizer received it
(its first moment over 1 - beta1, per leaf) and the change of every leaf
over the steps, as norms. The window then runs the same state on fresh
batches for `seconds`, keeping the host at most one step ahead of the
card, and ends in a synchronise.

The reference repeats the checked steps in float32 from the same
parameters and batches; the comparison takes, by the worst leaf, the gap
between the two sides' norms over the larger of the reference leaf's norm
and the median leaf's.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from perfbench import data, program, weights
from perfbench.counts.attention import prefill_work
from perfbench.counts.flops import train_step_flops
from perfbench.reference import tinylm as ref

B1 = 0.9


def shape(ctx) -> tuple:
    t = ctx.traffic
    return t["accum"], t["batch"], t["seq"]


def start_count(ctx) -> int:
    return ctx.hp["warmup_steps"] if ctx.traffic.get("start") == "after_warmup" else 0


def feed(ctx) -> data.TrainFeed:
    accum, batch, seq = shape(ctx)
    return data.TrainFeed(ctx.seed, accum, batch, seq, ctx.cfg["vocab_size"],
                          ctx.traffic["zipf_exponent"], ctx.device)


def leaf_norms(tree) -> dict:
    """name -> float32 norm (a device scalar) of every leaf of a port tree,
    the fused projections as their seven parts."""
    return {k: v.detach().float().norm() for k, v in weights.flat(tree).items()}


class Run:
    def __init__(self, ctx):
        from nsa_vibe_tpu_torch.core.config import TrainConfig
        from nsa_vibe_tpu_torch.train.train_step import (
            init_train_state, make_train_step, param_leaves, tree_from_leaves,
        )

        self.ctx = ctx
        accum, batch, seq = shape(ctx)
        mcfg = program.model_config(ctx.cfg)
        hp = ctx.hp
        tcfg = TrainConfig(lr=hp["lr"], warmup_steps=hp["warmup_steps"], steps=hp["steps"],
                           max_grad_norm=hp["max_grad_norm"],
                           weight_decay=hp.get("weight_decay", 0.0), batch_size=batch,
                           seq_len=seq, accum_steps=accum)
        self.tokens_per_step = accum * batch * seq
        params = program.params(weights.make(ctx.cfg, ctx.seed, ctx.device))
        self.state = init_train_state(params, tcfg)
        self.state.opt_state["count"].fill_(start_count(ctx))
        self.step = make_train_step(mcfg, tcfg)
        self.feed = feed(ctx)
        leaves = [t for _, t in param_leaves(self.state.params)]
        first = [t.detach().clone() for t in leaves]
        losses = []
        for i in range(ctx.traffic["check_steps"]):
            self.state, m = self.step(self.state, self.feed())
            losses.append(m["loss"])
            if i == 0:
                mu = [x / (1 - B1) for x in self.state.opt_state["mu"]]
                grad1 = leaf_norms(tree_from_leaves(self.state.params, mu))
                del mu
        change = leaf_norms(tree_from_leaves(
            self.state.params, [t.detach() - f for t, f in zip(leaves, first)]))
        del first, leaves
        ctx.sync()
        self.readings = {"losses": [float(x) for x in losses],
                         "grad1": {k: float(v) for k, v in grad1.items()},
                         "change": {k: float(v) for k, v in change.items()}}

    def window(self, seconds: float) -> dict:
        ctx = self.ctx
        spans = ctx.spans
        ctx.sync()
        steps, good, prev = 0, [], None
        t0 = time.perf_counter()
        while True:
            with spans("step"):
                self.state, m = self.step(self.state, self.feed())
            good.append(m["good"])
            ev = ctx.event()
            steps += 1
            if prev is not None:
                with spans("sync"):
                    prev.synchronize()
            prev = ev
            if time.perf_counter() - t0 >= seconds:
                break
        with spans("sync"):
            ctx.sync()
        wall = time.perf_counter() - t0
        accum, batch, seq = shape(self.ctx)
        cfg = self.ctx.cfg
        return {
            "steps": steps, "wall_s": wall, "tokens": steps * self.tokens_per_step,
            "attempted": steps, "failed": int(steps - int(torch.stack(good).sum())),
            "train_flops": train_step_flops(cfg, accum * batch, seq) * steps,
            "nsa_work": {k: v * steps for k, v in
                         prefill_work(cfg, accum * batch, seq, train=True).items()},
            "dtype": cfg["dtype"],
        }

    def release(self) -> None:
        del self.state, self.step, self.feed
        gc.collect()
        self.ctx.empty_cache()


def setup(ctx) -> Run:
    return Run(ctx)


def reference(ctx, variant: str = "float32", program_readings=None) -> dict:
    """The reference's readings for the checked steps: variant "float32"
    (the reference), "fp8" (computed in float8: the control), or
    "half_batch" (each step on the first half of its rows: a planted
    fault)."""
    ref.float32_matmuls()
    p0 = {k: v.float() for k, v in weights.make(ctx.cfg, ctx.seed, ctx.device).items()}
    f = feed(ctx)
    batches = [f() for _ in range(ctx.traffic["check_steps"])]
    rnd = ref.Rounding("fp8" if variant == "fp8" else "float32")
    half = slice(0, ctx.traffic["batch"] // 2) if variant == "half_batch" else None
    out = ref.train_steps(p0, batches, ctx.cfg, ctx.hp, start_count(ctx), rnd,
                          ctx.cell.get("ref_rows", 1), ctx.cell.get("ref_chunk", 1024), half,
                          weights.DTYPES[ctx.cfg["dtype"]])
    return {"losses": out["losses"],
            "grad1": {k: float(v.norm()) for k, v in out["grad1"].items()},
            "change": {k: float((out["params"][k] - p0[k]).norm()) for k in p0}}


def leaf_gap(got: dict, want: dict, names) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's want)."""
    med = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in names)


def diagnostics(got: dict, want: dict) -> dict:
    """Each step's relative loss gap and the median leaf's gaps."""
    def median_gap(k):
        med = statistics.median(want[k].values())
        return statistics.median(abs(got[k][n] - w) / max(w, med) for n, w in want[k].items())
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])],
            "grad1_median": median_gap("grad1"), "change_median": median_gap("change")}


def compare(got: dict, want: dict, ctx) -> dict:
    """The numbers compared: the first step's relative loss gap (the
    float8 control's number), the worst step's (a step on half the batch
    reads far above it), the first gradient's and the change's worst-leaf
    gaps (a state left unchanged reads 1 on both). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change: Adam moves them by round-off alone."""
    med = statistics.median(want["grad1"].values())
    moved = [k for k, v in want["grad1"].items() if v >= 1e-3 * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    return {
        "loss1": gaps[0],
        "loss": max(gaps),
        "grad1": leaf_gap(got["grad1"], want["grad1"], want["grad1"]),
        "change": leaf_gap(got["change"], want["change"], moved),
    }
