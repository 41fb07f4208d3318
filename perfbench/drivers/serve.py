"""Serving driver: a closed loop of clients over the port's serving parts.

Each of `slots` clients holds one decode slot. A request is a prompt of
uniform bytes from the seed and a number of answer tokens, greedy. The
mix names its lengths: every pairing of one of `prompt_lengths` with one
of the `answers` (a task's tokens to generate) is one request of a round,
and the rounds are replayed in an order drawn once from the mix's
`order_seed`, the same for every seed: the parent and the change are held
to one trace. (Drawn from the run's seed instead, the order moved the
95th percentile of time to first token by 15% from seed to seed: which
long prompts meet at one boundary.)

The loop, as a continuous-batching server runs it: a segment of `segment`
replays of one captured decode tick (models/decode_graph.py::DecodeGraph
over models/tinylm.py::model_decode_step_ragged and
utils/sampling.py::sample_logits, all slots at their own depths), then at
the segment's boundary every slot whose request has produced its last
token takes its client's next request: prefilled alone
(model_prefill_with_caches), its first token sampled from the prefill,
and installed into the running batch's caches (core/cache.py::admit_row).
A client sends its next request when its previous one produced its last
token, so the time to first token counts the wait for the boundary, the
other admissions before it and its own prefill. Set-up fills every slot
before the window and captures the tick.

Times are CUDA events on the one stream: one after every tick, one after
each admission's first token, and one around each admission and each
segment. The host stays at most one segment ahead of the card.

What is checked: a sample of the finished requests drawn from the seed,
the longest among them, whose served tokens the reference's full forward
pass (no cache) over prompt and answer scores: the widest gap by which a
served token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from perfbench import data, program, weights
from perfbench.counts.attention import decode_sel_work, prefill_work
from perfbench.counts.flops import decode_flops, prefill_flops
from perfbench.reference import tinylm as ref



def pool(ctx) -> list:
    """(prompt length, answer length) of every request, in sending order."""
    t = ctx.traffic
    rng = random.Random(t["order_seed"])
    pairs = [(n, a) for n in t["prompt_lengths"] for a in t["answers"].values()]
    out = []
    for _ in range(t["pool_rounds"]):
        rng.shuffle(pairs)
        out += pairs
    return out


class Slot:
    __slots__ = ("req", "length", "n_out", "made", "first_ev", "send_ev", "last_ev",
                 "in_window")

    def __init__(self):
        self.req = None


class Run:
    def __init__(self, ctx):
        from nsa_vibe_tpu_torch.core.cache import cache_tensors, ragged_cache
        from nsa_vibe_tpu_torch.models.decode_graph import DecodeGraph
        from nsa_vibe_tpu_torch.models.tinylm import (
            init_model_caches, model_decode_step_ragged,
        )
        from nsa_vibe_tpu_torch.utils.sampling import sample_logits

        self.ctx = ctx
        t = ctx.traffic
        dev = ctx.device
        self.mcfg = mcfg = program.model_config(ctx.cfg)
        self.params = params = program.params(weights.make(ctx.cfg, ctx.seed, dev))
        self.n = n = t["slots"]
        self.cap = t["capacity"]
        self.seg = t["segment"]
        self.width = max(t["answers"].values()) + self.seg          # a finished slot writes past its answer
        self.pool = pool(ctx)
        self.next_req = 0
        self.slots = [Slot() for _ in range(n)]
        self.done = []            # (req, length, n_out, tokens [n_out] on the device)
        self.rec = {"ttft_ms": [], "tpot_ms": [], "tokens": 0, "admitted": 0,
                    "prompt_tokens": 0, "admit_ms": 0.0, "tick_ms": 0.0, "ticks": 0,
                    "flops": 0, "nsa_ops": 0, "nsa_bytes": 0}
        self.counting = False
        with torch.no_grad():
            self.caches = [ragged_cache(c) for c in
                           init_model_caches(mcfg, n, self.cap, device=dev)]
            self.tok = torch.zeros((n, 1), dtype=torch.int64, device=dev)
            self.out = torch.zeros((n, self.width), dtype=torch.int64, device=dev)
            self.k = torch.zeros((n,), dtype=torch.int64, device=dev)
            rows = torch.arange(n, device=dev)
            caches, tok, out, k = self.caches, self.tok, self.out, self.k
            width = self.width

            def tick():
                logits, _ = model_decode_step_ragged(params, tok, caches, mcfg)
                nxt = sample_logits(logits[:, -1], 0.0)
                tok.copy_(nxt[:, None])
                out[rows, k.clamp(max=width - 1)] = nxt
                k.add_(1)

            # fill every slot, the longest prompts first (the allocator's
            # largest blocks come first)
            self.next_req = n
            ev0 = ctx.event()
            for i, r in enumerate(sorted(range(n), key=lambda r: -self.pool[r][0])):
                self.admit(i, r, ev0)
            state = [tok, out, k] + [x for c in caches for x in cache_tensors(c)]
            self.graph = DecodeGraph(tick, state)
        ctx.sync()

    def admit(self, i: int, r: int, send_ev) -> None:
        """Request r into slot i: prefill alone, first token, admit_row."""
        from nsa_vibe_tpu_torch.core.cache import admit_row
        from nsa_vibe_tpu_torch.models.tinylm import model_prefill_with_caches
        from nsa_vibe_tpu_torch.utils.sampling import sample_logits

        ctx = self.ctx
        spans, dev = ctx.spans, ctx.device
        length, n_out = self.pool[r]
        a = ctx.event()
        with spans("prefill"):
            prompt = data.prompt(self.ctx.seed, r, length, self.ctx.cfg["vocab_size"], dev)
            logits, solo = model_prefill_with_caches(self.params, prompt, self.mcfg, self.cap)
            first = sample_logits(logits[:, -1], 0.0)
            first_ev = ctx.event()
        with spans("admit"):
            for c, s in zip(self.caches, solo):
                admit_row(c, s, i)
            self.tok[i].copy_(first[0])
            self.out[i, 0].copy_(first[0])
            self.k[i].fill_(1)
        del logits, solo
        b = ctx.event()
        s = self.slots[i]
        s.req, s.length, s.n_out, s.made = r, length, n_out, 1
        s.first_ev, s.send_ev, s.last_ev, s.in_window = first_ev, send_ev, None, self.counting
        if self.counting:
            self.rec["admitted"] += 1
            self.rec["tokens"] += 1
            self.rec["prompt_tokens"] += length
            self.rec["flops"] += prefill_flops(self.ctx.cfg, length)
            w = prefill_work(self.ctx.cfg, 1, length, train=False)
            self.rec["nsa_ops"] += w["ops"]
            self.rec["nsa_bytes"] += w["bytes"]
            self.pending.append(("admit", a, b))
            self.pending.append(("ttft", send_ev, first_ev))

    def window(self, seconds: float) -> dict:
        ctx = self.ctx
        spans, cfg = ctx.spans, ctx.cfg
        self.counting = True
        self.pending = []          # event pairs, read once the window has closed
        ctx.sync()
        prev = None
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                a = ctx.event()
                evs = []
                with spans("replay"):
                    for _ in range(self.seg):
                        self.graph.replay()
                        evs.append(ctx.event())
                self.pending.append(("tick", a, evs[-1]))
                self.rec["ticks"] += self.seg
                finished = []
                for i, s in enumerate(self.slots):
                    live = min(self.seg, s.n_out - s.made)
                    for j in range(live):
                        t = s.length + s.made - 1 + j       # position of the token fed
                        self.rec["flops"] += decode_flops(cfg, t)
                        w = decode_sel_work(cfg, t)
                        self.rec["nsa_ops"] += w["ops"]
                        self.rec["nsa_bytes"] += w["bytes"]
                    self.rec["tokens"] += live
                    s.made += live
                    if s.made == s.n_out:
                        s.last_ev = evs[live - 1]
                        finished.append((live, i))
                if prev is not None:
                    with spans("sync"):
                        prev.synchronize()
                prev = evs[-1]
                for _, i in sorted(finished):       # first finished, first served
                    s = self.slots[i]
                    self.retire(s, i)
                    r = self.next_req % len(self.pool)
                    self.next_req += 1
                    self.admit(i, r, s.last_ev)
                if time.perf_counter() - t0 >= seconds:
                    break
            with spans("sync"):
                ctx.sync()
        wall = time.perf_counter() - t0
        self.counting = False
        for kind, a, b, *n in self.pending:
            ms = a.elapsed_time(b)
            if kind in ("admit", "tick"):
                self.rec[kind + "_ms"] += ms
            else:
                self.rec[kind + "_ms"].append(ms / (n[0] - 1) if n else ms)
        self.rec.update(wall_s=wall, attempted=self.rec["admitted"], failed=0,
                        dtype=cfg["dtype"])
        return self.rec

    def retire(self, s: Slot, i: int) -> None:
        """Times and tokens of the finished request in slot i."""
        if s.in_window:
            self.pending.append(("tpot", s.first_ev, s.last_ev, s.n_out))
        self.done.append((s.req, s.length, s.n_out, self.out[i, :s.n_out].clone()))
        s.in_window = False

    def release(self) -> None:
        done = [(r, n, m, t.cpu()) for r, n, m, t in self.done]
        self.readings = sample(self.ctx, done)
        del self.graph, self.caches, self.params, self.tok, self.out, self.k, self.done
        gc.collect()
        self.ctx.empty_cache()


def sample(ctx, done: list) -> dict:
    """The checked requests: the longest finished one and others drawn from
    the seed, up to `check_requests`."""
    if not done:
        return {"requests": []}
    rng = random.Random(weights.seed_of(ctx.seed, 4))
    longest = max(range(len(done)), key=lambda j: done[j][1] + done[j][2])
    rest = [j for j in range(len(done)) if j != longest]
    rng.shuffle(rest)
    pick = [longest] + rest[:ctx.traffic["check_requests"] - 1]
    return {"requests": [{"req": done[j][0], "length": done[j][1],
                          "tokens": done[j][3].tolist()} for j in pick]}


def setup(ctx) -> Run:
    return Run(ctx)


def reference(ctx, variant: str = "float32", program_readings=None) -> dict:
    """Per checked request, the reference's logits at the answer positions
    (variant "float32"), or the tokens its float8 version puts first there
    (variant "fp8", the control)."""
    ref.float32_matmuls()
    p = {k: v.float() for k, v in weights.make(ctx.cfg, ctx.seed, ctx.device).items()}
    rnd = ref.Rounding(variant)
    out = []
    for q in program_readings["requests"]:
        prompt = data.prompt(ctx.seed, q["req"], q["length"], ctx.cfg["vocab_size"], ctx.device)
        ans = torch.tensor(q["tokens"], dtype=torch.int64, device=ctx.device)[None]
        seq = torch.cat([prompt, ans[:, :-1]], 1)
        pos = range(q["length"] - 1, q["length"] - 1 + len(q["tokens"]))
        lg = ref.served_logits(p, seq, pos, ctx.cfg, rnd, ctx.cell.get("ref_chunk", 1024))
        out.append({"logits": lg} if variant == "float32" else
                   {"tokens": lg.argmax(-1).tolist()})
    return {"requests": out}


def diagnostics(got: dict, want: dict) -> dict:
    """The gaps of every checked token: how many, their mean and 95th
    percentile."""
    gaps = []
    for g, w in zip(got["requests"], want["requests"]):
        lg = w["logits"]
        tok = torch.tensor(g["tokens"], device=lg.device)
        gaps += (lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]).tolist()
    gaps.sort()
    return {"tokens": len(gaps), "mean": sum(gaps) / max(len(gaps), 1),
            "p95": gaps[int(0.95 * (len(gaps) - 1))] if gaps else None,
            "nonzero": sum(1 for x in gaps if x > 0)}


def compare(got: dict, want: dict, ctx) -> dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best logit at its position."""
    gap = 0.0
    for g, w in zip(got["requests"], want["requests"]):
        lg = w["logits"]
        tok = torch.tensor(g["tokens"], device=lg.device)
        served = lg.gather(-1, tok[:, None])[:, 0]
        gap = max(gap, float((lg.max(-1).values - served).max()))
    return {"logit_gap": gap if got["requests"] else math.inf}
