#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (nsa_vibe_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  (a) build: compile the CUDA kernels of nsa_vibe_tpu_torch/csrc/ from the
      checkout (one nvcc per source, in parallel) and print the ptxas report;
  (b) kernel checks: each kernel at the m7c-125M serving shapes (B=4,
      S=2048, G=2, h=6, D=64; decode with cache capacity 2080) against its
      plain PyTorch version on the card, in f32 with TF32 off and in bf16,
      with the bounds of `allowed_err`; select_cmp's sel_idx is compared as
      sets and may differ only on near ties (NEAR_TIE); then each kernel is
      timed beside its plain version, one PyTorch library call where one
      computes the same function, and its bound on the card;
  (c) serve: m7c-125M in bf16 with random weights from a seed serves 4
      prompts of 2048 tokens and 32 greedy new tokens each through
      `generate`; the kernels' launch counters must show 12 select_cmp,
      12 win_attn and 12 + 12*31 sel_attn launches. Prefill and decode are
      timed with CUDA events, and must issue with no host-device
      synchronisation; one layer's nsa_prefill and nsa_decode_step on the
      card are compared, in f32, with the plain path (the same functions
      on CPU tensors) on the serve's own inputs; torch.profiler gives the
      device busy time of a prefill and of a decode step, by kernel.

The last lines are the card's `name, power.limit`, a JSON line of the
kernels' numbers, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nsa_vibe_tpu_torch import M7C_125M
from nsa_vibe_tpu_torch.convert import params_to
from nsa_vibe_tpu_torch.core.cache import cache_from_prefill
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step
from nsa_vibe_tpu_torch.core.nsa import nsa_prefill
from nsa_vibe_tpu_torch.models.llama_block import rmsnorm
from nsa_vibe_tpu_torch.models.tinylm import (
    generate, init_model_params, model_decode_step, model_prefill_with_caches,
)
from nsa_vibe_tpu_torch.ops import cuda as kernels
from nsa_vibe_tpu_torch.ops.block_index import build_block_meta, expected_decode_reads
from nsa_vibe_tpu_torch.ops.cuda import build as kbuild
from nsa_vibe_tpu_torch.ops.cuda.sel_attn import sel_attn, sel_attn_plain
from nsa_vibe_tpu_torch.ops.cuda.select_cmp import select_cmp, select_cmp_plain
from nsa_vibe_tpu_torch.ops.cuda.win_attn import win_attn, win_attn_plain
from nsa_vibe_tpu_torch.ops.selection import (
    canonicalize_sel, select_topn_blocks, selection_token_mask,
)

HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense tensor-core bf16 / f32 FMA
F32_TOL = 5e-5                  # kernel vs plain, f32 with TF32 off: summation order only
BF16_ULPS, BF16_FLOOR = 2, 1e-4  # kernel vs plain, bf16: see allowed_err
NEAR_TIE = 1e-5            # sel_idx may differ where p_grp scores are this close
LAYER_TOL = 1e-4           # one layer, f32: kernel path vs plain path (|out| ~ 0.1)
SLEEP_CYCLES_PER_S = 2e9   # >= the H100's SM clock (1.98 GHz), so a sleep lasts at least as asked
B, S, CAP, N_NEW = 4, 2048, 2080, 32
PORT_KERNELS = ("select_cmp_kernel", "sel_attn_kernel", "win_attn_kernel")   # CUDA symbol names
DECODE_T = (2048, 2055, 2070, 2079)                          # decode positions per row


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 2, hold: bool = False) -> float:
    """Mean time of `iters` back-to-back calls of fn, from CUDA events.
    hold=True first parks the stream on a sleep kernel long enough for the
    host to queue every call, so the events time the device's work and not
    the wrapper's Python cost (kernel timings); without it the result is
    the wall time a caller sees (end-to-end timings)."""
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t) / warmup        # upper bound of one call's host cost
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(min(2 * host_s * iters, 1.0) * SLEEP_CYCLES_PER_S))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(nbytes: int, ops: float, dtype) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ (a)

def phase_build() -> None:
    t = time.perf_counter()
    path = kbuild.build(force=True)
    print(kbuild.BUILD_LOG)
    kbuild.library()
    print(f"[build] {path.name} built from {len(kbuild.SOURCES)} sources in "
          f"{time.perf_counter() - t:.1f} s")


# ------------------------------------------------------------------ (b)

def near_tie_rows(sel_k, sel_p, p_grp):
    """(rows whose selection sets differ, of those the rows whose differing
    blocks' plain scores spread more than NEAR_TIE)."""
    ck, cp = canonicalize_sel(sel_k), canonicalize_sel(sel_p)
    S_sel = p_grp.shape[-1]

    def onehot(c):
        ids = torch.where(c < 0, torch.full_like(c, S_sel), c).long()
        oh = torch.zeros((*c.shape[:-1], S_sel + 1), dtype=torch.bool, device=c.device)
        return oh.scatter_(-1, ids, True)[..., :S_sel]

    diff = onehot(ck) ^ onehot(cp)
    differ = diff.any(-1)
    hi = torch.where(diff, p_grp, torch.full_like(p_grp, -1e30)).amax(-1)
    lo = torch.where(diff, p_grp, torch.full_like(p_grp, 1e30)).amin(-1)
    far = differ & ((hi - lo) > NEAR_TIE)
    return int(differ.sum()), int(far.sum())


def kernel_inputs(dtype, dev, gen):
    cfg = M7C_125M.nsa
    G, h, D = cfg.n_kv_groups, cfg.h_per_group, cfg.d_k
    meta = build_block_meta(S, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
    dmeta = build_block_meta(CAP, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    t_dec = torch.tensor(DECODE_T, device=dev)[:, None]                     # [B,1]
    p_dec = torch.rand((B, 1, G, dmeta.S_sel), generator=gen, device=dev)
    return dict(
        cfg=cfg, scale=1.0 / float(np.sqrt(D)),
        Q=r(B, S, G, h, D), K_cmp=r(B, G, meta.S_cmp, D), V_cmp=r(B, G, meta.S_cmp, D),
        M=torch.from_numpy(meta.M_csl).to(dev),
        K=r(B, G, S, D), V=r(B, G, S, D), Kw=r(B, G, S, D), Vw=r(B, G, S, D),
        t_pre=torch.arange(S, device=dev),
        Qd=r(B, 1, G, h, D), Kd=r(B, G, CAP, D), Vd=r(B, G, CAP, D), t_dec=t_dec,
        sel_dec=select_topn_blocks(p_dec, cfg.n_sel, t_dec, cfg.l_sel),
    )


def allowed_err(plain: torch.Tensor) -> torch.Tensor:
    """Per-element bound of |kernel - plain|. f32: F32_TOL. bf16: both
    versions round an f32 result (f32 accumulation, f32 softmax) that agrees
    to ~1e-6, so they may land one bf16 ulp of the plain value apart, two
    across a power of two; BF16_ULPS ulps plus BF16_FLOOR."""
    if plain.dtype == torch.float32:
        return torch.full_like(plain, F32_TOL)
    x = plain.float().abs()
    _, e = torch.frexp(x)                                   # x in [2^(e-1), 2^e)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)            # bf16: 8 significant bits
    return torch.where(x > 0, BF16_ULPS * ulp, torch.zeros_like(x)) + BF16_FLOOR


def check(name, got, want, extra="") -> float:
    """Holds a kernel's output against its plain version's; returns the max
    absolute error."""
    err = (got.float() - want.float()).abs()
    worst = float((err / allowed_err(want)).max())
    max_err = float(err.max())
    dt = str(want.dtype).replace("torch.", "")
    print(f"[check] {name:18s} {dt:8s} max_abs_err={max_err:.3e} worst err/bound={worst:.3f}"
          f"{extra}")
    if not worst <= 1.0:
        fail(f"{name} {dt}: an element is {worst:.3f} x its bound")
    return max_err


def phase_kernels(dev) -> dict:
    """Returns per-kernel records: max_abs_err (bf16, the serving dtype) and
    the bf16 inputs for timing."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = kernel_inputs(dtype, dev, gen)
        cfg, sc = x["cfg"], x["scale"]
        kw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
        sel_k, O_k = select_cmp(x["Q"], x["K_cmp"], x["V_cmp"], x["M"], **kw)
        sel_p, O_p, p_grp = select_cmp_plain(x["Q"], x["K_cmp"], x["V_cmp"], x["M"], **kw,
                                             return_scores=True)
        torch.cuda.synchronize()
        n_diff, n_far = near_tie_rows(sel_k, sel_p, p_grp)
        e1 = check("select_cmp", O_k, O_p,
                   f"; sel rows differing on near ties: {n_diff} of "
                   f"{sel_k.shape[0] * sel_k.shape[1] * sel_k.shape[2]}")
        if n_far:
            fail(f"select_cmp {dtype}: {n_far} rows differ beyond the near-tie bound")
        # prefill selection on the scorer's own output (forced slots repeat)
        O_k = sel_attn(x["Q"], x["K"], x["V"], sel_k, x["t_pre"], l_sel=cfg.l_sel, scale=sc)
        O_p = sel_attn_plain(x["Q"], x["K"], x["V"], sel_k, x["t_pre"], l_sel=cfg.l_sel,
                             scale=sc)
        e2 = check("sel_attn@prefill", O_k, O_p)
        O_k = sel_attn(x["Qd"], x["Kd"], x["Vd"], x["sel_dec"], x["t_dec"], l_sel=cfg.l_sel,
                       scale=sc)
        O_p = sel_attn_plain(x["Qd"], x["Kd"], x["Vd"], x["sel_dec"], x["t_dec"],
                             l_sel=cfg.l_sel, scale=sc)
        e3 = check("sel_attn@decode", O_k, O_p)
        O_k = win_attn(x["Q"], x["Kw"], x["Vw"], w=cfg.w, scale=sc)
        O_p = win_attn_plain(x["Q"], x["Kw"], x["Vw"], w=cfg.w, scale=sc)
        e4 = check("win_attn", O_k, O_p)
        torch.cuda.synchronize()
        rec = {"select_cmp": e1, "sel_attn@prefill": e2, "sel_attn@decode": e3,
               "win_attn": e4, "inputs": x, "sel": sel_k}
    return rec


def sdpa_operands(Q, K, V, mask=None):
    """[B,S,G,h,D] / [B,G,S_kv,D] / mask [B,S,G,S_kv] -> SDPA's [B,H,S,D]
    layout with K/V repeated per head and mask [B,H,S,S_kv]."""
    Bq, Sq, G, h, D = Q.shape
    q = Q.permute(0, 2, 3, 1, 4).reshape(Bq, G * h, Sq, D)
    k, v = K.repeat_interleave(h, dim=1), V.repeat_interleave(h, dim=1)
    m = None if mask is None else mask.permute(0, 2, 1, 3).repeat_interleave(h, dim=1)
    return q, k, v, m


def measure(rec, counts, decode_launches) -> list:
    """Times each kernel (bf16, serving shapes) beside its plain version and
    a library call; computes its bound from this run's inputs."""
    x, sel = rec["inputs"], rec["sel"]
    cfg, sc = x["cfg"], x["scale"]
    Q, dt = x["Q"], x["Q"].dtype
    Dk = Dv = cfg.d_k
    h = cfg.h_per_group
    kw = dict(scale=sc, l=cfg.l, d=cfg.d, l_sel=cfg.l_sel, n_top=cfg.n_sel)
    out = []

    # select_cmp: per row 2*n_c*(Dk + Dv + S_sel) for its n_c visible compressed tokens
    S_cmp, S_sel = x["M"].shape
    t = torch.arange(S, device=Q.device)
    n_c = torch.clamp(torch.where(t + 1 >= cfg.l, (t + 1 - cfg.l) // cfg.d + 1, 0), max=S_cmp)
    ops = float(n_c.sum()) * B * cfg.n_kv_groups * h * 2 * (Dk + Dv + S_sel)
    sel_out, O_out = select_cmp(Q, x["K_cmp"], x["V_cmp"], x["M"], **kw)
    bms, by = bound(nbytes(Q, x["K_cmp"], x["V_cmp"], x["M"], sel_out, O_out), ops, dt)
    out.append(dict(
        name="select_cmp", source="nsa_vibe_tpu_torch/csrc/select_cmp.cu",
        replaces="nsa_vibe_tpu/ops/pallas/scorer.py:436",
        launches=counts["select_cmp"], max_abs_err=rec["select_cmp"],
        ms=time_ms(lambda: select_cmp(Q, x["K_cmp"], x["V_cmp"], x["M"], **kw), 20, hold=True),
        plain_ms=time_ms(lambda: select_cmp_plain(Q, x["K_cmp"], x["V_cmp"], x["M"], **kw), 5,
                         hold=True),
        bound_ms=bms, bound_by=by, library_ms=None))

    # sel_attn at prefill and decode: per (b,s,g) the visible keys of its block set
    for kind, (q, k, v, s, tp) in {
        "prefill": (Q, x["K"], x["V"], sel, x["t_pre"]),
        "decode": (x["Qd"], x["Kd"], x["Vd"], x["sel_dec"], x["t_dec"]),
    }.items():
        mask = selection_token_mask(s, tp, cfg.l_sel, k.shape[2])            # [B,S,G,S_kv]
        ops = float(mask.sum()) * h * 2 * (Dk + Dv)
        kv_rows = int(mask.any(dim=1).sum())                                  # distinct rows
        o = sel_attn(q, k, v, s, tp, l_sel=cfg.l_sel, scale=sc)
        tpb = tp.to(torch.int32).expand(q.shape[0], q.shape[1])
        bms, by = bound(nbytes(q, s, tpb, o) + kv_rows * (Dk + Dv) * k.element_size(), ops, dt)
        sq, sk, sv, sm = sdpa_operands(q, k, v, mask)
        launches = (counts["sel_attn"] - decode_launches if kind == "prefill"
                    else decode_launches)
        out.append(dict(
            name=f"sel_attn@{kind}", source="nsa_vibe_tpu_torch/csrc/sel_attn.cu",
            replaces=("nsa_vibe_tpu/ops/pallas/sel_flash.py:227" if kind == "prefill"
                      else "nsa_vibe_tpu/ops/pallas/selection.py:97"),
            launches=launches, max_abs_err=rec[f"sel_attn@{kind}"],
            ms=time_ms(lambda: sel_attn(q, k, v, s, tp, l_sel=cfg.l_sel, scale=sc), 20, hold=True),
            plain_ms=time_ms(lambda: sel_attn_plain(q, k, v, s, tp, l_sel=cfg.l_sel,
                                                    scale=sc), 5, hold=True),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=sm, scale=sc), 10, hold=True)))
        del sq, sk, sv, sm, mask

    # win_attn: per row 2*min(w, t+1)*(Dk + Dv)
    ops = float(torch.clamp(t + 1, max=cfg.w).sum()) * B * cfg.n_kv_groups * h * 2 * (Dk + Dv)
    o = win_attn(Q, x["Kw"], x["Vw"], w=cfg.w, scale=sc)
    bms, by = bound(nbytes(Q, x["Kw"], x["Vw"], o), ops, dt)
    kpos = torch.arange(S, device=Q.device)
    band = (kpos[None, :] <= t[:, None]) & (kpos[None, :] > t[:, None] - cfg.w)
    sq, sk, sv, _ = sdpa_operands(Q, x["Kw"], x["Vw"])
    out.append(dict(
        name="win_attn", source="nsa_vibe_tpu_torch/csrc/win_attn.cu",
        replaces="nsa_vibe_tpu/ops/pallas/flash_diag.py:146",
        launches=counts["win_attn"], max_abs_err=rec["win_attn"],
        ms=time_ms(lambda: win_attn(Q, x["Kw"], x["Vw"], w=cfg.w, scale=sc), 20, hold=True),
        plain_ms=time_ms(lambda: win_attn_plain(Q, x["Kw"], x["Vw"], w=cfg.w, scale=sc), 5,
                         hold=True),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=band, scale=sc), 10, hold=True)))
    for r in out:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {r['name']:18s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"launches {r['launches']}  max_abs_err(bf16) {r['max_abs_err']:.3e}")
    return out


# ------------------------------------------------------------------ (c)

def layer_check(params, prompt, tokens, dev) -> None:
    """Layer 0 in f32: nsa_prefill and 4 nsa_decode_step calls on the card
    (kernels) against the same functions on CPU tensors (plain path), on
    the serve's own layer-0 inputs."""
    mcfg, cfg = M7C_125M, M7C_125M.nsa
    blk = params["blocks"][0]
    pg = params_to(blk["attn"], dtype=torch.float32)
    pc = params_to(blk["attn"], device="cpu", dtype=torch.float32)

    def layer_in(tok):
        return rmsnorm(params["embed"][tok].float(), blk["attn_norm"].float(), mcfg.rmsnorm_eps)

    x = layer_in(prompt)
    out_g, aux_g = nsa_prefill(pg, x, cfg)
    out_c, aux_c = nsa_prefill(pc, x.cpu(), cfg)
    differ = (canonicalize_sel(aux_g["sel_idx"].cpu()) != canonicalize_sel(aux_c["sel_idx"])
              ).any(-1).any(-1)                                        # [B,S]
    err = (out_g.cpu() - out_c).abs().amax(-1)                         # [B,S]
    worst = float(err[~differ].max())
    print(f"[layer] prefill f32 kernels vs plain: max_abs_err={worst:.3e} (bound {LAYER_TOL:g}) "
          f"over rows with equal selection; rows with a near-tie selection flip: "
          f"{int(differ.sum())} of {differ.numel()}")
    if not worst <= LAYER_TOL or differ.float().mean() > 1e-3:
        fail("layer prefill disagrees with the plain path")
    cg, cc = cache_from_prefill(cfg, aux_g, CAP), cache_from_prefill(cfg, aux_c, CAP)
    for i in range(4):
        xt = layer_in(tokens[:, S + i:S + i + 1])
        og, cg, ig = nsa_decode_step(pg, xt, cg, cfg)
        oc, cc, ic = nsa_decode_step(pc, xt.cpu(), cc, cfg)
        e = float((og.cpu() - oc).abs().max())
        want = expected_decode_reads(S + i + 1, cfg.l, cfg.d, cfg.l_sel, cfg.n_sel, cfg.w)
        same_sel = bool((ig.sel_idx.cpu() == ic.sel_idx).all())
        print(f"[layer] decode step t={S + i}: max_abs_err={e:.3e} reads_pred={ig.reads_pred} "
              f"(expected {want}) same selection: {same_sel}")
        if ig.reads_pred != want or ic.reads_pred != want:
            fail("decode read counters disagree with expected_decode_reads")
        if same_sel and not e <= LAYER_TOL:
            fail("layer decode disagrees with the plain path")


def phase_serve(dev) -> dict:
    mcfg = M7C_125M
    gen = torch.Generator().manual_seed(0)
    params = init_model_params(mcfg, gen, device=dev)
    prompt = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen).to(dev)
    n_params = sum(p.numel() for k, p in _leaves(params) if k != "W_qkv")
    print(f"[serve] m7c-125M: {mcfg.n_layers} layers, dim {mcfg.nsa.dim}, "
          f"{n_params / 1e6:.1f} M parameters, {mcfg.dtype}")
    with torch.no_grad():
        generate(params, prompt, 2, mcfg, capacity=CAP)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tokens = generate(params, prompt, N_NEW, mcfg, capacity=CAP)
        e1.record()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        decode_launches = sel_attn.decode_launches
        serve_ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        L = mcfg.n_layers
        want = {"select_cmp": L, "sel_attn": L + L * (N_NEW - 1), "win_attn": L}
        print(f"[serve] launches on the main path: {counts} "
              f"(sel_attn at decode: {decode_launches}); expected {want}")
        if counts != want:
            fail(f"launch counts {counts} != {want}")
        if tuple(tokens.shape) != (B, S + N_NEW) or not torch.equal(tokens[:, :S], prompt) \
                or int(tokens.min()) < 0 or int(tokens.max()) >= mcfg.vocab_size:
            fail("generate returned a malformed token tensor")
        logits, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
        if not bool(torch.isfinite(logits).all()):
            fail("prefill logits are not finite")
        prefill_ms = time_ms(lambda: model_prefill_with_caches(params, prompt, mcfg, CAP), 3, 1)
        tok = tokens[:, S:S + 1]
        t_host = time.perf_counter()
        e0.record()
        for i in range(N_NEW - 1):
            logits, caches = model_decode_step(params, tok, caches, mcfg)
            tok = tokens[:, S + i + 1:S + i + 2]
        e1.record()
        decode_host_ms = (time.perf_counter() - t_host) * 1e3 / (N_NEW - 1)
        torch.cuda.synchronize()
        decode_ms = e0.elapsed_time(e1) / (N_NEW - 1)
        if not bool(torch.isfinite(logits).all()):
            fail("decode logits are not finite")
        print(f"[serve] {B} requests x ({S} prompt + {N_NEW} new) tokens: generate "
              f"{serve_ms:.2f} ms, {B * N_NEW / (serve_ms / 1e3):.1f} new tokens/s")
        print(f"[serve] prefill {prefill_ms:.3f} ms ({B * S / (prefill_ms / 1e3):.0f} tokens/s); "
              f"decode {decode_ms:.4f} ms/token step ({B / (decode_ms / 1e3):.1f} tokens/s "
              f"over {B} rows), of which the host took {decode_host_ms:.4f} ms to issue")
        print(f"[serve] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
        # the serving path never makes the host wait for the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
            model_decode_step(params, tokens[:, S:S + 1], caches, mcfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print("[serve] prefill and decode step issued with no host-device synchronisation "
              "(torch.cuda.set_sync_debug_mode('error'))")
        layer_check(params, prompt, tokens, dev)
        trace(lambda: model_prefill_with_caches(params, prompt, mcfg, CAP), 1, "prefill",
              prefill_ms)
        _, caches = model_prefill_with_caches(params, prompt, mcfg, CAP)
        trace(lambda: model_decode_step(params, tokens[:, S:S + 1], caches, mcfg), 3,
              "decode step", decode_ms)
    return {"counts": counts, "decode_launches": decode_launches}


def trace(fn, n: int, what: str, wall_ms: float) -> None:
    """Device busy time of fn (mean of n calls) from torch.profiler: the sum
    of its kernels' durations, by kernel, beside the untraced wall time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = next((k for k in PORT_KERNELS if k in e.key), e.key[:48])
            by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    busy = sum(by_name.values())
    if busy <= 0:
        fail(f"the profiler saw no device time for the {what}")
    port = {k: by_name.get(k, 0.0) for k in PORT_KERNELS}
    others = sorted(((v, k) for k, v in by_name.items() if k not in PORT_KERNELS), reverse=True)
    print(f"[trace] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {1 - busy / wall_ms:.3f}); port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in port.items())
          + f"; other kernels {busy - sum(port.values()):.3f} ms, largest: "
          + "; ".join(f"{k} {v:.3f} ms" for v, k in others[:3]))


def _leaves(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, key)
    else:
        yield key, tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    phase_build()
    rec = phase_kernels(dev)
    serve = phase_serve(dev)
    rows = measure(rec, serve["counts"], serve["decode_launches"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{"route": "cuda", **r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
