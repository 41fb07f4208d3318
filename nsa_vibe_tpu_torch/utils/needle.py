"""Needle retrieval probes of the long-context path.

Port of nsa_vibe_tpu/utils/needle.py (`needle_probe`) and of the body of
bench/needle_smoke.py (`needle_smoke`).

* `needle_probe` runs the whole NSA layer: prefill of S-1 tokens, then one
  cached decode step of the probe query (or the prefill of all S tokens
  with decode=False), and asks that the query's attention output retrieve
  the needle's VALUE. Construction (as the JAX probe): x chunk 0 carries
  the key signature, chunk 1 the value signature; W_Q and the W_K_* map
  chunk 0 into every head, the W_V_* map chunk 1, W_O averages the heads
  back into chunk 0, all with small noise; the needle spans one ϕ window
  (l tokens) with key k0 and value v0; the query carries k0 and no value.
  rope_scale is huge, so rotary phases are ~0. Pass: every group selects
  the needle's block, cos(out[:d_v], v0) > 0.5, and the ablated control
  (no needle) < 0.25. The inputs come from numpy (`default_rng(seed)`),
  the parameters from a torch.Generator or from the caller (a test passes
  the JAX probe's own through `convert.params_from_numpy`).
* `needle_smoke` runs only the Eq. 8-12 selection (the select_blocks
  kernel on a card) for one query row at position S-1 over a planted
  compressed stream, and asks that it select the needle's block.

CLI (on the card unless --device cpu):

    python -m nsa_vibe_tpu_torch.utils.needle probe --S 65536 --depths 0.1,0.5,0.9
    python -m nsa_vibe_tpu_torch.utils.needle smoke --S 65536
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from nsa_vibe_tpu_torch.core.cache import cache_from_prefill
from nsa_vibe_tpu_torch.core.config import NSAConfig
from nsa_vibe_tpu_torch.core.decode import nsa_decode_step
from nsa_vibe_tpu_torch.core.nsa import PROJ_KEYS, fuse_projections, init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.ops.attention import select_blocks
from nsa_vibe_tpu_torch.ops.block_index import num_cmp_blocks
from nsa_vibe_tpu_torch.utils.device import resolve_device, torch_dtype

# bench/needle_e2e.py's and bench/needle_smoke.py's configuration
NEEDLE_CFG = NSAConfig(dim=256, n_heads=4, n_kv_groups=2, d_k=64, d_v=64, l=32, d=16,
                       l_sel=64, n_sel=16, w=512)


def _broadcast_chunk(gen: torch.Generator, dim: int, out: int, d: int, src_chunk: int,
                     eps: float = 0.005) -> torch.Tensor:
    """[dim, out] f32 matrix mapping x[src_chunk*d:(src_chunk+1)*d]
    identically into every d-sized slice of the output (+ noise)."""
    w = torch.zeros((dim, out))
    for j in range(out // d):
        w[src_chunk * d:(src_chunk + 1) * d, j * d:(j + 1) * d] = torch.eye(d)
    return w + torch.randn((dim, out), generator=gen) * eps


def _probe_params(cfg: NSAConfig, dtype, seed: int, device) -> dict:
    params = init_nsa_params(cfg, torch.Generator().manual_seed(seed), device=device,
                             dtype=dtype)
    gen = torch.Generator().manual_seed(seed + 100)
    d, dim, H, G = cfg.d_k, cfg.dim, cfg.n_heads, cfg.n_kv_groups
    new = {"W_Q": _broadcast_chunk(gen, dim, H * d, d, 0)}
    for n in ("W_K_sel", "W_K_win", "W_K_cmp"):
        new[n] = _broadcast_chunk(gen, dim, G * d, d, 0)
    for n in ("W_V_sel", "W_V_win", "W_V_cmp"):
        new[n] = _broadcast_chunk(gen, dim, G * cfg.d_v, cfg.d_v, 1)
    wo = torch.zeros((H * cfg.d_v, dim))
    for hh in range(H):        # W_O: average head outputs into chunk 0
        wo[hh * cfg.d_v:(hh + 1) * cfg.d_v, :cfg.d_v] = torch.eye(cfg.d_v) / H
    new["W_O"] = wo + torch.randn(wo.shape, generator=gen) * 0.005
    params = {k: v for k, v in params.items() if k != "W_qkv" and k not in PROJ_KEYS}
    params.update({k: v.to(device=device, dtype=dtype) for k, v in new.items()})
    return fuse_projections(params)


def needle_probe(cfg: NSAConfig, S: int, depth: float, dtype=torch.float32, seed: int = 0,
                 decode: bool = True, device="cuda", params: dict = None) -> dict:
    """Plant the needle at `depth` of an S-token context and probe it
    (module docstring). params: the probe's parameters (default: made from
    `seed`), built for cfg with rope_scale=1e9. Returns {S, depth,
    needle_pos, found_sel, cos_needle, cos_ablated, pass_}."""
    cfg = dataclasses.replace(cfg, rope_scale=1e9)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    d, dim = cfg.d_k, cfg.dim
    if params is None:
        params = _probe_params(cfg, dtype, seed, dev)

    rng = np.random.default_rng(seed)
    k0 = rng.normal(0, 1, (d,))
    k0 /= np.linalg.norm(k0)
    v0 = rng.normal(0, 1, (cfg.d_v,))
    v0 /= np.linalg.norm(v0)
    needle_pos = (int((S - 2 - cfg.l) * depth) // cfg.d) * cfg.d
    base = rng.normal(0, 0.05, (1, S, dim)).astype(np.float32)
    query = np.zeros((dim,), np.float32)
    query[:d] = k0 * 4.0                                # key match, no value
    needle_row = np.zeros((dim,), np.float32)
    needle_row[:d] = k0 * 4.0
    needle_row[d:d + cfg.d_v] = v0 * 4.0

    @torch.no_grad()
    def run(plant: bool):
        x = base.copy()
        if plant:
            x[0, needle_pos:needle_pos + cfg.l] = needle_row
        x[0, S - 1] = query
        xt = torch.from_numpy(x).to(device=dev, dtype=dtype)
        if decode:
            # prefill the first S-1 tokens, then decode the query as token S
            _, aux = nsa_prefill(params, xt[:, :S - 1], cfg)
            cache = cache_from_prefill(cfg, aux, capacity=S + 8)
            out, _, info = nsa_decode_step(params, xt[:, S - 1:], cache, cfg)
            sel_final = info.sel_idx[0, 0]
            o = out[0, 0]
        else:
            out, aux = nsa_prefill(params, xt, cfg)
            sel_final = aux["sel_idx"][0, S - 1]
            o = out[0, S - 1]
        v = o.float().cpu().numpy()[:cfg.d_v]
        return sel_final.cpu().numpy(), float(v @ v0 / (np.linalg.norm(v) + 1e-8))

    sel_final, cos_needle = run(plant=True)
    _, cos_ablated = run(plant=False)
    needle_block = needle_pos // cfg.l_sel
    found_sel = all(needle_block in sel_final[g] for g in range(cfg.n_kv_groups))
    return {
        "S": S, "depth": depth, "needle_pos": needle_pos,
        "found_sel": bool(found_sel),
        "cos_needle": cos_needle, "cos_ablated": cos_ablated,
        "pass_": bool(found_sel and cos_needle > 0.5 and cos_ablated < 0.25),
    }


def smoke_inputs(rng: np.random.Generator, S: int, depth: float, cfg: NSAConfig = NEEDLE_CFG):
    """One needle smoke case (bench/needle_smoke.py's construction, drawn
    from `rng` in its order): K_cmp [1,G,S_cmp,d_k] small noise plus 10 x a
    unit direction on every compressed token whose window covers the
    needle, and the query Q [1,1,G,h,d_k] = 10 x that direction. Returns
    (Q, K_cmp, needle_pos) as f32 numpy arrays and an int."""
    G, h = cfg.n_kv_groups, cfg.h_per_group
    S_cmp = num_cmp_blocks(S, cfg.l, cfg.d)
    needle_pos = int(S * depth)
    K_cmp = rng.normal(0, 0.02, (1, G, S_cmp, cfg.d_k)).astype(np.float32)
    covering = [i for i in range(S_cmp) if i * cfg.d <= needle_pos < i * cfg.d + cfg.l]
    direction = rng.normal(0, 1, (cfg.d_k,)).astype(np.float32)
    direction /= np.linalg.norm(direction)
    K_cmp[:, :, covering] += direction * 10.0
    Q = np.broadcast_to(direction * 10.0, (1, 1, G, h, cfg.d_k)).astype(np.float32)
    return Q, K_cmp, needle_pos


def needle_smoke(S: int = 65536, depths=(0.1, 0.25, 0.5, 0.75, 0.9), device="cuda",
                 dtype=torch.bfloat16, cfg: NSAConfig = NEEDLE_CFG) -> dict:
    """Selection alone at the last query row (t = S-1) of an S-token
    context, one planted needle per depth; every group must select the
    needle's block. Returns {S, pass, results: [{depth, pos, found, sel,
    s}]} with sel the [G, n] block ids."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    S_sel = -(-S // cfg.l_sel)
    rng = np.random.default_rng(0)
    results = []
    for depth in depths:
        Q, K_cmp, needle_pos = smoke_inputs(rng, S, depth, cfg)
        t0 = time.perf_counter()
        sel = select_blocks(
            torch.from_numpy(Q).to(device=dev, dtype=dtype),
            torch.from_numpy(K_cmp).to(device=dev, dtype=dtype), S_sel=S_sel,
            scale=1.0 / float(np.sqrt(cfg.d_k)), l=cfg.l, d=cfg.d, l_sel=cfg.l_sel,
            n_top=cfg.n_sel, force_init=cfg.force_init, force_local=cfg.force_local,
            pos_offset=S - 1)[0, 0].cpu().numpy()
        dt = time.perf_counter() - t0
        needle_block = needle_pos // cfg.l_sel
        found = all(needle_block in sel[g] for g in range(cfg.n_kv_groups))
        results.append({"depth": depth, "pos": needle_pos, "found": bool(found),
                        "sel": sel.tolist(), "s": dt})
    return {"S": S, "pass": all(r["found"] for r in results), "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=("probe", "smoke"))
    ap.add_argument("--S", type=int, default=65536)
    ap.add_argument("--depths", default=None,
                    help="comma-separated (default: 0.1,0.5,0.9 probe; 0.1,0.25,0.5,0.75,0.9 "
                         "smoke)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    depths = [float(x) for x in (args.depths or ("0.1,0.5,0.9" if args.tool == "probe"
                                                  else "0.1,0.25,0.5,0.75,0.9")).split(",")]
    if args.tool == "smoke":
        out = needle_smoke(args.S, depths, args.device, args.dtype)
        for r in out["results"]:
            r.pop("sel")
        print(json.dumps(out))
        return 0 if out["pass"] else 1
    ok = True
    for depth in depths:
        t0 = time.perf_counter()
        r = needle_probe(NEEDLE_CFG, args.S, depth, dtype=args.dtype, device=args.device)
        r["s"] = time.perf_counter() - t0
        ok &= r["pass_"]
        print(json.dumps(r), flush=True)
    print(json.dumps({"S": args.S, "pass": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
