"""Where the bf16 window backward at the sequence-parallel offset sits
against chip_smoke.py's tensor-core bound, and why.

    python scripts/offset_bound_probe.py

On phase (i-kernels)' bf16 inputs (8 x 2048 query rows at t_start 2048
against 4096 keys, the same seeded draws), for dQ, dK and dV of the
window backward: the error of the design's own arithmetic
(chip_smoke.py::bwd_rounded, P and dS rounded to bf16 before their
products) against the unrounded plain gradients in units of its modelled
standard deviation 0.85 * 2^-9 * rss (mean, std, max |z|, elements),
that arithmetic's and the kernel's (banded_bwd_1p) worst err/bound under
allowed_tc_err of the unrounded gradients, and at the kernel's worst
element its distance from the rounded arithmetic in the same units.
Needs a card; imports torch, the port and chip_smoke.py (the repo root).
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from nsa_vibe_tpu_torch.ops.reference import attention_delta  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_build()
    gen = torch.Generator(device=dev).manual_seed(2468)   # phase_offset_kernels': f32, then bf16
    cs.offset_kernel_inputs(torch.float32, dev, gen)
    torch.cuda.empty_cache()
    x = cs.offset_kernel_inputs(torch.bfloat16, dev, gen)
    cfg, sc, t0 = x["cfg"], x["scale"], x["t0"]
    args = (x["Q"], x["Kw"], x["Vw"], x["dO"], x["lse_w"], attention_delta(x["dO"], x["Ow"]))
    want, rss = cs.banded_bwd_rss(*args, mode="win", w=cfg.w, scale=sc, t_start=t0)
    mask = cs.banded_mask(x["Q"].shape[1], x["Kw"].shape[2], mode="win", w=cfg.w, t_start=t0,
                          device=dev)[None, :, None, None, :]
    center = cs.bwd_rounded(*args, mask, sc)
    got = cs.banded_bwd_1p(*args, mode="win", w=cfg.w, scale=sc, t_start=t0)
    for name, g, w, c, r in zip(("dQ", "dK", "dV"), got, want, center, rss):
        sigma = 0.85 * 2.0 ** -9 * r
        live = r > 0
        z = ((c - w) / torch.where(live, sigma, torch.ones_like(sigma)))[live]
        bound = cs.allowed_tc_err(w, r)
        ratio = (g.float() - w).abs() / bound
        k = int(ratio.argmax())
        off = float((g.float() - c).flatten()[k] / sigma.flatten()[k])
        print(f"[probe] {name}: rounded arithmetic vs unrounded, z mean {float(z.mean()):.4f} "
              f"std {float(z.std()):.4f} max |z| {float(z.abs().max()):.3f} over {z.numel()} "
              f"elements; worst err/bound: rounded arithmetic "
              f"{float(((c - w).abs() / bound).max()):.3f}, kernel {float(ratio.max()):.3f}; at "
              f"the kernel's worst element it sits {off:.3f} sigma from the rounded arithmetic")


if __name__ == "__main__":
    main()
