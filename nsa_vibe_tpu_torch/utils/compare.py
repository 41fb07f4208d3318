"""Parity checks of the port's prefill and selection.

Port of nsa_vibe_tpu/utils/compare.py. The JAX tool puts its Pallas
kernels against its own reference path; the port's counterpart puts the
route a tensor's device takes (the CUDA kernels on a card) against the
same layer on CPU tensors (the kernels' plain versions), branch by
branch under `force_branch`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nsa_vibe_tpu_torch.convert import params_to
from nsa_vibe_tpu_torch.core.nsa import nsa_prefill
from nsa_vibe_tpu_torch.ops.selection import canonicalize_sel


@torch.no_grad()
def debug_compare_prefill(params: dict, x: torch.Tensor, cfg,
                          branches=("cmp", "sel", "win")) -> dict:
    """nsa_prefill on x's device and on CPU copies of params and x, once
    per branch with the gate forced to it and once ungated. Returns
    {branch: mean |difference|, "all": the same ungated,
    "sel_idx_mismatch": share of (b, t, g) rows whose selected sets
    differ}."""
    p_cpu, x_cpu = params_to(params, device="cpu"), x.cpu()

    def both(force):
        c = dataclasses.replace(cfg, force_branch=force)
        return nsa_prefill(params, x, c), nsa_prefill(p_cpu, x_cpu, c)

    def mae(a, b):
        return float((a.cpu().float() - b.float()).abs().mean())

    out = {}
    for br in branches:
        (o, _), (o_cpu, _) = both(br)
        out[br] = mae(o, o_cpu)
    (o, aux), (o_cpu, aux_cpu) = both(None)
    out["all"] = mae(o, o_cpu)
    differ = (canonicalize_sel(aux["sel_idx"].cpu()) != canonicalize_sel(aux_cpu["sel_idx"]))
    out["sel_idx_mismatch"] = float(differ.any(-1).float().mean())
    return out


def validate_selection(sel_idx: torch.Tensor, t_pos: torch.Tensor, l_sel: int,
                       force_init: bool = True) -> Optional[str]:
    """Selection invariants (the reference's selection validators):
    causality (block start <= t), block 0 in every row when force_init,
    no block twice. sel_idx [B,S,G,n] with -1 pads, in any order (the
    scorer's forced-first form repeats forced slots by design, so check
    its `canonicalize_sel` form); t_pos [S]. Returns None if they hold,
    else a message naming the first row that breaks one."""
    s = sel_idx.cpu().long()
    t = t_pos.cpu().long()[None, :, None, None]
    srt = torch.sort(s, dim=-1).values
    checks = [
        ("causality violated", ((s >= 0) & (s * l_sel > t)).any(-1)),
        ("duplicate blocks", ((srt[..., 1:] >= 0) & (srt[..., 1:] == srt[..., :-1])).any(-1)),
    ]
    if force_init:
        checks.append(("block 0 not selected", ~(s == 0).any(-1)))
    for what, bad in checks:
        if bool(bad.any()):
            b, i, g = (int(v) for v in bad.nonzero()[0])
            return f"{what} at (b={b}, t={int(t_pos[i])}, g={g}): {s[b, i, g].tolist()}"
    return None
