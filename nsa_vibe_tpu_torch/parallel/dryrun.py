"""One sharded training step on every mesh the JAX package's dry run
builds, over torch.distributed.

The port's twin of `__graft_entry__.py::dryrun_multichip` (which it does
not import): the same meshes, shapes, configurations, seeds and batches
(numpy's default_rng), each step's loss finite as there, and besides held
to one process's loss on the same global batch (`DRYRUN_TOL`). The
model: dim 128, 8 heads in 2 KV groups, d_k = d_v = 32, l 8, d 4, l_sel
16, n_sel 4, w 32, 2 layers, vocab 256, f32, remat. On n ranks (n the
world size):
  * dp x tp (dp = n / 2, tp = 2) + fsdp (fsdp_min_size 64), 2 accumulated
    micro-batches of dp rows x 64;
  * n >= 4: dp x sp x tp (sp 2, tp 2, dp n / 4);
  * n >= 4: dp x pp (2 x 2, 4 rows, 2 micro-batches), on ranks [0, 4);
  * n >= 8: dp x pp x sp (2 x 2 x 2), dp x pp x tp (2 x 2 x 2) and
    pp x sp x tp (2 x 2 x 2);
  * sequence-parallel prefill of one NSA layer at sp = min(n, 8), on
    ranks [0, sp), against one process's prefill of the same rows.
A mesh on ranks [0, k) leaves the others idle for that step
(parallel/mesh.py::make_mesh(size=k)). Rank 0 prints the JAX run's tail
line. Any mismatch raises, so the rank and torchrun exit non-zero.

Run (one rank a card, NCCL):
    torchrun --nproc-per-node 8 -m nsa_vibe_tpu_torch.parallel.dryrun
eight ranks sharing one card, or on the CPU:
    torchrun --nproc-per-node 8 -m nsa_vibe_tpu_torch.parallel.dryrun \
        --device cuda:0 --backend gloo
    torchrun --nproc-per-node 4 -m nsa_vibe_tpu_torch.parallel.dryrun --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nsa_vibe_tpu_torch.core.config import ModelConfig, NSAConfig, TrainConfig
from nsa_vibe_tpu_torch.core.nsa import init_nsa_params, nsa_prefill
from nsa_vibe_tpu_torch.models.tinylm import init_model_params
from nsa_vibe_tpu_torch.parallel.context import context_parallel_prefill
from nsa_vibe_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from nsa_vibe_tpu_torch.parallel.train_step import build_state_and_step, local_batch
from nsa_vibe_tpu_torch.train.train_step import init_train_state, make_train_step
from nsa_vibe_tpu_torch.utils.device import resolve_device

NSA = NSAConfig(dim=128, n_heads=8, n_kv_groups=2, d_k=32, d_v=32, l=8, d=4, l_sel=16, n_sel=4,
                w=32)
MODEL = ModelConfig(vocab_size=256, n_layers=2, nsa=NSA, dtype="float32", remat=True)
SEQ = 64
# a mesh's loss vs one process's on the same batch (f32, relative): the
# sums run in other orders, and near-tie selections may flip
DRYRUN_TOL = 1e-4


def _tokens(seed: int, accum: int, rows: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (accum, rows, SEQ + 1))


def _step(label: str, tcfg: TrainConfig, mesh_kw: dict, seed: int, dev,
          size: Optional[int] = None) -> Optional[float]:
    """One step of `tcfg` on make_mesh(**mesh_kw, size=size) from the
    seed-0 parameters and batch `seed`; its loss, held finite and to one
    process's on rank 0 (None on a rank outside the mesh)."""
    mesh = make_mesh(**mesh_kw, size=size)
    if mesh is None:
        return None
    toks = torch.from_numpy(_tokens(seed, tcfg.accum_steps, tcfg.batch_size)).long().to(dev)
    step, state = build_state_and_step(
        init_model_params(MODEL, torch.Generator().manual_seed(0), device=dev), MODEL, tcfg,
        mesh)
    _, met = step(state, local_batch(toks, mesh))
    loss = float(met["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"{label}: non-finite loss {loss}")
    if mesh.rank == 0:
        one = make_train_step(MODEL, dataclasses.replace(tcfg, dp=0, sp=1, pp=1, tp=1,
                                                         fsdp=False))
        st1 = init_train_state(init_model_params(MODEL, torch.Generator().manual_seed(0),
                                                 device=dev), tcfg)
        ref = float(one(st1, toks)[1]["loss"])
        gap = abs(loss - ref) / abs(ref)
        print(f"[dryrun] {label}: loss {loss:.6f}, one process {ref:.6f} (relative gap "
              f"{gap:.3e}, bound {DRYRUN_TOL:g})", flush=True)
        if not gap <= DRYRUN_TOL:
            raise RuntimeError(f"{label}: loss {loss} differs from one process's {ref}")
    return loss


def _prefill(sp: int, dev) -> None:
    """Sequence-sharded prefill of one NSA layer over ranks [0, sp): each
    rank's rows finite and within 1e-4 of one process's prefill."""
    mesh = make_mesh(sp=sp, size=sp)
    if mesh is None:
        return
    params = init_nsa_params(NSA, torch.Generator().manual_seed(1), device=dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, sp * NSA.l_sel * 2, NSA.dim))).float().to(dev)
    s = x.shape[1] // sp
    with torch.no_grad():
        out = context_parallel_prefill(params, x[:, mesh.sp_rank * s:(mesh.sp_rank + 1) * s],
                                       NSA, mesh)
        ref = nsa_prefill(params, x, NSA)[0][:, mesh.sp_rank * s:(mesh.sp_rank + 1) * s]
    err = float((out - ref).abs().max())
    if not bool(torch.isfinite(out).all()) or not err <= 1e-4:
        raise RuntimeError(f"context-parallel prefill rank {mesh.rank}: finite "
                           f"{bool(torch.isfinite(out).all())}, max |err| {err:.3e} vs one process")


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: Optional[str] = None) -> str:
    """One training step on each mesh of the JAX dry run over the n_devices
    ranks of the world (torchrun); returns (and rank 0 prints) the JAX
    run's tail line. device: "cuda" (cuda:LOCAL_RANK), "cuda:N" (every
    rank on card N; pass backend="gloo") or "cpu"."""
    initialize_distributed(backend)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of {n_devices} ranks, "
                         f"got {dist.get_world_size()}")
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    n = n_devices
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // tp
    loss = _step(f"mesh {dp}x{tp} (dp x tp) + fsdp",
                 TrainConfig(steps=10, batch_size=dp, seq_len=SEQ, accum_steps=2, tp=tp,
                             fsdp=True, fsdp_min_size=64), dict(dp=dp, tp=tp), 0, dev)
    if n >= 4:
        dp_t = n // (2 * tp) if n % (2 * tp) == 0 else 1
        _step(f"dp {dp_t} x sp 2 x tp {tp}",
              TrainConfig(steps=2, batch_size=dp_t, seq_len=SEQ, sp=2, tp=tp),
              dict(dp=dp_t, sp=2, tp=tp), 2, dev, size=dp_t * 2 * tp)
        _step("dp 2 x pp 2", TrainConfig(steps=2, batch_size=4, seq_len=SEQ, pp=2,
                                         pp_microbatches=2), dict(dp=2, pp=2), 3, dev, size=4)
    if n >= 8:
        _step("dp 2 x pp 2 x sp 2", TrainConfig(steps=2, batch_size=4, seq_len=SEQ, pp=2, sp=2,
                                                pp_microbatches=2),
              dict(dp=2, pp=2, sp=2), 4, dev, size=8)
        _step("dp 2 x pp 2 x tp 2", TrainConfig(steps=2, batch_size=4, seq_len=SEQ, pp=2, tp=2,
                                                pp_microbatches=2),
              dict(dp=2, pp=2, tp=2), 5, dev, size=8)
        _step("pp 2 x sp 2 x tp 2", TrainConfig(steps=2, batch_size=2, seq_len=SEQ, pp=2, sp=2,
                                                tp=2, pp_microbatches=2),
              dict(dp=1, pp=2, sp=2, tp=2), 6, dev, size=8)
    sp = n if n <= 8 else 8
    _prefill(sp, dev)
    line = (f"dryrun_multichip({n}): mesh {dp}x{tp} ok, loss={loss:.4f}; "
            f"pp train ok; pp x sp train ok; pp x tp train ok; "
            f"pp x sp x tp train ok; cp prefill sp={sp} ok")
    dist.barrier()
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description="The JAX dry run's meshes, one step each "
                                             "(run under torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK), cuda:N (every rank on card N) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on a card, gloo on the CPU; gloo for ranks sharing a card")
    args = ap.parse_args()
    dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), args.device, args.backend)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
