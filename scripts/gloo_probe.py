"""Which torch.distributed collectives gloo runs on CUDA tensors, and how
fast, with two ranks on one card (NCCL refuses two ranks on one device).

    python scripts/gloo_probe.py

Prints, for f32 and bf16, ok or the error of each collective the port's
parallel/mesh.py could use, then the time of an all-gather of 8.4 MB
(bf16) and of an all-reduce of 167.8 MB (f32), the fourth of four calls
each, from rank 0. Needs a card; imports torch only.
"""

import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    dev = torch.device("cuda:0")
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((1024,), float(rank + 1), device=dev, dtype=dt)
        calls = [
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(world * 1024, device=dev, dtype=dt), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(1024 // world, device=dev, dtype=dt), x)),
            ("reduce_scatter", lambda: dist.reduce_scatter(
                torch.empty(1024 // world, device=dev, dtype=dt), list(x.chunk(world)))),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_reduce_max", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)),
        ]
        for name, fn in calls:
            try:
                fn()
                torch.cuda.synchronize()
                ok = "ok"
            except Exception as e:   # report, do not stop: this probes what exists
                ok = "FAIL " + type(e).__name__ + ": " + str(e).splitlines()[0][:200]
            if rank == 0:
                print(f"{dt} {name}: {ok}", flush=True)
    for n, dt, op in [(4 << 20, torch.bfloat16, "all_gather"), (40 << 20, torch.float32,
                                                                 "all_reduce")]:
        x = torch.randn(n, device=dev).to(dt)
        for it in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if op == "all_gather":
                dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
            else:
                dist.all_reduce(x)
            torch.cuda.synchronize()
            if rank == 0 and it == 3:
                print(f"{op} {n * x.element_size() / 1e6:.1f} MB: "
                      f"{(time.perf_counter() - t) * 1e3:.2f} ms", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("gloo_probe: needs a card")
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    mp.spawn(run, args=(2, _free_port()), nprocs=2, join=True)
