"""Which torch.distributed collectives gloo runs on CUDA tensors, and how
fast, with two ranks on one card (NCCL refuses two ranks on one device).

    python scripts/gloo_probe.py

Prints, for f32 and bf16, ok or the error of each collective the port's
parallel/mesh.py could use, and of point-to-point send/recv and
batch_isend_irecv on host tensors (each rank its own line; a call that
blocks gives up after the group's 30 s timeout), then the time of an all-gather of 8.4 MB (bf16), of
an all-reduce of 167.8 MB (f32) and of a send of one pipeline activation
of 12.6 MB (bf16 [2, 4096, 768], staged through host memory as
parallel/mesh.py::send_to does under gloo), the fourth of four calls
each, from rank 0; last, send/recv of a CUDA tensor in a process group of
its own, f32 and bf16 (gloo aborts the process there rather than raise,
so the probe reports how the ranks died). Needs a card; imports torch only.
"""

import datetime
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
                            rank=rank, timeout=datetime.timedelta(seconds=30))
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
        peer = 1 - rank
        y = torch.zeros(1024, dtype=dt)
        z = torch.full((1024,), float(rank + 1), dtype=dt)

        def send_recv():
            if rank == 0:
                dist.send(z, peer)
            else:
                dist.recv(y, peer)
                assert float(y[0]) == 1.0

        def batched():
            ops = [dist.P2POp(dist.isend, z, peer), dist.P2POp(dist.irecv, y, peer)]
            for r in dist.batch_isend_irecv(ops):
                r.wait()
            assert float(y[0]) == peer + 1

        for name, fn in (("send/recv", send_recv), ("batch_isend_irecv", batched)):
            try:
                fn()
                ok = "ok"
            except Exception as e:   # report, do not stop
                ok = "FAIL " + type(e).__name__ + ": " + str(e).splitlines()[0][:200]
            print(f"rank {rank} {dt} {name} on host tensors: {ok}", flush=True)
        dist.barrier()
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
    act = torch.randn(2, 4096, 768, device=dev).to(torch.bfloat16)
    for it in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if rank == 0:
            dist.send(act.cpu(), 1)
        else:
            buf = torch.empty(act.shape, dtype=act.dtype)
            dist.recv(buf, 0)
            buf.to(dev)
        torch.cuda.synchronize()
        dist.barrier()
        if rank == 0 and it == 3:
            print(f"send (host-staged) {act.numel() * 2 / 1e6:.1f} MB: "
                  f"{(time.perf_counter() - t) * 1e3:.2f} ms", flush=True)
    dist.destroy_process_group()


def run_cuda_p2p(rank: int, world: int, port: int, dt: torch.dtype) -> None:
    """send/recv of a CUDA tensor, alone in its process group: gloo may
    abort the process rather than raise."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=30))
    x = torch.full((1024,), float(rank + 1), device="cuda:0", dtype=dt)
    if rank == 0:
        dist.send(x, 1)
    else:
        dist.recv(x, 0)
        assert float(x[0]) == 1.0
    print(f"rank {rank} {dt} send/recv on cuda tensors: ok", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("gloo_probe: needs a card")
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    mp.spawn(run, args=(2, _free_port()), nprocs=2, join=True)
    for dt in (torch.float32, torch.bfloat16):
        try:
            mp.spawn(run_cuda_p2p, args=(2, _free_port(), dt), nprocs=2, join=True)
        except Exception as e:   # report, do not stop: this probes what exists
            print(f"{dt} send/recv on cuda tensors: FAIL, the ranks died: "
                  f"{type(e).__name__}: {e}", flush=True)
