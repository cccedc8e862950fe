#!/usr/bin/env python3
"""Probe torch.distributed on one NVIDIA card: what the sharded step
(``gnnome_tpu_torch/parallel/``) can run there.

    python3 scripts/torch_probe_dist.py

Two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one device):
``all_to_all_single`` on CUDA tensors in f32 and bf16 (directly and as an
int16 view), ``all_reduce``, the autograd of
``torch.distributed.nn.functional`` (its all-reduce's backward all-reduces
the cotangent), and the host ms of an all-to-all of 16 and 128 MB a rank,
on the CUDA tensors and staged through the host by hand. Then NCCL at
world size 1: an all-reduce, an all-to-all and a subgroup. Prints the
card's name and power limit first; needs a card.
"""
import datetime
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=60)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _try(out: dict, what: str, fn) -> None:
    try:
        out[what] = f"ok {fn()}"
    except Exception as exc:  # a probe reports what the backend refuses
        out[what] = f"refused: {type(exc).__name__}: {str(exc)[:200]}"


def gloo_rank(rank: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=TIMEOUT)
    dev = torch.device("cuda:0")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.arange(32, dtype=torch.float32, device=dev).reshape(8, 4)
             + 100 * rank).to(dt)

        def a2a(x=x):
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            return y[:, 0].tolist()

        def a2a_int16(x=x):
            xi = x.view(torch.int16) if x.element_size() == 2 else x.view(torch.int32)
            yi = torch.empty_like(xi)
            dist.all_to_all_single(yi, xi)
            return "moved"

        _try(out, f"all_to_all cuda {dt}", a2a)
        _try(out, f"all_to_all cuda {dt} as an integer view", a2a_int16)

    def all_reduce():
        z = torch.ones(5, device=dev) * (rank + 1)
        dist.all_reduce(z)
        return z.tolist()

    def nn_functional():
        import torch.distributed.nn.functional as F

        x = torch.ones(4, 2, device=dev, requires_grad=True)
        y = F.all_to_all_single(torch.empty(4, 2, device=dev), x)
        F.all_reduce(y.sum()).backward()
        return f"x.grad {x.grad[0].tolist()} (the true derivative is 1)"

    _try(out, "all_reduce cuda", all_reduce)
    _try(out, "torch.distributed.nn.functional grad", nn_functional)
    for mb in (16, 128):
        x = torch.randn(mb * 2**20 // 4, device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_to_all_single(y, x)
        torch.cuda.synchronize()
        out[f"all_to_all cuda {mb} MB ms"] = (time.perf_counter() - t0) / 3 * 1e3
        t0 = time.perf_counter()
        for _ in range(3):
            xc = x.cpu()
            yc = torch.empty_like(xc)
            dist.all_to_all_single(yc, xc)
            y.copy_(yc)
        torch.cuda.synchronize()
        out[f"all_to_all staged by hand {mb} MB ms"] = (time.perf_counter() - t0) / 3 * 1e3
    if rank == 0:
        for k, v in out.items():
            print(f"gloo, 2 ranks on cuda:0, {k}: {v}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_probe_dist: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.device_count(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    mp.spawn(gloo_rank, args=(_free_port(),), nprocs=2, join=True)
    print(f"gloo: two ranks spawned and joined in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, timeout=TIMEOUT, device_id=dev)
    try:
        z = torch.ones(3, device=dev)
        dist.all_reduce(z)
        y = torch.empty(4, device=dev)
        dist.all_to_all_single(y, torch.arange(4.0, device=dev))
        dist.all_reduce(z, group=dist.new_group([0]))
        torch.cuda.synchronize()
        print(f"nccl, world size 1: all_reduce {z.tolist()}, all_to_all {y.tolist()}, "
              f"a subgroup ran; backend {dist.get_backend()}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
