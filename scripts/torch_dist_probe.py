"""Which ``torch.distributed`` operations take CUDA tensors, on one card.

    python scripts/torch_dist_probe.py

Runs a world of one rank over NCCL and over gloo in this process, then each
operation below in its own world of two gloo ranks on ``cuda:0`` (spawned
processes: a crash ends only that world) and prints, per operation, OK with
its result, FAIL with the exception, or CRASH with the ranks' exit codes
(-6 an abort, -11 a segmentation fault). ``parallel.mesh.host_staged``
routes gloo's CUDA tensors through the host because of what this prints.
Prints the card's ``nvidia-smi`` name and power limit first.
"""

import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _op(name, rank, dev):
    """Run one operation; returns what it gave."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Shard,
        distribute_tensor,
    )

    peer = (rank + 1) % WORLD
    if name.startswith("batch_isend_irecv"):
        where = "cpu" if name.endswith("cpu") else dev
        x = torch.full((3, 4), float(rank), device=where)
        y = torch.empty((3, 4), device=where)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer),
                dist.P2POp(dist.irecv, y, peer)]):
            req.wait()
        return float(y[0, 0])
    if name == "all_gather cuda":
        out = [torch.empty(2, device=dev) for _ in range(WORLD)]
        dist.all_gather(out, torch.full((2,), float(rank), device=dev))
        return [float(t[0]) for t in out]
    mesh = init_device_mesh("cuda", (WORLD,), mesh_dim_names=("space",))
    if name == "distribute_tensor cuda (no communication)":
        full = torch.arange(8.0, device=dev).reshape(4, 2)
        return distribute_tensor(full, mesh, [Shard(0)],
                                 src_data_rank=None).to_local().tolist()
    if name == "DTensor.full_tensor cuda":
        local = torch.full((2, 3), float(rank), device=dev)
        return DTensor.from_local(local, mesh, [Shard(0)], run_check=False
                                  ).full_tensor()[:, 0].tolist()
    raise ValueError(name)


OPS = ("batch_isend_irecv cpu", "distribute_tensor cuda (no communication)",
       "batch_isend_irecv cuda", "all_gather cuda",
       "DTensor.full_tensor cuda")


def rank_main(rank, name, store):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        print(f"OK    {name} (rank {rank}): {_op(name, rank, dev)}",
              flush=True)
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        print(f"FAIL  {name} (rank {rank}): {type(e).__name__}: "
              f"{str(e)[:200]}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def world_of_one(backend):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("space",))
        whole = DTensor.from_local(torch.ones(2, 2, device="cuda"), mesh,
                                   [Shard(0)], run_check=False).full_tensor()
        print(f"OK    {backend} world of one: full_tensor sum "
              f"{float(whole.sum())}", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("torch_dist_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), f"| torch {torch.__version__}", flush=True)
    for backend in ("nccl", "gloo"):
        world_of_one(backend)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(OPS):
            procs = [ctx.Process(target=rank_main, args=(
                r, name, os.path.join(tmp, f"store{i}")))
                for r in range(WORLD)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            if any(codes):
                print(f"CRASH {name}: exit codes {codes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
