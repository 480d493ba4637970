"""Start one process per rank and collect what each returns.

New in the port: the JAX package drives its mesh from one controller
process, which has no counterpart here.  run_ranks spawns `world`
processes (torch.multiprocessing, the spawn method), each joins the group
through a rendezvous file (init_method="file://..."; no TCP port, so
several groups can start at once on one host) in a fresh directory, under
build/ for CUDA ranks and the system's temporary directory otherwise, and
calls fn(shard, *args).

A spawned process imports fn's module anew, so fn lives in an importable
module that imports no JAX, and its arguments and result are picklable
(numpy arrays, numbers, strings, dicts of them).
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quantum_compute_dft_tpu_torch.parallel.mesh import grid_group

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rank_main(rank, fn, world, backend, device_kind, tmp, args):
    device = f"cuda:{rank}" if device_kind == "cuda" else device_kind
    shard = grid_group(backend, init_method=f"file://{tmp}/rendezvous",
                       rank=rank, world=world, device=device)
    out = fn(shard, *args)
    dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(fn, world: int, backend: str, device_kind: str, *args) -> list:
    """fn(shard, *args) on `world` ranks over `backend` ('nccl' or 'gloo')
    -> [each rank's result, by rank].  device_kind: 'cuda' puts rank r on
    card r; 'cpu', or one device such as 'cuda:0' (gloo ranks sharing a
    card), puts every rank there.  Raises when any rank raises (the others
    are then stopped)."""
    base = None
    if device_kind != "cpu":
        base = os.path.join(ROOT, "build")
        os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=base) as tmp:
        mp.start_processes(_rank_main, args=(fn, world, backend, device_kind,
                                             tmp, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
