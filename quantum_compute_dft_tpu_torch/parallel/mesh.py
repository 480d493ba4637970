"""The rank group of the multi-GPU path, and how grid arrays are cut.

Port of ``quantum_compute_dft_tpu/parallel/mesh.py``.  The JAX package
shards over a device mesh driven by one controller; here each rank is a
process with one device, joined to the others by ``torch.distributed``
(NCCL on the card; gloo on the CPU, or when the caller asks for it, as for
two ranks sharing one card).  One rank is the world-of-1 case of the same
code: no separate code path.

Padding with zeros makes the sharding exact: a zero-weight grid point and a
zero aux column or ERI row add nothing to any sum.

Collectives go through two helpers, :func:`all_reduce_sum` and
:func:`broadcast`: PyTorch's backend table lists only ``broadcast`` and
``all_reduce`` for gloo on CUDA tensors.  The JAX package's
``all_gather`` of row blocks becomes an ``all_reduce`` of zero-filled
full-size blocks, which gives the same matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's place in the group: its rank, the world size, the
    process group (None: the default group) and its device."""

    rank: int
    world: int
    group: object
    device: torch.device


def grid_group(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world: int | None = None,
               device=None) -> Shard:
    """The counterpart of grid_mesh: joins the process group (or wraps the
    default one, when it is already initialized) -> Shard.

    device defaults to cuda:<rank>; backend to nccl on a CUDA device and
    gloo on the CPU.  Nothing here falls back: a failed init raises."""
    if not dist.is_initialized():
        if device is None:
            device = f"cuda:{rank}"
        device = torch.device(device)
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        device = f"cuda:{rank}"
    return Shard(rank, world, None, torch.device(device))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int):
    """Zero-pad `axis` so its size divides `multiple` (zero quadrature
    weights make padding exact, not approximate)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths)


def local_block(shard: Shard, arr, axis: int) -> torch.Tensor:
    """This rank's block of `arr` (numpy or tensor, on any device) along
    `axis`, as pad_to_multiple(arr, world, axis) would cut it: a fresh f64
    tensor on the rank's device, zero-filled past the end of `arr`.  It
    shares no memory with `arr`, so the caller may free the whole array."""
    arr = torch.as_tensor(arr)
    n = arr.shape[axis]
    b = -(-n // shard.world)
    lo = min(shard.rank * b, n)
    hi = min(lo + b, n)
    shape = list(arr.shape)
    shape[axis] = b
    out = torch.zeros(shape, dtype=torch.float64, device=shard.device)
    out.narrow(axis, 0, hi - lo).copy_(arr.narrow(axis, lo, hi - lo))
    return out


def shard_grid_arrays(shard: Shard, ao, weights, ao_grad=None):
    """This rank's rows of the grid arrays: ao (ngrid, nao), weights
    (ngrid,) and ao_grad (3, ngrid, nao) or None, contiguous on the rank's
    device (the JAX package's P(grid, None), P(grid), P(None, grid, None))."""
    g = None if ao_grad is None else local_block(shard, ao_grad, 1)
    return local_block(shard, ao, 0), local_block(shard, weights, 0), g


def _all_reduce(shard: Shard, t: torch.Tensor, op) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=shard.group)
    return t


def all_reduce_sum(shard: Shard, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; every rank gets the same bits."""
    return _all_reduce(shard, t, dist.ReduceOp.SUM)


def broadcast(shard: Shard, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank, in place."""
    dist.broadcast(t, src=src, group=shard.group)
    return t


def replica_spread(shard: Shard, t: torch.Tensor) -> float:
    """max over ranks of max |t - rank 0's t|: 0.0 when the replicated
    tensor `t` holds the same bits on every rank."""
    ref = broadcast(shard, t.clone())
    d = torch.abs(t - ref).max().reshape(1)
    return float(_all_reduce(shard, d, dist.ReduceOp.MAX))
