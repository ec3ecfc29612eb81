"""The process mesh: one rank a process, each holding its own row shard
on its own device.

Counterpart of `duckdb_imputation_tpu.parallel.mesh` (`make_mesh`,
`row_sharding`, `replicated`). The JAX package runs one controller over a
`jax.sharding.Mesh` and places arrays on it; here every rank is a process
of a `torch.distributed` group and owns its tensors outright, so there is
no sharding object: a rank's rows are `row_shard(n, rank, world)` of the
global row order, and `replicated` has no counterpart (a tensor that every
rank holds the same is simply computed the same on every rank, as the
solves are from an all-reduced sigma).

Every collective of the port goes through the helpers here, `all_reduce`
(and `all_reduce_async`, its form that returns the work handle) and
`broadcast`: NCCL takes only CUDA tensors, and gloo takes CUDA tensors
only for these two collectives, so the port uses no other. A mesh
of one process with no group (`make_mesh()` before any
`init_process_group`) runs no collective at all.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the process group: `group` (None for a world of
    one without collectives), its `rank`, the `world` size, the `device`
    its tensors lie on and the group's `backend` ('nccl', 'gloo' or
    None)."""
    group: object
    rank: int
    world: int
    device: torch.device
    backend: str | None = None


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group`, else of the default group when one is
    initialized, else a world of one with no collective. device: where
    the rank's tensors lie; by default the current CUDA device (the card,
    as every entry point of the port), or pass 'cpu'."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cuda"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(group=None, rank=0, world=1, device=device)
    return Mesh(group=group, rank=dist.get_rank(group),
                world=dist.get_world_size(group), device=device,
                backend=str(dist.get_backend(group)))


def row_shard(n: int, rank: int, world: int) -> tuple[int, int]:
    """[lo, hi) of rank's rows among n: the first n % world ranks take
    one row more than the others (uneven shards; a rank may have none)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """Reduce `t` over the mesh in place ('sum', 'max' or 'min') and
    return it; every rank gets the same values. A mesh without a group
    returns t untouched."""
    work = all_reduce_async(t, mesh, op)
    if work is not None:
        work.wait()
    return t


def all_reduce_async(t: torch.Tensor, mesh: Mesh, op: str = "sum"):
    """Start reducing `t` over the mesh in place ('sum', 'max' or 'min')
    and return at once with the collective's work handle; `t` holds the
    reduction after `handle.wait()`. The pipelined reduction of
    `overlap.sum_to_triple_overlapped` issues one a sigma stripe, so the
    stripe's exchange runs while the next stripe is computed (the JAX
    package's per-stripe psum, which XLA issues asynchronously). A mesh
    without a group reduces nothing and returns None."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {tuple(_OPS)}, got {op!r}")
    if mesh.group is None:
        return None
    return dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]),
                           group=mesh.group, async_op=True)


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank, in place; returns t."""
    if mesh.group is not None:
        dist.broadcast(t, src=dist.get_global_rank(mesh.group, src)
                       if mesh.group is not dist.group.WORLD else src,
                       group=mesh.group)
    return t


def barrier(mesh: Mesh) -> None:
    """Wait for every rank: an all-reduce of one int (the port's only
    collectives are all-reduce and broadcast)."""
    all_reduce(torch.zeros(1, dtype=torch.int64, device=mesh.device), mesh)
