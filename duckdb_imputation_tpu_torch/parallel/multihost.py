"""Multi-process orchestration over `torch.distributed`.

Counterpart of `duckdb_imputation_tpu.parallel.multihost` (`initialize`,
`global_mesh`, `union_vocab`, `make_global_arrays`). The JAX package runs
one program a host under `jax.distributed`; here one process a device
joins a process group: `initialize` wires it (the backend is always
named: NCCL over CUDA tensors, gloo on the CPU, or gloo over CUDA
tensors), `make_mesh` (parallel.mesh) is `global_mesh`'s counterpart,
`union_vocab` is the one exchange of host data (each rank's category
keys), and `local_shard` cuts a rank's rows out of whole arrays or a
Table, which `make_global_arrays` assembled the other way round.
"""
from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, all_reduce, make_mesh, row_shard

BACKENDS = ("nccl", "gloo")


def initialize(backend: str, *, world_size: int, rank: int,
               init_method: str | None = None, store=None, device=None,
               timeout: datetime.timedelta = datetime.timedelta(minutes=5)
               ) -> Mesh:
    """Join the default process group and return its mesh. backend: 'nccl'
    (CUDA tensors; `device`, default cuda:rank mod the card count, is made
    current) or 'gloo' (CPU tensors, or CUDA ones with device='cuda...').
    Give `init_method` (e.g. 'tcp://localhost:PORT' or 'file://PATH') or a
    `store`; `timeout` bounds every collective, so a rank that never
    arrives ends the run instead of hanging it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if (init_method is None) == (store is None):
        raise ValueError("give exactly one of init_method and store")
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=init_method,
                            store=store, world_size=world_size, rank=rank,
                            timeout=timeout)
    return make_mesh(device=device)


def shutdown() -> None:
    """Leave the default process group, if one is initialized."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def union_vocab(local_keys, mesh: Mesh | None = None
                ) -> tuple[tuple[int, ...], ...]:
    """The union over ranks of per-column key tuples (the distributed
    `build_list_of_uniq_categoricals`), sorted; the identity on a world
    of one. Ranks may hold vocabularies of different lengths: per column,
    one all-reduce of the lengths ([world] int64, each rank its own slot),
    then one of a zero [world, max_n] int64 buffer in which each rank
    fills its own row; each rank's prefix is read back by its length, so
    no pad value can pass for a key."""
    mesh = mesh or make_mesh()
    local_keys = tuple(tuple(int(v) for v in keys) for keys in local_keys)
    if mesh.group is None:
        return tuple(tuple(sorted(set(keys))) for keys in local_keys)
    out = []
    for keys in local_keys:
        lens = torch.zeros(mesh.world, dtype=torch.int64, device=mesh.device)
        lens[mesh.rank] = len(keys)
        lens = all_reduce(lens, mesh).tolist()
        buf = torch.zeros((mesh.world, max(max(lens), 1)), dtype=torch.int64,
                          device=mesh.device)
        buf[mesh.rank, :len(keys)] = torch.tensor(keys, dtype=torch.int64)
        rows = all_reduce(buf, mesh).cpu().numpy()
        vals = np.unique(np.concatenate(
            [rows[r, :lens[r]] for r in range(mesh.world)]))
        out.append(tuple(int(v) for v in vals))
    return tuple(out)


def local_shard(a, mesh: Mesh | None = None, *, rank: int | None = None,
                world: int | None = None):
    """Rank's rows [lo, hi) = `row_shard(n, rank, world)` of `a`: a Table
    (every tensor cut along its row axis), a tensor or an array (cut along
    its last axis), or a tuple/list of those. rank and world default to
    the mesh's."""
    from ..table.table import Table

    mesh = mesh if mesh is not None else (None if rank is not None
                                          else make_mesh())
    rank = mesh.rank if rank is None else rank
    world = mesh.world if world is None else world
    if isinstance(a, (tuple, list)):
        return type(a)(local_shard(x, rank=rank, world=world) for x in a)
    if a is None:
        return None
    if isinstance(a, Table):
        lo, hi = row_shard(a.n_rows, rank, world)
        return dataclasses.replace(
            a, num_data=a.num_data[:, lo:hi].contiguous(),
            cat_codes=a.cat_codes[:, lo:hi].contiguous(),
            num_null=a.num_null[:, lo:hi].contiguous(),
            cat_null=a.cat_null[:, lo:hi].contiguous())
    lo, hi = row_shard(a.shape[-1], rank, world)
    cut = a[..., lo:hi]
    return cut.contiguous() if isinstance(a, torch.Tensor) else cut.copy()
