"""2-D sharded cofactor aggregation: rows over 'data', sigma's columns over
'model'.

Counterpart of `duckdb_imputation_tpu.parallel.sharded2d` (`make_mesh_2d`,
`_sigma_2d`, `sum_to_triple_sharded2d`). For a wide one-hot expansion
(large total vocab V) the P×P sigma itself is large (P = 1 + d + V; V =
64k ⇒ 16 GB f32), so each model rank owns a contiguous slice of sigma's
columns:

    S[:, cols_m] = Zᵀ · diag(w) · Z[:, cols_m]

The grid is a process grid over `torch.distributed`: rank r of the group
sits at (data, model) = divmod(r, n_model), as the JAX package's devices
reshape to [n_data, n_model]. Its `data` and `model` parts are
`parallel.mesh.Mesh` views over sub-groups made with `dist.new_group`
(every rank makes every sub-group, in one order, or the others hang), and
every collective still goes through `mesh.all_reduce` / `broadcast`. An
axis of one rank has no group and runs no collective.

Each rank aggregates its rows, `row_shard(n, data_rank, n_data)` (no row
padding: the kernels take any row count), against its columns
[m·cols_per, min((m + 1)·cols_per, P)), cols_per = ⌈P / n_model⌉, zero-
padded to cols_per as the JAX package pads the last shard: one launch of
K7 over that column window (`ring.kernels.sigma_pallas.masked_gram_window`)
on a CUDA table, its plain version on the CPU, then one all-reduce over
'data'. The JAX package builds a dense Zᵀ for the row shard and
multiplies it by the shard's columns. Inputs are each rank's own rows;
`shard_rows=True` takes whole arrays that every rank holds the same and
cuts the rank's row shard out of them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ring.kernels.sigma_pallas import masked_gram_window
from ..ring.sum import _normalize_inputs
from ..ring.triple import Triple, triple_from_sigma
from ..schema import FeatureSchema
from .mesh import Mesh, all_reduce, make_mesh, row_shard


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A rank's view of an n_data × n_model process grid: `data`, the
    ranks that hold its columns of sigma and other rows (rank = its data
    index), and `model`, the ranks that hold its rows and other columns
    (rank = its model index)."""
    data: Mesh
    model: Mesh


def make_mesh_2d(n_data: int, n_model: int, group=None,
                 device=None) -> Mesh2D:
    """The grid of `group` (by default the default group when one is
    initialized, else a world of one) as n_data × n_model; the group must
    have n_data·n_model ranks. device: as `make_mesh`'s."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"grid {n_data} × {n_model}: both at least 1")
    mesh = make_mesh(group, device)
    if mesh.world != n_data * n_model:
        raise ValueError(f"a grid of {n_data} × {n_model} needs "
                         f"{n_data * n_model} ranks, the group has "
                         f"{mesh.world}")
    d_rank, m_rank = divmod(mesh.rank, n_model)
    ranks = ([dist.get_global_rank(mesh.group, r) for r in range(mesh.world)]
             if mesh.group not in (None, dist.group.WORLD)
             else list(range(mesh.world)))
    data_group = model_group = None
    # every rank makes every sub-group, in this order
    for m in range(n_model) if n_data > 1 else ():
        g = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
        if m == m_rank:
            data_group = g
    for d in range(n_data) if n_model > 1 else ():
        g = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
        if d == d_rank:
            model_group = g
    backend = mesh.backend
    return Mesh2D(
        data=Mesh(group=data_group, rank=d_rank, world=n_data,
                  device=mesh.device,
                  backend=backend if data_group is not None else None),
        model=Mesh(group=model_group, rank=m_rank, world=n_model,
                   device=mesh.device,
                   backend=backend if model_group is not None else None))


def cols_per_rank(p: int, n_model: int) -> int:
    """Columns of sigma a model rank owns: ⌈P / n_model⌉ (the last rank's
    block is zero-padded to it)."""
    return -(-p // n_model)


def _rows(tensors, mesh: Mesh2D, shard_rows: bool) -> list:
    """The rank's rows of each tensor (its last axis; None stays None):
    `row_shard(n, data_rank, n_data)` with `shard_rows`, else the tensors
    as they are."""
    tensors = list(tensors)
    if not shard_rows:
        return tensors
    n = next(t for t in tensors if t is not None).shape[-1]
    lo, hi = row_shard(n, mesh.data.rank, mesh.data.world)
    return [None if t is None else t[..., lo:hi].contiguous()
            for t in tensors]


def _sigma_2d(x_num, codes, weights, *, schema: FeatureSchema,
              mesh: Mesh2D, shard_rows: bool = False) -> torch.Tensor:
    """The rank's block of sigma, f32[P, cols_per]: the Gram of every data
    rank's rows against the rank's columns (zero past P), one window
    launch and one all-reduce over 'data'."""
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    x, c, w = _rows((x, c, w), mesh, shard_rows)
    p = schema.sigma_size
    cols_per = cols_per_rank(p, mesh.model.world)
    lo = mesh.model.rank * cols_per
    width = min(cols_per, p - lo)
    if width == cols_per:
        block = masked_gram_window(list(x.unbind(0)), list(c.unbind(0)), w,
                                   schema=schema, lo=lo, width=width)
    else:
        block = torch.zeros((p, cols_per), dtype=torch.float32,
                            device=x.device)
        if width > 0:
            block[:, :width] = masked_gram_window(
                list(x.unbind(0)), list(c.unbind(0)), w, schema=schema,
                lo=lo, width=width)
    return all_reduce(block, mesh.data)


def sum_to_triple_sharded2d(x_num=None, codes=None, weights=None, *,
                            schema: FeatureSchema, mesh: Mesh2D,
                            shard_rows: bool = False) -> Triple:
    """Aggregate with rows sharded over 'data' and sigma's columns over
    'model', then gather the blocks into a Triple on every rank (one more
    all-reduce, over 'model'; it holds P × P, so it is for narrow schemas
    and tests). Wide-V flows skip the Triple and feed
    `parallel.wide.sigma_wide`'s block straight into the column-sharded
    CG solves, which keep a rank's sigma at P × cols_per throughout."""
    block = _sigma_2d(x_num, codes, weights, schema=schema, mesh=mesh,
                      shard_rows=shard_rows)
    # each rank's block in its columns of a zero matrix, summed over 'model'
    cols_per = block.shape[1]
    full = torch.zeros((block.shape[0], cols_per * mesh.model.world),
                       dtype=block.dtype, device=block.device)
    lo = mesh.model.rank * cols_per
    full[:, lo:lo + cols_per] = block
    sigma = all_reduce(full, mesh.model)[:, :schema.sigma_size]
    return triple_from_sigma(sigma.contiguous(), schema.num_cols)
