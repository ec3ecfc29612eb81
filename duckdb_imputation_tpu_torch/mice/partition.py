"""MICE initialization and partitioning on the table's device.

Counterpart of `duckdb_imputation_tpu.mice.partition`:
- `init_fill`: mean-fill numeric nulls, mode-fill categorical nulls
  (AVG/MODE fill of the reference's partition.cpp:42-57, init_baseline
  :671-719). The JAX package does this on the host in numpy f64; here it
  runs on the device that holds the table, so a 10M-row table never
  round-trips through host memory. Over a mesh of row shards the means
  and modes are the whole table's (the JAX package fills the whole table
  before it shards it): the f64 sums, counts and bincounts are
  all-reduced.
- `build_partitions`: the reference's physical partition tables
  (partition.cpp:77-237) as index tensors instead: per-column dirty rows,
  complete rows, all-null rows. Null positions never move, so the delta
  loop computes them once. The JAX package keeps them as host numpy
  arrays; here they are int64 tensors on the table's device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel.mesh import all_reduce
from ..table.table import Table


@dataclasses.dataclass(frozen=True)
class Partitions:
    """Partition structure of a table, static per table (int64 row ids)."""
    null_counts: torch.Tensor                # i32[n] per-row null count
    num_dirty_idx: tuple[torch.Tensor, ...]  # rows where num col j is null
    cat_dirty_idx: tuple[torch.Tensor, ...]
    complete_idx: torch.Tensor               # rows with 0 nulls
    all_null_idx: torch.Tensor               # rows with every column null


def build_partitions(t: Table) -> Partitions:
    nmask, cmask = t.num_null, t.cat_null
    counts = nmask.sum(0) + cmask.sum(0)
    total_cols = nmask.shape[0] + cmask.shape[0]

    def rows(mask):
        return torch.nonzero(mask).flatten()

    return Partitions(
        null_counts=counts.to(torch.int32),
        num_dirty_idx=tuple(rows(m) for m in nmask),
        cat_dirty_idx=tuple(rows(m) for m in cmask),
        complete_idx=rows(counts == 0),
        all_null_idx=rows(counts == total_cols),
    )


def observed_weights(t: Table, kind: str, j: int) -> torch.Tensor:
    """w f32[n] = 1 where column j (numeric if kind == 'num') is observed:
    the `WHERE <col>_IS_NULL IS FALSE` predicate
    (imputation_base.cpp:29,100)."""
    mask = t.num_null[j] if kind == "num" else t.cat_null[j]
    return (~mask).to(torch.float32)


def gather_rows(t: Table, idx) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_data, cat_codes) of a subset of rows."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=t.device)
    return t.num_data[:, idx], t.cat_codes[:, idx]


def init_fill(t: Table, mesh=None) -> Table:
    """Mean-fill numeric nulls (means accumulated in f64), mode-fill
    categorical nulls. The mode is `bincount(...).argmax()`: a tie goes to
    the lowest code, as `np.argmax` does in the JAX package.

    mesh: a `parallel.mesh.Mesh` whose ranks each hold a row shard of the
    table: the means and modes are then the global ones, from three
    all-reduces (the f64 sums and counts; the largest observed code, so
    every rank's bincount has one length; the bincounts). Without one the
    table is whole."""
    d, c = t.num_data.shape[0], t.cat_codes.shape[0]
    num = t.num_data.clone()
    if d:
        stats = torch.zeros((2, d), dtype=torch.float64, device=t.device)
        for j in range(d):
            obs = ~t.num_null[j]
            stats[0, j] = torch.where(obs, t.num_data[j].double(), 0.0).sum()
            stats[1, j] = obs.sum()
        if mesh is not None:
            stats = all_reduce(stats, mesh)
        for j in range(d):
            total, cnt = stats[0, j], stats[1, j]
            mean = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
            num[j] = torch.where(t.num_null[j], mean.float(), num[j])
    codes = t.cat_codes.clone()
    if not c:
        return dataclasses.replace(t, num_data=num, cat_codes=codes)
    obs = [t.cat_codes[j][~t.cat_null[j]].long() for j in range(c)]
    if mesh is None:
        counts = [torch.bincount(o) for o in obs]
    else:
        top = torch.stack([o.max() if o.numel() else o.new_tensor(-1)
                           for o in obs])
        lens = (all_reduce(top, mesh, "max") + 1).tolist()
        counts = all_reduce(torch.cat([
            torch.bincount(o, minlength=m) for o, m in zip(obs, lens)]),
            mesh).split(lens)
    for j in range(c):
        mode = (counts[j].argmax().to(codes.dtype) if counts[j].sum() > 0
                else torch.zeros((), dtype=codes.dtype, device=codes.device))
        codes[j] = torch.where(t.cat_null[j], mode, codes[j])
    return dataclasses.replace(t, num_data=num, cat_codes=codes)

