"""Row-sharded MICE over `torch.distributed`: every rank imputes its own
rows, one all-reduce a column step combines the aggregates.

Counterpart of `duckdb_imputation_tpu.mice.sharded_round`
(`mice_loop_sharded`, `_mice_loop_sharded_fused`, `_checkpointed_rounds`,
`run_mice_sharded`, `mice_loop_sharded_delta`, `run_mice_sharded_delta`):
BASELINE config 5, MICE over a table too large for one device. Each rank
holds a row shard on its own device (`parallel.mesh`); per round and per
null column:

  * each rank aggregates the masked sigma of ITS rows with the port's
    kernels (K1, or K7 above P = 88; in the fused loop each K2 / K2w pass
    emits it), and one all-reduce of the P×P sigma combines them: the
    reference's per-thread SumStates merged by SumStateCombine
    (sum_state.cpp:10-114), with the all-reduce as the combine;
  * every rank runs the same solve on the same all-reduced sigma, so the
    models are born replicated and never sent (the GD trainer's host
    reads agree across ranks for the same reason);
  * predict and write-back touch only the rank's rows.

Every rank makes the same collectives in the same order whatever its
data: the null columns are the global ones (an all-reduce of each rank's
flags), a rank with no rows, or no dirty rows in the delta loop,
all-reduces a zero sigma without a launch, and the settings are checked
to agree across ranks before the first round (a rank called with other
settings would wait on collectives the others never make).

Noise is keyed by (seed, global round, column, GLOBAL row), the row's id
in the whole table: a row draws the same number at any world size, and a
resumed run draws what an uninterrupted one does. In the fused loop K2
draws it (its `row_offset`), in the delta loop `philox_normal` over the
compact rows' global ids, as `run_mice_device_delta` does; in the
unfused loop `philox_normal` over the shard's global rows — the
single-device unfused loop draws from a `torch.Generator` instead, so
their noisy results differ (a divergence inside the port: a generator's
stream depends on the row count of the shard that draws it).

Divergences from the JAX package: no row padding (the kernels take any
row count, a shard is `row_shard`'s [lo, hi)); kernel='auto' is 'fused'
on a CUDA table with the solve trainer, 'gram' with GD and 'plain' on the
CPU, without the JAX package's switch to XLA below 2²⁰ rows a shard (on
the card the port never takes a plain path); `chunk_cols`, a TPU tile
width, is gone.

Checkpoints (`checkpoint_path`): each rank writes its own file (the
`utils.checkpoint` npz layout: its rows of the table, the loop's carried
state — the fused loop's sigma, the delta loop's compact rows and full
sigma — and the run's fingerprint) after every `checkpoint_every` rounds,
atomically, then all ranks meet. A run resumes only when an all-reduce
shows that every rank found a file of this run (the same fingerprint)
after the same round; a file of another run, or one past the rounds
asked for, raises ValueError on every rank. The carried state makes a
resumed run bit-identical to one never stopped.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import torch

from ..parallel.mesh import Mesh, all_reduce, barrier, broadcast, make_mesh
from ..ring.kernels.sigma_fused import philox_normal
from ..ring.kernels.sigma_pallas import masked_gram_cols
from ..table.table import Table
from ..utils.checkpoint import (fingerprint_mismatch, load_table_arrays,
                                run_fingerprint, save_table)
from .device_round import (DELTA_KERNELS, KERNELS, _check_trainer,
                           _delta_gather, _delta_round_columns,
                           _delta_scatter, _from_cols, _fused_round_body,
                           _make_agg, _observed, _round_columns, _to_cols,
                           build_union_gather)
from .partition import build_partitions, init_fill


def _agree(mesh: Mesh, settings: dict) -> None:
    """Raise ValueError on every rank unless every rank was called with
    rank 0's settings: a CRC of them broadcast from rank 0, then an
    all-reduce of the mismatch flags (2 collectives)."""
    crc = zlib.crc32(json.dumps(settings, sort_keys=True).encode())
    mine = torch.tensor([crc], dtype=torch.int64, device=mesh.device)
    theirs = broadcast(mine.clone(), mesh)
    bad = (theirs != mine).to(torch.int64)
    if int(all_reduce(bad, mesh, "max")):
        raise ValueError(f"the ranks were called with different settings "
                         f"(rank {mesh.rank}: {settings})")


def _shard_rows(t: Table, mesh: Mesh) -> tuple[int, int]:
    """(global id of the rank's first row, global row count), from one
    all-reduce of the ranks' row counts."""
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = t.n_rows
    counts = all_reduce(counts, mesh).tolist()
    return sum(counts[:mesh.rank]), sum(counts)


def _null_columns(t: Table, mesh: Mesh, num_null_cols, cat_null_cols):
    """The columns with a null on any rank (one all-reduce of the flags),
    unless the caller named them."""
    if num_null_cols is not None and cat_null_cols is not None:
        return tuple(num_null_cols), tuple(cat_null_cols)
    d = t.num_null.shape[0]
    flags = torch.cat([t.num_null.any(dim=1), t.cat_null.any(dim=1)]).to(
        torch.int64)
    flags = all_reduce(flags, mesh, "max").tolist()
    found_num = tuple(j for j in range(d) if flags[j])
    found_cat = tuple(j for j in range(len(flags) - d) if flags[d + j])
    return (found_num if num_null_cols is None else tuple(num_null_cols),
            found_cat if cat_null_cols is None else tuple(cat_null_cols))


def _rank_file(path: str, mesh: Mesh) -> str:
    return f"{path}.rank{mesh.rank}of{mesh.world}"


def _resume(path: str, mesh: Mesh, fingerprint: dict, iters: int):
    """(table, arrays, completed rounds) of this rank's file when every
    rank holds a file of this run after the same round, else None; raises
    ValueError on every rank when any rank's file is of another run or
    past `iters`. One all-reduce of a [world, 2] (status, rounds) table."""
    file = _rank_file(path, mesh)
    status, done, why, found = 0, 0, None, None   # 0 none, 1 ok, 2 refused
    if os.path.exists(file):
        t, extra, arrays = load_table_arrays(file, mesh.device)
        done = int(extra.get("completed_iters", 0))
        why = fingerprint_mismatch(extra.get("fingerprint"), fingerprint)
        if why is not None:
            why = f"it is not of this run: {why}"
        elif done > iters:
            why = f"it completed {done} rounds, more than the {iters} asked for"
        status = 1 if why is None else 2
        found = (t, arrays, done)
    table = torch.zeros((mesh.world, 2), dtype=torch.int64,
                        device=mesh.device)
    table[mesh.rank] = torch.tensor([status, done])
    table = all_reduce(table, mesh).tolist()
    if status == 2:
        raise ValueError(f"checkpoint {file}: {why}")
    refused = [r for r, (s, _) in enumerate(table) if s == 2]
    if refused:
        raise ValueError(f"the checkpoint of rank {refused[0]} under {path} "
                         f"was refused (see that rank's error)")
    if all(s == 1 for s, _ in table) and len({k for _, k in table}) == 1:
        return found
    return None


def _save(path: str, mesh: Mesh, t: Table, arrays: dict, done: int,
          fingerprint: dict) -> None:
    """This rank's file, written atomically, then all ranks meet."""
    save_table(_rank_file(path, mesh), t,
               extra={"completed_iters": done, "fingerprint": fingerprint,
                      "rank": mesh.rank, "world_size": mesh.world},
               arrays=arrays)
    barrier(mesh)


def _drive(loop, t: Table, iters: int, mesh: Mesh, fingerprint: dict,
           checkpoint_path, checkpoint_every: int) -> Table:
    """Run `loop` (a loop object: .start(arrays | None), .rounds(r0, r1),
    .state() -> arrays, .table() -> Table) for rounds [0, iters), in
    chunks of `checkpoint_every` rounds with a checkpoint after each when
    `checkpoint_path` is given, resuming from a checkpoint of this run."""
    if checkpoint_path is None:
        loop.start(None)
        loop.rounds(0, iters)
        return loop.table()
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got "
                         f"{checkpoint_every}")
    found = _resume(checkpoint_path, mesh, fingerprint, iters)
    start = 0
    if found is not None:
        saved, arrays, start = found
        loop.start(arrays, saved)
    else:
        loop.start(None)
    for r0 in range(start, iters, checkpoint_every):
        r1 = min(iters, r0 + checkpoint_every)
        loop.rounds(r0, r1)
        _save(checkpoint_path, mesh, loop.table(), loop.state(), r1,
              fingerprint)
    return loop.table()


class _Loop:
    """What the three loops share: the shard, its offset, the combine."""

    def __init__(self, t: Table, mesh: Mesh, row_offset: int, *, num_cols,
                 cat_cols, lda_shrinkage, noise, seed, trainer, gd_iters):
        self.t, self.mesh, self.row_offset = t, mesh, row_offset
        self.schema = t.schema
        self.num_cols, self.cat_cols = num_cols, cat_cols
        self.lda_shrinkage, self.trainer, self.gd_iters = (
            lda_shrinkage, trainer, gd_iters)
        self.seed = seed if noise else None

    def combine(self, sigma: torch.Tensor) -> torch.Tensor:
        return all_reduce(sigma.contiguous(), self.mesh)

    def _cols_of(self, saved: Table | None):
        src = self.t if saved is None else saved
        return _to_cols(src.num_data, src.cat_codes)

    def table(self) -> Table:
        x, c = _from_cols(self.x_cols, self.code_cols, self.t.num_data,
                          self.t.cat_codes)
        return dataclasses.replace(self.t, num_data=x, cat_codes=c)


class _UnfusedLoop(_Loop):
    """kernel 'plain' or 'gram': `_round_columns` with the all-reduce as
    its combine; noise from `philox_normal` over the shard's global
    rows."""

    def __init__(self, t, mesh, row_offset, *, kernel, **kw):
        super().__init__(t, mesh, row_offset, **kw)
        self.agg = _make_agg(kernel, self.schema)
        self.w_num = _observed(t.num_null, self.num_cols)
        self.w_cat = _observed(t.cat_null, self.cat_cols)

    def start(self, arrays, saved=None):
        self.x_cols, self.code_cols = self._cols_of(saved)

    def state(self) -> dict:
        return {}

    def rounds(self, r0: int, r1: int) -> None:
        n, dev = self.t.n_rows, self.t.device
        for r in range(r0, r1):
            def noise_for(col, r=r):
                if self.seed is None:
                    return None
                return philox_normal(self.seed, r, col, n, dev,
                                     row_offset=self.row_offset)
            self.x_cols, self.code_cols = _round_columns(
                self.x_cols, self.code_cols, self.w_num, self.w_cat,
                self.t.num_null, self.t.cat_null, schema=self.schema,
                num_cols_to_impute=self.num_cols,
                cat_cols_to_impute=self.cat_cols, agg=self.agg,
                lda_shrinkage=self.lda_shrinkage, noise_for=noise_for,
                trainer=self.trainer, gd_iters=self.gd_iters,
                combine=self.combine)


class _FusedLoop(_Loop):
    """kernel 'fused': one K1 (or K7) of the shard and an all-reduce seed
    the sigma (JAX :178), then every K2 / K2w pass imputes a column of the
    shard and emits its local sigma of the next column, all-reduced
    before the replicated solve. The sigma is the carried state."""

    def __init__(self, t, mesh, row_offset, **kw):
        super().__init__(t, mesh, row_offset, **kw)
        self.steps = ([("cat", j) for j in self.cat_cols]
                      + [("num", j) for j in self.num_cols])
        self.nulls = {"cat": t.cat_null.contiguous(),
                      "num": t.num_null.contiguous()}
        self.weights = {(k, j): (~self.nulls[k][j]).to(torch.float32)
                        for k, j in self.steps}

    def start(self, arrays, saved=None):
        self.x_cols, self.code_cols = self._cols_of(saved)
        if not self.steps:
            self.sigma = None
        elif arrays is not None:
            self.sigma = torch.as_tensor(arrays["sigma"]).to(self.t.device)
        else:
            self.sigma = self.combine(masked_gram_cols(
                self.x_cols, self.code_cols, self.weights[self.steps[0]],
                schema=self.schema))

    def state(self) -> dict:
        return {} if self.sigma is None else {"sigma": self.sigma}

    def rounds(self, r0: int, r1: int) -> None:
        if not self.steps:
            return
        for r in range(r0, r1):
            self.x_cols, self.code_cols, self.sigma = _fused_round_body(
                self.x_cols, self.code_cols, self.sigma, r,
                schema=self.schema, steps=self.steps,
                null_of=lambda k, j: self.nulls[k][j],
                w_of=lambda k, j: self.weights[(k, j)],
                lda_shrinkage=self.lda_shrinkage, seed=self.seed,
                combine=self.combine, row_offset=self.row_offset)


class _DeltaLoop(_Loop):
    """The delta loop over the shard's dirty rows (their exact union, no
    padding): one all-reduced full sigma, then per column step two
    all-reduced sigmas of the compact rows; the compact rows and the full
    sigma are the carried state, written back to the shard's columns with
    one scatter-add a column from the rows as first gathered."""

    def __init__(self, t, mesh, row_offset, *, kernel, **kw):
        super().__init__(t, mesh, row_offset, **kw)
        self.agg = _make_agg(kernel, self.schema)
        parts = build_partitions(t)
        self.union_idx, self.union_valid = build_union_gather(
            [parts.num_dirty_idx[j] for j in self.num_cols]
            + [parts.cat_dirty_idx[j] for j in self.cat_cols], blk=None)
        self.union_idx = self.union_idx.to(t.device)
        self.union_valid = self.union_valid.to(t.device)
        self.gidx = self.union_idx + row_offset
        self.x_cols0, self.code_cols0 = _to_cols(t.num_data, t.cat_codes)
        self.xc0, self.cc0, self.masks = _delta_gather(
            self.x_cols0, self.code_cols0, t.num_null, t.cat_null,
            self.union_idx, self.union_valid, self.num_cols, self.cat_cols)

    def start(self, arrays, saved=None):
        if arrays is None:
            self.xc, self.cc = list(self.xc0), list(self.cc0)
            self.full = self.combine(self.agg(self.x_cols0, self.code_cols0,
                                              None))
        else:
            dev = self.t.device
            self.xc = list(torch.as_tensor(arrays["xc"]).to(dev).unbind(0))
            self.cc = list(torch.as_tensor(arrays["cc"]).to(dev).unbind(0))
            self.full = torch.as_tensor(arrays["full"]).to(dev)

    def state(self) -> dict:
        k = self.union_idx.numel()
        dev = self.t.device
        return {"xc": torch.stack(self.xc) if self.xc
                else torch.zeros((0, k), device=dev),
                "cc": torch.stack(self.cc) if self.cc
                else torch.zeros((0, k), dtype=torch.int32, device=dev),
                "full": self.full}

    def rounds(self, r0: int, r1: int) -> None:
        for r in range(r0, r1):
            self.xc, self.cc, self.full = _delta_round_columns(
                self.xc, self.cc, self.full, *self.masks, self.gidx, r,
                schema=self.schema, num_cols_to_impute=self.num_cols,
                cat_cols_to_impute=self.cat_cols, agg=self.agg,
                lda_shrinkage=self.lda_shrinkage, seed=self.seed,
                trainer=self.trainer, gd_iters=self.gd_iters,
                combine=self.combine)

    def table(self) -> Table:
        x_cols, code_cols = _delta_scatter(
            self.x_cols0, self.code_cols0, self.xc, self.cc, self.xc0,
            self.cc0, self.union_idx, self.union_valid, self.num_cols,
            self.cat_cols)
        x, c = _from_cols(x_cols, code_cols, self.t.num_data,
                          self.t.cat_codes)
        return dataclasses.replace(self.t, num_data=x, cat_codes=c)


def _run(loop_name: str, t: Table, num_null_cols, cat_null_cols, iters: int,
         *, mesh, kernel, trainer, gd_iters, lda_shrinkage, noise, seed,
         checkpoint_path, checkpoint_every, kernels) -> Table:
    if kernel not in kernels:
        raise ValueError(f"kernel must be one of {kernels}, got {kernel!r}")
    _check_trainer(trainer)
    mesh = mesh or make_mesh(device=t.device)
    if mesh.device != t.device:
        raise ValueError(f"the table lies on {t.device}, the mesh's rank on "
                         f"{mesh.device}")
    if kernel == "auto":
        if t.device.type != "cuda":
            kernel = "plain"
        else:
            kernel = ("fused" if trainer == "solve" and loop_name == "sharded"
                      else "gram")
    if kernel == "fused" and trainer != "solve":
        raise ValueError("the fused impute+aggregate loop is solve-only; "
                         "use kernel='gram' for GD")
    settings = dict(
        loop=loop_name, kernel=kernel, trainer=trainer, gd_iters=gd_iters,
        lda_shrinkage=lda_shrinkage, noise=noise, seed=seed, iters=iters,
        num_null_cols=None if num_null_cols is None else list(num_null_cols),
        cat_null_cols=None if cat_null_cols is None else list(cat_null_cols),
        checkpoint=checkpoint_path is not None,
        checkpoint_every=checkpoint_every)
    _agree(mesh, settings)
    row_offset, n_rows = _shard_rows(t, mesh)
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = run_fingerprint(
            t, n_rows=n_rows, world_size=mesh.world, row_offset=row_offset,
            mesh=mesh, loop=loop_name, kernel=kernel, trainer=trainer,
            gd_iters=gd_iters, lda_shrinkage=lda_shrinkage, noise=noise,
            seed=seed, num_null_cols=settings["num_null_cols"],
            cat_null_cols=settings["cat_null_cols"])
    t = init_fill(t, mesh)
    num_cols, cat_cols = _null_columns(t, mesh, num_null_cols, cat_null_cols)
    kw = dict(num_cols=num_cols, cat_cols=cat_cols,
              lda_shrinkage=lda_shrinkage, noise=noise, seed=seed,
              trainer=trainer, gd_iters=gd_iters)
    if loop_name == "sharded_delta":
        loop = _DeltaLoop(t, mesh, row_offset, kernel=kernel, **kw)
    elif kernel == "fused":
        loop = _FusedLoop(t, mesh, row_offset, **kw)
    else:
        loop = _UnfusedLoop(t, mesh, row_offset, kernel=kernel, **kw)
    return _drive(loop, t, iters, mesh, fingerprint, checkpoint_path,
                  checkpoint_every)


def run_mice_sharded(t: Table, num_null_cols=None, cat_null_cols=None,
                     iters: int = 5, *, mesh: Mesh | None = None,
                     kernel: str = "auto", trainer: str = "solve",
                     gd_iters: int = 500, lda_shrinkage: float = 0.001,
                     noise: bool = False, seed: int = 0,
                     checkpoint_path: str | None = None,
                     checkpoint_every: int = 1) -> Table:
    """MICE over the rows of every rank of `mesh` (default: the process
    group, else a world of one): `t` is THIS rank's row shard (rows in the
    global order, rank 0's first), on the mesh's device. Global mean/mode
    fill (`init_fill(t, mesh)`), then `iters` rounds over the global null
    columns (or those named). Returns the rank's rows imputed.

    kernel: 'plain' (plain torch Gram), 'gram' (K1 / K7), 'fused' (K1 / K7
    once, then K2 / K2w; solve trainer only) or 'auto' ('fused' on a CUDA
    table with trainer='solve', 'gram' with 'gd', 'plain' on the CPU).
    trainer: 'solve' or 'gd' (at most `gd_iters` steps). noise=True: the
    residual std times N(0, 1) keyed by (seed, round, column, global row).
    checkpoint_path: a file a rank (`<path>.rank<r>of<world>`) written
    every `checkpoint_every` rounds; a run of the same fingerprint resumes
    from it (see the module docstring)."""
    return _run("sharded", t, num_null_cols, cat_null_cols, iters,
                mesh=mesh, kernel=kernel, trainer=trainer, gd_iters=gd_iters,
                lda_shrinkage=lda_shrinkage, noise=noise, seed=seed,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, kernels=KERNELS)


def run_mice_sharded_delta(t: Table, num_null_cols=None, cat_null_cols=None,
                           iters: int = 5, *, mesh: Mesh | None = None,
                           kernel: str = "auto", trainer: str = "solve",
                           gd_iters: int = 500, lda_shrinkage: float = 0.001,
                           noise: bool = False, seed: int = 0,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 1) -> Table:
    """The delta-MICE strategy (imputation_low.cpp:42-110,188-194) over the
    ranks' row shards: each rank gathers the union of ITS dirty rows once;
    one all-reduced full sigma, then per column step the compact rows'
    delta and re-added sigmas, each all-reduced (2 P×P all-reduces a
    column, whatever the world size); `full` and `train` are replicated.
    kernel: 'auto' ('gram' on a CUDA table, 'plain' on the CPU), 'plain'
    or 'gram'; the other arguments as `run_mice_sharded`'s."""
    return _run("sharded_delta", t, num_null_cols, cat_null_cols, iters,
                mesh=mesh, kernel=kernel, trainer=trainer, gd_iters=gd_iters,
                lda_shrinkage=lda_shrinkage, noise=noise, seed=seed,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, kernels=DELTA_KERNELS)
