"""Out-of-core MICE: the low-missing delta rounds on tables that do not
fit in device memory.

Counterpart of `duckdb_imputation_tpu.mice.streaming`. The reference's
low-missing strategy (`run_MICE_low`, imputation_low.cpp:9-306) retrains
every column on full − delta after ONE full aggregate; taken to its
limit, the clean rows never need to be resident at all:

  pass 0 (host):   vocabularies, nullable columns, the dirty-row cache
  pass 1 (device): one streaming fold of the extended Gram, whose blocks
                   give the mean/mode-FILLED full triple exactly
                   (`ring.streaming`: K1 or K7 a chunk, summed in f64)
  rounds:          the delta rounds over the dirty rows alone
  write-out:       `impute_chunks` streams the source again and puts the
                   imputed values in at the cached positions.

Peak memory is O(chunk + dirty rows + (P+K)²), whatever n.

Rounds (`engine`): 'host' runs `mice.low.run_delta_rounds` (f64 host
trainers, the reference's GD for numeric columns; every delta triple
`sum_to_triple`, K1 or K7 on the card); 'device' runs the delta loop's
round body (`mice.device_round._delta_round_columns`: K1 or K7 on a CUDA
table, 'plain' on the CPU, the solve trainer) with the streamed full
sigma: the dirty table IS the compact union, so the loop needs no gather
or scatter and the sigma it carries is what a checkpoint stores. Past
`dirty_budget_rows` the cache spills to disk and the rounds run
windowed on the host (`run_delta_rounds_spill`), whatever the engine
(with a warning for 'device'); their windows still aggregate on the card.

Noise: the host engine draws each (round, column) from
`baseline.noise_generator`, the spill rounds each (round, column, window)
from a generator seeded the same way; the device engine draws Philox
numbers keyed by (seed, round, column, global row id), as
`run_mice_device_delta` does. None is JAX's stream: noise is compared
with the JAX package by its moments.

Checkpoints (`checkpoint_path`, in-core cache only): after each round the
dirty table, the full sigma, the fills and the schema are written with a
run fingerprint (the dirty rows' checksum, the schema, the row count, the
nullable columns and the settings; for `impute_csv_stream` the file's
size and mtime). A resume reads the source once more on the host (pass
0, which the checksum needs), skips the fold and continues bit-identical
to a run never stopped; a file of another run, or one past the rounds
asked for, raises ValueError.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from .. import config
from ..ring.streaming import (DEFAULT_STREAM_CHUNK, DirtyCache, DirtySpill,
                              StreamFills, StreamSchema, _normalize_chunk,
                              _rows, assemble_filled_triple, scan_gram,
                              scan_schema)
from ..ring.triple import Triple, sigma_from_triple, triple_from_sigma
from ..table.table import Table, from_numpy
from ..utils.checkpoint import StreamCheckpointer, run_fingerprint
from ..utils.profiling import PhaseTimer
from .low import run_delta_rounds
from .partition import build_partitions

ENGINES = ("host", "device")


def _dirty_table(cache: DirtyCache, ss: StreamSchema, fills: StreamFills,
                 device) -> Table:
    """The dirty-row cache as a Table on `device`, init-filled with the
    stream's means and modes (init_baseline over just these rows)."""
    schema = ss.schema
    num = np.asarray(cache.num, np.float32).copy()
    for j in range(schema.num_cols):
        num[j, cache.num_null[j]] = fills.num_means[j]
    codes = np.zeros((schema.cat_cols, cache.idx.shape[0]), np.int32)
    if schema.cat_cols:
        codes[:] = schema.encode(cache.cat.T).T
        for j in range(schema.cat_cols):
            codes[j, cache.cat_null[j]] = fills.cat_modes[j]

    def tensor(a, dtype):
        return torch.tensor(np.ascontiguousarray(a, dtype), device=device)
    return Table(num_data=tensor(num, np.float32),
                 cat_codes=tensor(codes, np.int32),
                 num_null=tensor(cache.num_null, bool),
                 cat_null=tensor(cache.cat_null, bool), schema=schema)


@dataclasses.dataclass
class StreamImputation:
    """Result of out-of-core MICE: what a rewrite of the source needs.

    dirty: the imputed dirty rows (a Table over ss.schema), or None when
           they spilled and live in `spill` instead.
    idx:   their global row ids, ascending.
    filled: the fold's full triple of the mean/mode-FILLED table (f64
           sums rounded to f32 once: exact counts past 2²⁴ rows); None
           after a resume, which skips the fold.
    """
    dirty: Table | None
    idx: np.ndarray
    fills: StreamFills
    ss: StreamSchema
    spill: DirtySpill | None = None
    filled: Triple | None = None

    def _dirty_slice(self, lo: int, hi: int):
        """(num f32[d, m], cat RAW i64[c, m]) of dirty rows [lo, hi)."""
        if self.spill is not None:
            num, cat, _, _ = self.spill.window(lo, hi)
            return num, cat
        return (self.dirty.num_data[:, lo:hi].cpu().numpy(),
                self.dirty.cat_values()[:, lo:hi])

    def impute_chunks(self, chunk_source):
        """Stream the source again, yielding (num f32[d, m], cat i64[c, m])
        chunks with every null cell replaced by its imputed value (a raw
        category value for a categorical cell). The chunks must come in
        the order the passes saw them. An in-core result is copied to the
        host once; a spilled one is read a chunk's rows at a time."""
        schema = self.ss.schema
        whole = (self._dirty_slice(0, len(self.idx)) if self.spill is None
                 else None)
        pos = row0 = 0
        for raw in chunk_source():
            num, cat, num_null, cat_null = _normalize_chunk(raw)
            m = _rows(num, cat)
            out_num, out_cat = num.copy(), cat.copy()
            hi = int(np.searchsorted(self.idx, row0 + m))
            if hi > pos:
                local = self.idx[pos:hi] - row0
                num_d, cat_d = (self._dirty_slice(pos, hi) if whole is None
                                else (whole[0][:, pos:hi],
                                      whole[1][:, pos:hi]))
                for j in range(schema.num_cols):
                    nm = num_null[j, local]
                    out_num[j, local[nm]] = num_d[j][nm]
                for j in range(schema.cat_cols):
                    cm = cat_null[j, local]
                    out_cat[j, local[cm]] = cat_d[j][cm]
            pos = hi
            row0 += m
            yield out_num, out_cat


def _spill_init_fill(spill: DirtySpill, ss: StreamSchema,
                     fills: StreamFills, window: int) -> None:
    """Write the AVG/MODE init fills (partition.cpp:42-57) into the spilled
    null cells, one bounded window at a time."""
    schema = ss.schema
    for lo in range(0, spill.n, window):
        hi = min(lo + window, spill.n)
        for j in range(schema.num_cols):
            mask = spill.num_null[lo:hi, j]
            if mask.any():
                spill.write_num(j, lo, np.full(hi - lo, fills.num_means[j],
                                               np.float32), mask)
        for j in range(schema.cat_cols):
            mask = spill.cat_null[lo:hi, j]
            if mask.any() and schema.cat_sizes[j]:
                raw_mode = int(schema.decode(j, [fills.cat_modes[j]])[0])
                spill.write_cat(j, lo, np.full(hi - lo, raw_mode, np.int64),
                                mask)


def window_generator(seed: int, it: int, col: int, window: int,
                     device) -> torch.Generator:
    """The noise stream of (round, numeric column, window) of the spill
    rounds: a generator on `device` seeded by numpy's SeedSequence hash of
    (seed, it, col, window), as `baseline.noise_generator` seeds its."""
    state = np.random.SeedSequence([seed, it, col, window]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def run_delta_rounds_spill(spill: DirtySpill, full, ss: StreamSchema, *,
                           iters: int = 5, window: int,
                           lda_shrinkage: float = 0.001,
                           linreg_step: float = 0.001,
                           linreg_lambda: float = 0.0,
                           linreg_iters: int = 10000, noise: bool = True,
                           seed: int = 0, timer: PhaseTimer | None = None,
                           device=config.DEFAULT_DEVICE):
    """The delta rounds of run_MICE_low (imputation_low.cpp:85-194)
    against a DISK-backed dirty store: each delta triple is the sum of
    per-window triples (`sum_to_triple` of the window's rows on `device`,
    weighted by the column's null mask; the ring sum makes the windowing
    exact), training takes `full − Σ_w delta_w` on the host, and the
    predictions go back to the memmaps a window at a time. Peak host
    memory is O(window + (P+K)²) at any missing rate. noise=False is the
    in-core rounds' arithmetic up to the order of the sums. Returns the
    full triple after the rounds."""
    from ..models import (lda_predict, lda_train, linreg_predict,
                          linreg_train)
    from ..ring.sum import sum_to_triple
    from ..ring.triple import Triple, triple_add, triple_sub

    timer = timer or PhaseTimer()
    schema = ss.schema
    windows = [(lo, min(lo + window, spill.n))
               for lo in range(0, spill.n, window)]

    def on_device(a, dtype):
        return torch.tensor(np.ascontiguousarray(a, dtype), device=device)

    def encode(cat):
        return (on_device(schema.encode(cat.T).T, np.int32)
                if schema.cat_cols else None)

    def delta_col(kind: str, col: int) -> Triple:
        total = None
        for lo, hi in windows:
            num, cat, nn, cn = spill.window(lo, hi)
            mask = nn[col] if kind == "num" else cn[col]
            if not mask.any():
                continue
            tr = sum_to_triple(on_device(num, np.float32), encode(cat),
                               on_device(mask, np.float32), schema=schema)
            total = tr if total is None else triple_add(total, tr)
        return (total if total is not None
                else Triple.zeros(schema, device=device))

    for it in range(iters):
        for col in ss.nullable_cat:
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, delta_col("cat", col))
            with timer.phase("train"):
                params = lda_train(train, schema, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                other = [j for j in range(schema.cat_cols) if j != col]
                for lo, hi in windows:
                    num, cat, nn, cn = spill.window(lo, hi)
                    if not cn[col].any():
                        continue
                    codes = schema.encode(cat.T).T.astype(np.int32)
                    pred = lda_predict(params, on_device(num, np.float32),
                                       on_device(codes[other], np.int32)
                                       if other else None)
                    spill.write_cat(col, lo, schema.decode(
                        col, pred.cpu().numpy()), cn[col])
            with timer.phase("cofactor_readd"):
                full = triple_add(train, delta_col("cat", col))

        for col in ss.nullable_num:
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, delta_col("num", col))
            with timer.phase("train"):
                params = linreg_train(train, schema, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(schema.num_cols) if j != col]
                for w, (lo, hi) in enumerate(windows):
                    num, cat, nn, cn = spill.window(lo, hi)
                    if not nn[col].any():
                        continue
                    pred = linreg_predict(
                        params, on_device(num[keep], np.float32),
                        encode(cat), add_noise=noise,
                        generator=window_generator(seed, it, col, w, device))
                    spill.write_num(col, lo, pred.cpu().numpy(), nn[col])
            with timer.phase("cofactor_readd"):
                full = triple_add(train, delta_col("num", col))
    return full


def _run_delta_rounds_device(t: Table, sigma: torch.Tensor,
                             ss: StreamSchema, *, iters: int,
                             start_iter: int, lda_shrinkage: float,
                             noise: bool, seed: int, timer: PhaseTimer,
                             ckpt, idx, fills) -> Table:
    """The device engine: the delta loop's round body over the dirty table
    (the compact union itself, every row), carrying the full sigma, with a
    checkpoint after each round when `ckpt` is given."""
    from .device_round import (_delta_gather, _delta_round_columns,
                               _from_cols, _make_agg, _to_cols,
                               build_union_gather)

    schema = ss.schema
    kernel = "gram" if t.device.type == "cuda" else "plain"
    agg = _make_agg(kernel, schema)
    union_idx, union_valid = build_union_gather(
        [torch.arange(t.n_rows, device=t.device)], blk=None)
    xc, cc, masks = _delta_gather(
        *_to_cols(t.num_data, t.cat_codes), t.num_null, t.cat_null,
        union_idx, union_valid, ss.nullable_num, ss.nullable_cat)
    gidx = torch.as_tensor(np.asarray(idx, np.int64), device=t.device)

    def table():
        x, c = _from_cols(xc, cc, t.num_data, t.cat_codes)
        return dataclasses.replace(t, num_data=x, cat_codes=c)

    for r in range(start_iter, iters):
        with timer.phase("delta_rounds_device"):
            xc, cc, sigma = _delta_round_columns(
                xc, cc, sigma, *masks, gidx, r, schema=schema,
                num_cols_to_impute=ss.nullable_num,
                cat_cols_to_impute=ss.nullable_cat, agg=agg,
                lda_shrinkage=lda_shrinkage, seed=seed if noise else None,
                trainer="solve", gd_iters=500)
        if ckpt is not None:
            ckpt.save(table(), sigma, idx, fills, ss, r + 1)
    return table()


def _fingerprint(cache: DirtyCache, ss: StreamSchema, device,
                 settings: dict) -> dict:
    """The run fingerprint of a stream checkpoint: `run_fingerprint` of
    the dirty rows (their observed values and null masks), the stream's
    row count and nullable columns, and `settings`."""
    raw = from_numpy(cache.num, cache.cat, cache.num_null, cache.cat_null,
                     schema=ss.schema, rows_first=False, device=device)
    return run_fingerprint(raw, n_rows=ss.n_rows,
                           nullable_num=ss.nullable_num,
                           nullable_cat=ss.nullable_cat, **settings)


def run_mice_stream(chunk_source, iters: int = 5, *,
                    chunk_rows: int = DEFAULT_STREAM_CHUNK,
                    lda_shrinkage: float = 0.001,
                    linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                    linreg_iters: int = 10000, noise: bool = True,
                    seed: int = 0, timer: PhaseTimer | None = None,
                    mesh=None, dirty_budget_rows: int | None = None,
                    spill_dir=None, checkpoint_path: str | None = None,
                    engine: str = "host", device=config.DEFAULT_DEVICE,
                    source_id: dict | None = None) -> StreamImputation:
    """MICE over a chunk stream (a callable returning an iterator of
    `ring.streaming.Chunk`s or (num, cat[, num_null, cat_null]) tuples),
    on `device` (the card unless asked otherwise); see the module
    docstring.

    mesh: a `parallel.Mesh`; the fold then row-shards each chunk over its
    ranks (one all-reduce), and every rank runs the same rounds on the
    same dirty rows (only rank 0 writes a checkpoint). dirty_budget_rows:
    past that many dirty rows the cache spills to disk (`spill_dir`) and
    the rounds run windowed. checkpoint_path: write a checkpoint after
    every round and resume from one of this run (in-core cache only).
    engine: 'host' (f64 host trainers, GD for numeric columns) or
    'device' (the delta loop's rounds on the device, solve trainer).
    source_id: JSON fields that identify the source, added to the
    checkpoint's fingerprint (`impute_csv_stream` passes the file's size
    and mtime)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    timer = timer or PhaseTimer()
    if mesh is not None:
        device = mesh.device
    with timer.phase("scan_schema"):
        ss, cache = scan_schema(chunk_source,
                                dirty_budget_rows=dirty_budget_rows,
                                spill_dir=spill_dir)
    spilled = isinstance(cache, DirtySpill)
    ckpt = resumed = None
    if checkpoint_path is not None and not spilled:
        settings = dict(engine=engine, seed=seed, noise=noise,
                        lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
                        linreg_lambda=linreg_lambda,
                        linreg_iters=linreg_iters, **(source_id or {}))
        ckpt = StreamCheckpointer(checkpoint_path,
                                  _fingerprint(cache, ss, device, settings))
        resumed = ckpt.resume(iters, device)
        if mesh is not None and mesh.rank != 0:
            ckpt = None      # every rank reads the file, rank 0 writes it
    filled = None
    if resumed is not None:
        t, sigma, idx, fills, _, start = resumed
    else:
        with timer.phase("scan_gram"):
            gram = scan_gram(chunk_source, ss, chunk_rows=chunk_rows,
                             mesh=mesh, device=device)
        filled, fills = assemble_filled_triple(gram, ss)
        if spilled:
            if engine == "device":
                warnings.warn(
                    "the dirty cache spilled to disk; the device engine "
                    "runs in-core only, so the windowed host rounds run "
                    "instead (f64 GD trainer)", stacklevel=2)
            window = int(dirty_budget_rows)
            with timer.phase("prepare"):
                _spill_init_fill(cache, ss, fills, window)
            run_delta_rounds_spill(
                cache, filled, ss, iters=iters, window=window,
                lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
                linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
                noise=noise, seed=seed, timer=timer, device=device)
            return StreamImputation(dirty=None, idx=np.asarray(cache.idx),
                                    fills=fills, ss=ss, spill=cache,
                                    filled=filled)
        with timer.phase("prepare"):
            t = _dirty_table(cache, ss, fills, device)
        sigma, idx, start = sigma_from_triple(filled), cache.idx, 0
    if engine == "device":
        t = _run_delta_rounds_device(
            t, sigma, ss, iters=iters, start_iter=start,
            lda_shrinkage=lda_shrinkage, noise=noise, seed=seed, timer=timer,
            ckpt=ckpt, idx=idx, fills=fills)
        return StreamImputation(dirty=t, idx=idx, fills=fills, ss=ss,
                                filled=filled)
    full = triple_from_sigma(sigma, ss.schema.num_cols)
    with timer.phase("prepare"):
        parts = build_partitions(t)
    for it in range(start, iters):
        t, full = run_delta_rounds(
            t, full, parts, iters=it + 1, start_iter=it,
            lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
            linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
            noise=noise, seed=seed, timer=timer)
        if ckpt is not None:
            ckpt.save(t, sigma_from_triple(full), idx, fills, ss, it + 1)
    return StreamImputation(dirty=t, idx=idx, fills=fills, ss=ss,
                            filled=filled)


def impute_csv_stream(in_path: str, out_path: str, iters: int = 5, *,
                      has_header: bool = True, block_bytes: int = 64 << 20,
                      noise: bool = True, seed: int = 0,
                      timer: PhaseTimer | None = None,
                      **mice_kw) -> StreamImputation:
    """Out-of-core CSV → CSV imputation: two read passes through the
    native chunked parser (the host scan, then the fold on the device),
    the delta rounds over the dirty rows (`run_mice_stream`'s keywords in
    `mice_kw`: engine, device, checkpoint_path, ...), and one streamed
    write pass through the native formatter. Peak host memory is O(block
    + dirty rows); the file is never resident. Categorical (integer)
    columns are written as integers, numeric ones as the shortest repr of
    their f32 value; the header and column order are the input's."""
    from ..table.native import CsvStream, csv_chunk_source, format_csv_block

    timer = timer or PhaseTimer()
    st = os.stat(in_path)
    source = csv_chunk_source(in_path, has_header, block_bytes)
    res = run_mice_stream(
        source, iters=iters, noise=noise, seed=seed, timer=timer,
        source_id={"file_size": st.st_size, "file_mtime_ns": st.st_mtime_ns},
        **mice_kw)

    # the file's columns and their kinds, probed with the passes' own
    # block size: a stream types each column from its first block, so
    # another size could type a column otherwise
    probe = CsvStream(in_path, has_header, block_bytes)
    try:
        names = probe.col_names
        nt = probe.next_chunk()
        kinds = ([nt.is_numeric(c) for c in range(nt.n_cols)]
                 if nt is not None else [])
        if nt is not None:
            nt.close()
    finally:
        probe.close()

    with timer.phase("write_out"), open(out_path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        is_int = [not k for k in kinds]
        for num, cat in res.impute_chunks(source):
            cols, ni, ci = [], 0, 0
            for numeric in kinds:
                if numeric:
                    cols.append(num[ni])
                    ni += 1
                else:
                    cols.append(cat[ci])
                    ci += 1
            f.write(format_csv_block(cols, is_int, names=names))
    return res
