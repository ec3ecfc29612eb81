"""MICE low-missing driver: delta-aggregate retraining.

Counterpart of `duckdb_imputation_tpu.mice.low`, mirroring `run_MICE_low`
(imputation_low.cpp:9-306): one FULL triple over the whole (filled) table
up front (:42-73); then per column
    delta  = triple over the rows where the column is null      (:85-110)
    train  = full − delta          (client-side subtract_triple)
    …train, impute the dirty rows…
    delta' = triple over the same rows with the updated values
    full   = train + delta'                                      (:188-194)
so each retrain pays O(dirty rows) instead of O(n). The dirty-row sets are
static (null positions never move), so they are found once on the
table's device (`partition.build_partitions`) and each delta aggregates
only that subset.

Divergence that is not a fault: the JAX package pads each gather to the
next power of two with zero-weight rows to bound its XLA compiles; here
the gather is exact, with no weights, as the device delta loop's union is.
An empty dirty set is `Triple.zeros`, with no launch.

Algebraic invariant (tested): train == the baseline driver's full rescan
over the observed rows, up to f32 accumulation order.
"""
from __future__ import annotations

from ..models import lda_predict, lda_train, linreg_predict, linreg_train
from ..ring.sum import sum_to_triple
from ..ring.triple import Triple, triple_add, triple_sub
from ..table.table import Table
from ..utils.profiling import PhaseTimer
from .baseline import noise_generator
from .partition import build_partitions, init_fill


def subset_triple(t: Table, idx, aggregate) -> Triple:
    """The triple of the rows `idx` (int64 on the table's device), gathered
    exactly; zeros for an empty set."""
    if idx.numel() == 0:
        return Triple.zeros(t.schema, device=t.device)
    return aggregate(t.num_data[:, idx], t.cat_codes[:, idx], None,
                     schema=t.schema)


def run_mice_low(t: Table, num_null_cols=None, cat_null_cols=None,
                 iters: int = 5, *, lda_shrinkage: float = 0.001,
                 linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                 linreg_iters: int = 10000, noise: bool = True, seed: int = 0,
                 timer: PhaseTimer | None = None,
                 on_iteration=None, start_iter: int = 0,
                 aggregate=sum_to_triple) -> Table:
    """Run low-missing MICE (see the module docstring); the arguments are
    `run_mice_baseline`'s. Returns the imputed table."""
    timer = timer or PhaseTimer()
    with timer.phase("prepare"):
        t = init_fill(t)
        parts = build_partitions(t)
    with timer.phase("cofactor_full"):
        full = aggregate(t.num_data, t.cat_codes, None, schema=t.schema)
    t, _ = run_delta_rounds(
        t, full, parts, num_null_cols, cat_null_cols, iters,
        lda_shrinkage=lda_shrinkage, linreg_step=linreg_step,
        linreg_lambda=linreg_lambda, linreg_iters=linreg_iters,
        noise=noise, seed=seed, timer=timer, on_iteration=on_iteration,
        start_iter=start_iter, aggregate=aggregate)
    return t


def run_delta_rounds(t: Table, full, parts, num_null_cols=None,
                     cat_null_cols=None, iters: int = 5, *,
                     lda_shrinkage: float = 0.001,
                     linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                     linreg_iters: int = 10000, noise: bool = True,
                     seed: int = 0, timer: PhaseTimer | None = None,
                     on_iteration=None, start_iter: int = 0,
                     aggregate=sum_to_triple):
    """The delta-round body of `run_MICE_low` (imputation_low.cpp:85-194),
    factored out so a driver whose `t` holds only the dirty rows, with
    `full` aggregated elsewhere, runs the same rounds: the algebra never
    references clean rows except through `full`. Returns (t, full) after
    the rounds."""
    timer = timer or PhaseTimer()
    schema = t.schema
    if num_null_cols is None:
        num_null_cols = [j for j, ix in enumerate(parts.num_dirty_idx)
                         if ix.numel()]
    if cat_null_cols is None:
        cat_null_cols = [j for j, ix in enumerate(parts.cat_dirty_idx)
                         if ix.numel()]

    for it in range(start_iter, iters):
        for col in cat_null_cols:
            idx = parts.cat_dirty_idx[col]
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, subset_triple(t, idx, aggregate))
            with timer.phase("train"):
                params = lda_train(train, schema, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                other = [j for j in range(schema.cat_cols) if j != col]
                codes = t.cat_codes[other][:, idx] if other else None
                pred_idx = lda_predict(params, t.num_data[:, idx], codes)
                t = t.with_cat_col(
                    col, t.cat_codes[col].index_put((idx,), pred_idx),
                    only_null=False)
            with timer.phase("cofactor_readd"):
                full = triple_add(train, subset_triple(t, idx, aggregate))

        for col in num_null_cols:
            idx = parts.num_dirty_idx[col]
            with timer.phase("cofactor_delta"):
                train = triple_sub(full, subset_triple(t, idx, aggregate))
            with timer.phase("train"):
                params = linreg_train(train, schema, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(schema.num_cols) if j != col]
                pred = linreg_predict(
                    params, t.num_data[keep][:, idx],
                    t.cat_codes[:, idx] if schema.cat_cols else None,
                    add_noise=noise,
                    generator=noise_generator(seed, it, col, t.device))
                t = t.with_num_col(
                    col, t.num_data[col].index_put((idx,), pred),
                    only_null=False)
            with timer.phase("cofactor_readd"):
                full = triple_add(train, subset_triple(t, idx, aggregate))
        if on_iteration is not None:
            on_iteration(t, it)
    return t, full
