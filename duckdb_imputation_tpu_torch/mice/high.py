"""MICE high-missing driver: static + delta retraining.

Counterpart of `duckdb_imputation_tpu.mice.high`, mirroring
`run_MICE_high` (imputation_high.cpp:8-319): when most rows contain nulls,
keep one STATIC triple over the all-observed partition only (:20-35); per
column the train aggregate is

    train = static + delta(rows where col is observed AND the row is dirty)

(:70), a SUM, not a subtract: the dirty-but-col-observed set is small in
the high-missing regime, so the per-column scan is O(that set).
Imputation then rewrites the column's dirty rows. The gathers are exact,
as in `low` (the JAX package pads them to a power of two).

Algebraic invariant (tested): train == triple over ALL rows where the
column is observed, the same training set as baseline/low, reached by a
cheaper scan.
"""
from __future__ import annotations

import torch

from ..models import lda_predict, lda_train, linreg_predict, linreg_train
from ..ring.sum import sum_to_triple
from ..ring.triple import triple_add
from ..table.table import Table
from ..utils.profiling import PhaseTimer
from .baseline import noise_generator
from .low import subset_triple as _subset_triple
from .partition import build_partitions, init_fill


def run_mice_high(t: Table, num_null_cols=None, cat_null_cols=None,
                  iters: int = 5, *, lda_shrinkage: float = 0.001,
                  linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                  linreg_iters: int = 10000, noise: bool = True,
                  seed: int = 0, timer: PhaseTimer | None = None,
                  on_iteration=None, start_iter: int = 0,
                  aggregate=sum_to_triple) -> Table:
    """Run high-missing MICE (see the module docstring); the arguments are
    `run_mice_baseline`'s. Returns the imputed table."""
    timer = timer or PhaseTimer()
    with timer.phase("prepare"):
        t = init_fill(t)
        parts = build_partitions(t)
        schema = t.schema
        dirty_rows = parts.null_counts > 0
        if num_null_cols is None:
            num_null_cols = [j for j, ix in enumerate(parts.num_dirty_idx)
                             if ix.numel()]
        if cat_null_cols is None:
            cat_null_cols = [j for j, ix in enumerate(parts.cat_dirty_idx)
                             if ix.numel()]

        # rows that are dirty overall but observed in column j
        def obs_dirty(mask):
            return torch.nonzero(dirty_rows & ~mask).flatten()
        num_obs_dirty = tuple(obs_dirty(m) for m in t.num_null)
        cat_obs_dirty = tuple(obs_dirty(m) for m in t.cat_null)
    with timer.phase("cofactor_static"):
        static = _subset_triple(t, parts.complete_idx, aggregate)

    for it in range(start_iter, iters):
        for col in cat_null_cols:
            with timer.phase("cofactor_delta"):
                train = triple_add(
                    static, _subset_triple(t, cat_obs_dirty[col], aggregate))
            with timer.phase("train"):
                params = lda_train(train, schema, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                idx = parts.cat_dirty_idx[col]
                other = [j for j in range(schema.cat_cols) if j != col]
                codes = t.cat_codes[other][:, idx] if other else None
                pred_idx = lda_predict(params, t.num_data[:, idx], codes)
                t = t.with_cat_col(
                    col, t.cat_codes[col].index_put((idx,), pred_idx),
                    only_null=False)

        for col in num_null_cols:
            with timer.phase("cofactor_delta"):
                train = triple_add(
                    static, _subset_triple(t, num_obs_dirty[col], aggregate))
            with timer.phase("train"):
                params = linreg_train(train, schema, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                idx = parts.num_dirty_idx[col]
                keep = [j for j in range(schema.num_cols) if j != col]
                pred = linreg_predict(
                    params, t.num_data[keep][:, idx],
                    t.cat_codes[:, idx] if schema.cat_cols else None,
                    add_noise=noise,
                    generator=noise_generator(seed, it, col, t.device))
                t = t.with_num_col(
                    col, t.num_data[col].index_put((idx,), pred),
                    only_null=False)
        if on_iteration is not None:
            on_iteration(t, it)
    return t
