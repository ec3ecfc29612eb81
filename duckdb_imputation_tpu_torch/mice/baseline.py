"""MICE baseline driver: full-rescan retraining every column, every round.

Counterpart of `duckdb_imputation_tpu.mice.baseline`, mirroring
`run_MICE_baseline` (imputation_base.cpp:6-146): per round, categorical
null-columns first (LDA, shrinkage 0.001, :46), then continuous
(stochastic linear regression: lr=0.001, λ=0, 10000 iters, variance +
noise on predict, :116,133). Each column's cofactor is aggregated over the
rows where that column is observed (the WHERE … IS FALSE filter → a
weight mask), trained on the host in f64, and the predictions, made on the
table's device, replace only the originally-missing cells (the CASE WHEN …
write-back → a column swap). On a CUDA table the aggregate is K1's stacked
entry point (`sum_to_triple` → `masked_gram`, K7 above P = 88).

Deliberate deviation kept from the JAX package: the reference imputes a
categorical column with LDA's 0-based CLASS INDEX (lda.cpp:575, written
straight into the column at imputation_base.cpp:75-79), correct only when
the categories happen to be 0..k-1. Here the index is the column's local
code, so it decodes back to the actual category value.

Noise: each (round, column) draws from its own `torch.Generator`, seeded
from (seed, round, column) through numpy's SeedSequence, so its draws do
not depend on the rounds run before it (`start_iter`), and no two
(round, column) pairs share a stream (the JAX low driver's
`fold_in(key, round·1009 + col)` collides at 1009 or more columns).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import lda_predict, lda_train, linreg_predict, linreg_train
from ..ring.sum import sum_to_triple
from ..table.table import Table
from ..utils.profiling import PhaseTimer
from .partition import init_fill, observed_weights


def noise_generator(seed: int, it: int, col: int,
                    device) -> torch.Generator:
    """The noise stream of round `it`, numeric column `col`: a generator on
    `device` seeded by numpy's SeedSequence hash of (seed, it, col)."""
    state = np.random.SeedSequence([seed, it, col]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def run_mice_baseline(t: Table, num_null_cols=None, cat_null_cols=None,
                      iters: int = 5, *, lda_shrinkage: float = 0.001,
                      linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                      linreg_iters: int = 10000, noise: bool = True,
                      seed: int = 0, timer: PhaseTimer | None = None,
                      on_iteration=None, start_iter: int = 0,
                      aggregate=sum_to_triple) -> Table:
    """Run MICE and return the imputed table.

    num_null_cols / cat_null_cols: indices of columns to impute (default:
    every column that has any nulls). `aggregate(x, codes, w, schema=)`
    returns the Triple of the weighted rows."""
    timer = timer or PhaseTimer()
    with timer.phase("prepare"):
        t = init_fill(t)
        schema = t.schema
        if num_null_cols is None:
            has = t.num_null.any(dim=1).tolist()
            num_null_cols = [j for j, h in enumerate(has) if h]
        if cat_null_cols is None:
            has = t.cat_null.any(dim=1).tolist()
            cat_null_cols = [j for j, h in enumerate(has) if h]

    for it in range(start_iter, iters):
        # categorical columns first (imputation_base.cpp:18-87)
        for col in cat_null_cols:
            with timer.phase("cofactor"):
                w = observed_weights(t, "cat", col)
                triple = aggregate(t.num_data, t.cat_codes, w, schema=schema)
            with timer.phase("train"):
                params = lda_train(triple, schema, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                other = [j for j in range(schema.cat_cols) if j != col]
                codes = t.cat_codes[other] if other else None
                pred_idx = lda_predict(params, t.num_data, codes)
                t = t.with_cat_col(col, pred_idx)

        # continuous columns (imputation_base.cpp:89-143)
        for col in num_null_cols:
            with timer.phase("cofactor"):
                w = observed_weights(t, "num", col)
                triple = aggregate(t.num_data, t.cat_codes, w, schema=schema)
            with timer.phase("train"):
                params = linreg_train(triple, schema, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(schema.num_cols) if j != col]
                pred = linreg_predict(
                    params, t.num_data[keep],
                    t.cat_codes if schema.cat_cols else None,
                    add_noise=noise,
                    generator=noise_generator(seed, it, col, t.device))
                t = t.with_num_col(col, pred)
        if on_iteration is not None:
            on_iteration(t, it)
    return t
