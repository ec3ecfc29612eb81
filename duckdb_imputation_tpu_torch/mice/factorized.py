"""Factorized MICE: imputation over a normalized (star) schema without
materializing the join.

Counterpart of `duckdb_imputation_tpu.mice.factorized`, the intent of the
reference's paper-experiment drivers (imputation/include/
factorized_imputation_flight.h, factorized_imputation_retailer.h, bodies
not in the repository) on its factorized-join plan `sum_triple(
multiply_triple(A, B))` (README.md:163-174): per-join-key triples on each
side, the ring product per key, the ring sum over keys.

`run_mice_factorized` (fact ⋈ one dimension): the per-key triples are
grouped aggregates and the product-sum over keys is a few contractions
(`ring.triple.factorized_join_sum`, f64). The dimension side is aggregated
once for the whole run; each column step re-aggregates only the fact side
under that column's observed mask, so a step costs O(fact rows), never
O(join rows). On a CUDA table the dimension side is a sort and K8 (or K5
at P ≤ 88), each fact step a sort and K5 (`ring.sum.
sum_to_triple_grouped`).

`run_mice_star` (fact ⋈ several dimensions on different keys): each column
step's triple is `ring.star.star_join_triple`: on a CUDA table one K1 of
the fact columns, one NB-sums kernel (K6) a dimension, a bincount a pair
of dimensions.

Prediction gathers each fact row's dimension attributes by key, so a
dimension key must be unique (the usual FK → PK star); a fact key with no
dimension row is an error. Models are the host f64 trainers and their
predictors on the table's device, as in `mice.baseline`; noise comes from
`mice.baseline.noise_generator`, one stream per (seed, round, column).
"""
from __future__ import annotations

import torch

from ..models import lda_predict, lda_train, linreg_predict, linreg_train
from ..ring.star import star_join_triple, star_schema
from ..ring.sum import sum_to_triple_grouped
from ..ring.triple import factorized_join_sum
from ..table.table import Table
from ..utils.profiling import PhaseTimer
from .baseline import noise_generator
from .partition import init_fill, observed_weights


def _dim_row_of_key(dim_key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """i64[num_keys]: the dimension row of each key, −1 for a key no row
    has. Raises ValueError when a key names two rows."""
    if bool((torch.bincount(dim_key, minlength=num_keys) > 1).any()):
        raise ValueError("dimension key must be unique for prediction "
                         "(FK -> PK star join)")
    rows = torch.full((num_keys,), -1, dtype=torch.int64,
                      device=dim_key.device)
    rows[dim_key] = torch.arange(dim_key.shape[0], device=dim_key.device)
    return rows


def _fact_gather(row_of_key: torch.Tensor,
                 fact_key: torch.Tensor) -> torch.Tensor:
    """The dimension row of each fact row. A fact FK with no dimension row
    (row_of_key = −1) would gather the LAST dimension row, so dangling FKs
    are an error (an inner join would drop them; the join is taken to be
    lossless FK → PK)."""
    g = row_of_key[fact_key]
    if bool((g < 0).any()):
        bad = torch.unique(fact_key[g < 0]).tolist()
        raise ValueError(
            f"dangling foreign keys with no matching dimension row: "
            f"{bad[:10]}{'...' if len(bad) > 10 else ''}")
    return g


def _keys(k, device) -> torch.Tensor:
    return torch.as_tensor(k, dtype=torch.int64, device=device)


def _null_cols(mask: torch.Tensor, cols):
    """The given column list, or every column with a null."""
    if cols is not None:
        return list(cols)
    return [j for j, h in enumerate(mask.any(dim=1).tolist()) if h]


def _gathered(t: Table, idx: torch.Tensor):
    """(num f32[d, n], codes i32[c, n]): t's rows at idx."""
    return t.num_data[:, idx], t.cat_codes[:, idx]


def _impute_rounds(fact: Table, train_triple, joined, dim_num, dim_cat,
                   num_null_cols, cat_null_cols, iters: int, timer,
                   *, lda_shrinkage, linreg_step, linreg_lambda,
                   linreg_iters, noise, seed) -> Table:
    """The MICE rounds over the joined feature space [fact ‖ dimension
    columns]: categorical fact columns first (imputation_base.cpp:18-87),
    then numeric; each trained on `train_triple(w)` and predicted from the
    fact row's own columns and its gathered dimension columns."""
    fs = fact.schema
    for it in range(iters):
        for col in cat_null_cols:
            with timer.phase("cofactor"):
                triple = train_triple(fact, observed_weights(fact, "cat",
                                                             col))
            with timer.phase("train"):
                params = lda_train(triple, joined, label=col,
                                   shrinkage=lda_shrinkage)
            with timer.phase("impute"):
                x_num = torch.cat([fact.num_data, dim_num])
                other = [j for j in range(fs.cat_cols) if j != col]
                codes = torch.cat([fact.cat_codes[other], dim_cat])
                pred_idx = lda_predict(params, x_num,
                                       codes if codes.shape[0] else None)
                fact = fact.with_cat_col(col, pred_idx)
        for col in num_null_cols:
            with timer.phase("cofactor"):
                triple = train_triple(fact, observed_weights(fact, "num",
                                                             col))
            with timer.phase("train"):
                params = linreg_train(triple, joined, label=col,
                                      step_size=linreg_step,
                                      lam=linreg_lambda,
                                      max_iters=linreg_iters,
                                      compute_variance=noise)
            with timer.phase("impute"):
                keep = [j for j in range(fs.num_cols) if j != col]
                x_num = torch.cat([fact.num_data[keep], dim_num])
                codes = torch.cat([fact.cat_codes, dim_cat])
                pred = linreg_predict(
                    params, x_num, codes if codes.shape[0] else None,
                    add_noise=noise,
                    generator=noise_generator(seed, it, col, fact.device))
                fact = fact.with_num_col(col, pred)
    return fact


def run_mice_factorized(fact: Table, fact_key, dim: Table, dim_key=None,
                        num_null_cols=None, cat_null_cols=None,
                        iters: int = 5, *, lda_shrinkage: float = 0.001,
                        linreg_step: float = 0.001,
                        linreg_lambda: float = 0.0,
                        linreg_iters: int = 10000, noise: bool = True,
                        seed: int = 0,
                        timer: PhaseTimer | None = None,
                        grouped_aggregate=sum_to_triple_grouped) -> Table:
    """MICE over `fact JOIN dim ON fact_key = dim_key`, imputing the fact
    table's null columns; the models train on the joined feature space.
    Both tables lie on one device; the result stays there.

    fact_key: [n_fact] join-key codes in [0, num_keys) (numpy or tensor).
    dim_key: [n_dim] unique key per dim row (default: row g <-> key g).
    grouped_aggregate(x, codes, group_ids, *, schema, num_groups,
      weights=None) -> Triple batched on the groups: the multi-GPU
      aggregate can take its place.
    The joined feature space is ordered as the ring product's
    (mul.cpp:97-107): [fact nums ‖ dim nums], [fact cats ‖ dim cats], so a
    fact column keeps its index as the training label."""
    timer = timer or PhaseTimer()
    dev = fact.device
    with timer.phase("prepare"):
        fact_key = _keys(fact_key, dev)
        fact = init_fill(fact)
        fs, ds = fact.schema, dim.schema
        joined = fs.concat(ds)
        dim_key = (torch.arange(dim.n_rows, device=dev) if dim_key is None
                   else _keys(dim_key, dev))
        num_keys = int(max(int(fact_key.max()), int(dim_key.max()))) + 1
        row_of_key = _dim_row_of_key(dim_key, num_keys)
        # the complete dimension side: per-key triples, aggregated once
        dim_grouped = grouped_aggregate(
            dim.num_data, dim.cat_codes, dim_key, schema=ds,
            num_groups=num_keys)
        # the dimension attributes of each fact row, for prediction
        dim_num, dim_cat = _gathered(dim, _fact_gather(row_of_key, fact_key))
        num_null_cols = _null_cols(fact.num_null, num_null_cols)
        cat_null_cols = _null_cols(fact.cat_null, cat_null_cols)

    def train_triple(t: Table, w: torch.Tensor):
        fact_grouped = grouped_aggregate(t.num_data, t.cat_codes, fact_key,
                                         schema=fs, num_groups=num_keys,
                                         weights=w)
        return factorized_join_sum(fact_grouped, dim_grouped)

    return _impute_rounds(
        fact, train_triple, joined, dim_num, dim_cat, num_null_cols,
        cat_null_cols, iters, timer, lda_shrinkage=lda_shrinkage,
        linreg_step=linreg_step, linreg_lambda=linreg_lambda,
        linreg_iters=linreg_iters, noise=noise, seed=seed)


def run_mice_star(fact: Table, fact_keys, dims, dim_keys=None,
                  num_null_cols=None, cat_null_cols=None,
                  iters: int = 5, *, lda_shrinkage: float = 0.001,
                  linreg_step: float = 0.001, linreg_lambda: float = 0.0,
                  linreg_iters: int = 10000, noise: bool = True,
                  seed: int = 0, timer: PhaseTimer | None = None) -> Table:
    """MICE over a multi-dimension star schema `fact ⋈ dims[0] ⋈ dims[1]
    ⋈ …` with a different FK per dimension, beyond what the reference's
    shared-key multiply chain can express (see `ring.star`). Each column
    step's training triple is `star_join_triple`: the join is never
    materialized. All tables lie on one device; the result stays there.

    fact_keys: per dimension, [n_fact] FK codes (numpy or tensor).
    dims: the complete dimension Tables; dim_keys[i] (optional) gives each
      dim row's unique key (default: row g <-> key g)."""
    timer = timer or PhaseTimer()
    dev = fact.device
    with timer.phase("prepare"):
        fact_keys = [_keys(k, dev) for k in fact_keys]
        fact = init_fill(fact)
        fs = fact.schema
        dss = [d.schema for d in dims]
        joined = star_schema(fs, dss)
        dim_keys = ([torch.arange(d.n_rows, device=dev) for d in dims]
                    if dim_keys is None else [_keys(k, dev)
                                              for k in dim_keys])
        num_keys = tuple(int(max(int(fk.max()), int(dk.max()))) + 1
                         for fk, dk in zip(fact_keys, dim_keys))
        dim_arrays, dim_num, dim_cat = [], [], []
        for d, dk, fk, k in zip(dims, dim_keys, fact_keys, num_keys):
            row_of_key = _dim_row_of_key(dk, k)
            # a key no dim row has gathers row 0: no fact row references
            # it (else _fact_gather raises), so its weight is 0
            dim_arrays.append(_gathered(d, row_of_key.clamp(min=0)))
            num, cat = _gathered(d, _fact_gather(row_of_key, fk))
            dim_num.append(num)
            dim_cat.append(cat)
        n = fact.n_rows
        dim_num = torch.cat([torch.zeros((0, n), device=dev)] + dim_num)
        dim_cat = torch.cat([torch.zeros((0, n), dtype=torch.int32,
                                         device=dev)] + dim_cat)
        num_null_cols = _null_cols(fact.num_null, num_null_cols)
        cat_null_cols = _null_cols(fact.cat_null, cat_null_cols)

    def train_triple(t: Table, w: torch.Tensor):
        return star_join_triple(t.num_data, t.cat_codes, w, keys=fact_keys,
                                dims=dim_arrays, fact_schema=fs,
                                dim_schemas=dss, num_keys=num_keys)

    return _impute_rounds(
        fact, train_triple, joined, dim_num, dim_cat, num_null_cols,
        cat_null_cols, iters, timer, lda_shrinkage=lda_shrinkage,
        linreg_step=linreg_step, linreg_lambda=linreg_lambda,
        linreg_iters=linreg_iters, noise=noise, seed=seed)
