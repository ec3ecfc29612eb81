"""On-device MICE rounds: the single-device loops.

Counterpart of `duckdb_imputation_tpu.mice.device_round` (the unfused,
fused and delta loops, `run_mice_device` and `run_mice_device_delta`). For
each round and each null column, categorical columns first (the
reference's order, imputation_base.cpp:18-87), a round:
  1. aggregates the masked sigma (Zᵀ·diag(w)·Z, w = observed mask);
  2. trains the model on the device (`_lda_device`; for a numeric column
     `models.device.linreg_solve_device`, trainer='solve', or the
     reference's GD loop `models.device.linreg_train_device`, trainer='gd'
     with `gd_iters` steps at most);
  3. predicts and writes the result back under the null mask.

COLUMNAR CARRY: inside the loops the table is a list of per-column [n]
tensors, not a stacked [d, n] block; the kernels take the columns as they
are, and a write-back replaces one list entry. Rounds are a Python loop;
the solves stay on the device (no host read inside a round). The loops
leave their inputs unchanged and return new tensors.

`kernel=` selects the aggregation, against the JAX package's names:

    'plain' ↔ 'xla'           plain torch Gram (ring.sum.masked_sigma)
    'gram'  ↔ 'pallas_fast'   K1, the hand-written masked-Gram kernel
    'fused' ↔ 'pallas_fused'  K1 seeds the loop, then K2 (fused
                              impute+aggregate) does every later pass
    'auto'                    'gram' for a CUDA table, 'plain' on the CPU

Above P = 88 the same wrappers launch the wide kernels (K7 for the Gram,
K2w for the fused pass): one launch up to P = 1,024, and past it K7 a
column window of 1,024, and for the fused pass K2w's impute kernel, W
read from device memory, before K7's windows (favorita_items, P = 4,592).
On CPU tensors every kernel
takes its plain version, so every kernel value runs on the CPU too.
The fused loop is solve-only, as the JAX package's is.

The delta loop (`run_mice_device_delta`, the low-missing strategy of the
reference's imputation_low.cpp) aggregates the full table once, gathers
the union of dirty rows into a compact sub-table once, trains each column
on `full − delta` and re-aggregates only the compact rows; `kernel=` is
'auto', 'plain' or 'gram' there.

Noise (stochastic regression): the unfused loop draws N(0, 1) per row from
a `torch.Generator` on the table's device, seeded from `seed`, in the
order (round, column); the fused loop draws it inside K2 from Philox keyed
by (seed, round, column, global row), and the delta loop draws the same
Philox numbers for its compact rows by their global row ids
(`philox_normal(..., rows=)`), so a row's draw is the fused loop's. None
is JAX's threefry stream, so noise is compared with the JAX package by its
moments.

The round bodies take the hooks of the row-sharded loops
(`mice.sharded_round`): `combine`, applied to every aggregated sigma
before it is used (an all-reduce across the shards; the identity here),
and the global id of the shard's first row, which keys the noise. With
the defaults the single-device loops are unchanged.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..schema import FeatureSchema
from ..models.device import (linreg_solve_device, linreg_train_device,
                             lstsq_min_norm)
from ..ring.kernels.sigma_fused import fused_impute_aggregate, philox_normal
from ..ring.kernels.sigma_pallas import masked_gram_cols
from ..ring.sum import _stack_cols, class_argmax, linear_predict, masked_sigma
from ..table.table import Table
from ..utils.precision import ieee_f32
from .partition import build_partitions, init_fill

KERNELS = ("auto", "plain", "gram", "fused")
DELTA_KERNELS = ("auto", "plain", "gram")
TRAINERS = ("solve", "gd")


def _identity(sigma: torch.Tensor) -> torch.Tensor:
    return sigma


def _row_noise(generator: torch.Generator, n: int,
               device) -> torch.Tensor:
    """N(0, 1) f32[n], the next n draws of the loop's generator."""
    return torch.randn(n, generator=generator, device=device)


@ieee_f32()
def _lda_device(sigma: torch.Tensor, schema: FeatureSchema, label: int,
                shrinkage: float):
    """Device LDA from the full sigma: returns (W [m, C], intercept [C],
    keep) where features = [num cols ‖ non-label one-hot]. An empty class
    keeps intercept log(0) = -inf, so argmax never predicts it."""
    d = schema.num_cols
    offs = schema.offsets
    lab_lo = 1 + d + offs[label]
    lab_hi = 1 + d + offs[label + 1]
    keep = torch.tensor([i for i in range(schema.sigma_size)
                         if not lab_lo <= i < lab_hi], device=sigma.device)
    sig = sigma[keep][:, keep]
    n_total = sigma[0, 0]

    # class sums from the label block rows (the factorized GROUP BY label)
    sums = sigma[lab_lo:lab_hi][:, keep]                    # [C, P']
    counts = sums[:, 0]
    cnt = counts.clamp(min=1.0)

    m = keep.numel() - 1
    mean_c = sums[:, 1:] / cnt[:, None]                      # [C, m]
    scaled = sums[:, 1:] / torch.sqrt(cnt)[:, None]
    cov = sig[1:, 1:] - scaled.T @ scaled
    mu = torch.trace(cov) / m
    eye = torch.eye(m, dtype=sigma.dtype, device=sigma.device)
    cov = (cov * (1.0 - shrinkage) + shrinkage * mu * eye) / n_total
    w = lstsq_min_norm(cov, mean_c.T)                         # [m, C]
    intercept = (-0.5 * (mean_c * w.T).sum(dim=1)
                 + torch.log(counts / n_total))
    return w, intercept, keep


def _w_full(w: torch.Tensor, keep: torch.Tensor,
            schema: FeatureSchema) -> torch.Tensor:
    """Scatter LDA coefficients back to full sigma layout: excluded rows
    (ones + the label's own one-hot block) get zero coefficients."""
    out = w.new_zeros((schema.sigma_size, w.shape[1]))
    out[keep[1:]] = w
    return out


def _check_trainer(trainer: str) -> None:
    if trainer not in TRAINERS:
        raise ValueError(f"trainer must be one of {TRAINERS}, "
                         f"got {trainer!r}")


def _train_num(sigma: torch.Tensor, col: int, trainer: str,
               gd_iters: int) -> torch.Tensor:
    """The numeric column's coeff f32[P] (−1 at the label): one min-norm
    solve, or at most `gd_iters` steps of the reference's GD."""
    if trainer == "solve":
        return linreg_solve_device(sigma, label=col + 1)
    return linreg_train_device(sigma, label=col + 1, max_iters=gd_iters)


@ieee_f32()
def _noise_std(coeff: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Residual std of the linreg model, from the sigma it was trained on
    (coeff has −1 at the label)."""
    var = coeff @ sigma @ coeff / sigma[0, 0].clamp(min=1.0)
    return torch.sqrt(var.clamp(min=0.0))


def _round_columns(x_cols, code_cols, w_num, w_cat, null_num, null_cat, *,
                   schema: FeatureSchema,
                   num_cols_to_impute: tuple[int, ...],
                   cat_cols_to_impute: tuple[int, ...],
                   agg, lda_shrinkage: float, noise_for, trainer: str,
                   gd_iters: int, combine=_identity):
    """One MICE round's per-column body. x_cols / code_cols: lists of
    per-column [n] tensors; w_* / null_*: per-column observed weights and
    null masks; `agg(x_cols, code_cols, w) -> sigma`, then `combine(sigma)`
    (an all-reduce over row shards); `noise_for(col) -> f32[n] | None`, the
    noise of numeric column col (a row shard keys it by global rows);
    `trainer`, `gd_iters`: see `_train_num`."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    for col in cat_cols_to_impute:
        sigma = combine(agg(x_cols, code_cols, w_cat[col]))
        w, intercept, keep = _lda_device(sigma, schema, col, lda_shrinkage)
        pred = class_argmax(_w_full(w, keep, schema), intercept,
                            x_cols, code_cols, schema=schema)
        code_cols[col] = torch.where(null_cat[col], pred, code_cols[col])

    for col in num_cols_to_impute:
        sigma = combine(agg(x_cols, code_cols, w_num[col]))
        coeff = _train_num(sigma, col, trainer, gd_iters)
        theta = coeff.clone()
        theta[col + 1] = 0.0
        pred = linear_predict(theta, x_cols, code_cols, schema=schema)
        z = noise_for(col)
        if z is not None:
            pred = pred + _noise_std(coeff, sigma) * z
        x_cols[col] = torch.where(null_num[col], pred, x_cols[col])
    return x_cols, code_cols


def _make_agg(kernel: str, schema: FeatureSchema):
    """(x_cols, code_cols, w) → masked sigma via the chosen aggregation."""
    if kernel == "gram":
        return functools.partial(masked_gram_cols, schema=schema)

    def agg(x_cols, code_cols, w):
        x, c = _stack_cols(x_cols, code_cols, schema)
        return masked_sigma(x, c, w, schema=schema)
    return agg


def _observed(null: torch.Tensor, cols) -> dict:
    """Per-column observed weights f32[n] (1 = observed), loop-invariant."""
    return {j: (~null[j]).to(torch.float32) for j in cols}


def _to_cols(x_num, codes):
    """The columnar carry: contiguous per-column [n] views (one copy of a
    strided input)."""
    return (list(x_num.contiguous().unbind(0)),
            list(codes.contiguous().unbind(0)))


def _from_cols(x_cols, code_cols, x_num, codes):
    return (torch.stack(x_cols) if x_cols else x_num.clone(),
            torch.stack(code_cols) if code_cols else codes.clone())


def mice_loop_device(x_num, codes, num_null, cat_null, generator=None, *,
                     schema: FeatureSchema,
                     num_cols_to_impute: tuple[int, ...],
                     cat_cols_to_impute: tuple[int, ...], iters: int,
                     lda_shrinkage: float = 0.001, noise: bool = False,
                     kernel: str = "plain", trainer: str = "solve",
                     gd_iters: int = 500):
    """The unfused MICE loop: `iters` rounds over the columnar carry.
    Arrays are features-first; returns (x_num, codes). kernel: 'plain' or
    'gram'; trainer: 'solve' or 'gd' (at most `gd_iters` GD steps a
    numeric column); noise=True draws from `generator`."""
    _check_trainer(trainer)
    if kernel not in ("plain", "gram"):
        raise ValueError(f"unfused loop kernel must be 'plain' or 'gram', "
                         f"got {kernel!r}")
    if noise and generator is None:
        raise ValueError("noise=True needs a torch.Generator")
    n = num_null.shape[-1]
    agg = _make_agg(kernel, schema)
    w_num = _observed(num_null, num_cols_to_impute)
    w_cat = _observed(cat_null, cat_cols_to_impute)

    def noise_for(col):
        return _row_noise(generator, n, x_num.device) if noise else None

    x_cols, code_cols = _to_cols(x_num, codes)
    for _ in range(iters):
        x_cols, code_cols = _round_columns(
            x_cols, code_cols, w_num, w_cat, num_null, cat_null,
            schema=schema, num_cols_to_impute=num_cols_to_impute,
            cat_cols_to_impute=cat_cols_to_impute, agg=agg,
            lda_shrinkage=lda_shrinkage, noise_for=noise_for,
            trainer=trainer, gd_iters=gd_iters)
    return _from_cols(x_cols, code_cols, x_num, codes)


def mice_round_device(x_num, codes, num_null, cat_null, generator=None,
                      **kwargs):
    """One MICE round of the unfused loop; returns (x_num, codes)."""
    return mice_loop_device(x_num, codes, num_null, cat_null, generator,
                            iters=1, **kwargs)


def _fused_round_body(x_cols, code_cols, sigma, r: int, *,
                      schema: FeatureSchema, steps, null_of, w_of,
                      lda_shrinkage: float, seed: int | None = None,
                      combine=_identity, row_offset: int = 0):
    """One fused-MICE round: per column, train on the carried sigma, then
    ONE fused impute+aggregate pass (K2) that writes the column and emits
    the NEXT column's sigma, passed through `combine` (an all-reduce over
    row shards). `null_of(kind, col)` → bool[n] (True = impute),
    `w_of(kind, col)` → f32[n] observed weights; `seed` enables K2's
    in-kernel noise, keyed by round r and global row (local row +
    `row_offset`). Returns (x_cols, code_cols, sigma)."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    for i, (kind, col) in enumerate(steps):
        w_next = w_of(*steps[(i + 1) % len(steps)])
        if kind == "cat":
            w, icpt, keep = _lda_device(sigma, schema, col, lda_shrinkage)
            new, sigma = fused_impute_aggregate(
                x_cols, code_cols, null_of(kind, col), w_next,
                _w_full(w, keep, schema), icpt, schema=schema, kind="cat",
                imp_col=col)
            sigma = combine(sigma)
            code_cols[col] = new
        else:
            coeff = linreg_solve_device(sigma, label=col + 1)
            theta = coeff.clone()
            theta[col + 1] = 0.0
            noise = (None if seed is None
                     else (seed, r, _noise_std(coeff, sigma)))
            new, sigma = fused_impute_aggregate(
                x_cols, code_cols, null_of(kind, col), w_next,
                theta[:, None], theta.new_zeros(1), schema=schema,
                kind="num", imp_col=col, noise=noise, row_offset=row_offset)
            sigma = combine(sigma)
            x_cols[col] = new
    return x_cols, code_cols, sigma


def mice_loop_device_fused(x_num, codes, num_null, cat_null, *,
                           schema: FeatureSchema,
                           num_cols_to_impute: tuple[int, ...],
                           cat_cols_to_impute: tuple[int, ...], iters: int,
                           lda_shrinkage: float = 0.001, noise: bool = False,
                           seed: int = 0):
    """The MICE loop as a chain of FUSED impute+aggregate passes: one K1
    aggregation for the first column, then every K2 call imputes the
    previous column AND produces the next column's masked sigma in the
    same pass — 2 table passes per round at 2 null columns instead of 4.
    Trainer is the direct solve. Semantics otherwise those of
    mice_loop_device(kernel='gram'). noise=True: stochastic-regression
    imputation with K2's Philox noise keyed by `seed` (a different stream
    from the unfused loop's generator)."""
    steps = ([("cat", j) for j in cat_cols_to_impute]
             + [("num", j) for j in num_cols_to_impute])
    if not steps:
        return x_num.clone(), codes.clone()
    nulls = {"cat": cat_null.contiguous(), "num": num_null.contiguous()}
    weights = {(kind, col): (~nulls[kind][col]).to(torch.float32)
               for kind, col in steps}

    def null_of(kind, col):
        return nulls[kind][col]

    def w_of(kind, col):
        return weights[(kind, col)]

    x_cols, code_cols = _to_cols(x_num, codes)
    sigma = masked_gram_cols(x_cols, code_cols, w_of(*steps[0]),
                             schema=schema)
    for r in range(iters):
        x_cols, code_cols, sigma = _fused_round_body(
            x_cols, code_cols, sigma, r, schema=schema, steps=steps,
            null_of=null_of, w_of=w_of, lda_shrinkage=lda_shrinkage,
            seed=seed if noise else None)
    return _from_cols(x_cols, code_cols, x_num, codes)


def run_mice_device(t: Table, num_null_cols=None, cat_null_cols=None,
                    iters: int = 5, *, lda_shrinkage: float = 0.001,
                    noise: bool = False, seed: int = 0, kernel: str = "auto",
                    trainer: str = "solve", gd_iters: int = 500) -> Table:
    """Mean/mode init on the table's device, then the device loop chosen by
    `kernel` (see the module docstring) with the numeric trainer `trainer`
    ('solve', or 'gd' with at most `gd_iters` steps; the fused loop is
    solve-only). Returns the imputed Table."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    _check_trainer(trainer)
    t = init_fill(t)
    schema = t.schema
    if num_null_cols is None:
        has = t.num_null.any(dim=1).tolist()
        num_null_cols = tuple(j for j, h in enumerate(has) if h)
    if cat_null_cols is None:
        has = t.cat_null.any(dim=1).tolist()
        cat_null_cols = tuple(j for j, h in enumerate(has) if h)
    if kernel == "auto":
        kernel = "gram" if t.device.type == "cuda" else "plain"
    kw = dict(schema=schema, num_cols_to_impute=tuple(num_null_cols),
              cat_cols_to_impute=tuple(cat_null_cols), iters=iters,
              lda_shrinkage=lda_shrinkage, noise=noise)
    if kernel == "fused":
        if trainer != "solve":
            raise ValueError("the fused impute+aggregate loop is "
                             "solve-only; use kernel='gram' for GD")
        x, c = mice_loop_device_fused(t.num_data, t.cat_codes, t.num_null,
                                      t.cat_null, seed=seed, **kw)
    else:
        generator = None
        if noise:
            generator = torch.Generator(device=t.device)
            generator.manual_seed(seed)
        x, c = mice_loop_device(t.num_data, t.cat_codes, t.num_null,
                                t.cat_null, generator, kernel=kernel,
                                trainer=trainer, gd_iters=gd_iters, **kw)
    return dataclasses.replace(t, num_data=x, cat_codes=c)


def _delta_round_columns(xc, cc, full, imp_num, imp_cat, w_num, w_cat, gidx,
                         r: int, *, schema: FeatureSchema,
                         num_cols_to_impute: tuple[int, ...],
                         cat_cols_to_impute: tuple[int, ...], agg,
                         lda_shrinkage: float, seed: int | None,
                         trainer: str, gd_iters: int, combine=_identity):
    """One delta-MICE round over the COMPACT union sub-table (the
    imputation_low.cpp:42-110 algebra), categorical columns first: per
    column, delta = sigma(compact rows, weights = the column's dirty mask);
    train = full − delta → train and impute the compact cells; full =
    train + sigma(compact rows with the updated values). Every compact
    sigma passes through `combine` (an all-reduce over row shards). xc /
    cc: compact per-column [K] tensors; imp_* bool[K] (True = impute) and
    w_* f32[K] per column; gidx int64[K] the global row ids (noise keying);
    `seed` enables the Philox noise of round r; `trainer`, `gd_iters`: see
    `_train_num`. Returns (xc, cc, full)."""
    xc, cc = list(xc), list(cc)
    for col in cat_cols_to_impute:
        train = full - combine(agg(xc, cc, w_cat[col]))
        w, intercept, keep = _lda_device(train, schema, col, lda_shrinkage)
        pred = class_argmax(_w_full(w, keep, schema), intercept, xc, cc,
                            schema=schema)
        cc[col] = torch.where(imp_cat[col], pred, cc[col])
        full = train + combine(agg(xc, cc, w_cat[col]))

    for col in num_cols_to_impute:
        train = full - combine(agg(xc, cc, w_num[col]))
        coeff = _train_num(train, col, trainer, gd_iters)
        theta = coeff.clone()
        theta[col + 1] = 0.0
        pred = linear_predict(theta, xc, cc, schema=schema)
        if seed is not None:
            pred = pred + _noise_std(coeff, train) * philox_normal(
                seed, r, col, gidx.numel(), rows=gidx)
        xc[col] = torch.where(imp_num[col], pred, xc[col])
        full = train + combine(agg(xc, cc, w_num[col]))
    return xc, cc, full


def mice_loop_device_delta(x_num, codes, num_null, cat_null, union_idx,
                           union_valid, full_sigma=None, *,
                           schema: FeatureSchema,
                           num_cols_to_impute: tuple[int, ...],
                           cat_cols_to_impute: tuple[int, ...], iters: int,
                           lda_shrinkage: float = 0.001, noise: bool = False,
                           seed: int = 0, kernel: str = "plain",
                           trainer: str = "solve", gd_iters: int = 500,
                           round_offset: int = 0):
    """The low-missing delta strategy (imputation_low.cpp) on the device:
    ONE full aggregation, ONE gather of the union of dirty rows into a
    compact sub-table, then every round runs on the compact rows alone
    (`_delta_round_columns`), and ONE scatter-add per column writes the
    imputed cells back at exit. Arrays are features-first; returns
    (x_num, codes); the inputs stay unchanged.

    union_idx int64[K]: the union rows, padding aliased to row 0;
    union_valid f32[K]: 1 for a union row, 0 for padding
    (`build_union_gather`). full_sigma: optionally the [P, P] sigma of the
    full table computed elsewhere. round_offset: global index of the first
    round (the noise is keyed by it). kernel: 'plain' or 'gram' (K1, or K7
    for P > 88); trainer: 'solve' or 'gd' (at most `gd_iters` GD steps a
    numeric column); noise=True draws Philox noise keyed by `seed`, the
    round, the column and each row's global id."""
    _check_trainer(trainer)
    if kernel not in ("plain", "gram"):
        raise ValueError(f"delta loop kernel must be 'plain' or 'gram', "
                         f"got {kernel!r}")
    agg = _make_agg(kernel, schema)
    x_cols0, code_cols0 = _to_cols(x_num, codes)
    full = (full_sigma if full_sigma is not None
            else agg(x_cols0, code_cols0, None))
    xc, cc, masks = _delta_gather(x_cols0, code_cols0, num_null, cat_null,
                                  union_idx, union_valid, num_cols_to_impute,
                                  cat_cols_to_impute)
    xc0, cc0 = list(xc), list(cc)
    for r in range(round_offset, round_offset + iters):
        xc, cc, full = _delta_round_columns(
            xc, cc, full, *masks, union_idx, r,
            schema=schema, num_cols_to_impute=num_cols_to_impute,
            cat_cols_to_impute=cat_cols_to_impute, agg=agg,
            lda_shrinkage=lda_shrinkage, seed=seed if noise else None,
            trainer=trainer, gd_iters=gd_iters)
    x_cols, code_cols = _delta_scatter(
        x_cols0, code_cols0, xc, cc, xc0, cc0, union_idx, union_valid,
        num_cols_to_impute, cat_cols_to_impute)
    return _from_cols(x_cols, code_cols, x_num, codes)


def _delta_gather(x_cols, code_cols, num_null, cat_null, union_idx,
                  union_valid, num_cols_to_impute, cat_cols_to_impute):
    """The compact union sub-table: (xc, cc, (imp_num, imp_cat, w_num,
    w_cat)), per-column [K] tensors gathered at union_idx and, per imputed
    column, its null mask there (False at padding) and its f32 weights."""
    xc = [a[union_idx] for a in x_cols]
    cc = [a[union_idx] for a in code_cols]
    valid = union_valid > 0
    imp_num = {j: num_null[j][union_idx] & valid for j in num_cols_to_impute}
    imp_cat = {j: cat_null[j][union_idx] & valid for j in cat_cols_to_impute}
    w_num = {j: m.to(torch.float32) for j, m in imp_num.items()}
    w_cat = {j: m.to(torch.float32) for j, m in imp_cat.items()}
    return xc, cc, (imp_num, imp_cat, w_num, w_cat)


def _delta_scatter(x_cols, code_cols, xc, cc, xc0, cc0, union_idx,
                   union_valid, num_cols_to_impute, cat_cols_to_impute):
    """The write-back: one scatter-ADD of (new − gathered) per imputed
    column (padding aliases row 0 with valid 0, an exact no-op; cells left
    as they were add 0). Returns new column lists."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    valid = (union_valid > 0).to(torch.int32)
    for col in num_cols_to_impute:
        x_cols[col] = x_cols[col].index_add(
            0, union_idx, union_valid * (xc[col] - xc0[col]))
    for col in cat_cols_to_impute:
        code_cols[col] = code_cols[col].index_add(
            0, union_idx, valid * (cc[col] - cc0[col]))
    return x_cols, code_cols


def build_union_gather(dirty_idx_lists, blk: int | None = 1):
    """Union of per-column dirty-row index lists (int tensors or arrays) →
    (union_idx int64[K], union_valid f32[K]), sorted, on the lists' device.

    blk an int: the JAX package's bucket, K = the next power of two of the
    union size rounded up to a multiple of blk, the padding aliased to row 0
    with valid 0 (it bounds the number of XLA compiles). blk=None: the
    exact union, valid all ones (the port's kernels take any row count, so
    `run_mice_device_delta` passes no padding)."""
    lists = [torch.as_tensor(ix, dtype=torch.int64) for ix in dirty_idx_lists]
    union = (torch.unique(torch.cat(lists)) if lists
             else torch.zeros(0, dtype=torch.int64))
    if blk is None:
        return union, torch.ones(union.numel(), dtype=torch.float32,
                                 device=union.device)
    size = max(union.numel(), 1)
    bucket = 1 << (size - 1).bit_length()
    bucket = -(-bucket // blk) * blk
    idx = union.new_zeros(bucket)
    idx[:union.numel()] = union
    valid = (torch.arange(bucket, device=union.device)
             < union.numel()).to(torch.float32)
    return idx, valid


def run_mice_device_delta(t: Table, num_null_cols=None, cat_null_cols=None,
                          iters: int = 5, *, lda_shrinkage: float = 0.001,
                          noise: bool = False, seed: int = 0,
                          kernel: str = "auto", trainer: str = "solve",
                          gd_iters: int = 500) -> Table:
    """Mean/mode init, the dirty-row partitions and their exact union, then
    the compact delta loop (`mice_loop_device_delta`). kernel: 'auto'
    ('gram' for a CUDA table, 'plain' on the CPU), 'plain' or 'gram';
    trainer: 'solve' or 'gd' (at most `gd_iters` steps). Returns the
    imputed Table."""
    if kernel not in DELTA_KERNELS:
        raise ValueError(f"kernel must be one of {DELTA_KERNELS}, "
                         f"got {kernel!r}")
    t = init_fill(t)
    parts = build_partitions(t)
    if num_null_cols is None:
        num_null_cols = tuple(j for j, ix in enumerate(parts.num_dirty_idx)
                              if ix.numel())
    if cat_null_cols is None:
        cat_null_cols = tuple(j for j, ix in enumerate(parts.cat_dirty_idx)
                              if ix.numel())
    if kernel == "auto":
        kernel = "gram" if t.device.type == "cuda" else "plain"
    union_idx, union_valid = build_union_gather(
        [parts.num_dirty_idx[j] for j in num_null_cols]
        + [parts.cat_dirty_idx[j] for j in cat_null_cols], blk=None)
    x, c = mice_loop_device_delta(
        t.num_data, t.cat_codes, t.num_null, t.cat_null, union_idx,
        union_valid, schema=t.schema, num_cols_to_impute=tuple(num_null_cols),
        cat_cols_to_impute=tuple(cat_null_cols), iters=iters,
        lda_shrinkage=lda_shrinkage, noise=noise, seed=seed, kernel=kernel,
        trainer=trainer, gd_iters=gd_iters)
    return dataclasses.replace(t, num_data=x, cat_codes=c)
