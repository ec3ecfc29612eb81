"""On-device MICE rounds: the single-device loops.

Counterpart of `duckdb_imputation_tpu.mice.device_round` (the unfused and
fused loops and `run_mice_device`). For each round and each null column,
categorical columns first (the reference's order,
imputation_base.cpp:18-87), a round:
  1. aggregates the masked sigma (Zᵀ·diag(w)·Z, w = observed mask);
  2. solves the model on the device (`_lda_device`, or
     `models.device.linreg_solve_device`);
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

On CPU tensors K1 and K2 take their plain versions, so every kernel value
runs on the CPU too. trainer='gd' (the JAX package's GD loop) is not
ported yet and raises NotImplementedError.

Noise (stochastic regression): the unfused loop draws N(0, 1) per row from
a `torch.Generator` on the table's device, seeded from `seed`, in the
order (round, column); the fused loop draws it inside K2 from Philox keyed
by (seed, round, column, global row). Neither is JAX's threefry stream, so
noise is compared with the JAX package by its moments.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..schema import FeatureSchema
from ..models.device import linreg_solve_device, lstsq_min_norm
from ..ring.kernels.sigma_fused import fused_impute_aggregate
from ..ring.kernels.sigma_pallas import masked_gram_cols
from ..ring.sum import _stack_cols, class_argmax, linear_predict, masked_sigma
from ..table.table import Table
from .partition import init_fill

KERNELS = ("auto", "plain", "gram", "fused")


def _row_noise(generator: torch.Generator, n: int,
               device) -> torch.Tensor:
    """N(0, 1) f32[n], the next n draws of the loop's generator."""
    return torch.randn(n, generator=generator, device=device)


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


def _noise_std(coeff: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Residual std of the linreg model, from the sigma it was trained on
    (coeff has −1 at the label)."""
    var = coeff @ sigma @ coeff / sigma[0, 0].clamp(min=1.0)
    return torch.sqrt(var.clamp(min=0.0))


def _round_columns(x_cols, code_cols, w_num, w_cat, null_num, null_cat, *,
                   schema: FeatureSchema,
                   num_cols_to_impute: tuple[int, ...],
                   cat_cols_to_impute: tuple[int, ...],
                   agg, lda_shrinkage: float, noise_for):
    """One MICE round's per-column body. x_cols / code_cols: lists of
    per-column [n] tensors; w_* / null_*: per-column observed weights and
    null masks; `agg(x_cols, code_cols, w) -> sigma`; `noise_for() ->
    f32[n] | None`."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    for col in cat_cols_to_impute:
        sigma = agg(x_cols, code_cols, w_cat[col])
        w, intercept, keep = _lda_device(sigma, schema, col, lda_shrinkage)
        pred = class_argmax(_w_full(w, keep, schema), intercept,
                            x_cols, code_cols, schema=schema)
        code_cols[col] = torch.where(null_cat[col], pred, code_cols[col])

    for col in num_cols_to_impute:
        sigma = agg(x_cols, code_cols, w_num[col])
        coeff = linreg_solve_device(sigma, label=col + 1)
        theta = coeff.clone()
        theta[col + 1] = 0.0
        pred = linear_predict(theta, x_cols, code_cols, schema=schema)
        z = noise_for()
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
                     kernel: str = "plain", trainer: str = "solve"):
    """The unfused MICE loop: `iters` rounds over the columnar carry.
    Arrays are features-first; returns (x_num, codes). kernel: 'plain' or
    'gram'; noise=True draws from `generator`."""
    if trainer != "solve":
        raise NotImplementedError(
            f"trainer={trainer!r} is not ported yet; use 'solve'")
    if kernel not in ("plain", "gram"):
        raise ValueError(f"unfused loop kernel must be 'plain' or 'gram', "
                         f"got {kernel!r}")
    if noise and generator is None:
        raise ValueError("noise=True needs a torch.Generator")
    n = num_null.shape[-1]
    agg = _make_agg(kernel, schema)
    w_num = _observed(num_null, num_cols_to_impute)
    w_cat = _observed(cat_null, cat_cols_to_impute)

    def noise_for():
        return _row_noise(generator, n, x_num.device) if noise else None

    x_cols, code_cols = _to_cols(x_num, codes)
    for _ in range(iters):
        x_cols, code_cols = _round_columns(
            x_cols, code_cols, w_num, w_cat, num_null, cat_null,
            schema=schema, num_cols_to_impute=num_cols_to_impute,
            cat_cols_to_impute=cat_cols_to_impute, agg=agg,
            lda_shrinkage=lda_shrinkage, noise_for=noise_for)
    return _from_cols(x_cols, code_cols, x_num, codes)


def mice_round_device(x_num, codes, num_null, cat_null, generator=None,
                      **kwargs):
    """One MICE round of the unfused loop; returns (x_num, codes)."""
    return mice_loop_device(x_num, codes, num_null, cat_null, generator,
                            iters=1, **kwargs)


def _fused_round_body(x_cols, code_cols, sigma, r: int, *,
                      schema: FeatureSchema, steps, null_of, w_of,
                      lda_shrinkage: float, seed: int | None = None):
    """One fused-MICE round: per column, train on the carried sigma, then
    ONE fused impute+aggregate pass (K2) that writes the column and emits
    the NEXT column's sigma. `null_of(kind, col)` → bool[n] (True =
    impute), `w_of(kind, col)` → f32[n] observed weights; `seed` enables
    K2's in-kernel noise. Returns (x_cols, code_cols, sigma)."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    for i, (kind, col) in enumerate(steps):
        w_next = w_of(*steps[(i + 1) % len(steps)])
        if kind == "cat":
            w, icpt, keep = _lda_device(sigma, schema, col, lda_shrinkage)
            new, sigma = fused_impute_aggregate(
                x_cols, code_cols, null_of(kind, col), w_next,
                _w_full(w, keep, schema), icpt, schema=schema, kind="cat",
                imp_col=col)
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
                kind="num", imp_col=col, noise=noise)
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
                    trainer: str = "solve") -> Table:
    """Mean/mode init on the table's device, then the device loop chosen by
    `kernel` (see the module docstring). Returns the imputed Table."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
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
                             "solve-only")
        x, c = mice_loop_device_fused(t.num_data, t.cat_codes, t.num_null,
                                      t.cat_null, seed=seed, **kw)
    else:
        generator = None
        if noise:
            generator = torch.Generator(device=t.device)
            generator.manual_seed(seed)
        x, c = mice_loop_device(t.num_data, t.cat_codes, t.num_null,
                                t.cat_null, generator, kernel=kernel,
                                trainer=trainer, **kw)
    return dataclasses.replace(t, num_data=x, cat_codes=c)
