"""Large-vocabulary aggregation: sigma computed in column stripes.

Counterpart of `duckdb_imputation_tpu.ring.striped` (`sigma_stripe`,
`sigma_striped`). For a large total vocab V the dense P×P sigma no longer
fits one device (V = 64k ⇒ 16 GB f32); a stripe S[:, lo:lo + width] =
Zᵀ·diag(w)·Z[:, lo:lo + width] bounds the memory by P × width, and a
consumer that needs only some columns of sigma (a MICE column step needs
the label's rows and the numeric block) computes just those.

On a CUDA table a stripe is one launch of K7 over the window's plans
(`ring.kernels.sigma_pallas.masked_gram_window`: the cells of S's nonzero
structure whose row or column lies in the stripe, summed over each row's
1 + d + c nonzeros); the JAX package builds a dense Zᵀ per row chunk and
multiplies it by the stripe's columns. On the CPU the stripe is its plain
version. The kernel takes any row count, so the JAX signature's
`row_chunk` is gone. Peak device memory of a stripe: P × width f32, plus
the inputs, the window's plans (their map of one i32[4] entry a nonzero
place), K7's f64 partials of the window's cells and, where the stripe
keys a column, the copy of the columns in that column's order.

For V_j·V_k ≫ n (hyper-sparse co-occurrence) the JAX package names the
structure: the cells keyed by code and summed in a fixed order. K7's
windows take it past P = 1,024: a column whose tables take more than
one task is keyed, the rows ordered once by its codes, and each of its
tasks walks only its key range's rows, so a stripe reads each row a
bounded number of times whatever V_j·V_k is, where a task used to read
every row (`_build.keyed_window_plan`, PERF.md §6). Each stripe orders
its own rows; `masked_gram(_cols)` order them once for all of S.
"""
from __future__ import annotations

from ..schema import FeatureSchema
from .kernels.sigma_pallas import masked_gram_window
from .sum import _normalize_inputs


def sigma_stripe(x_num, codes, weights, *, schema: FeatureSchema, lo: int,
                 width: int):
    """S[:, lo:lo + width] = Zᵀ·diag(w)·Z[:, lo:lo + width], f32[P, width],
    of x_num f32[d, n], codes i32[c, n] (local codes) and weights f32[n]
    (None = all ones)."""
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    return masked_gram_window(list(x.unbind(0)), list(c.unbind(0)), w,
                              schema=schema, lo=lo, width=width)


def sigma_striped(x_num, codes, weights, *, schema: FeatureSchema,
                  stripe: int = 1024):
    """Yield (lo, S[:, lo:lo + w]) stripes of `stripe` columns (the last
    one narrower) covering the whole sigma, one at a time: peak memory is
    one stripe."""
    p = schema.sigma_size
    for lo in range(0, p, stripe):
        yield lo, sigma_stripe(x_num, codes, weights, schema=schema, lo=lo,
                               width=min(stripe, p - lo))
