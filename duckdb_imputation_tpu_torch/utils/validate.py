"""Triple validation: the structural invariants of the ring, checked.

Counterpart of `duckdb_imputation_tpu.utils.validate`. The reference
detects nothing: LAPACK failures, missing delta keys and SVD
non-convergence are cout messages that keep going (lda.cpp:302-305,
qda.cpp:215-217, sub.cpp:29,57). Here corruption (NaNs from bad input,
drift in the delta algebra, a desynced schema) is checkable at any ring
boundary. The checks read the aggregate on the host.
"""
from __future__ import annotations

import numpy as np

from ..ring.triple import NBAgg, Triple
from ..schema import FeatureSchema


class TripleValidationError(ValueError):
    pass


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def validate_triple(t: Triple, schema: FeatureSchema, *,
                    atol: float = 1e-2) -> None:
    """Check the structural invariants of a dense triple:
      * every section finite; N >= 0;
      * quad and cat_cat symmetric;
      * per categorical column: Σ_category count == N (every row carries
        exactly one category), the invariant the reference's lin_cat
        derivation from quad_num_cat slot 0 relies on (sum_state.cpp:116+);
      * same-column off-diagonal cat_cat blocks are zero (a row has one
        category per column).
    Raises TripleValidationError with the failed invariant."""
    n = float(_host(t.n))
    arrays = {name: _host(getattr(t, name))
              for name in ("lin", "quad", "lin_cat", "num_cat", "cat_cat")}
    for name, a in arrays.items():
        if not np.isfinite(a).all():
            raise TripleValidationError(f"{name} has non-finite entries")
    if not np.isfinite(n) or n < -atol:
        raise TripleValidationError(f"N = {n} invalid")
    quad = arrays["quad"]
    if not np.allclose(quad, quad.T, atol=atol):
        raise TripleValidationError("quad not symmetric")
    cat_cat = arrays["cat_cat"]
    if not np.allclose(cat_cat, cat_cat.T, atol=atol):
        raise TripleValidationError("cat_cat not symmetric")
    lin_cat = arrays["lin_cat"]
    offs = schema.offsets
    for j in range(schema.cat_cols):
        s = lin_cat[offs[j]:offs[j + 1]].sum()
        if abs(s - n) > max(atol, 4e-6 * abs(n)):  # f32 count-drift bound
            raise TripleValidationError(
                f"cat col {j}: category counts sum to {s}, expected N={n}")
        block = cat_cat[offs[j]:offs[j + 1], offs[j]:offs[j + 1]]
        off_diag = block - np.diag(np.diag(block))
        if np.abs(off_diag).max() > atol:
            raise TripleValidationError(
                f"cat col {j}: same-column cat_cat off-diagonal nonzero")


def validate_nb(t: NBAgg, schema: FeatureSchema, *,
                atol: float = 1e-2) -> None:
    """Finite sections, and per categorical column Σ count == N."""
    n = float(_host(t.n))
    for name in ("lin", "quad_diag", "lin_cat"):
        if not np.isfinite(_host(getattr(t, name))).all():
            raise TripleValidationError(f"{name} has non-finite entries")
    lin_cat = _host(t.lin_cat)
    offs = schema.offsets
    for j in range(schema.cat_cols):
        s = lin_cat[offs[j]:offs[j + 1]].sum()
        if abs(s - n) > max(atol, 4e-6 * abs(n)):
            raise TripleValidationError(
                f"cat col {j}: counts sum {s} != N {n}")
