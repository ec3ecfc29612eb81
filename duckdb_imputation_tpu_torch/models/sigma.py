"""Sigma-matrix assembly and related transforms from dense triples.

Counterpart of `duckdb_imputation_tpu.models.sigma`. In the reference,
`build_sigma_matrix` (ML/utils.cpp:176-310, :313-483) scatters the
triple's nested maps into a dense (1+d+V)² double matrix, and
`n_cols_1hot_expansion` (:520-576) rebuilds the category dictionary. With
the dense Triple those become index selection: the triple IS the sigma
matrix in blocks; excluding a label column or dropping first categories is
a gather on the vocab axis.

The solver-side math is f64 numpy on the host, the reference's precision
and provider (LAPACK): sigma is a small matrix, the FLOPs live in the
aggregation. A triple on the card reaches the host in one copy of its
sigma (`host_sigma`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ring.triple import Triple, sigma_from_triple
from ..schema import FeatureSchema


@dataclasses.dataclass(frozen=True)
class VocabSelection:
    """A selection of vocab slots: the kept schema + flat indices into V."""
    schema: FeatureSchema       # schema restricted to kept columns/categories
    slots: np.ndarray           # i64[V'] indices into the original vocab axis
    kept_cols: tuple[int, ...]  # original cat column ids that survive


def select_vocab(schema: FeatureSchema, exclude_cat: int | None = None,
                 drop_first: bool = False) -> VocabSelection:
    """Build the vocab gather for sigma assembly.

    exclude_cat: drop an entire categorical column (the label exclusion of
      build_sigma_matrix's `label_categorical_sigma`, ML/utils.cpp:211-215).
    drop_first: drop the first category of every kept column (QDA,
      ML/utils.cpp:565-572)."""
    offs = schema.offsets
    slots: list[int] = []
    keys: list[tuple[int, ...]] = []
    kept: list[int] = []
    for j in range(schema.cat_cols):
        if exclude_cat is not None and j == exclude_cat:
            continue
        start = offs[j] + (1 if drop_first else 0)
        slots.extend(range(start, offs[j + 1]))
        keys.append(schema.cat_keys[j][1 if drop_first else 0:])
        kept.append(j)
    return VocabSelection(
        schema=FeatureSchema(num_cols=schema.num_cols, cat_keys=tuple(keys)),
        slots=np.asarray(slots, np.int64),
        kept_cols=tuple(kept),
    )


def host_sigma(t: Triple) -> np.ndarray:
    """The full sigma f64[..., P, P] of a (possibly batched) triple on the
    host: one device-to-host copy of the f32 blocks, widened exactly."""
    return sigma_from_triple(t).detach().cpu().numpy().astype(np.float64)


def _sigma_index(d: int, sel: VocabSelection) -> np.ndarray:
    """Rows/columns of the full sigma that a selection keeps: the ones
    row, the numeric rows, then the selected vocab slots."""
    return np.concatenate([np.arange(1 + d), 1 + d + sel.slots])


def select_sigma(full: np.ndarray, schema: FeatureSchema,
                 sel: VocabSelection) -> np.ndarray:
    """The selection's sigma, cut out of a full host sigma (a copy)."""
    idx = _sigma_index(schema.num_cols, sel)
    return full[..., idx[:, None], idx]


def build_sigma(t: Triple, schema: FeatureSchema,
                exclude_cat: int | None = None,
                drop_first: bool = False) -> tuple[np.ndarray, VocabSelection]:
    """Dense f64 sigma matrix [[N, lin, lin_cat],[…]] with optional label
    exclusion / drop-first. Returns (sigma, selection)."""
    sel = select_vocab(schema, exclude_cat, drop_first)
    return select_sigma(host_sigma(t), schema, sel), sel


def standardize_sigma(sigma: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """In-place sigma standardization (ML/utils.cpp:580-599): convert to the
    Gram matrix of standardized data. Returns (means, std); sigma's first
    row/col sums are zeroed (standardized columns sum to 0)."""
    p = sigma.shape[0]
    n = sigma[0, 0]
    means = sigma[0, :].copy() / n
    std = np.sqrt(np.diag(sigma) / n - (sigma[0, :] / n) ** 2)
    for i in range(1, p):
        for j in range(1, p):
            sigma[i, j] = (sigma[i, j] - means[i] * sigma[0, j]
                           - means[j] * sigma[0, i]
                           + n * means[j] * means[i]) / (std[i] * std[j])
    sigma[0, 1:] = 0.0
    sigma[1:, 0] = 0.0
    return means, std


def class_sums_host(full: np.ndarray, schema: FeatureSchema, label: int,
                    sel: VocabSelection) -> np.ndarray:
    """`class_sums` from a full host sigma (see there)."""
    offs = schema.offsets
    d = schema.num_cols
    rows = 1 + d + np.arange(offs[label], offs[label + 1])
    return full[rows[:, None], _sigma_index(d, sel)]


def class_sums(t: Triple, schema: FeatureSchema, label: int,
               sel: VocabSelection) -> np.ndarray:
    """Per-class sum vectors from the triple's own categorical sections: the
    factorized GROUP BY label (build_sum_vector, lda.cpp:58-144).

    Returns f64[C, P'] where C = |vocab(label)| and P' = 1 + d + V' (the
    label-excluded sigma width): row c = [count_c, Σ x_num per col,
    Σ onehot(other cats)] over rows with label == category c."""
    return class_sums_host(host_sigma(t), schema, label, sel)
