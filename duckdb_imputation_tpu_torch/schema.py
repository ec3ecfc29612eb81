"""Feature schema: the static description of a (numeric, categorical) column set.

TPU-native replacement for the reference's per-call vocabulary machinery
(`n_cols_1hot_expansion`, reference/duckdb_extension/src/ML/utils.cpp:520-576):
instead of re-deriving the sorted per-column category dictionary from every triple's
nested maps, we build it once per table and carry it as a static schema. All dense
triple arrays are laid out against this schema:

  feature vector layout (the "sigma" layout, ML/utils.cpp:176-310):
      [ 1 | x_num[0..d) | onehot(cat_0) | onehot(cat_1) | ... ]

Categories within a column are sorted ascending (the reference's std::map order),
so serialization to the reference's nested key/value lists is a direct scan.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    """Static schema for a triple / cofactor aggregate.

    Attributes:
      num_cols: number of numeric (continuous) columns, d.
      cat_keys: per categorical column, the sorted unique category values
        (tuple of tuples so the schema is hashable and usable as a jit static arg).
    """

    num_cols: int
    cat_keys: tuple[tuple[int, ...], ...] = ()

    # ---- derived sizes ----
    @property
    def cat_cols(self) -> int:
        return len(self.cat_keys)

    @property
    def cat_sizes(self) -> tuple[int, ...]:
        return tuple(len(k) for k in self.cat_keys)

    @property
    def vocab_size(self) -> int:
        """V = total one-hot width across all categorical columns."""
        return sum(self.cat_sizes)

    @property
    def offsets(self) -> tuple[int, ...]:
        """Start offset of each categorical column inside the concatenated vocab
        (the reference's ``cat_vars_idxs``, ML/utils.cpp:528-563). Length cat_cols+1."""
        out = [0]
        for s in self.cat_sizes:
            out.append(out[-1] + s)
        return tuple(out)

    @property
    def sigma_size(self) -> int:
        """1 + d + V — width of the dense sigma matrix (ML/utils.cpp:503-507)."""
        return 1 + self.num_cols + self.vocab_size

    def keys_flat(self) -> np.ndarray:
        """Concatenated category values, i64[V]."""
        if not self.cat_keys:
            return np.zeros((0,), dtype=np.int64)
        return np.concatenate([np.asarray(k, dtype=np.int64) for k in self.cat_keys])

    # ---- construction ----
    @staticmethod
    def infer(num_data: np.ndarray | None, cat_data: np.ndarray | None) -> "FeatureSchema":
        """Build a schema from raw column data.

        num_data: f32[n, d] (or None), cat_data: int[n, c] (or None).
        Mirrors the vocab build of `build_list_of_uniq_categoricals`
        (reference/imputation/algorithms/partition.cpp:722-747): per-column
        SELECT DISTINCT ... ORDER BY.
        """
        d = 0 if num_data is None else int(np.asarray(num_data).shape[1])
        keys: list[tuple[int, ...]] = []
        if cat_data is not None:
            cat_data = np.asarray(cat_data)
            for j in range(cat_data.shape[1]):
                keys.append(tuple(int(v) for v in np.unique(cat_data[:, j])))
        return FeatureSchema(num_cols=d, cat_keys=tuple(keys))

    def encode(self, cat_data: np.ndarray) -> np.ndarray:
        """Map raw categorical values -> local codes in [0, size_j) per column.

        Values not in the vocab map to size_j (one past the end), matching the
        reference's `find_in_array` miss convention (ML/utils.cpp:152-162).
        """
        cat_data = np.asarray(cat_data)
        out = np.empty(cat_data.shape, dtype=np.int32)
        for j, keys in enumerate(self.cat_keys):
            karr = np.asarray(keys, dtype=np.int64)
            idx = np.searchsorted(karr, cat_data[:, j])
            idx = np.clip(idx, 0, len(keys) - 1 if len(keys) else 0)
            found = len(keys) > 0 and True
            hit = karr[idx] == cat_data[:, j] if len(keys) else np.zeros(len(cat_data), bool)
            out[:, j] = np.where(hit, idx, len(keys))
        return out

    def decode(self, col: int, code: np.ndarray) -> np.ndarray:
        """Local code -> raw category value for categorical column `col`."""
        karr = np.asarray(self.cat_keys[col], dtype=np.int64)
        return karr[np.asarray(code)]

    # ---- ring-structure helpers ----
    def concat(self, other: "FeatureSchema") -> "FeatureSchema":
        """Schema of a triple product (join multiply): numeric cols then cat cols
        of self followed by other (mul.cpp:97-107 concatenation order)."""
        return FeatureSchema(
            num_cols=self.num_cols + other.num_cols,
            cat_keys=self.cat_keys + other.cat_keys,
        )

    def union(self, other: "FeatureSchema") -> "FeatureSchema":
        """Schema covering both operands of a ring sum: per-column sorted
        union of category vocabularies. This is what the reference's map
        merge does implicitly (SumStateCombine upserts unseen keys,
        sum_state.cpp:37-96; client-side sum.cpp map merge)."""
        if (self.num_cols != other.num_cols
                or self.cat_cols != other.cat_cols):
            raise ValueError("ring sum of triples with different column sets")
        keys = tuple(tuple(sorted(set(a) | set(b)))
                     for a, b in zip(self.cat_keys, other.cat_keys))
        return FeatureSchema(num_cols=self.num_cols, cat_keys=keys)

    def vocab_map(self, target: "FeatureSchema") -> np.ndarray:
        """Index map i64[V] sending this schema's flat vocab positions to
        `target`'s (target's per-column vocab must be a superset)."""
        out = np.empty(self.vocab_size, dtype=np.int64)
        toff = target.offsets
        for j, (mine, theirs) in enumerate(zip(self.cat_keys,
                                               target.cat_keys)):
            tk = np.asarray(theirs, dtype=np.int64)
            pos = np.searchsorted(tk, np.asarray(mine, dtype=np.int64))
            if len(mine) and (pos >= len(theirs)).any() or \
                    (len(mine) and (tk[pos] != np.asarray(mine)).any()):
                raise ValueError(f"cat col {j}: vocab not a subset of target")
            out[self.offsets[j]:self.offsets[j + 1]] = toff[j] + pos
        return out

    def drop_first(self) -> "FeatureSchema":
        """Drop the first category of every column (QDA collinearity guard,
        ML/utils.cpp:565-572)."""
        return FeatureSchema(
            num_cols=self.num_cols,
            cat_keys=tuple(k[1:] for k in self.cat_keys),
        )

    def without_cat(self, col: int) -> "FeatureSchema":
        """Remove one categorical column (used when a cat label is excluded
        from sigma, ML/utils.cpp:211-215)."""
        keys = tuple(k for j, k in enumerate(self.cat_keys) if j != col)
        return FeatureSchema(num_cols=self.num_cols, cat_keys=keys)
