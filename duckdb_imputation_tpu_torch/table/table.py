"""Columnar table: torch tensors on one explicit device plus null masks.

Counterpart of `duckdb_imputation_tpu.table.table`. The layout is the
same FEATURES-FIRST one: num_data f32[d, n], cat_codes i32[c, n] (local
per-column codes against `schema`), and bool null masks of the same
shapes, True where a cell was ORIGINALLY missing. Every tensor of a table
lies on the same device; `Table.device` names it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..schema import FeatureSchema


@dataclasses.dataclass
class Table:
    """Columnar table. All tensors share the trailing row count n and the
    device.

    num_data: f32[d_num, n] — numeric columns (current, possibly imputed).
    cat_codes: i32[d_cat, n] — categorical columns as LOCAL codes.
    num_null: bool[d_num, n] — True where the value was originally missing.
    cat_null: bool[d_cat, n].
    """
    num_data: torch.Tensor
    cat_codes: torch.Tensor
    num_null: torch.Tensor
    cat_null: torch.Tensor
    schema: FeatureSchema
    num_names: tuple[str, ...] = ()
    cat_names: tuple[str, ...] = ()

    @property
    def n_rows(self) -> int:
        return self.num_data.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.num_data.device

    def to_numpy(self):
        """(num_data, cat_codes, num_null, cat_null) as host numpy arrays."""
        return tuple(a.detach().cpu().numpy() for a in (
            self.num_data, self.cat_codes, self.num_null, self.cat_null))

    def cat_values(self) -> np.ndarray:
        """Decode codes back to raw category values, [c, n] (host)."""
        codes = self.cat_codes.cpu().numpy()
        out = np.zeros_like(codes, dtype=np.int64)
        for j in range(self.schema.cat_cols):
            out[j] = self.schema.decode(j, codes[j])
        return out


def from_numpy(num_data=None, cat_data=None, num_null=None, cat_null=None,
               num_names=(), cat_names=(), schema: FeatureSchema | None = None,
               rows_first: bool = True, device="cuda") -> Table:
    """Build a Table on `device` from host arrays (default pandas-style
    [n, d] row-major; pass rows_first=False for features-first input).
    The device defaults to the card; pass device="cpu" for the plain
    versions (a machine without CUDA raises, it never falls back).
    NaNs in num_data and negative values in cat_data are treated as missing
    when explicit masks are absent. Missing cells hold zero / first-key
    placeholders (call mice.partition.init_fill to mean/mode-fill)."""
    if num_data is None and cat_data is None:
        raise ValueError("need at least one of num_data/cat_data")

    def orient(a):
        if a is None:
            return None
        a = np.asarray(a)
        return a.T if rows_first else a

    num_data = orient(num_data)
    cat_data = orient(cat_data)
    num_null = orient(num_null)
    cat_null = orient(cat_null)
    if num_data is None:
        num_data = np.zeros((0, cat_data.shape[-1]), np.float32)
    num_data = np.asarray(num_data, np.float32)
    n = num_data.shape[-1]
    if cat_data is None:
        cat_data = np.zeros((0, n), np.int64)
    if num_null is None:
        num_null = np.isnan(num_data)
    if cat_null is None:
        cat_null = cat_data < 0
    num_null = np.asarray(num_null, bool)
    cat_null = np.asarray(cat_null, bool)
    if schema is None:
        # vocab from OBSERVED values only (missing cells don't define classes)
        keys = []
        for j in range(cat_data.shape[0]):
            obs = cat_data[j, ~cat_null[j]]
            keys.append(tuple(int(v) for v in np.unique(obs)))
        schema = FeatureSchema(num_cols=num_data.shape[0],
                               cat_keys=tuple(keys))
    if schema.cat_cols:
        filler = np.array([k[0] if k else 0 for k in schema.cat_keys])
        filled = np.where(cat_null, filler[:, None], cat_data)
        codes = schema.encode(filled.T).T
    else:
        codes = np.zeros((0, n), np.int32)
    if not num_names:
        num_names = tuple(f"num{j}" for j in range(num_data.shape[0]))
    if not cat_names:
        cat_names = tuple(f"cat{j}" for j in range(cat_data.shape[0]))

    def tensor(a, dtype):     # contiguous features-first rows
        return torch.tensor(np.ascontiguousarray(a, dtype), device=device)

    return Table(
        num_data=tensor(np.where(num_null, 0.0, num_data), np.float32),
        cat_codes=tensor(codes, np.int32),
        num_null=tensor(num_null, bool),
        cat_null=tensor(cat_null, bool),
        schema=schema, num_names=num_names, cat_names=cat_names)


def from_reference(t_ref, device="cuda") -> Table:
    """Carry a table of the JAX package (`duckdb_imputation_tpu.table.Table`)
    over to this package through numpy, onto `device` (the card unless
    asked otherwise): the data, the null masks, the schema and the column
    names, unchanged. Duck-typed, so this module never imports the JAX
    package."""
    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return Table(
        num_data=tensor(t_ref.num_data, np.float32),
        cat_codes=tensor(t_ref.cat_codes, np.int32),
        num_null=tensor(t_ref.num_null, bool),
        cat_null=tensor(t_ref.cat_null, bool),
        schema=FeatureSchema(num_cols=t_ref.schema.num_cols,
                             cat_keys=tuple(t_ref.schema.cat_keys)),
        num_names=tuple(t_ref.num_names), cat_names=tuple(t_ref.cat_names))
