"""Columnar table: torch tensors on one explicit device plus null masks.

Counterpart of `duckdb_imputation_tpu.table.table`. The layout is the
same FEATURES-FIRST one: num_data f32[d, n], cat_codes i32[c, n] (local
per-column codes against `schema`), and bool null masks of the same
shapes, True where a cell was ORIGINALLY missing. Every tensor of a table
lies on the same device; `Table.device` names it. The write-backs
(`with_num_col`, `with_cat_col`) return a new Table and never write into
the caller's tensors.
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
    # per cat col: None for native-integer categories, or the tuple of
    # original labels of a dictionary-encoded string/object column (the
    # reference ingests INTEGER categories only, triple/lift.cpp:34-37).
    # Raw value v of column j decodes to cat_labels[j][v].
    cat_labels: tuple = ()

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

    def to_pandas(self, nulls_as_na: bool = False):
        """Materialize as a pandas DataFrame: numeric columns f64,
        categorical columns as raw values (dictionary-encoded string
        columns decode back to their labels; integer categories come out
        as nullable Int64). By default the CURRENT cell values are emitted,
        the output after MICE, where originally-null slots hold imputed
        values. nulls_as_na=True blanks the originally-null slots (NaN /
        pd.NA / None) instead: the `from_pandas` round trip of a table that
        was not imputed."""
        import pandas as pd

        num, _, num_null, cat_null = self.to_numpy()
        num = num.astype(np.float64)
        data = {}
        for j, name in enumerate(self.num_names):
            data[name] = (np.where(num_null[j], np.nan, num[j])
                          if nulls_as_na else num[j])
        raw = self.cat_values()
        labels = self.cat_labels or (None,) * self.schema.cat_cols
        for j, name in enumerate(self.cat_names):
            if labels[j] is not None:
                col = np.asarray(labels[j], object)[raw[j]]
                if nulls_as_na:
                    col = np.where(cat_null[j], None, col)
            else:
                col = pd.array(raw[j], dtype="Int64")
                if nulls_as_na:
                    col[cat_null[j]] = pd.NA
            data[name] = col
        return pd.DataFrame(data)

    def with_num_col(self, j: int, values: torch.Tensor,
                     only_null: bool = True) -> "Table":
        """Write-back for a numeric column: replace the (originally null)
        values, the `CASE WHEN col_IS_NULL THEN pred ELSE col END` + column
        swap of the MICE loop (imputation_base.cpp:137-139). Returns a new
        Table; the caller's tensors stay unchanged."""
        col = self.num_data[j]
        new = torch.where(self.num_null[j], values, col) if only_null \
            else values
        num = self.num_data.clone()
        num[j] = new
        return dataclasses.replace(self, num_data=num)

    def with_cat_col(self, j: int, codes: torch.Tensor,
                     only_null: bool = True) -> "Table":
        """Write-back for a categorical column, as `with_num_col`."""
        col = self.cat_codes[j]
        codes = codes.to(col.dtype)
        new = torch.where(self.cat_null[j], codes, col) if only_null \
            else codes
        cat = self.cat_codes.clone()
        cat[j] = new
        return dataclasses.replace(self, cat_codes=cat)

    def null_count_per_row(self) -> torch.Tensor:
        """The `n_nulls` row histogram column of `partition`
        (partition.cpp:61-73), i32[n]."""
        return (self.num_null.sum(0) + self.cat_null.sum(0)).to(torch.int32)


def from_pandas(df, schema: FeatureSchema | None = None,
                device="cuda") -> Table:
    """Build a Table on `device` (the card unless asked otherwise) from a
    pandas DataFrame.

    Column dispatch follows the reference's rule (triple/lift.cpp:34-37):
    float dtypes ⇒ numeric, integer/boolean/categorical-of-int ⇒
    categorical. String/object/categorical-of-string columns are
    dictionary-encoded at the door: sorted-unique labels → codes 0..k−1,
    the labels kept on `Table.cat_labels` so `to_pandas` decodes them back
    (the reference only ingests INTEGER categories). Missing cells (NaN /
    pandas NA / None) set the null masks. pandas is imported here only."""
    import pandas as pd

    num_cols, cat_cols, str_cols = [], [], set()
    for name in df.columns:
        s = df[name]
        if pd.api.types.is_float_dtype(s):
            num_cols.append(name)
        elif (pd.api.types.is_integer_dtype(s)
              or pd.api.types.is_bool_dtype(s)):
            cat_cols.append(name)
        else:
            cat_cols.append(name)
            str_cols.add(name)
    n = len(df)
    num = np.zeros((len(num_cols), n), np.float32)
    num_null = np.zeros((len(num_cols), n), bool)
    for j, name in enumerate(num_cols):
        v = df[name].to_numpy(dtype=np.float64, na_value=np.nan)
        num_null[j] = np.isnan(v)
        num[j] = np.where(num_null[j], 0.0, v)
    cat = np.zeros((len(cat_cols), n), np.int64)
    cat_null = np.zeros((len(cat_cols), n), bool)
    labels: list = []
    for j, name in enumerate(cat_cols):
        s = df[name]
        isna = s.isna().to_numpy()
        cat_null[j] = isna
        if name in str_cols:
            vals = s.to_numpy(dtype=object)
            try:
                uniq = sorted({str(v) for v in vals[~isna]})
            except TypeError:
                raise ValueError(
                    f"column {name!r}: mixed un-encodable values") from None
            lut = {v: i for i, v in enumerate(uniq)}
            cat[j] = [0 if na else lut[str(v)]
                      for v, na in zip(vals, isna)]
            labels.append(tuple(uniq))
        else:
            cat[j] = np.where(isna, 0, s.fillna(0).to_numpy(dtype=np.int64))
            labels.append(None)
    t = from_numpy(num, cat, num_null, cat_null,
                   num_names=tuple(num_cols), cat_names=tuple(cat_cols),
                   schema=schema, rows_first=False, device=device)
    return dataclasses.replace(t, cat_labels=tuple(labels))


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
    asked otherwise): the data, the null masks, the schema, the column
    names and the category labels, unchanged. Duck-typed, so this module
    never imports the JAX package."""
    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return Table(
        num_data=tensor(t_ref.num_data, np.float32),
        cat_codes=tensor(t_ref.cat_codes, np.int32),
        num_null=tensor(t_ref.num_null, bool),
        cat_null=tensor(t_ref.cat_null, bool),
        schema=FeatureSchema(num_cols=t_ref.schema.num_cols,
                             cat_keys=tuple(t_ref.schema.cat_keys)),
        num_names=tuple(t_ref.num_names), cat_names=tuple(t_ref.cat_names),
        cat_labels=tuple(t_ref.cat_labels))
