"""Reference-parity API surface, on torch tensors.

Counterpart of `duckdb_imputation_tpu.api`: a Python mirror of every SQL
function the reference extension registers (duckdb_extension/src/
duckdb_imputation_extension.cpp:48-249) and of the client-side library
entry points (imputation/include/*.h):

  ring ops:  to_cofactor, sum_triple, sum_to_triple_<x>_<y>, multiply_triple,
             to_nb_agg, sum_nb_agg, sum_to_nb_agg_<x>_<y>, multiply_nb_agg,
             subtract_triple (client-side, sum_sub.h:9-13), and the
             factorized join sums factorized_sum / factorized_sum_nb
  models:    lda_train/lda_predict, linreg_train/linreg_predict,
             qda_train/qda_predict, nb_train/nb_predict
  MICE:      run_MICE_baseline, run_MICE_low, run_MICE_high

Inputs are numpy columns, as in the JAX package. Column-type dispatch
follows the reference's rule (triple/lift.cpp:34-37): a float dtype is
numeric, an integer dtype categorical, and numeric columns precede
categorical ones. Each function that takes columns builds its tensors on
`device` (the card unless asked otherwise), so the aggregates run the
kernels there; the predictors return numpy. Any `sum_to_triple_<x>_<y>` /
`sum_to_nb_agg_<x>_<y>` name resolves through the module's `__getattr__`
(no 20-column ceiling, unlike the reference's registered 20×20 grid,
duckdb_imputation_extension.cpp:80-113).

Values are `Cofactor` / `NBValue` wrappers (dense triple + schema) whose
`.to_dict()` gives the reference's nested key/value format.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

from . import models as _models
from .ring import serialize
from .ring import sum as ring_sum
from .ring import triple as ring_triple
from .schema import FeatureSchema


# ---------------------------------------------------------------------------
# value wrappers
# ---------------------------------------------------------------------------

def _per_group(agg) -> list:
    """Each group's aggregate of a batched one (the port's field map in
    place of jax.tree.map)."""
    return [ring_triple._map(lambda a, i=i: a[i], agg)
            for i in range(agg.n.shape[0])]


@dataclasses.dataclass
class Cofactor:
    """A triple (or a batch of per-group triples) and its schema."""
    triple: ring_triple.Triple
    schema: FeatureSchema
    batched: bool = False

    def to_dict(self, style: str = "agg"):
        if self.batched:
            return [serialize.triple_to_dict(t, self.schema, style)
                    for t in _per_group(self.triple)]
        return serialize.triple_to_dict(self.triple, self.schema, style)

    def __add__(self, other: "Cofactor") -> "Cofactor":
        return Cofactor(ring_triple.triple_add(self.triple, other.triple),
                        self.schema, self.batched)

    def __sub__(self, other: "Cofactor") -> "Cofactor":
        return Cofactor(ring_triple.triple_sub(self.triple, other.triple),
                        self.schema, self.batched)


@dataclasses.dataclass
class NBValue:
    """An NB aggregate (or a batch of per-group ones) and its schema."""
    agg: ring_triple.NBAgg
    schema: FeatureSchema
    batched: bool = False

    def to_dict(self, style: str = "agg"):
        if self.batched:
            return [serialize.nb_to_dict(a, self.schema, style)
                    for a in _per_group(self.agg)]
        return serialize.nb_to_dict(self.agg, self.schema, style)

    def __add__(self, other: "NBValue") -> "NBValue":
        return NBValue(ring_triple.triple_add(self.agg, other.agg),
                       self.schema, self.batched)

    def __sub__(self, other: "NBValue") -> "NBValue":
        return NBValue(ring_triple.triple_sub(self.agg, other.agg),
                       self.schema, self.batched)


# ---------------------------------------------------------------------------
# column splitting (the FLOAT ⇒ num / INTEGER ⇒ cat dispatch)
# ---------------------------------------------------------------------------

def _split_columns(cols: Sequence[np.ndarray]):
    """(x f32[d, n] or None, raw categories i64[c, n] or None, n)."""
    num, cat = [], []
    seen_cat = False
    for c in cols:
        c = np.asarray(c)
        if np.issubdtype(c.dtype, np.floating):
            if seen_cat:
                raise ValueError(
                    "numerical columns must precede categorical ones "
                    "(reference rule, README.md:126)")
            num.append(c.astype(np.float32))
        else:
            seen_cat = True
            cat.append(c.astype(np.int64))
    n = len(num[0]) if num else len(cat[0])
    x = np.stack(num, 0) if num else None          # features-first [d, n]
    craw = np.stack(cat, 0) if cat else None
    return x, craw, n


def _schema_and_codes(x, craw, schema: FeatureSchema | None):
    if schema is None:
        schema = FeatureSchema.infer(
            x.T if x is not None else None,
            craw.T if craw is not None else None)
    codes = schema.encode(craw.T).T if craw is not None else None
    return schema, codes


def _tensor(a, dtype, device):
    if a is None:
        return None
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _columns(cols, schema, device):
    """(x f32[d, n] or None, codes i32[c, n] or None, schema) on device."""
    x, craw, _ = _split_columns(cols)
    schema, codes = _schema_and_codes(x, craw, schema)
    return (_tensor(x, torch.float32, device),
            _tensor(codes, torch.int32, device), schema)


# ---------------------------------------------------------------------------
# ring aggregate surface
# ---------------------------------------------------------------------------

def to_cofactor(*cols, schema: FeatureSchema | None = None,
                device="cuda") -> Cofactor:
    """`to_cofactor(cols…)` (lift): one degree-1 triple per row."""
    x, codes, schema = _columns(cols, schema, device)
    return Cofactor(ring_sum.lift(x, codes, schema=schema), schema,
                    batched=True)


def sum_triple(value: Cofactor) -> Cofactor:
    """`sum_triple(triple)` aggregate over lifted triples."""
    return Cofactor(ring_sum.sum_triples(value.triple), value.schema)


def _group_ids(group_by, num_groups, device):
    g = np.asarray(group_by)
    if num_groups is None:
        num_groups = int(g.max()) + 1
    return _tensor(g, torch.int32, device), num_groups


def sum_to_triple(*cols, weights=None, group_by=None, num_groups=None,
                  schema: FeatureSchema | None = None,
                  backend: str = "auto", device="cuda") -> Cofactor:
    """`sum_to_triple_x_y(cols…)`, the fused lift+sum; optional row weights
    (a WHERE mask) and GROUP BY vector."""
    x, codes, schema = _columns(cols, schema, device)
    w = _tensor(weights, torch.float32, device)
    if group_by is not None:
        g, num_groups = _group_ids(group_by, num_groups, device)
        t = ring_sum.sum_to_triple_grouped(
            x, codes, g, schema=schema, num_groups=num_groups, weights=w)
        return Cofactor(t, schema, batched=True)
    t = ring_sum.sum_to_triple(x, codes, w, schema=schema, backend=backend)
    return Cofactor(t, schema)


def multiply_triple(a: Cofactor, b: Cofactor) -> Cofactor:
    """`multiply_triple(t1, t2)`, the ring product for factorized joins."""
    return Cofactor(ring_triple.triple_multiply(a.triple, b.triple),
                    a.schema.concat(b.schema))


def factorized_sum(a: Cofactor, b: Cofactor) -> Cofactor:
    """Fused `sum_triple(multiply_triple(A, B))` over per-join-key triples,
    the factorized-join aggregation of README.md:163-174, as contractions
    over the key axis (`ring.triple.factorized_join_sum`).

    `a`/`b` are batched Cofactors from `sum_to_triple(..., group_by=key)`
    with the SAME num_groups (key space). Returns the single joined
    triple."""
    if not (a.batched and b.batched):
        raise ValueError("factorized_sum needs per-key (batched) cofactors; "
                         "use sum_to_triple(..., group_by=join_key)")
    return Cofactor(ring_triple.factorized_join_sum(a.triple, b.triple),
                    a.schema.concat(b.schema))


def factorized_sum_nb(a: NBValue, b: NBValue) -> NBValue:
    """NB-aggregate factorized join-sum (see factorized_sum)."""
    if not (a.batched and b.batched):
        raise ValueError("factorized_sum_nb needs per-key (batched) aggs")
    return NBValue(ring_triple.factorized_join_sum_nb(a.agg, b.agg),
                   a.schema.concat(b.schema))


def subtract_triple(a: Cofactor, b: Cofactor) -> Cofactor:
    """Client-side `Triple::subtract_triple`, the MICE delta operator
    (imputation/triple/sub.cpp)."""
    return a - b


def to_nb_agg(*cols, schema: FeatureSchema | None = None,
              device="cuda") -> NBValue:
    """`to_nb_agg(cols…)`: one degree-1 NB aggregate per row."""
    x, codes, schema = _columns(cols, schema, device)
    return NBValue(ring_sum.nb_lift(x, codes, schema=schema), schema,
                   batched=True)


def sum_nb_agg(value: NBValue) -> NBValue:
    """`sum_nb_agg(agg)` aggregate over lifted NB aggregates."""
    return NBValue(ring_sum.sum_nb_aggs(value.agg), value.schema)


def sum_to_nb_agg(*cols, weights=None, group_by=None, num_groups=None,
                  schema: FeatureSchema | None = None,
                  device="cuda") -> NBValue:
    """`sum_to_nb_agg_x_y(cols…)`; optional row weights and GROUP BY."""
    x, codes, schema = _columns(cols, schema, device)
    w = _tensor(weights, torch.float32, device)
    if group_by is not None:
        g, num_groups = _group_ids(group_by, num_groups, device)
        t = ring_sum.sum_to_nb_agg_grouped(
            x, codes, g, schema=schema, num_groups=num_groups, weights=w)
        return NBValue(t, schema, batched=True)
    return NBValue(ring_sum.sum_to_nb_agg(x, codes, w, schema=schema),
                   schema)


def multiply_nb_agg(a: NBValue, b: NBValue) -> NBValue:
    """`multiply_nb_agg(a, b)`, the ring product of NB aggregates."""
    return NBValue(ring_triple.nb_multiply(a.agg, b.agg),
                   a.schema.concat(b.schema))


def sum_nb_triple(a: NBValue, b: NBValue) -> NBValue:
    """Client-side `Triple::sum_nb_triple` (imputation/triple/sum_nb.cpp)."""
    return a + b


# ---------------------------------------------------------------------------
# model surface — reference argument orders
# ---------------------------------------------------------------------------

def _predict_inputs(cols, decode, device):
    """x f32[d, n] and the local codes i32[c, n] (or None) of predict
    columns on device, the categories encoded against the vocab stored in
    the parameters that `decode(d)` reads (their boundaries `offsets` and
    flat keys `cat_keys`)."""
    x, craw, n = _split_columns(cols)
    p = decode(0 if x is None else x.shape[0])
    codes = None
    if craw is not None:
        offs = p.offsets
        keys = tuple(tuple(int(k) for k in p.cat_keys[offs[j]:offs[j + 1]])
                     for j in range(len(offs) - 1))
        codes = FeatureSchema(num_cols=0, cat_keys=keys).encode(craw.T).T
    if x is None:
        x = np.zeros((0, n), np.float32)
    return (_tensor(x, torch.float32, device),
            _tensor(codes, torch.int32, device))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def lda_train(value: Cofactor, label: int, shrinkage: float = 0.0,
              normalize: bool = False) -> np.ndarray:
    return _models.lda_train(value.triple, value.schema, label,
                             shrinkage=shrinkage, normalize=normalize)


def lda_predict(params, normalize: bool, *cols, device="cuda") -> np.ndarray:
    """Class indices of the rows (the non-label columns use the vocab
    stored in params)."""
    params = np.asarray(params)
    x, codes = _predict_inputs(
        cols, lambda d: _models.LDAParams.decode(params, d, normalize),
        device)
    return _host(_models.lda_predict(params, x, codes,
                                     normalize=normalize))


def linreg_train(value: Cofactor, label: int, step_size: float = 0.001,
                 lambda_: float = 0.0, max_iterations: int = 10000,
                 compute_variance: bool = False,
                 normalize: bool = False) -> np.ndarray:
    return _models.linreg_train(value.triple, value.schema, label,
                                step_size=step_size, lam=lambda_,
                                max_iters=max_iterations,
                                compute_variance=compute_variance,
                                normalize=normalize)


def linreg_predict(params, add_noise: bool, normalize: bool, *cols,
                   generator: torch.Generator | None = None,
                   device="cuda") -> np.ndarray:
    """Predictions of the rows; noise (add_noise) from `generator`, a
    torch.Generator on `device` (the JAX package's `key=`)."""
    params = np.asarray(params)
    x, codes = _predict_inputs(
        cols, lambda d: _models.LinregParams.decode(params, d, normalize,
                                                    add_noise), device)
    return _host(_models.linreg_predict(
        params, x, codes, add_noise=add_noise,
        normalize=normalize, generator=generator))


def qda_train(value: Cofactor, labels, normalize: bool = False) -> np.ndarray:
    """value: batched per-class Cofactor (from sum_to_triple(group_by=…))."""
    return _models.qda_train(value.triple, value.schema, labels,
                             normalize=normalize)


def qda_predict(params, normalize: bool, *cols, device="cuda") -> np.ndarray:
    params = np.asarray(params)
    x, codes = _predict_inputs(
        cols, lambda d: _models.QDAParams.decode(params, d, normalize),
        device)
    return _host(_models.qda_predict(params, x, codes,
                                     normalize=normalize))


def nb_train(value: NBValue, labels) -> np.ndarray:
    return _models.nb_train(value.agg, value.schema, labels)


def nb_predict(params, normalize: bool, *cols, device="cuda") -> np.ndarray:
    params = np.asarray(params)
    x, codes = _predict_inputs(
        cols, lambda d: _models.NBParams.decode(params, d), device)
    return _host(_models.nb_predict(params, x, codes))


# ---------------------------------------------------------------------------
# MICE surface — reference entry-point names
# ---------------------------------------------------------------------------

def run_MICE_baseline(table, con_columns_nulls=None, cat_columns_nulls=None,
                      mice_iters: int = 5, **kw):
    """`run_MICE_baseline(con, con_columns, cat_columns, con_columns_nulls,
    cat_columns_nulls, table_name, mice_iters)`
    (imputation/include/imputation_baseline.h:8). Columns are given by name
    or index; the full column lists are implied by the table, which keeps
    its device."""
    from .mice import run_mice_baseline
    return run_mice_baseline(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def run_MICE_low(table, con_columns_nulls=None, cat_columns_nulls=None,
                 mice_iters: int = 5, **kw):
    from .mice import run_mice_low
    return run_mice_low(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def run_MICE_high(table, con_columns_nulls=None, cat_columns_nulls=None,
                  mice_iters: int = 5, **kw):
    from .mice import run_mice_high
    return run_mice_high(
        table, _resolve(table.num_names, con_columns_nulls),
        _resolve(table.cat_names, cat_columns_nulls), iters=mice_iters, **kw)


def _resolve(names, cols):
    if cols is None:
        return None
    return [names.index(c) if isinstance(c, str) else int(c) for c in cols]


# ---------------------------------------------------------------------------
# the registration grid: sum_to_triple_<x>_<y> / sum_to_nb_agg_<x>_<y>
# ---------------------------------------------------------------------------

_GRID_RE = re.compile(r"^(sum_to_triple|sum_to_nb_agg)_(\d+)_(\d+)$")


def __getattr__(name: str):
    m = _GRID_RE.match(name)
    if not m:
        raise AttributeError(name)
    base, n_num, n_cat = m.group(1), int(m.group(2)), int(m.group(3))
    fn = sum_to_triple if base == "sum_to_triple" else sum_to_nb_agg

    def grid_fn(*cols, **kw):
        if len(cols) != n_num + n_cat:
            raise TypeError(
                f"{name} expects {n_num + n_cat} columns, got {len(cols)}")
        num = [np.asarray(c, np.float32) for c in cols[:n_num]]
        cat = [np.asarray(c).astype(np.int64) for c in cols[n_num:]]
        return fn(*num, *cat, **kw)

    grid_fn.__name__ = name
    return grid_fn
