"""P past 46,340 on the CPU: criteo_c18, Criteo's Kaggle schema with C18
(13 numerics, 18 categorical columns, P = 47,412, 47 windows of 1,024).

The CPU cannot hold its dense S (9.0 GB in f32), so the kernels' own
plans are tested a window at a time:

- three windows of K7's plans (`_build.keyed_window_plan`: the one inside
  C15, which holds C_{15,7}'s row-cut slabs, one inside C18 and the last)
  map every structurally nonzero place of their columns once, with no
  task past the budget (`assert_kernel_windows_cover_once`'s rule, a
  window at a time);
- the plain walker of those plans (`masked_gram_window_keyed_plain`: the
  residual plan's cells, the keyed tasks over the window order, both
  placed through the maps by `wide_assemble`) over 64 seeded rows equals
  the f64 sums Zᵀ·diag(w)·Z[:, lo:hi] (counts exact, the rest within
  1e-5 of max|σ|), and the JAX package's `ring.striped.sigma_stripe` of
  the same window (its dense Zᵀ of 64 rows, Precision.HIGHEST) within the
  same gates;
- the limits: every wrapper of K7, K2w and K8 (and `scan_gram`'s check)
  takes the schema on 'meta' tensors and refuses them only as lying on no
  CUDA device; K3/K3w refuse it on the sigma size (MAX_SCORER_SIGMA_SIZE);
  K2w's W past 2³¹ cells and P past MAX_WINDOW_SIGMA_SIZE raise
  ValueError before any launch.

The entry points past 1,024 columns (masked_gram_cols, fused_impute_
aggregate, grouped_gram_presorted, scan_gram, run_mice_wide) are held
against the JAX package at small schemas by tests/test_torch_past_1024.py,
tests/test_torch_wide_levels.py and tests/test_torch_window_keyed.py:
past 46,340 they take the same code paths, with wider integers only in
the kernels.
"""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.striped import sigma_stripe as ref_stripe

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import streaming
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
    qda_predict_kernel)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram, masked_gram_cols, masked_gram_window,
    masked_gram_window_keyed_plain)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    GroupLayout, grouped_gram, grouped_gram_presorted)

torch.set_num_threads(4)

# criteo_c18's level counts (the DLRM repository's Kaggle preprocessing):
# C1, C2, C5, C6, C7, C8, C9, C11, C13, C14, C15, C17, C18, C19, C20, C22,
# C23, C25 (chip_smoke.py's CRITEO_VOCABS)
CRITEO_C18 = (1460, 583, 305, 24, 12517, 633, 3, 5683, 3194, 27, 14992, 10,
              5652, 2173, 4, 18, 15, 105)
C15, C18, C20 = 10, 12, 14          # their indices among the codes
D = 13
ROWS = 64


def criteo_c18() -> FeatureSchema:
    return FeatureSchema(num_cols=D, cat_keys=tuple(
        tuple(range(v)) for v in CRITEO_C18))


def column_start(schema, j: int) -> int:
    return 1 + schema.num_cols + schema.offsets[j]


def test_schema_is_past_the_old_bound():
    schema = criteo_c18()
    p = schema.sigma_size
    assert p == 47412 and p * p >= 2 ** 31
    assert -(-p // _build.WINDOW_WIDTH) == 47
    assert _build.MAX_SCORER_SIGMA_SIZE < p <= _build.MAX_WINDOW_SIGMA_SIZE
    assert 8 * p * p > 2 ** 34          # f64 per-class forms: 18 GB each
    assert C18 in _build.keyed_columns(D, CRITEO_C18)


def _windows():
    schema = criteo_c18()
    inside = [column_start(schema, j) // 1024 * 1024 + 1024
              for j in (C15, C18)]
    last = (schema.sigma_size - 1) // 1024 * 1024
    return inside + [last]


@pytest.fixture(scope="module")
def rows():
    """64 seeded rows: x N(0, 1), codes uniform in each column, binary
    weights (a quarter zero)."""
    rng = np.random.default_rng(46341)
    x = rng.normal(size=(D, ROWS)).astype(np.float32)
    codes = np.stack([rng.integers(0, v, ROWS)
                      for v in CRITEO_C18]).astype(np.int32)
    w = (rng.random(ROWS) >= 0.25).astype(np.float32)
    yield x, codes, w
    _build.plan_cache.clear()


def _structure(schema, lo: int, hi: int) -> torch.Tensor:
    """bool[P, hi − lo]: the places of S[:, lo:hi] that are not zero by
    construction (all but the off-diagonal cells of one column's one-hot
    block)."""
    p = schema.sigma_size
    col = torch.full((p,), -1, dtype=torch.int64)
    for j in range(schema.cat_cols):
        col[column_start(schema, j):column_start(schema, j + 1)
            if j + 1 < schema.cat_cols else p] = j
    idx = torch.arange(p)
    same = (col[:, None] == col[None, lo:hi]) & (col[:, None] >= 0)
    return ~same | (idx[:, None] == idx[None, lo:hi])


@pytest.mark.parametrize("which", ["c15", "c18", "last"])
def test_window_plans_cover_their_columns_once(which, rows):
    """The window's residual and keyed plans map every structurally
    nonzero place of S[:, lo:hi] once and nothing else, no task past the
    budget; the window inside C15 holds C_{15,7}'s row-cut (CB) slabs."""
    schema = criteo_c18()
    p = schema.sigma_size
    lo = _windows()[["c15", "c18", "last"].index(which)]
    hi = min(lo + _build.WINDOW_WIDTH, p)
    residual, keyed = _build.keyed_window_plan(schema, lo, hi)
    plans = [pl for pl in (residual, keyed and keyed.plan) if pl is not None]
    count = torch.zeros(p * (hi - lo), dtype=torch.int64)
    for pl in plans:
        assert pl.window == (lo, hi)
        assert pl.max_task_cells <= _build.WIDE_TASK_BYTES // 8
        for a in range(0, pl.entries.shape[0], 1 << 22):
            e = pl.entries[a:a + (1 << 22)].long()
            assert bool(((e[:, 3] >= lo) & (e[:, 3] < hi)).all())
            count += torch.bincount(e[:, 2] * (hi - lo) + e[:, 3] - lo,
                                    minlength=p * (hi - lo))
    assert torch.equal(count.view(p, hi - lo),
                       _structure(schema, lo, hi).long())
    kinds = {k for pl in plans for k in pl.slabs[:, 0].tolist()}
    if which == "c15":
        assert _build.SLAB_CB in kinds
    if which != "last":       # a window inside a keyed column: all keyed
        assert residual is None
        assert (C15 if which == "c15" else C18) in keyed.columns


@pytest.mark.parametrize("which", ["c15", "c18", "last"])
def test_plain_walker_of_a_window_against_f64_and_jax(which, rows):
    """`masked_gram_window_keyed_plain` (the plans K7 runs, walked in plain
    torch) over 64 rows equals the f64 sums Zᵀ·diag(w)·Z[:, lo:hi] and the
    JAX package's sigma_stripe of the window: counts exact, within 1e-5 of
    max|σ| elsewhere."""
    x, codes, w = rows
    schema = criteo_c18()
    p = schema.sigma_size
    lo = _windows()[["c15", "c18", "last"].index(which)]
    width = min(_build.WINDOW_WIDTH, p - lo)
    got = masked_gram_window_keyed_plain(
        [torch.tensor(a) for a in x], [torch.tensor(a) for a in codes],
        torch.tensor(w), schema=schema, lo=lo, width=width).numpy()
    z = np.zeros((ROWS, p))
    z[:, 0] = 1.0
    z[:, 1:1 + D] = x.T
    for j in range(schema.cat_cols):
        z[np.arange(ROWS), column_start(schema, j) + codes[j]] = 1.0
    want = (z * w[:, None]).T @ z[:, lo:lo + width]        # f64
    jax = np.asarray(ref_stripe(x, codes, w, schema=RefSchema(
        num_cols=D, cat_keys=schema.cat_keys), lo=lo, width=width))
    counted = np.ones(p, bool)
    counted[1:1 + D] = False
    cm = counted[:, None] & counted[None, lo:lo + width]
    scale = np.abs(want).max()
    assert np.array_equal(got[cm], want[cm])
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.array_equal(jax[cm], want[cm])
    assert np.abs(got - jax).max() <= 1e-5 * scale


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_take_criteo_c18_on_meta_tensors():
    """Every wrapper of K7 (per-column, stacked and a window), K2w ('cat'
    on C20, 'num' on I1) and K8 (unsorted and presorted entries) and the
    stream fold's check take P = 47,412: 'meta' tensors are refused only
    as lying on no CUDA device. K3/K3w refuse the schema on the sigma
    size before any launch."""
    schema = criteo_c18()
    p, n, c = schema.sigma_size, 10, schema.cat_cols
    xs = [_meta(n) for _ in range(D)]
    cs = [_meta(n, torch.int32) for _ in range(c)]
    x, cc = _meta((D, n)), _meta((c, n), torch.int32)
    null, w = _meta(n, torch.bool), _meta(n)
    calls = [
        lambda: masked_gram_cols(xs, cs, w, schema=schema),
        lambda: masked_gram(x, cc, w, schema=schema),
        lambda: masked_gram_window(xs, cs, w, schema=schema, lo=39936,
                                   width=1024),
        lambda: fused_impute_aggregate(xs, cs, null, w, _meta((p, 4)),
                                       _meta(4), schema=schema, kind="cat",
                                       imp_col=C20),
        lambda: fused_impute_aggregate(xs, cs, null, w, _meta((p, 1)),
                                       _meta(1), schema=schema, kind="num",
                                       imp_col=0),
        lambda: grouped_gram(x, cc, w, _meta(n, torch.int32), schema=schema,
                             num_groups=2),
        lambda: grouped_gram_presorted(
            x, cc, w, GroupLayout(_meta(3, torch.int64), 2), schema=schema)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    streaming.check_fold(streaming.StreamSchema(
        schema=schema, nullable_num=(0, 2), nullable_cat=(C20,),
        n_rows=n), n)
    small = FeatureSchema(num_cols=4, cat_keys=(tuple(range(1020)),))
    with pytest.raises(ValueError, match="sigma size"):
        qda_predict_kernel(_meta((2, 8)), _build.qda_plan(small), x, cc,
                           schema=schema)
    with pytest.raises(ValueError, match="sigma size"):
        _build.check_qda(schema, 2, n)


def test_limits_past_criteo_c18():
    """K2w's 'cat' W padded to [P + 2][ldw] must stay below 2³¹ cells
    (its int offsets: R past 45,184 classes at P = 47,412 raises); P past
    MAX_WINDOW_SIGMA_SIZE raises in every K7/K2w/K8 check and in the
    stream fold's."""
    schema = criteo_c18()
    ld, m, batch = _build.impute_global_plan(schema, 45184)
    assert (ld, m) == (128, 4) and batch % 32 == 0
    assert (schema.sigma_size + 2) * 45184 < 2 ** 31 <= (
        schema.sigma_size + 2) * 45312
    with pytest.raises(ValueError, match="2\\^31"):
        _build.impute_global_plan(schema, 45185)
    big = tuple(range(1 << 20))
    past = FeatureSchema(num_cols=D, cat_keys=(big, big))
    assert past.sigma_size > _build.MAX_WINDOW_SIGMA_SIZE
    for limit in (_build.MAX_WINDOW_SIGMA_SIZE,
                  _build.MAX_SCORER_SIGMA_SIZE):
        with pytest.raises(ValueError, match="sigma size"):
            _build.check_schema(past, 10, limit)
    with pytest.raises(ValueError, match="sigma size"):
        streaming.check_fold(streaming.StreamSchema(
            schema=past, nullable_num=(), nullable_cat=(), n_rows=10), 10)
    xs = [_meta(10) for _ in range(D)]
    cs = [_meta(10, torch.int32)] * 2
    with pytest.raises(ValueError, match="sigma size"):
        masked_gram_cols(xs, cs, None, schema=past)
    with pytest.raises(ValueError, match="sigma size"):
        fused_impute_aggregate(xs, cs, _meta(10, torch.bool), _meta(10),
                               _meta((past.sigma_size, 1)), _meta(1),
                               schema=past, kind="num", imp_col=0)
