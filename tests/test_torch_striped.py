"""K7 over a column window and the port's `ring/striped.py`, on the CPU.

- the window plan (`_build.window_plan`) lists every structurally nonzero
  place of S[:, lo:hi] exactly once, and its cells, summed in plain torch
  (`wide_tables_plain`) and placed by its map (`wide_assemble`), are the
  window of the plain Gram;
- `masked_gram_window_plain` and `sigma_stripe` / `sigma_striped` match
  the JAX package's `ring.striped.sigma_stripe` and its XLA
  `masked_sigma` at P = 4,099 (n = 4,096) and P = 16,387 (n = 512, as
  tests/test_wide.py sizes it): counts exact, within 1e-5 of max|σ|;
- the limits: K7 takes windows up to MAX_WINDOW_SIGMA_SIZE (P·1,024
  places a window counted in an int), and so do K2w and K8 past
  MAX_WIDE_SIGMA_SIZE = 1,024, over K7's window plans, criteo_c18 (P =
  47,412) among them; K3/K3w stop at MAX_SCORER_SIGMA_SIZE = 46,340; past
  their limits they raise ValueError before any launch (tensors on the
  'meta' device reach each wrapper's kernel path, which checks the schema
  first).
"""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.striped import sigma_stripe as ref_stripe
from duckdb_imputation_tpu.ring.sum import masked_sigma as ref_masked_sigma

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import sigma_stripe, sigma_striped
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
    qda_predict_kernel)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols, masked_gram_cols_plain, masked_gram_window,
    masked_gram_window_plain, wide_assemble, wide_tables_plain)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    GroupLayout, grouped_gram, grouped_gram_presorted)
from duckdb_imputation_tpu_torch.ring.sum import masked_sigma

from test_torch_past_46340 import CRITEO_C18
from test_torch_wide_levels import assert_kernel_windows_cover_once

torch.set_num_threads(4)


def structure(schema) -> torch.Tensor:
    """bool[P, P]: the places of S that are not zero by construction (all
    but the off-diagonal cells of one column's one-hot block)."""
    p, d = schema.sigma_size, schema.num_cols
    m = torch.ones((p, p), dtype=torch.bool)
    for lo, hi in zip(schema.offsets, schema.offsets[1:]):
        blk = slice(1 + d + lo, 1 + d + hi)
        m[blk, blk] = torch.eye(hi - lo, dtype=torch.bool)
    return m


def make_cols(schema, n, seed, misses=True):
    """Per-column inputs of `schema`: x N(0, 1); codes uniform, with codes
    outside [0, size) (which add nothing) when `misses`; binary weights."""
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32))
          for _ in range(schema.num_cols)]
    lo = -1 if misses else 0
    cs = [torch.tensor(rng.integers(lo, v + (1 if misses else 0), size=n)
                       .astype(np.int32)) for v in schema.cat_sizes]
    w = torch.tensor((rng.random(n) > 0.25).astype(np.float32))
    return xs, cs, w


def assert_window_close(got, want, schema, lo):
    """Counts exact (N, one-hot counts and cross counts), the rest within
    1e-5 of max|σ| of the window; compared 1,024 columns at a time."""
    got, want = np.asarray(got), np.asarray(want)
    d = schema.num_cols
    scale = np.abs(want).max()
    rows = np.arange(schema.sigma_size)
    for a in range(0, got.shape[1], 1024):
        g = got[:, a:a + 1024].astype(np.float64)
        h = want[:, a:a + 1024].astype(np.float64)
        cols = np.arange(lo + a, lo + a + g.shape[1])
        counts = (((rows[:, None] == 0) | (rows[:, None] > d))
                  & ((cols[None] == 0) | (cols[None] > d)))
        np.testing.assert_array_equal(g[counts], h[counts])
        assert np.abs(g - h).max() <= 1e-5 * scale


SMALL = {
    "mixed": (2, (7, 5, 3)),
    "codes only": (0, (40, 300)),
    "one column": (3, (13,)),
    "wide pair": (1, (1500, 700, 4)),
}


def windows(p):
    return sorted({(0, p), (0, 1), (2, min(9, p)), (5, p), (p - 1, p),
                   (3, 4), (min(30, p - 1), min(200, p)),
                   (max(p - 1100, 0), p)})


@pytest.mark.parametrize("name", SMALL)
def test_window_plan_covers_each_place_once(name):
    d, sizes = SMALL[name]
    schema = FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    p = schema.sigma_size
    nonzero = structure(schema)
    xs, cs, w = make_cols(schema, 2000, seed=len(name))
    x = torch.stack(xs) if xs else torch.zeros((0, 2000))
    full = masked_sigma(x, torch.stack(cs), w, schema=schema)
    for lo, hi in windows(p):
        plan = _build.window_plan(schema, lo, hi)
        e = plan.entries.long()
        assert plan.window == (lo, hi)
        assert bool(((e[:, 3] >= lo) & (e[:, 3] < hi)).all())
        hits = torch.bincount(e[:, 2] * (hi - lo) + e[:, 3] - lo,
                              minlength=p * (hi - lo)).reshape(p, hi - lo)
        assert int(hits.max()) == 1, (lo, hi)
        assert torch.equal(hits.bool(), nonzero[:, lo:hi]), (lo, hi)
        cells = wide_tables_plain(xs, cs, w, schema=schema, plan=plan)
        got = wide_assemble(cells, schema=schema, plan=plan)
        assert_window_close(got, full[:, lo:hi], schema, lo)
        assert_window_close(masked_gram_window_plain(
            xs, cs, w, schema=schema, lo=lo, width=hi - lo),
            full[:, lo:hi], schema, lo)


def test_window_plan_keys_a_cross_table_on_either_column():
    """A window inside column k's one-hot block keys C_jk on k's codes
    (slabs (C, k, j)); a window over both blocks takes the whole table
    once, keyed on the column of more levels."""
    schema = FeatureSchema(num_cols=1, cat_keys=(tuple(range(300)),
                                                 tuple(range(40))))
    base_k = 2 + 300
    inside_k = _build.window_plan(schema, base_k + 5, base_k + 25)
    c_slabs = inside_k.slabs[inside_k.slabs[:, 0] == _build.SLAB_C]
    assert c_slabs.shape[0] and bool((c_slabs[:, 1] == 1).all())
    assert bool((c_slabs[:, 3] >= 5).all() & (c_slabs[:, 4] <= 25).all())
    whole = _build.window_plan(schema, 0, schema.sigma_size)
    c_slabs = whole.slabs[whole.slabs[:, 0] == _build.SLAB_C]
    assert bool((c_slabs[:, 1] == 0).all())       # keyed on the 300 levels
    cells = int((c_slabs[:, 4] - c_slabs[:, 3]).sum()) * 40
    assert cells == 300 * 40                       # once


def test_whole_plan_below_1024_is_unchanged():
    """At P ≤ 1,024 K7 keeps its one plan (its map i ≤ j, both triangles
    written), not a window's."""
    schema = FeatureSchema(num_cols=3, cat_keys=tuple(
        tuple(range(v)) for v in (54, 33, 337, 2, 2, 22, 16, 5, 17)))
    plan = _build.wide_plan(schema)
    assert plan.window is None
    e = plan.entries
    assert bool((e[:, 2] <= e[:, 3]).all())


# ---------------------------------------------------------------------------
# Against the JAX package at tests/test_wide.py's widths
# ---------------------------------------------------------------------------

def wide_table(n, vocab, seed):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(2, n)).astype(np.float32)
    codes = rng.integers(0, vocab, size=(2, n)).astype(np.int32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    keys = (tuple(range(vocab)),) * 2
    return (num, codes, w, FeatureSchema(num_cols=2, cat_keys=keys),
            RefSchema(num_cols=2, cat_keys=keys))


@pytest.fixture(scope="module", params=[(4096, 2048, 0), (512, 8192, 3)],
            ids=["P4099", "P16387"])
def wide(request):
    """A wide table, the JAX package's XLA sigma of it, and the port's
    plain S assembled from its windows (masked_gram_cols_plain above
    1,024)."""
    num, codes, w, schema, rschema = wide_table(*request.param)
    ref = np.asarray(ref_masked_sigma(num, codes, w, schema=rschema))
    xs, cs = list(torch.tensor(num)), list(torch.tensor(codes))
    port = masked_gram_cols_plain(xs, cs, torch.tensor(w), schema=schema)
    return num, codes, w, schema, rschema, ref, port.numpy()


def test_plain_sigma_above_1024_matches_jax(wide):
    _, _, _, schema, _, ref, port = wide
    assert port.shape == ref.shape == (schema.sigma_size,) * 2
    assert_window_close(port, ref, schema, 0)


@pytest.mark.parametrize("at", ["first", "across", "last"])
def test_sigma_stripe_matches_jax(wide, at):
    """A stripe of 1,024 columns (the first; one across the two one-hot
    blocks; the last, narrower) against JAX's sigma_stripe and its
    masked_sigma."""
    num, codes, w, schema, rschema, ref, _ = wide
    p = schema.sigma_size
    lo = {"first": 0, "across": 3 + schema.cat_sizes[0] - 512,
          "last": p - 1024 + 9}[at]
    width = min(1024, p - lo)
    got = sigma_stripe(torch.tensor(num), torch.tensor(codes),
                       torch.tensor(w), schema=schema, lo=lo, width=width)
    want = np.asarray(ref_stripe(num, codes, w, schema=rschema, lo=lo,
                                 width=width, row_chunk=256))
    assert got.shape == (p, width)
    assert_window_close(got.numpy(), want, schema, lo)
    assert_window_close(got.numpy(), ref[:, lo:lo + width], schema, lo)
    xs, cs = list(torch.tensor(num)), list(torch.tensor(codes))
    assert torch.equal(got, masked_gram_window(
        xs, cs, torch.tensor(w), schema=schema, lo=lo, width=width))


def test_sigma_striped_covers_sigma(wide):
    num, codes, w, schema, _, _, port = wide
    stripes = list(sigma_striped(torch.tensor(num), torch.tensor(codes),
                                 torch.tensor(w), schema=schema,
                                 stripe=1024))
    assert [lo for lo, _ in stripes] == list(range(0, schema.sigma_size,
                                                   1024))
    assert np.array_equal(np.concatenate([s.numpy() for _, s in stripes],
                                         1), port)


# ---------------------------------------------------------------------------
# Limits
# ---------------------------------------------------------------------------

def test_k7_window_limit():
    """K7 takes P up to MAX_WINDOW_SIGMA_SIZE through its windows: a
    window of WINDOW_WIDTH columns maps at most P·WINDOW_WIDTH places, an
    int count, and every index of S is an int; criteo_c18 (P = 47,412,
    past the old P² < 2³¹ bound of 46,340) passes. P past it or a window
    outside [0, P) raise ValueError before a launch. A column of more
    levels than a task's cells beside another (9,000 beside 2), which it
    refused before cross tables were cut by row code too, is taken, its
    windows' plans mapping every place of S once."""
    limit = _build.MAX_WINDOW_SIGMA_SIZE
    assert limit * _build.WINDOW_WIDTH < 2 ** 31
    assert (limit + 1) * _build.WINDOW_WIDTH >= 2 ** 31
    assert _build.MAX_WINDOW_PLACES <= limit * _build.WINDOW_WIDTH
    at = FeatureSchema(num_cols=2, cat_keys=(tuple(range(8192)),) * 2)
    _build.check_schema(at, 1000, limit)
    _build.check_window(at, 0, at.sigma_size)
    with pytest.raises(ValueError):
        _build.check_window(at, at.sigma_size - 3, 4)
    wide_col = FeatureSchema(num_cols=0, cat_keys=(tuple(range(9000)),
                                                   (0, 1)))
    _build.check_window(wide_col, 0, 1024)
    assert_kernel_windows_cover_once(wide_col)
    c18 = FeatureSchema(num_cols=13, cat_keys=tuple(
        tuple(range(v)) for v in CRITEO_C18))
    assert c18.sigma_size == 47412 > 46340
    _build.check_schema(c18, 1000, limit)
    _build.check_window(c18, c18.sigma_size - 308, 308)
    meta = [torch.empty(10, dtype=torch.int32, device="meta")] * 18
    xm = [torch.empty(10, device="meta")] * 13
    with pytest.raises(ValueError, match="CUDA device"):
        masked_gram_cols(xm, meta, None, schema=c18)
    with pytest.raises(ValueError, match="CUDA device"):
        masked_gram_window(xm, meta, None, schema=c18, lo=46080, width=1024)
    big = tuple(range(1 << 20))
    past = FeatureSchema(num_cols=3, cat_keys=(big, big))
    assert past.sigma_size == limit + 5
    with pytest.raises(ValueError, match="sigma size"):
        _build.check_schema(past, 1000, limit)
    with pytest.raises(ValueError, match="sigma size"):
        masked_gram_cols(xm[:3], meta[:2], None, schema=past)
    with pytest.raises(ValueError, match="sigma size"):
        masked_gram_window(xm[:3], meta[:2], None, schema=past, lo=0,
                           width=8)
    with pytest.raises(ValueError):       # a window outside [0, P)
        masked_gram_window([], [meta[0], meta[1]], None, schema=wide_col,
                           lo=wide_col.sigma_size - 4, width=8)


ABOVE = FeatureSchema(num_cols=4, cat_keys=(tuple(range(1020)),))
# one column of every level but 4 of P (the column the fused pass imputes)
C18_LIKE = FeatureSchema(num_cols=4, cat_keys=(tuple(range(47412 - 5)),))
SCORER_PAST = FeatureSchema(num_cols=4, cat_keys=(tuple(range(
    _build.MAX_SCORER_SIGMA_SIZE)),))
_BIG = tuple(range(1 << 20))
PAST = FeatureSchema(num_cols=4, cat_keys=(_BIG, _BIG[:-4]))


def _wrapper_calls(schema, n=10):
    """Each wrapper of K2w, K8 (sorted and unsorted entry) and K3/K3w on
    'meta' tensors of `schema` (its first categorical column imputed by
    K2w; K3/K3w with ABOVE's scorer plan, which it reads only after the
    schema's check)."""
    v = schema.cat_sizes[0]
    c = schema.cat_cols
    xs = [torch.empty(n, device="meta") for _ in range(4)]
    cs = [torch.empty(n, dtype=torch.int32, device="meta")] * c
    x = torch.empty((4, n), device="meta")
    cc = torch.empty((c, n), dtype=torch.int32, device="meta")
    g = torch.empty(n, dtype=torch.int32, device="meta")
    layout = GroupLayout(torch.empty(3, dtype=torch.int64, device="meta"), 2)
    plan = _build.qda_plan(ABOVE)
    return [
        lambda: fused_impute_aggregate(
            xs, cs, torch.empty(n, dtype=torch.bool, device="meta"),
            torch.empty(n, device="meta"),
            torch.empty((schema.sigma_size, v), device="meta"),
            torch.empty(v, device="meta"), schema=schema, kind="cat",
            imp_col=0),
        lambda: grouped_gram(x, cc, None, g, schema=schema, num_groups=2),
        lambda: grouped_gram_presorted(x, cc, torch.empty(n, device="meta"),
                                       layout, schema=schema),
        lambda: qda_predict_kernel(torch.empty((2, 8), device="meta"), plan,
                                   x, cc, schema=schema)]


def test_k2w_k8_k3_still_raise_past_1024():
    """The fused pass (K2w), the grouped Grams (K4/K5/K8) and the scorer
    (K3/K3w) run past MAX_WIDE_SIGMA_SIZE over K7's window plans: at P =
    1,025 each wrapper's schema checks pass, and 'meta' tensors are refused
    only as lying on no CUDA device. Past 46,340 (P = 47,412, criteo_c18's
    P) K2w and K8 still reach the device check, while K3/K3w raise
    ValueError on the sigma size (MAX_SCORER_SIGMA_SIZE: a class's whole
    P² form); past K7's window limit all of them raise it before any
    launch, with no fallback."""
    assert ABOVE.sigma_size == _build.MAX_WIDE_SIGMA_SIZE + 1
    assert C18_LIKE.sigma_size == 47412
    assert SCORER_PAST.sigma_size > _build.MAX_SCORER_SIGMA_SIZE
    assert PAST.sigma_size > _build.MAX_WINDOW_SIGMA_SIZE
    for call in _wrapper_calls(ABOVE):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    *k2w_k8, k3 = _wrapper_calls(C18_LIKE)
    for call in k2w_k8:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    for call in (k3, _wrapper_calls(SCORER_PAST)[-1]):
        with pytest.raises(ValueError, match="sigma size"):
            call()
    for call in _wrapper_calls(PAST):
        with pytest.raises(ValueError, match="sigma size"):
            call()
    with pytest.raises(ValueError):
        _build.check_schema(ABOVE, 10, _build.MAX_WIDE_SIGMA_SIZE)
    _build.check_qda(ABOVE, 2, 10)
    _build.check_qda(FeatureSchema(num_cols=3, cat_keys=(tuple(range(
        _build.MAX_SCORER_SIGMA_SIZE - 4)),)), 2, 10)
    for past in (C18_LIKE, SCORER_PAST, PAST):
        with pytest.raises(ValueError, match="sigma size"):
            _build.check_qda(past, 2, 10)
