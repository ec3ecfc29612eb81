"""The port's host MICE drivers (mice/{baseline, low, high}.py), the table
helpers (table/table.py: write-backs, null counts, pandas in and out) and
PhaseTimer against the JAX package's on the same numpy inputs.

With noise off, each driver's imputed table is the JAX driver's: values
within 1e-4 (both aggregate in f32 and train in f64; the sums round in
another order), codes equal. The delta algebra's invariant, that low's
and high's train triples are baseline's, holds as in tests/test_mice.py.
Noise is drawn per (round, column) from its own keyed generator (JAX's
threefry stream cannot be reproduced): the tests check its keying and
scale, and tests/test_torch_models.py its moments.
"""
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import load_iris

from duckdb_imputation_tpu.mice import (run_mice_baseline as ref_baseline,
                                        run_mice_high as ref_high,
                                        run_mice_low as ref_low)
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy
from duckdb_imputation_tpu.table import from_pandas as ref_from_pandas

from duckdb_imputation_tpu_torch import (from_numpy, from_pandas,
                                         run_mice_baseline, run_mice_high,
                                         run_mice_low)
from duckdb_imputation_tpu_torch.mice import (build_partitions, init_fill,
                                              observed_weights)
from duckdb_imputation_tpu_torch.mice.baseline import noise_generator
from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
from duckdb_imputation_tpu_torch.ring.triple import triple_add, triple_sub
from duckdb_imputation_tpu_torch.utils import PhaseTimer

torch.set_num_threads(2)

MICE_KW = dict(iters=2, linreg_iters=300, noise=False)
DRIVERS = {"baseline": (run_mice_baseline, ref_baseline),
           "low": (run_mice_low, ref_low),
           "high": (run_mice_high, ref_high)}


@pytest.fixture(scope="module")
def iris_mcar():
    """iris with 20% MCAR nulls in s_length (num 0), p_width (num 3) and
    target (cat 0): tests/test_mice.py's fixture."""
    x, y = load_iris(return_X_y=True)
    rng = np.random.default_rng(42)
    n = len(x)
    num = x.astype(np.float32).copy()
    cat = y[:, None].astype(np.int64).copy()
    num_null = np.zeros_like(num, bool)
    cat_null = np.zeros_like(cat, bool)
    for j in (0, 3):
        num_null[rng.choice(n, n // 5, replace=False), j] = True
    cat_null[rng.choice(n, n // 5, replace=False), 0] = True
    return num, cat, num_null, cat_null


def _port(iris_mcar):
    return from_numpy(*iris_mcar, device="cpu")


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_matches_reference(iris_mcar, driver):
    port_fn, ref_fn = DRIVERS[driver]
    want = ref_fn(ref_from_numpy(*iris_mcar), **MICE_KW)
    got = port_fn(_port(iris_mcar), **MICE_KW)
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(want.cat_codes))
    np.testing.assert_allclose(got.num_data.numpy(),
                               np.asarray(want.num_data), rtol=0, atol=1e-4)
    num, _, num_null, _ = iris_mcar
    np.testing.assert_array_equal(got.num_data.numpy()[~num_null.T],
                                  num.T[~num_null.T])


def test_baseline_improves_over_mean_fill(iris_mcar):
    """tests/test_mice.py's quality bound, on the port."""
    num, cat, num_null, cat_null = iris_mcar
    t = _port(iris_mcar)
    filled = init_fill(t)
    out = run_mice_baseline(t, **MICE_KW)
    for j in (0, 3):
        mask = num_null[:, j]
        mean_rmse = np.sqrt(np.mean(
            (filled.num_data[j].numpy()[mask] - num[mask, j]) ** 2))
        mice_rmse = np.sqrt(np.mean(
            (out.num_data[j].numpy()[mask] - num[mask, j]) ** 2))
        assert mice_rmse < mean_rmse * 0.8, (j, mice_rmse, mean_rmse)
    mask = cat_null[:, 0]
    assert (out.cat_values()[0, mask] == cat[mask, 0]).mean() > 0.8


def test_low_and_high_match_baseline_imputation(iris_mcar):
    """tests/test_mice.py's bounds for low against baseline, and high."""
    base = run_mice_baseline(_port(iris_mcar), **MICE_KW)
    for fn in (run_mice_low, run_mice_high):
        out = fn(_port(iris_mcar), **MICE_KW)
        np.testing.assert_allclose(out.num_data.numpy(),
                                   base.num_data.numpy(), rtol=1e-3,
                                   atol=1e-2)
        agree = (out.cat_codes.numpy() == base.cat_codes.numpy()).mean()
        assert agree > 0.99, agree


def test_low_and_high_train_triples_match_baseline(iris_mcar):
    """low: full − delta(null rows); high: static + delta(dirty but
    observed): both are baseline's scan over observed(col)."""
    t = init_fill(_port(iris_mcar))
    parts = build_partitions(t)
    schema = t.schema
    full = sum_to_triple(t.num_data, t.cat_codes, None, schema=schema)
    c = parts.complete_idx
    static = sum_to_triple(t.num_data[:, c], t.cat_codes[:, c], None,
                           schema=schema)
    for kind, col, dirty, mask in (
            ("num", 0, parts.num_dirty_idx[0], t.num_null[0]),
            ("cat", 0, parts.cat_dirty_idx[0], t.cat_null[0])):
        w = observed_weights(t, kind, col)
        baseline = sum_to_triple(t.num_data, t.cat_codes, w, schema=schema)
        low = triple_sub(full, sum_to_triple(
            t.num_data[:, dirty], t.cat_codes[:, dirty], None, schema=schema))
        obs_dirty = torch.nonzero((parts.null_counts > 0) & ~mask).flatten()
        high = triple_add(static, sum_to_triple(
            t.num_data[:, obs_dirty], t.cat_codes[:, obs_dirty], None,
            schema=schema))
        for cand in (low, high):
            np.testing.assert_allclose(cand.quad.numpy(),
                                       baseline.quad.numpy(), rtol=1e-5,
                                       atol=1e-2)
            np.testing.assert_allclose(cand.lin_cat.numpy(),
                                       baseline.lin_cat.numpy(), rtol=0,
                                       atol=1e-3)
            assert float(cand.n) == float(baseline.n)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_aggregates_through_the_given_function(iris_mcar, driver):
    """Every aggregate goes through `aggregate`: baseline 2 a column step;
    low one full scan, then 2 a column step; high one static scan, then 1
    a column step."""
    calls = []

    def aggregate(*args, **kw):
        calls.append(args[0].shape[-1])
        return sum_to_triple(*args, **kw)
    DRIVERS[driver][0](_port(iris_mcar), aggregate=aggregate, **MICE_KW)
    steps = 3 * MICE_KW["iters"]
    want = {"baseline": steps, "low": 1 + 2 * steps, "high": 1 + steps}
    assert len(calls) == want[driver]


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_driver_noise_is_keyed_by_round_and_column(iris_mcar, driver):
    """noise=True: same seed, same table; another seed, another. The noise
    of round 1, column 0 is std · N(0, 1) from noise_generator(seed, 1, 0)
    whatever ran before it: a run of round 1 alone (start_iter=1) differs
    from its noise-free twin by a constant times exactly those draws."""
    fn = DRIVERS[driver][0]
    kw = dict(iters=2, linreg_iters=300, noise=True)
    a = fn(_port(iris_mcar), seed=3, **kw)
    b = fn(_port(iris_mcar), seed=3, **kw)
    c = fn(_port(iris_mcar), seed=4, **kw)
    assert torch.equal(a.num_data, b.num_data)
    assert not torch.equal(a.num_data, c.num_data)

    noisy = fn(_port(iris_mcar), seed=3, start_iter=1, **kw)
    clean = fn(_port(iris_mcar), start_iter=1,
               **dict(kw, noise=False))
    m = torch.tensor(iris_mcar[2][:, 0])
    rows = len(m) if driver == "baseline" else int(m.sum())
    z = torch.randn(rows, generator=noise_generator(3, 1, 0, "cpu"))
    if driver == "baseline":
        z = z[m]
    d = (noisy.num_data[0] - clean.num_data[0])[m]
    std = float((d / z).median())
    assert 0.05 < std < 1.0
    np.testing.assert_allclose(d.numpy(), (std * z).numpy(), rtol=0,
                               atol=1e-5)


def test_noise_streams_differ_where_the_reference_keys_collide():
    """The JAX low driver folds round·1009 + column into one key, so
    (round 1, column 0) and (round 0, column 1009) share a stream there.
    Here each (seed, round, column) has its own."""
    def draw(seed, it, col):
        return torch.randn(64, generator=noise_generator(seed, it, col,
                                                         "cpu"))
    assert 1 * 1009 + 0 == 0 * 1009 + 1009
    assert not torch.equal(draw(0, 1, 0), draw(0, 0, 1009))
    assert not torch.equal(draw(0, 2, 5), draw(0, 1, 1014))
    assert torch.equal(draw(7, 3, 2), draw(7, 3, 2))
    pairs = {(it, col) for it in range(4) for col in range(4)}
    streams = {tuple(draw(0, it, col)[:4].tolist()) for it, col in pairs}
    assert len(streams) == len(pairs)


def test_phase_timer_records_the_driver_phases(iris_mcar):
    timer = PhaseTimer()
    run_mice_low(_port(iris_mcar), timer=timer, **MICE_KW)
    steps = 3 * MICE_KW["iters"]
    assert timer.counts == {"prepare": 1, "cofactor_full": 1,
                            "cofactor_delta": steps, "train": steps,
                            "impute": steps, "cofactor_readd": steps}
    assert all(v >= 0 for v in timer.summary().values())
    assert "train" in timer.report() and "cofactor_full" in timer.to_json()
    synced = []
    timer = PhaseTimer(sync=lambda: synced.append(1))
    with timer.phase("x"):
        pass
    assert len(synced) == 2 and timer.counts["x"] == 1


# ---------------------------------------------------------------------------
# the table helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("only_null", [True, False])
def test_write_backs_match_reference(iris_mcar, only_null):
    t = _port(iris_mcar)
    r = ref_from_numpy(*iris_mcar)
    vals = np.linspace(-1, 1, 150).astype(np.float32)
    codes = (np.arange(150) % 3).astype(np.int32)
    got = t.with_num_col(3, torch.tensor(vals), only_null=only_null)
    got = got.with_cat_col(0, torch.tensor(codes), only_null=only_null)
    want = r.with_num_col(3, vals, only_null=only_null)
    want = want.with_cat_col(0, codes, only_null=only_null)
    np.testing.assert_array_equal(got.num_data.numpy(),
                                  np.asarray(want.num_data))
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(want.cat_codes))
    # the caller's tensors stay as they were
    assert torch.equal(t.num_data, _port(iris_mcar).num_data)
    assert torch.equal(t.cat_codes, _port(iris_mcar).cat_codes)
    np.testing.assert_array_equal(t.null_count_per_row().numpy(),
                                  np.asarray(r.null_count_per_row()))
    assert t.null_count_per_row().dtype == torch.int32


@pytest.fixture(scope="module")
def frame():
    """A frame with every dispatch case: floats with NaN, integer
    categories, nullable Int64 with NA, strings with None, booleans."""
    rng = np.random.default_rng(9)
    n = 40
    x = rng.normal(size=n)
    x[[3, 7]] = np.nan
    ints = pd.array(rng.integers(10, 14, n), dtype="Int64")
    ints[[1, 5]] = pd.NA
    strs = np.array(["red", "green", "blue"], object)[rng.integers(0, 3, n)]
    strs[[2, 8, 9]] = None
    return pd.DataFrame({"x": x, "y": rng.normal(size=n).astype(np.float32),
                         "k": rng.integers(0, 4, n), "m": ints,
                         "s": strs, "b": rng.random(n) < 0.5})


def test_from_pandas_matches_reference(frame):
    want = ref_from_pandas(frame)
    got = from_pandas(frame, device="cpu")
    assert got.num_names == want.num_names
    assert got.cat_names == want.cat_names
    assert got.cat_labels == want.cat_labels
    assert got.schema.cat_keys == want.schema.cat_keys
    for a, b in zip(got.to_numpy(), (want.num_data, want.cat_codes,
                                     want.num_null, want.cat_null)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("nulls_as_na", [False, True])
def test_to_pandas_round_trip_with_string_categories(frame, nulls_as_na):
    got = from_pandas(frame, device="cpu").to_pandas(nulls_as_na=nulls_as_na)
    want = ref_from_pandas(frame).to_pandas(nulls_as_na=nulls_as_na)
    pd.testing.assert_frame_equal(got, want)
    if nulls_as_na:    # the frame back, its floats through f32
        assert got["s"].tolist() == frame["s"].tolist()
        np.testing.assert_array_equal(
            got["x"].to_numpy(), frame["x"].to_numpy(np.float32))
        assert got["m"].isna().tolist() == frame["m"].isna().tolist()
        assert got["k"].tolist() == frame["k"].tolist()
