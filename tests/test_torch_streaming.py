"""The port's out-of-core path (`ring.streaming`, `mice.streaming`,
`utils.checkpoint.StreamCheckpointer`) against the JAX package's on the
CPU, on the same numpy inputs.

The fold is the port's own (K1/K7 over the extended schema, chunks summed
in f64); on the CPU it runs the plain Gram, and its K7 plan over the
extended schema is held here through the plan's plain arithmetic
(`wide_tables_plain` + `wide_assemble`). Tolerances: the Gram within 1e-6
of max|G| and its counts exact; the rounds at the bounds of the port's
in-core tests (tests/test_torch_host_mice.py's low-vs-baseline bounds for
the host engine, tests/test_torch_delta.py's for the device engine) and
tests/test_streaming.py's own for the spill path.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.mice.streaming import (
    impute_csv_stream as ref_impute_csv,
    run_mice_stream as ref_run_stream,
)
from duckdb_imputation_tpu.ring import streaming as ref
from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice import init_fill, run_mice_low
from duckdb_imputation_tpu_torch.mice.streaming import (
    impute_csv_stream,
    run_mice_stream,
)
from duckdb_imputation_tpu_torch.ring import streaming
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    wide_assemble,
    wide_tables_plain,
)
from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple
from duckdb_imputation_tpu_torch.table.native import read_csv

import torch_stream_worker as worker
from test_torch_wide_levels import assert_kernel_windows_cover_once
from torch_stream_worker import stream_fixture

torch.set_num_threads(2)

FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")
WORLDS = (1, 2)
DEADLINE_S = 150
WORKER = os.path.join(os.path.dirname(__file__), "torch_stream_worker.py")


def dense_gram(num_in, cat_in, ss) -> np.ndarray:
    """Aᵀ·diag(w)·A in f64 with w = 1, A = [1 | x₀ | onehot(c₀) | M] in
    the JAX package's layout (null cells zero, null codes out of
    vocabulary, M the nullable columns' flags)."""
    num_null, cat_null = np.isnan(num_in), cat_in < 0
    cols = [np.ones(num_in.shape[1])]
    cols += list(np.where(num_null, 0.0, num_in).astype(np.float64))
    for j, keys in enumerate(ss.schema.cat_keys):
        cols += [((cat_in[j] == v) & ~cat_null[j]).astype(float)
                 for v in keys]
    cols += [num_null[j].astype(float) for j in ss.nullable_num]
    cols += [cat_null[j].astype(float) for j in ss.nullable_cat]
    a = np.stack(cols, 1)
    return a.T @ a


def count_mask(ss) -> np.ndarray:
    """True at the entries of the extended Gram that are counts: both
    indices among the constant, the one-hots and the flags."""
    d, p = ss.schema.num_cols, ss.schema.sigma_size + ss.k
    idx = [0] + list(range(1 + d, p))
    m = np.zeros((p, p), bool)
    m[np.ix_(idx, idx)] = True
    return m


def assert_gram(got, want, ss, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cm = count_mask(ss)
    np.testing.assert_array_equal(got[cm], want[cm])
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.fixture(scope="module")
def data():
    return stream_fixture(seed=3)


# ---------------------------------------------------------------------------
# Pass 0 and the fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [700, 4000])
def test_scan_schema_matches_reference(data, chunk):
    num_in, cat_in, _, _, num_null, cat_null = data
    ss, cache = streaming.scan_schema(
        streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=chunk))
    rss, rcache = ref.scan_schema(
        ref.chunks_from_arrays(num_in, cat_in, chunk_rows=chunk))
    assert ss.schema.num_cols == rss.schema.num_cols
    assert ss.schema.cat_keys == tuple(rss.schema.cat_keys)
    assert (ss.nullable_num, ss.nullable_cat, ss.n_rows) == (
        rss.nullable_num, rss.nullable_cat, rss.n_rows)
    for name in ("idx", "num", "cat", "num_null", "cat_null"):
        np.testing.assert_array_equal(getattr(cache, name),
                                      getattr(rcache, name))
    dirty = num_null.any(0) | cat_null.any(0)
    np.testing.assert_array_equal(cache.idx, np.nonzero(dirty)[0])


@pytest.mark.parametrize("chunk_rows", [512, 1 << 20])
def test_scan_gram_matches_reference_and_dense(data, chunk_rows):
    num_in, cat_in = data[:2]
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=700)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    g = streaming.scan_gram(src, ss, chunk_rows=chunk_rows, device="cpu")
    assert g.dtype == torch.float64
    rsrc = ref.chunks_from_arrays(num_in, cat_in, chunk_rows=700)
    rss, _ = ref.scan_schema(rsrc, collect_dirty=False)
    want = ref.scan_gram(rsrc, rss, chunk_rows=512)
    assert_gram(g.numpy(), want, ss)
    assert_gram(g.numpy(), dense_gram(num_in, cat_in, ss), ss)


def test_extended_schema_is_the_fold_layout(data):
    """extended_schema's Z of an encoded chunk is [Z₀ | M] exactly."""
    num_in, cat_in = data[:2]
    ss, _ = streaming.scan_schema(
        streaming.chunks_from_arrays(num_in, cat_in), collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert ext.sigma_size == ss.schema.sigma_size + ss.k
    assert ext.cat_keys[ss.schema.cat_cols:] == ((0,),) * ss.k
    x, codes = streaming.encode_chunk(
        *streaming._normalize_chunk((num_in, cat_in)), ss)
    got = sum_to_triple(torch.from_numpy(x), torch.from_numpy(codes), None,
                        schema=ext)
    assert_gram(sigma_from_triple(got).double().numpy(),
                dense_gram(num_in, cat_in, ss), ss)


def _wide_case(name, n, rng):
    """'p88': d = 3, columns of 54 and 30 levels (P = 88), nulls in one
    numeric and one categorical column (K = 2); 'p61': 20 numeric and 10
    categorical columns of 4 levels (P = 61), nulls in all 30 (K = 30,
    c + K = 40). Both extended schemas pass 88."""
    if name == "p88":
        num = rng.normal(size=(3, n)).astype(np.float32)
        cat = np.stack([rng.integers(0, 54, n), rng.integers(0, 30, n) * 3])
        num[1, rng.random(n) < 0.1] = np.nan
        cat[0, rng.random(n) < 0.1] = -1
        return num, cat, (88, 90)
    num = rng.normal(size=(20, n)).astype(np.float32)
    cat = rng.integers(0, 4, size=(10, n)) * 2 + 1
    num[rng.random(num.shape) < 0.05] = np.nan
    cat[rng.random(cat.shape) < 0.05] = -1
    return num, cat, (61, 91)


@pytest.mark.parametrize("case", ["p88", "p61"])
def test_fold_past_88_uses_the_wide_plan(case):
    """Extended schemas past P + K = 88, which K7's plan folds on the card:
    P = 88 with K = 2, and P = 61 with 30 nullable columns. The plan's
    plain arithmetic, chunk by chunk, equals scan_gram's plain fold and
    the JAX package's."""
    rng = np.random.default_rng(4)
    n = 3000
    num, cat, sizes = _wide_case(case, n, rng)
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=1000)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert (ss.schema.sigma_size, ext.sigma_size) == sizes
    got = streaming.scan_gram(src, ss, chunk_rows=700, device="cpu")
    plan = torch.zeros_like(got)
    for lo in range(0, n, 700):
        parts = streaming._normalize_chunk(
            (num[:, lo:lo + 700], cat[:, lo:lo + 700]))
        x, codes = streaming.encode_chunk(*parts, ss)
        cells = wide_tables_plain(list(torch.from_numpy(x)),
                                  list(torch.from_numpy(codes)), None,
                                  schema=ext)
        plan += wide_assemble(cells, schema=ext).double()
    assert_gram(plan.numpy(), got.numpy(), ss)
    rsrc = ref.chunks_from_arrays(num, cat, chunk_rows=1000)
    rss, _ = ref.scan_schema(rsrc, collect_dirty=False)
    assert_gram(got.numpy(), ref.scan_gram(rsrc, rss, chunk_rows=700), ss)


def test_fold_past_64_categorical_columns_matches_jax():
    """60 categorical columns and 5 nullable ones (c + K = 65, past the 64
    the kernels once took): check_fold takes the extended schema, and the
    CPU fold equals the JAX package's."""
    rng = np.random.default_rng(7)
    n = 2000
    num = rng.normal(size=(2, n)).astype(np.float32)
    cat = rng.integers(0, 2, size=(60, n)).astype(np.int64)
    for j in range(5):
        cat[j, rng.random(n) < 0.1] = -1          # nulls: K = 5 flags
    num_null = np.zeros_like(num, bool)
    cat_null = cat < 0
    src = streaming.chunks_from_arrays(num, cat, num_null, cat_null,
                                       chunk_rows=700)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert ext.cat_cols == 65
    streaming.check_fold(ss, n)
    got = streaming.scan_gram(src, ss, chunk_rows=700, device="cpu")
    rsrc = ref.chunks_from_arrays(num, cat, num_null, cat_null,
                                  chunk_rows=700)
    rss, _ = ref.scan_schema(rsrc, collect_dirty=False)
    assert_gram(got.numpy(), ref.scan_gram(rsrc, rss, chunk_rows=700), ss)


@pytest.mark.parametrize("cats,nullable", [(2, 0), (3, 0)])
def test_fold_limits_raise_before_the_stream(cats, nullable):
    """P + K past K7's window limit (two columns of 2²⁰ levels, P =
    2,097,154): a CUDA fold raises ValueError before it reads a chunk;
    two columns of 23,200 levels (P = 46,402, past the old limit of
    46,340) pass the fold's checks. A column of more levels than a K7
    task's cells beside others (9,000 beside two of 2), which it refused
    before cross tables were cut by row code too, is taken: the fold's
    checks pass and the plans K7 folds it in map every place of its
    extended Gram once."""
    keys = {2: (tuple(range(1 << 20)),) * 2,
            3: (tuple(range(9000)), (0, 1), (0, 1))}[cats]
    ss = streaming.StreamSchema(
        schema=FeatureSchema(num_cols=1, cat_keys=keys),
        nullable_num=(), nullable_cat=tuple(range(nullable)), n_rows=1)

    def source():
        raise AssertionError("the stream was read")
        yield
    if cats == 2:
        assert (streaming.extended_schema(ss).sigma_size
                > _build.MAX_WINDOW_SIGMA_SIZE)
        with pytest.raises(ValueError, match="sigma size"):
            streaming.scan_gram(source, ss, device="cuda")
        streaming.check_fold(streaming.StreamSchema(
            schema=FeatureSchema(num_cols=1,
                                 cat_keys=(tuple(range(23_200)),) * 2),
            nullable_num=(), nullable_cat=(), n_rows=1), 1000)
        return
    streaming.check_fold(ss, 1000)
    assert_kernel_windows_cover_once(streaming.extended_schema(ss))


def test_fold_past_1024_takes_k7_windows():
    """P + K past 1,024 (d = 2, columns of up to 700 and 400 levels, nulls
    in a numeric and a categorical column, K = 2), which K7 folds a
    column window at a time on the card: the windows' plans, summed in
    plain torch chunk by chunk, equal scan_gram's plain fold and the JAX
    package's XLA fold; a CUDA fold's checks pass. (P counts the observed
    levels: 1,094 here.)"""
    rng = np.random.default_rng(6)
    n = 3000
    num = rng.normal(size=(2, n)).astype(np.float32)
    cat = np.stack([rng.integers(0, 700, n), rng.integers(0, 400, n) * 2])
    num[1, rng.random(n) < 0.1] = np.nan
    cat[1, rng.random(n) < 0.1] = -1
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=1000)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert ext.sigma_size == ss.schema.sigma_size + 2 > 1024
    streaming.check_fold(ss, 700)
    got = streaming.scan_gram(src, ss, chunk_rows=700, device="cpu")
    p = ext.sigma_size
    plan = torch.zeros_like(got)
    for lo in range(0, n, 700):
        parts = streaming._normalize_chunk(
            (num[:, lo:lo + 700], cat[:, lo:lo + 700]))
        x, codes = streaming.encode_chunk(*parts, ss)
        xs, cs = list(torch.from_numpy(x)), list(torch.from_numpy(codes))
        for a in range(0, p, 1024):
            win = _build.window_plan(ext, a, min(a + 1024, p))
            cells = wide_tables_plain(xs, cs, None, schema=ext, plan=win)
            plan[:, a:a + 1024] += wide_assemble(cells, schema=ext,
                                                 plan=win).double()
    assert_gram(plan.numpy(), got.numpy(), ss)
    rsrc = ref.chunks_from_arrays(num, cat, chunk_rows=1000)
    rss, _ = ref.scan_schema(rsrc, collect_dirty=False)
    assert_gram(got.numpy(), ref.scan_gram(rsrc, rss, chunk_rows=700), ss)


def test_assemble_filled_triple_matches_reference_and_init_fill(data):
    num_in, cat_in = data[:2]
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=700)
    full, fills, ss, _ = streaming.aggregate_stream(src, chunk_rows=512,
                                                    device="cpu")
    rfull, rfills, _, _ = ref.aggregate_stream(
        ref.chunks_from_arrays(num_in, cat_in, chunk_rows=700),
        chunk_rows=512)
    for name in FIELDS:
        a = getattr(full, name).double().numpy()
        b = np.asarray(getattr(rfull, name), np.float64)
        assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0), name
    np.testing.assert_allclose(fills.num_means, rfills.num_means, rtol=1e-6)
    assert fills.cat_modes == rfills.cat_modes
    assert fills.num_null_counts == rfills.num_null_counts
    assert fills.cat_null_counts == rfills.cat_null_counts
    # the filled triple is init_fill + sum_to_triple of the in-core table
    t = init_fill(from_numpy(num_in, cat_in, rows_first=False, device="cpu"))
    want = sum_to_triple(t.num_data, t.cat_codes, None, schema=t.schema)
    for name in FIELDS:
        a = getattr(full, name).double().numpy()
        b = getattr(want, name).double().numpy()
        if name in ("n", "lin_cat", "cat_cat"):
            np.testing.assert_array_equal(a, b)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), name
    for j, mean in enumerate(fills.num_means):
        assert abs(mean - float(t.num_data[j].double().mean())) <= (
            1e-6 * max(abs(mean), 1e-3) + 1e-6)


# ---------------------------------------------------------------------------
# The rounds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rounds(data):
    """Port and JAX runs, 3 rounds, noise off, on the same stream."""
    num_in, cat_in = data[:2]
    kw = dict(iters=3, noise=False, chunk_rows=512)
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=640)
    rsrc = ref.chunks_from_arrays(num_in, cat_in, chunk_rows=640)
    return {
        "host": run_mice_stream(src, device="cpu", **kw),
        "device": run_mice_stream(src, device="cpu", engine="device", **kw),
        "ref_host": ref_run_stream(rsrc, **kw),
        "ref_device": ref_run_stream(rsrc, engine="device", **kw),
        "low": run_mice_low(from_numpy(num_in, cat_in, rows_first=False,
                                       device="cpu"), iters=3, noise=False),
    }


def _imputed(res):
    """(x f32[d, nd], codes i32[c, nd]) of a stream result's dirty rows."""
    t = res.dirty
    x = (t.num_data.numpy() if isinstance(t.num_data, torch.Tensor)
         else np.asarray(t.num_data))
    c = (t.cat_codes.numpy() if isinstance(t.cat_codes, torch.Tensor)
         else np.asarray(t.cat_codes))
    return x, c


def test_host_engine_matches_reference_and_low(data, rounds):
    """engine='host' against the JAX host engine and against the port's
    in-core run_mice_low on the dirty rows: x within rtol 1e-3, atol 1e-2,
    codes agree on > 0.99 (the port's low-vs-baseline bounds)."""
    _, _, _, _, num_null, cat_null = data
    res = rounds["host"]
    np.testing.assert_array_equal(res.idx, rounds["ref_host"].idx)
    x, c = _imputed(res)
    rx, rc = _imputed(rounds["ref_host"])
    lx = rounds["low"].num_data.numpy()[:, res.idx]
    lc = rounds["low"].cat_codes.numpy()[:, res.idx]
    for want_x, want_c in ((rx, rc), (lx, lc)):
        np.testing.assert_allclose(x, want_x, rtol=1e-3, atol=1e-2)
        assert (c == want_c).mean() > 0.99
    obs = ~num_null[:, res.idx]
    np.testing.assert_array_equal(x[obs], data[2][:, res.idx][obs])


def test_device_engine_matches_reference(data, rounds):
    """engine='device' against the JAX device engine: codes agree on
    ≥ 0.99 of the cells, x within 1e-3 of max|x| (tests/test_torch_delta.py
    bounds); observed cells unchanged."""
    _, _, num, _, num_null, _ = data
    res = rounds["device"]
    x, c = _imputed(res)
    rx, rc = _imputed(rounds["ref_device"])
    assert (c == rc).mean() >= 0.99
    np.testing.assert_allclose(x, rx, rtol=0, atol=1e-3 * np.abs(rx).max())
    obs = ~num_null[:, res.idx]
    np.testing.assert_array_equal(x[obs], num[:, res.idx][obs])


def test_filled_triple_is_the_folds(data, rounds):
    """StreamImputation.filled, of either engine, is aggregate_stream's
    filled triple."""
    num_in, cat_in = data[:2]
    full, _, _, _ = streaming.aggregate_stream(
        streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=640),
        chunk_rows=512, device="cpu")
    for engine in ("host", "device"):
        assert torch.equal(sigma_from_triple(rounds[engine].filled),
                           sigma_from_triple(full))


def test_impute_chunks_matches_reference(data, rounds):
    num_in, cat_in, num, cat, num_null, cat_null = data
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=550)
    out = list(rounds["host"].impute_chunks(src))
    rout = list(rounds["ref_host"].impute_chunks(
        ref.chunks_from_arrays(num_in, cat_in, chunk_rows=550)))
    got_x = np.concatenate([a for a, _ in out], axis=1)
    got_c = np.concatenate([b for _, b in out], axis=1)
    want_x = np.concatenate([a for a, _ in rout], axis=1)
    want_c = np.concatenate([b for _, b in rout], axis=1)
    assert got_x.shape == num.shape and not np.isnan(got_x).any()
    np.testing.assert_array_equal(got_x[~num_null], num[~num_null])
    np.testing.assert_array_equal(got_c[~cat_null], cat[~cat_null])
    np.testing.assert_allclose(got_x, want_x, rtol=1e-3, atol=1e-2)
    assert (got_c == want_c).mean() > 0.99


def test_spill_matches_in_core_at_high_missing():
    """tests/test_streaming.py:109-145 on the port: 50% nulls, a dirty
    budget far below the dirty count; the cache spills to memmaps, the
    windowed rounds match the in-core cache's (x within 5e-3·(max|x|+1),
    codes agree > 0.98) and the write pass reads the spill."""
    num_in, cat_in, num, cat, num_null, cat_null = stream_fixture(
        seed=9, n=3000, miss=0.5)
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=640)
    kw = dict(iters=2, noise=False, chunk_rows=512, device="cpu")
    budget = 256
    with pytest.warns(UserWarning, match="spilled"):
        sp = run_mice_stream(src, dirty_budget_rows=budget, engine="device",
                             **kw)
    try:
        assert sp.spill is not None and sp.dirty is None
        assert sp.spill.n > budget
        assert isinstance(sp.spill.num, np.memmap)
        inc = run_mice_stream(src, **kw)
        np.testing.assert_array_equal(sp.idx, inc.idx)
        num_sp, cat_sp = sp._dirty_slice(0, sp.spill.n)
        num_ic = inc.dirty.num_data.numpy()
        cat_ic = inc.dirty.cat_values()
        for j in range(num.shape[0]):
            m = num_null[j, inc.idx]
            np.testing.assert_allclose(
                num_sp[j][m], num_ic[j][m],
                atol=5e-3 * (np.abs(num_ic[j]).max() + 1))
        for j in range(cat.shape[0]):
            m = cat_null[j, inc.idx]
            assert (cat_sp[j][m] == cat_ic[j][m]).mean() > 0.98
        out = np.concatenate([a for a, _ in sp.impute_chunks(src)], axis=1)
        assert not np.isnan(out).any()
        np.testing.assert_array_equal(out[~num_null], num[~num_null])
    finally:
        sp.spill.cleanup()
    assert not os.path.exists(sp.spill._dir)


def test_all_observed_stream_is_a_no_op():
    rng = np.random.default_rng(5)
    num = rng.normal(size=(2, 300)).astype(np.float32)
    cat = rng.integers(0, 3, size=(1, 300))
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=128)
    for engine in ("host", "device"):
        res = run_mice_stream(src, iters=2, chunk_rows=128, engine=engine,
                              device="cpu")
        assert res.idx.size == 0
        out = list(res.impute_chunks(src))
        np.testing.assert_array_equal(
            np.concatenate([a for a, _ in out], axis=1), num)
        np.testing.assert_array_equal(
            np.concatenate([b for _, b in out], axis=1), cat)


@pytest.mark.parametrize("entry", ["scan_gram", "run_mice_stream"])
def test_entry_points_default_to_the_card(data, entry):
    """Without a device argument the fold and the driver put their tensors
    on "cuda": on a machine without a card they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = streaming.chunks_from_arrays(*data[:2])
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    call = ((lambda: streaming.scan_gram(src, ss)) if entry == "scan_gram"
            else (lambda: run_mice_stream(src, iters=1)))
    with pytest.raises((RuntimeError, AssertionError)):
        call()


def test_unknown_engine_raises(data):
    src = streaming.chunks_from_arrays(*data[:2])
    with pytest.raises(ValueError, match="engine"):
        run_mice_stream(src, engine="tpu", device="cpu")


# ---------------------------------------------------------------------------
# CSV in, CSV out
# ---------------------------------------------------------------------------

def _write_csv(path, seed=7, n=6000):
    """tests/test_streaming.py's end-to-end file: a, b numeric, g
    categorical from the sign of the latent, 10% nulls in a and g."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=n)
    a = (lat * 2 + rng.normal(size=n) * .3).astype(np.float32)
    b = (-lat + rng.normal(size=n) * .3).astype(np.float32)
    g = (lat > 0).astype(np.int64) * 5 + 1
    na, ng = rng.random(n) < 0.1, rng.random(n) < 0.1
    with open(path, "w") as f:
        f.write("a,b,g\n")
        for i in range(n):
            f.write("%s,%.6f,%s\n" % ("" if na[i] else "%.6f" % a[i], b[i],
                                      "" if ng[i] else str(g[i])))
    return a, g, na, ng


def test_impute_csv_stream_matches_reference(tmp_path):
    src = tmp_path / "in.csv"
    a, g, na, ng = _write_csv(src)
    kw = dict(iters=3, block_bytes=1 << 13, noise=False)
    impute_csv_stream(str(src), str(tmp_path / "out.csv"), device="cpu",
                      **kw)
    ref_impute_csv(str(src), str(tmp_path / "ref.csv"), **kw)
    got_text = (tmp_path / "out.csv").read_text().splitlines()
    want_text = (tmp_path / "ref.csv").read_text().splitlines()
    assert got_text[0] == want_text[0] == "a,b,g"
    assert len(got_text) == len(want_text) == len(a) + 1
    got = read_csv(str(tmp_path / "out.csv"), device="cpu")
    want = read_csv(str(tmp_path / "ref.csv"), device="cpu")
    inp = read_csv(str(src), device="cpu")
    gx, wx, ix = (t.num_data.numpy() for t in (got, want, inp))
    gc, wc = got.cat_values()[0], want.cat_values()[0]
    assert not got.num_null.any() and not got.cat_null.any()
    # observed cells as read; imputed ones at the host bounds
    np.testing.assert_array_equal(gx[:, ~na][0], ix[:, ~na][0])
    np.testing.assert_array_equal(gx[1], ix[1])
    np.testing.assert_array_equal(gc[~ng], g[~ng])
    np.testing.assert_allclose(gx, wx, rtol=1e-3, atol=1e-2)
    assert (gc == wc).mean() > 0.99
    assert np.corrcoef(gx[0][na], a[na])[0, 1] > 0.85
    assert (gc[ng] == g[ng]).mean() > 0.85


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["host", "device"])
def test_checkpoint_resume_is_bit_identical(data, tmp_path, engine):
    src = streaming.chunks_from_arrays(*data[:2], chunk_rows=640)
    kw = dict(noise=True, seed=5, chunk_rows=512, device="cpu",
              engine=engine, linreg_iters=300)
    path = str(tmp_path / "run.ckpt")
    straight = run_mice_stream(src, iters=3, **kw)
    run_mice_stream(src, iters=1, checkpoint_path=path, **kw)
    resumed = run_mice_stream(src, iters=3, checkpoint_path=path, **kw)
    assert torch.equal(straight.dirty.num_data, resumed.dirty.num_data)
    assert torch.equal(straight.dirty.cat_codes, resumed.dirty.cat_codes)
    np.testing.assert_array_equal(straight.idx, resumed.idx)
    assert straight.fills == resumed.fills
    with pytest.raises(ValueError, match="field 'seed'"):
        run_mice_stream(src, iters=3, checkpoint_path=path,
                        **dict(kw, seed=6))
    with pytest.raises(ValueError, match="more than the 2"):
        run_mice_stream(src, iters=2, checkpoint_path=path, **kw)
    other = streaming.chunks_from_arrays(*stream_fixture(seed=4)[:2],
                                         chunk_rows=640)
    with pytest.raises(ValueError, match="not of this run"):
        run_mice_stream(other, iters=3, checkpoint_path=path, **kw)


def test_checkpoint_refuses_another_file_and_a_jax_file(tmp_path):
    src = tmp_path / "in.csv"
    _write_csv(src, n=2000)
    path = str(tmp_path / "csv.ckpt")
    kw = dict(iters=2, block_bytes=1 << 13, noise=False, device="cpu",
              checkpoint_path=path, engine="device")
    impute_csv_stream(str(src), str(tmp_path / "out.csv"), **kw)
    impute_csv_stream(str(src), str(tmp_path / "out.csv"), **kw)
    later = time.time_ns() + 10 ** 9
    os.utime(src, ns=(later, later))
    with pytest.raises(ValueError, match="file_mtime_ns"):
        impute_csv_stream(str(src), str(tmp_path / "out.csv"), **kw)
    # the JAX package's stream checkpoint carries no fingerprint
    num_in, cat_in = stream_fixture(seed=2, n=1000)[:2]
    jax_path = str(tmp_path / "jax.ckpt")
    ref_run_stream(ref.chunks_from_arrays(num_in, cat_in, chunk_rows=512),
                   iters=1, noise=False, chunk_rows=512,
                   checkpoint_path=jax_path)
    with pytest.raises(ValueError, match="no run fingerprint"):
        run_mice_stream(
            streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=512),
            iters=2, noise=False, chunk_rows=512, device="cpu",
            checkpoint_path=jax_path)


# ---------------------------------------------------------------------------
# The fold over a mesh (gloo ranks in subprocesses)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's results, ...]} of tests/torch_stream_worker.py,
    every world size's ranks started at once; killed at the deadline."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"stream_world{world}")
        procs[world] = (d, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    end = time.monotonic() + DEADLINE_S
    logs = {}
    try:
        for world, (_, ps) in procs.items():
            for r, p in enumerate(ps):
                logs[world, r] = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))[0]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = {}
    for world, (d, ps) in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, (
                f"world {world} rank {r} failed:\n{logs[world, r]}")
        out[world] = [dict(np.load(d / f"out{r}.npz")) for r in range(world)]
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_scan_gram_over_a_mesh_is_the_single_fold(ranks, world):
    """Each rank folds its row_shard of every chunk, one all-reduce: every
    rank holds the single fold's Gram (counts exact, the rest within
    1e-6 of max|G|: each rank's part of a chunk is rounded to f32 once),
    and the rounds that follow it agree with the single run's."""
    num_in, cat_in = stream_fixture(seed=8, n=3100)[:2]
    src = streaming.chunks_from_arrays(num_in, cat_in, chunk_rows=900)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    want = streaming.scan_gram(src, ss, chunk_rows=worker.CHUNK_ROWS,
                               device="cpu").numpy()
    res = run_mice_stream(src, iters=2, noise=False, engine="device",
                          chunk_rows=worker.CHUNK_ROWS, device="cpu")
    for out in ranks[world]:
        assert_gram(out["gram"], want, ss)
        np.testing.assert_array_equal(out["c"], res.dirty.cat_codes.numpy())
        np.testing.assert_allclose(out["x"], res.dirty.num_data.numpy(),
                                   rtol=1e-5, atol=1e-5)
