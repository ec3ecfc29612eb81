"""The port's native CSV binding (`duckdb_imputation_tpu_torch.table.native`)
against the JAX package's (`duckdb_imputation_tpu.table.native`) on the
same files: the whole-file parse, the Table it builds, the chunked reader
and the formatter agree exactly; the formatter refuses integer cells it
cannot write; the port builds its own library under `build/native/` and
leaves `native/libdbi_native.so` as it was."""
import hashlib
import os

import numpy as np
import pytest

from duckdb_imputation_tpu.table import native as ref_native
from duckdb_imputation_tpu_torch import config
from duckdb_imputation_tpu_torch.table import native

JAX_LIB = config.ROOT / "native" / "libdbi_native.so"


def _sha256(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tests/test_native.py's files: ints, floats and nulls; a string
    column with a numeric token; whitespace and the null markers; and a
    larger one for the chunked reader."""
    d = tmp_path_factory.mktemp("native")
    out = {}
    out["mixed"] = d / "t.csv"
    out["mixed"].write_text("a,b,d,e\n1.5,2,4,5\n2.5,,8,9\n3.5,1,4,NULL\n"
                            "NaN,7,12,5\n5.0,3,8,9\n")
    out["strings"] = d / "s.csv"
    out["strings"].write_text("x,color,g\n0.5,red,1\n1.5,blue,2\n2.5,,1\n"
                              "3.5,red,2\n4.5,3,1\n")
    out["markers"] = d / "w.csv"
    out["markers"].write_text("a,b\n red ,1\nn/a,2\nnone,3\nred,oops\n")
    rng = np.random.default_rng(6)
    n = 3000
    a = rng.normal(size=n)
    g = rng.integers(0, 4, size=n)
    na = rng.random(n) < 0.1
    ng = rng.random(n) < 0.05
    out["stream"] = d / "stream.csv"
    out["stream"].write_text("a,g,b\n" + "".join(
        f"{'' if na[i] else '%.6f' % a[i]},{'' if ng[i] else g[i]},"
        f"{a[i] * 2:.5f}\n" for i in range(n)))
    return {k: str(v) for k, v in out.items()}


def test_library_is_built_outside_native_dir():
    before = _sha256(JAX_LIB)
    lib = native.load_library()
    path = native.library_path()
    assert os.path.dirname(path) == str(config.NATIVE_BUILD_DIR)
    assert os.path.exists(path) and lib.dbi_version() >= native.ABI_VERSION
    assert _sha256(JAX_LIB) == before


@pytest.mark.parametrize("name", ["mixed", "strings", "markers", "stream"])
def test_load_csv_matches_reference(files, name):
    got = native.load_csv(files[name])
    want = ref_native.load_csv(files[name])
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for c in range(got.n_cols):
        assert got.col_name(c) == want.col_name(c)
        assert got.is_numeric(c) == want.is_numeric(c)
        assert got.is_string(c) == want.is_string(c)
        assert got.col_labels(c) == want.col_labels(c)
        np.testing.assert_array_equal(got.col_null(c), want.col_null(c))
        if got.is_numeric(c):
            np.testing.assert_array_equal(got.col_f32(c), want.col_f32(c))
        else:
            np.testing.assert_array_equal(got.col_i64(c), want.col_i64(c))
            np.testing.assert_array_equal(got.col_vocab(c),
                                          want.col_vocab(c))
            np.testing.assert_array_equal(got.col_codes(c),
                                          want.col_codes(c))


@pytest.mark.parametrize("name", ["mixed", "strings", "markers", "stream"])
def test_read_csv_matches_reference(files, name):
    got = native.read_csv(files[name], device="cpu")
    want = ref_native.read_csv(files[name])
    assert got.schema.num_cols == want.schema.num_cols
    assert got.schema.cat_keys == tuple(want.schema.cat_keys)
    assert (got.num_names, got.cat_names) == (want.num_names,
                                             want.cat_names)
    assert tuple(got.cat_labels) == tuple(want.cat_labels)
    for mine, theirs in ((got.num_data, want.num_data),
                         (got.cat_codes, want.cat_codes),
                         (got.num_null, want.num_null),
                         (got.cat_null, want.cat_null)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_read_csv_defaults_to_the_card(files):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        native.read_csv(files["mixed"])


@pytest.mark.parametrize("block", [1 << 10, 1 << 13, 64 << 20])
def test_csv_chunk_source_matches_reference(files, block):
    got = list(native.csv_chunk_source(files["stream"], block_bytes=block)())
    want = list(ref_native.csv_chunk_source(files["stream"],
                                            block_bytes=block)())
    assert len(got) == len(want)
    assert len(got) > 1 or block == 64 << 20
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_stream_reader_refuses_strings(files):
    s = native.CsvStream(files["strings"])
    try:
        with pytest.raises(RuntimeError, match="string categorical"):
            s.next_chunk()
    finally:
        s.close()


def _cells(rng, n):
    f = rng.normal(size=n) * 10.0 ** rng.integers(-6, 8, n)
    f[rng.random(n) < 0.1] = np.nan
    i = rng.integers(-2 ** 40, 2 ** 40, n).astype(np.float64)
    i[:3] = [2.0 ** 53, -2.0 ** 53, 0.0]
    i[rng.random(n) < 0.1] = np.nan
    return f, i


def test_format_csv_block_matches_reference():
    f, i = _cells(np.random.default_rng(0), 5000)
    for cols, is_int in (([f, i], [0, 1]), ([i, f, f], [1, 0, 0]),
                         ([f], [0])):
        got = native.format_csv_block(cols, is_int)
        assert isinstance(got, memoryview)
        assert bytes(got) == bytes(ref_native.format_csv_block(cols, is_int))


@pytest.mark.parametrize("bad", [np.inf, -np.inf, 2.0 ** 53 + 2,
                                 -2.0 ** 60])
def test_format_csv_block_refuses_unwritable_integers(bad):
    f, i = _cells(np.random.default_rng(1), 100)
    i[50] = bad
    with pytest.raises(ValueError, match="'count'"):
        native.format_csv_block([f, i], [0, 1], names=["x", "count"])
    with pytest.raises(ValueError, match="column 1"):
        native.format_csv_block([f, i], [0, 1])
    # a float column takes the same cell
    f[50] = bad
    native.format_csv_block([f], [0])
