"""The port's command line (`python -m duckdb_imputation_tpu_torch.cli`)
against the JAX package's on the same CSV files, both in this process
(the port with `--device cpu`): `impute --mode low | stream | delta
--no-noise` and `train` / `predict` for linreg, lda, qda and nb, with
string categoricals across files (after tests/test_cli.py).

Observed cells come out equal to their .7g rounding, class labels
equal; imputed numbers agree at the bounds of the drivers behind each
mode (tests/test_torch_host_mice.py's, tests/test_torch_delta.py's),
linreg predictions to 1e-3 of their scale (two f64 GD runs on triples
summed in another order)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import duckdb_imputation_tpu.config as ref_config
from duckdb_imputation_tpu.cli import main as ref_main
from duckdb_imputation_tpu_torch.cli import main


@pytest.fixture(autouse=True)
def no_compile_cache(monkeypatch):
    """The JAX CLI turns on XLA's persistent compilation cache under the
    home directory; these in-process runs leave it off."""
    monkeypatch.setattr(ref_config, "enable_compilation_cache",
                        lambda path=None: None)


def _port(*argv):
    main(["--device", "cpu", *map(str, argv)])


def _ref(*argv):
    ref_main(list(map(str, argv)))


def _read(path):
    lines = open(path).read().strip().splitlines()
    return lines[0].split(","), [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def impute_csv(tmp_path_factory):
    """tests/test_cli.py's round trip: b = 2a + small noise with 20% nulls,
    c the sign of a (0/1), a fourth column d unrelated."""
    rng = np.random.default_rng(0)
    n = 400
    z = rng.normal(size=n)
    a = z.astype(np.float32)
    b = (2 * z + 0.01 * rng.normal(size=n)).astype(np.float32)
    d = rng.normal(size=n).astype(np.float32)
    c = (z > 0).astype(int)
    null = np.zeros(n, bool)
    null[rng.choice(n, n // 5, replace=False)] = True
    cnull = np.zeros(n, bool)
    cnull[rng.choice(n, n // 10, replace=False)] = True
    path = tmp_path_factory.mktemp("cli") / "in.csv"
    with open(path, "w") as f:
        f.write("a,b,d,c\n")
        for i in range(n):
            bv = "" if null[i] else f"{b[i]:.6g}"
            cv = "" if cnull[i] else str(c[i])
            f.write(f"{a[i]:.6g},{bv},{d[i]:.6g},{cv}\n")
    return path, b, c, null, cnull


@pytest.mark.parametrize("mode,atol", [("low", 1e-2), ("stream", 1e-2),
                                       ("delta", 1e-3)])
def test_impute_matches_reference(impute_csv, tmp_path, mode, atol):
    src, b, c, null, cnull = impute_csv
    argv = ["impute", src, "--mode", mode, "--iters", "2", "--no-noise",
            "--linreg-iters", "2000"]
    _port(*argv, "--out", tmp_path / "port.csv")
    _ref(*argv, "--out", tmp_path / "ref.csv")
    header, rows = _read(tmp_path / "port.csv")
    ref_header, ref_rows = _read(tmp_path / "ref.csv")
    assert header == ref_header and len(rows) == len(ref_rows) == len(b)
    got = np.asarray(rows, np.float64)
    want = np.asarray(ref_rows, np.float64)
    # observed cells: the same value, to the JAX CLI's .7g
    obs = np.ones_like(got, bool)
    obs[:, header.index("b")] = ~null
    obs[:, header.index("c")] = ~cnull
    np.testing.assert_allclose(got[obs], want[obs], rtol=1e-6, atol=0)
    ci = header.index("c")
    assert (got[:, ci] == want[:, ci]).mean() > 0.99
    bi = header.index("b")
    scale = np.abs(want[:, bi]).max()
    np.testing.assert_allclose(got[:, bi], want[:, bi], rtol=1e-3,
                               atol=atol * scale)
    assert np.sqrt(np.mean((got[null, bi] - b[null]) ** 2)) < 0.2


def _train_predict(run, tmp_path, tag, model, label, train_csv, test_csv,
                   extra=()):
    bundle = tmp_path / f"{tag}_{model}.npz"
    preds = tmp_path / f"{tag}_{model}_pred.csv"
    run("train", train_csv, "--model", model, "--label", label,
        "--out", bundle, *extra)
    run("predict", test_csv, "--params", bundle, "--out", preds)
    header, rows = _read(preds)
    assert header == [f"{label}_pred"]
    return [r[0] for r in rows]


@pytest.fixture(scope="module")
def model_csvs(tmp_path_factory):
    """tests/test_cli.py's serving files: x1, x2 numeric, y = 2z, g in
    {3, 7} by the sign of z."""
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("models")

    def write(path, n0):
        z = rng.normal(size=n0)
        x1 = z + 0.05 * rng.normal(size=n0)
        x2 = -z + 0.05 * rng.normal(size=n0)
        y = (2 * z + 0.01 * rng.normal(size=n0)).astype(np.float32)
        g = np.where(z > 0, 7, 3)
        with open(path, "w") as f:
            f.write("x1,x2,y,g\n")
            for i in range(n0):
                f.write(f"{x1[i]:.6g},{x2[i]:.6g},{y[i]:.6g},{g[i]}\n")
        return y, g

    write(d / "train.csv", 600)
    y, g = write(d / "test.csv", 200)
    return d / "train.csv", d / "test.csv", y, g


@pytest.mark.parametrize("model", ["linreg", "lda", "qda", "nb"])
def test_train_predict_matches_reference(model_csvs, tmp_path, model):
    train, test, y, g = model_csvs
    label = "y" if model == "linreg" else "g"
    got = _train_predict(_port, tmp_path, "port", model, label, train, test)
    want = _train_predict(_ref, tmp_path, "ref", model, label, train, test)
    if model == "linreg":
        got, want = np.asarray(got, float), np.asarray(want, float)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
        assert np.sqrt(np.mean((got - y) ** 2)) < 0.2
    else:
        assert got == want
        assert (np.asarray(got, int) == g).mean() > 0.95


def test_string_categoricals_across_files(tmp_path):
    """Predict remaps the test file's string labels through the bundle's
    training dictionary (the test file lacks one color, shifting its
    local codes), and string predictions decode to the label strings:
    the same strings as the JAX CLI's."""
    rng = np.random.default_rng(12)
    colors = ["apple", "banana", "cherry"]
    cls_of = {"apple": "one", "banana": "three", "cherry": "two"}

    def write(path, n0, allowed):
        cs = [allowed[i] for i in rng.integers(0, len(allowed), size=n0)]
        x = rng.normal(size=n0)
        with open(path, "w") as f:
            f.write("x,color,cls\n")
            for i in range(n0):
                f.write(f"{x[i]:.6g},{cs[i]},{cls_of[cs[i]]}\n")
        return [cls_of[c] for c in cs]

    train, test = tmp_path / "train.csv", tmp_path / "test.csv"
    write(train, 600, colors)
    want = write(test, 200, colors[1:])
    for model in ("nb", "lda"):
        got = _train_predict(_port, tmp_path, "port", model, "cls", train,
                             test)
        ref = _train_predict(_ref, tmp_path, "ref", model, "cls", train,
                             test)
        assert got == ref
        assert np.mean(np.asarray(got) == np.asarray(want)) > 0.99


def test_impute_writes_string_labels(tmp_path):
    """tests/test_native.py's CLI case: a string column is written back as
    its labels, the same ones the JAX CLI writes."""
    rng = np.random.default_rng(5)
    n = 300
    z = rng.normal(size=n)
    miss = set(rng.choice(n, n // 5, replace=False).tolist())
    src = tmp_path / "in.csv"
    with open(src, "w") as f:
        f.write("x,color\n")
        for i in range(n):
            c = "" if i in miss else ("warm" if z[i] > 0 else "cool")
            f.write(f"{z[i] + 0.05 * rng.normal():.6g},{c}\n")
    argv = ["impute", src, "--iters", "2", "--no-noise",
            "--linreg-iters", "200"]
    _port(*argv, "--out", tmp_path / "port.csv")
    _ref(*argv, "--out", tmp_path / "ref.csv")
    _, got = _read(tmp_path / "port.csv")
    _, want = _read(tmp_path / "ref.csv")
    assert [r[1] for r in got] == [r[1] for r in want]
    assert {r[1] for r in got} == {"warm", "cool"}


def test_module_entry_point_and_bench_refuses_the_cpu(impute_csv, tmp_path):
    """`python -m duckdb_imputation_tpu_torch.cli` runs as a program; bench
    times kernels on a CUDA card and refuses to run without one."""
    out = tmp_path / "o.csv"
    r = subprocess.run(
        [sys.executable, "-m", "duckdb_imputation_tpu_torch.cli", "--device",
         "cpu", "impute", str(impute_csv[0]), "--out", str(out), "--mode",
         "delta", "--iters", "1", "--no-noise"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(out.read_text().splitlines()) == len(impute_csv[1]) + 1
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            _port("bench", "--config", "sum_to_triple_4_0")
