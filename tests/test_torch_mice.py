"""The port's single-device MICE loops (mice/device_round.py) against the
JAX package's on the same numpy inputs: the unfused loop against
mice_loop_device(kernel='xla'), the fused loop against
mice_loop_device_fused in interpret mode, and run_mice_device on the iris
fixture at the quality bound of tests/test_mice.py."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from sklearn.datasets import load_iris

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice import run_mice_baseline
from duckdb_imputation_tpu.mice.device_round import (
    mice_loop_device as ref_loop,
    mice_loop_device_fused as ref_loop_fused,
)
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import (
    mice_loop_device,
    mice_loop_device_fused,
    mice_round_device,
    run_mice_device,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture():
    """tests/test_kernels.py's fused-loop fixture: 3 numeric and 2
    categorical columns, c0 predictable from x0/x1, 20% nulls in x1 and
    c0."""
    rng = np.random.default_rng(23)
    n = 1024
    cls = rng.integers(0, 3, size=n)
    z = rng.normal(size=n)
    x = np.stack([cls * 2.0 + 0.3 * z,
                  0.7 * cls + 0.2 * rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    c = np.stack([cls, rng.integers(0, 5, size=n)]).astype(np.int32)
    nn = np.zeros((3, n), bool)
    cn = np.zeros((2, n), bool)
    nn[1, rng.random(n) < 0.2] = True
    cn[0, rng.random(n) < 0.2] = True
    keys = (tuple(range(3)), tuple(range(5)))
    return x, c, nn, cn, keys


KW = dict(num_cols_to_impute=(1,), cat_cols_to_impute=(0,), iters=2)


def _port_args(x, c, nn, cn):
    return tuple(torch.tensor(a) for a in (x, c, nn, cn))


def test_mice_loop_device_matches_reference(fixture):
    """Unfused loop, plain aggregation, against the JAX loop with
    kernel='xla', trainer='solve': codes equal; numerics within 1e-4 (the
    two SVD solvers round differently)."""
    x, c, nn, cn, keys = fixture
    ref_x, ref_c, _ = ref_loop(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(nn), jnp.asarray(cn),
        jax.random.PRNGKey(0), schema=RefSchema(num_cols=3, cat_keys=keys),
        kernel="xla", trainer="solve", noise=False, **KW)
    for kernel in ("plain", "gram"):
        got_x, got_c = mice_loop_device(
            *_port_args(x, c, nn, cn), schema=FeatureSchema(3, keys),
            kernel=kernel, **KW)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got_x[0].numpy(), x[0])
        np.testing.assert_array_equal(got_x[1][~nn[1]].numpy(),
                                      x[1][~nn[1]])


def test_mice_loop_device_fused_matches_reference(fixture):
    """Fused loop (K1 then K2, plain versions on the CPU) against the JAX
    fused loop in interpret mode: codes equal, x within 2e-3 (the bound of
    tests/test_kernels.py for the JAX fused loop's split precision)."""
    x, c, nn, cn, keys = fixture
    with pltpu.force_tpu_interpret_mode():
        ref_x, ref_c = ref_loop_fused(
            jnp.asarray(x), jnp.asarray(c), jnp.asarray(nn),
            jnp.asarray(cn), schema=RefSchema(num_cols=3, cat_keys=keys),
            chunk_cols=128, **KW)
        ref_x, ref_c = np.asarray(ref_x), np.asarray(ref_c)
    got_x, got_c = mice_loop_device_fused(
        *_port_args(x, c, nn, cn), schema=FeatureSchema(3, keys), **KW)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_allclose(got_x.numpy(), ref_x, rtol=2e-3, atol=2e-3)


def test_fused_and_unfused_loops_agree_exactly(fixture):
    """The fused loop scores and aggregates in the same f32 order as the
    unfused loop: on the same device the two give identical tables."""
    x, c, nn, cn, keys = fixture
    args = _port_args(x, c, nn, cn)
    schema = FeatureSchema(3, keys)
    ux, uc = mice_loop_device(*args, schema=schema, kernel="gram", **KW)
    fx, fc = mice_loop_device_fused(*args, schema=schema, **KW)
    assert torch.equal(ux, fx) and torch.equal(uc, fc)
    # the loops leave their inputs unchanged
    assert torch.equal(args[0], torch.tensor(x))
    assert torch.equal(args[1], torch.tensor(c))


def test_mice_round_device_is_one_round(fixture):
    x, c, nn, cn, keys = fixture
    schema = FeatureSchema(3, keys)
    kw = dict(schema=schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,))
    one_x, one_c = mice_round_device(*_port_args(x, c, nn, cn), **kw)
    ref_x, ref_c = mice_loop_device(*_port_args(x, c, nn, cn), iters=1,
                                    **kw)
    assert torch.equal(one_x, ref_x) and torch.equal(one_c, ref_c)


@pytest.fixture(scope="module")
def iris_mcar():
    """iris with 20% MCAR nulls in s_length (num 0), p_width (num 3) and
    target (cat 0), as tests/test_mice.py builds it."""
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


@pytest.mark.parametrize("kernel", ["auto", "plain", "gram", "fused"])
def test_run_mice_device_iris_quality(iris_mcar, kernel):
    """run_mice_device reaches the imputation quality of the JAX package's
    host baseline MICE (run_mice_baseline), at the bound of test_mice.py::
    test_mice_device_matches_host."""
    num, cat, num_null, cat_null = iris_mcar
    host = run_mice_baseline(ref_from_numpy(*iris_mcar), iters=2,
                             linreg_iters=300, noise=False)
    dev = run_mice_device(from_numpy(*iris_mcar, device="cpu"), iters=2,
                          kernel=kernel)
    for j in (0, 3):
        mask = num_null[:, j]
        rmse_h = np.sqrt(np.mean(
            (np.asarray(host.num_data)[j, mask] - num[mask, j]) ** 2))
        rmse_d = np.sqrt(np.mean(
            (dev.num_data[j].numpy()[mask] - num[mask, j]) ** 2))
        assert rmse_d < rmse_h * 1.2 + 0.05, (j, rmse_d, rmse_h)
    mask = cat_null[:, 0]
    acc = (dev.cat_values()[0, mask] == cat[mask, 0]).mean()
    assert acc > 0.8, acc


def test_run_mice_device_unfused_noise(iris_mcar):
    """Unfused stochastic regression draws from a torch.Generator seeded
    by `seed`: reproducible, seed-sensitive, and only on null cells."""
    t = from_numpy(*iris_mcar, device="cpu")
    base = run_mice_device(t, iters=1, kernel="plain")
    a = run_mice_device(t, iters=1, kernel="plain", noise=True, seed=1)
    b = run_mice_device(t, iters=1, kernel="plain", noise=True, seed=1)
    c = run_mice_device(t, iters=1, kernel="plain", noise=True, seed=2)
    assert torch.equal(a.num_data, b.num_data)
    m = t.num_null
    assert not torch.equal(a.num_data[m], c.num_data[m])
    assert torch.equal(a.num_data[~m], base.num_data[~m])


def test_run_mice_device_fused_noise_moments():
    """Fused noise (K2's Philox draws) has the residual std of the model it
    perturbs: x1 = 2·x0 + 0.5·eps, so the noise is N(0, 0.5²), as
    tpu_checks.py checks the JAX fused loop's noise."""
    rng = np.random.default_rng(8)
    n = 100_000
    z0, eps = rng.normal(size=n), rng.normal(size=n)
    x = np.stack([z0, 2 * z0 + 0.5 * eps, rng.normal(size=n),
                  rng.normal(size=n)], 1).astype(np.float32)
    c = np.stack([np.clip(z0 + 4.0, 0, 7).astype(int),
                  rng.integers(0, 8, n)], 1)
    nn = np.zeros((n, 4), bool)
    nn[:, 1] = rng.random(n) < 0.2
    cn = np.zeros((n, 2), bool)
    cn[:, 0] = rng.random(n) < 0.2
    t = from_numpy(x, c, nn, cn, device="cpu")
    kw = dict(iters=2, kernel="fused")
    clean = run_mice_device(t, **kw).num_data
    a = run_mice_device(t, noise=True, seed=5, **kw).num_data
    b = run_mice_device(t, noise=True, seed=5, **kw).num_data
    other = run_mice_device(t, noise=True, seed=6, **kw).num_data
    m = t.num_null[1]
    assert torch.equal(a, b)
    assert not torch.equal(a[1][m], other[1][m])
    d = (a[1] - clean[1])[m].double()
    z = d / d.std()
    assert 0.45 < float(d.std()) < 0.55
    assert abs(float(d.mean())) < 0.02
    assert abs(float((z ** 3).mean())) < 0.1
    assert abs(float((z ** 4).mean()) - 3.0) < 0.2


def test_run_mice_device_rejects_unported_and_unknown(iris_mcar):
    t = from_numpy(*iris_mcar, device="cpu")
    with pytest.raises(ValueError):      # 'gd' is ported; no other trainer
        run_mice_device(t, iters=1, trainer="newton")
    with pytest.raises(ValueError):
        run_mice_device(t, iters=1, kernel="fused", trainer="gd")
    with pytest.raises(ValueError):
        run_mice_device(t, iters=1, kernel="pallas_fused")


def test_import_leaves_jax_out():
    """The port never imports jax: a fresh interpreter that imports the
    whole package has no jax module loaded."""
    code = ("import sys, duckdb_imputation_tpu_torch, "
            "duckdb_imputation_tpu_torch.mice, "
            "duckdb_imputation_tpu_torch.ring.kernels, "
            "duckdb_imputation_tpu_torch.models; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'duckdb_imputation_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
