"""The port's GD trainer (models/device.py: linreg_train_device,
linreg_predict_device, mice_column_step_device) and trainer='gd' in the
unfused and delta MICE loops (mice/device_round.py) against the JAX
package's on the same numpy inputs.

Both GD loops run in f32, so their trajectories part by rounding: on the
same f32 Σ the coefficients agree within 1e-4 relative where the model
identifies them. A full one-hot block is collinear with the intercept,
and GD drifts along that direction by rounding; there the fitted values
Z·θ agree within 1e-4 of the target's scale. On iris's raw sigma the f32
loop is ill-conditioned: it stops ~0.1 from the f64 loop's fitted values
(target s_width on the whole table, 300 steps: JAX's f32 loop 0.106, the
port's 0.031 from tests/reference_oracle.py's `oracle_linreg_gd`),
so the MICE loops are held against JAX's at the bounds of
tests/test_mice.py::test_mice_device_solve_vs_gd_trainer (numerics within
0.1), with codes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice.device_round import (
    mice_loop_device as ref_loop,
    mice_loop_device_delta as ref_loop_delta,
    build_union_gather as ref_union,
)
from duckdb_imputation_tpu.models.device import (
    linreg_predict_device as ref_predict,
    linreg_train_device as ref_train,
    mice_column_step_device as ref_column_step,
)

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import (
    mice_loop_device,
    mice_loop_device_delta,
    run_mice_device,
    run_mice_device_delta,
)
from duckdb_imputation_tpu_torch.models import device
from duckdb_imputation_tpu_torch.models.device import (
    linreg_predict_device,
    linreg_train_device,
    mice_column_step_device,
)

from reference_oracle import oracle_linreg_gd

torch.set_num_threads(2)

GD_ITERS = 300


def _design(n: int, seed: int, onehot: bool):
    """Z f32[n, P]: [1 ‖ x ‖ onehot], x1 = 2·x0 + 0.3·x2 + noise; with
    onehot, two categorical columns of 8 (BASELINE config 5, P = 21)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[:, 1] = 2 * x[:, 0] + 0.3 * x[:, 2] + 0.1 * rng.normal(size=n)
    parts = [np.ones((n, 1)), x]
    if onehot:
        c = rng.integers(0, 8, size=(n, 2))
        parts += [np.eye(8)[c[:, 0]], np.eye(8)[c[:, 1]]]
    return np.concatenate(parts, 1).astype(np.float32)


def _sigma(z):
    return (z.T.astype(np.float64) @ z).astype(np.float32)


@pytest.mark.parametrize("max_iters", [2, 5, 50, 500])
def test_gd_trainer_matches_reference_numeric(max_iters):
    """No collinearity: coefficients within 1e-4 relative."""
    sig = _sigma(_design(2000, 0, onehot=False))
    want = np.asarray(ref_train(jnp.asarray(sig), label=2,
                                max_iters=max_iters))
    got = linreg_train_device(torch.tensor(sig), label=2,
                              max_iters=max_iters)
    assert got.dtype == torch.float32 and float(got[2]) == -1.0
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("lam", [0.0, 0.1])
@pytest.mark.parametrize("max_iters", [50, 500])
def test_gd_trainer_matches_reference_collinear_onehot(max_iters, lam):
    """P = 21 with two full one-hot blocks (collinear with the intercept):
    fitted values within 1e-4 of the target's scale, the numeric
    coefficients within 1e-4 relative of the largest."""
    z = _design(2000, 1, onehot=True)
    sig = _sigma(z)
    assert sig.shape == (21, 21)
    want = np.asarray(ref_train(jnp.asarray(sig), label=2, lam=lam,
                                max_iters=max_iters))
    got = linreg_train_device(torch.tensor(sig), label=2, lam=lam,
                              max_iters=max_iters).numpy()
    scale = np.abs(z[:, 2]).max()
    fit_got = z.astype(np.float64) @ got
    fit_want = z.astype(np.float64) @ want
    assert np.abs(fit_got - fit_want).max() < 1e-4 * scale
    np.testing.assert_allclose(got[1:5], want[1:5],
                               atol=1e-4 * np.abs(want[1:5]).max(), rtol=0)


def test_gd_trainer_tracks_the_f64_oracle():
    """Against the f64 oracle of the reference loop: the f32 loop's fitted
    values stay within 1e-3 of the target's scale."""
    z = _design(2000, 1, onehot=True)
    sig = _sigma(z)
    got = linreg_train_device(torch.tensor(sig), label=2, max_iters=500)
    oracle = oracle_linreg_gd(sig.astype(np.float64), 2, 0.001, 0.0, 500)
    fit = z.astype(np.float64) @ got.numpy().astype(np.float64)
    assert np.abs(fit - z @ oracle).max() < 1e-3 * np.abs(z[:, 2]).max()


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_gd_trainer_result_does_not_depend_on_chunk(chunk, monkeypatch):
    """A done state steps to itself, so the steps between host reads
    (`GD_CHUNK`) change nothing: bit-identical coefficients; reads =
    ceil(steps/chunk) at most."""
    sig = torch.tensor(_sigma(_design(2000, 1, onehot=True)))
    base = linreg_train_device(sig, label=2, max_iters=GD_ITERS)
    monkeypatch.setattr(device, "GD_CHUNK", chunk)
    before = linreg_train_device.host_reads
    got = linreg_train_device(sig, label=2, max_iters=GD_ITERS)
    reads = linreg_train_device.host_reads - before
    assert torch.equal(got, base)
    assert 1 <= reads <= -(-(GD_ITERS - 1) // chunk)


def test_gd_trainer_stops_where_the_reference_stops():
    """A sigma whose GD is done after its first step (the zero-gradient
    target): the loop ends at the first read with the reference's value."""
    sig = np.eye(4, dtype=np.float32) * 10
    sig[0, 0] = 100.0
    want = np.asarray(ref_train(jnp.asarray(sig), label=1, max_iters=500))
    before = linreg_train_device.host_reads
    got = linreg_train_device(torch.tensor(sig), label=1, max_iters=500)
    assert linreg_train_device.host_reads - before == 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_linreg_predict_device_matches_reference():
    z = _design(500, 2, onehot=True)
    coeff = np.random.default_rng(3).normal(size=21).astype(np.float32)
    want = np.asarray(ref_predict(jnp.asarray(coeff), jnp.asarray(z.T), 2))
    got = linreg_predict_device(torch.tensor(coeff), torch.tensor(z.T.copy()),
                                2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mice_column_step_matches_reference():
    """One numeric column step (aggregate, GD, predict, write-back): the
    imputed cells within 1e-3 of the JAX step's, the others unchanged."""
    rng = np.random.default_rng(4)
    n = 1500
    z = _design(n, 4, onehot=True)
    x = np.ascontiguousarray(z[:, 1:5].T)
    codes = np.stack([z[:, 5:13].argmax(1), z[:, 13:].argmax(1)]
                     ).astype(np.int32)
    null = rng.random(n) < 0.2
    keys = (tuple(range(8)),) * 2
    want_x, want_c = ref_column_step(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(null),
        schema=RefSchema(num_cols=4, cat_keys=keys), label=1, max_iters=200)
    got_x, got_c = mice_column_step_device(
        torch.tensor(x), torch.tensor(codes), torch.tensor(null),
        schema=FeatureSchema(4, keys), label=1, max_iters=200)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-3,
                               rtol=0)
    assert np.array_equal(got_x.numpy()[1][~null], x[1][~null])
    assert np.array_equal(np.delete(got_x.numpy(), 1, 0), np.delete(x, 1, 0))


def test_gd_trainer_at_favorita_wide_stalls_like_the_reference():
    """favorita_wide (P = 492), 50k rows, 300 steps: the f32 GD of both
    packages stalls more than 0.1 (in fitted values of the null rows)
    short of the min-norm solve, so the solve-vs-GD bound of 0.1 holds at
    iris's schema and not here; the two imputations are equally good
    (transactions RMSE within 1.15× + 0.02 of each other, the delta
    test's bound)."""
    from test_torch_wide import FAVORITA_KEYS, favorita
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import linreg_solve_device
    from duckdb_imputation_tpu_torch.ring.sum import _zt_block, masked_sigma

    x, c, nn, cn = favorita(50_000, 3)
    t = init_fill(from_numpy(x, c, nn, cn, rows_first=False, device="cpu",
                             schema=FeatureSchema(3, FAVORITA_KEYS)))
    sig = masked_sigma(t.num_data, t.cat_codes, (~t.num_null[1]).float(),
                       schema=t.schema)
    zt = _zt_block(t.num_data, t.cat_codes, t.schema).double().numpy()
    m = nn[1]

    def fitted(coeff):
        theta = np.asarray(coeff, np.float64).copy()
        theta[2] = 0.0
        return (theta @ zt)[m]
    solve = fitted(linreg_solve_device(sig, label=2))
    port = fitted(linreg_train_device(sig, label=2, max_iters=300))
    jax_gd = fitted(ref_train(jnp.asarray(sig.numpy()), label=2,
                              max_iters=300))
    assert np.abs(port - solve).max() > 0.1
    assert np.abs(jax_gd - solve).max() > 0.1
    rmse = {k: np.sqrt(np.mean((v - x[1][m]) ** 2))
            for k, v in (("port", port), ("jax", jax_gd))}
    assert rmse["port"] <= 1.15 * rmse["jax"] + 0.02
    assert rmse["jax"] <= 1.15 * rmse["port"] + 0.02


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


LOOP_KW = dict(num_cols_to_impute=(0, 3), cat_cols_to_impute=(0,), iters=2)


def _filled(iris_mcar):
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    return init_fill(from_numpy(*iris_mcar, device="cpu"))


def test_gd_unfused_loop_matches_reference(iris_mcar):
    """trainer='gd' in the unfused loop against the JAX loop (kernel='xla',
    trainer='gd') from the same filled table: codes equal, numerics within
    0.1 (see the module docstring)."""
    t = _filled(iris_mcar)
    args = (t.num_data, t.cat_codes, t.num_null, t.cat_null)
    ref_x, ref_c, _ = ref_loop(
        *(jnp.asarray(a.numpy()) for a in args), jax.random.PRNGKey(0),
        schema=RefSchema(num_cols=4, cat_keys=t.schema.cat_keys),
        kernel="xla", trainer="gd", gd_iters=GD_ITERS, noise=False,
        **LOOP_KW)
    for kernel in ("plain", "gram"):
        got_x, got_c = mice_loop_device(
            *args, schema=t.schema, kernel=kernel, trainer="gd",
            gd_iters=GD_ITERS, **LOOP_KW)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x),
                                   atol=1e-1, rtol=0)


def test_gd_delta_loop_matches_reference(iris_mcar):
    """trainer='gd' in the delta loop against the JAX delta loop
    (kernel='xla') on the same exact union: codes equal, numerics within
    0.1."""
    t = _filled(iris_mcar)
    nn, cn = t.num_null.numpy(), t.cat_null.numpy()
    dirty = [np.nonzero(nn[0])[0], np.nonzero(nn[3])[0],
             np.nonzero(cn[0])[0]]
    idx, valid = ref_union(dirty, 1)
    args = (t.num_data, t.cat_codes, t.num_null, t.cat_null)
    ref_x, ref_c, _ = ref_loop_delta(
        *(jnp.asarray(a.numpy()) for a in args), jax.random.PRNGKey(0),
        idx, valid, schema=RefSchema(num_cols=4, cat_keys=t.schema.cat_keys),
        kernel="xla", trainer="gd", gd_iters=GD_ITERS, noise=False,
        **LOOP_KW)
    got_x, got_c = mice_loop_device_delta(
        *args, torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(valid)),
        schema=t.schema, kernel="gram", trainer="gd", gd_iters=GD_ITERS,
        **LOOP_KW)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=1e-1,
                               rtol=0)


@pytest.mark.parametrize("run", ["device", "delta"])
def test_solve_vs_gd_trainer(iris_mcar, run):
    """The bounds of tests/test_mice.py::test_mice_device_solve_vs_gd_trainer:
    imputed numerics within 0.1, imputed codes agree on > 95% of the null
    cells."""
    num, cat, num_null, cat_null = iris_mcar
    fn = run_mice_device if run == "device" else run_mice_device_delta
    solve = fn(from_numpy(*iris_mcar, device="cpu"), iters=2,
               trainer="solve")
    gd = fn(from_numpy(*iris_mcar, device="cpu"), iters=2, gd_iters=500,
            trainer="gd")
    for j in (0, 3):
        mask = num_null[:, j]
        np.testing.assert_allclose(solve.num_data[j].numpy()[mask],
                                   gd.num_data[j].numpy()[mask], atol=1e-1)
    mask = cat_null[:, 0]
    agree = (solve.cat_codes[0].numpy()[mask]
             == gd.cat_codes[0].numpy()[mask]).mean()
    assert agree > 0.95, agree


def test_fused_loop_stays_solve_only(iris_mcar):
    t = from_numpy(*iris_mcar, device="cpu")
    with pytest.raises(ValueError, match="solve-only"):
        run_mice_device(t, iters=1, kernel="fused", trainer="gd")
