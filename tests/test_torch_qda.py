"""The port's QDA path: `qda_train_device`, `qda_scorers` and the one-pass
scorer `qda_predict_kernel` (K3) through its plain version, held against
the JAX package (its Pallas QDA kernel in interpret mode, as
tests/test_kernels.py runs it, and its XLA predictor) and against an f64
numpy oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.models import device as ref_device
from duckdb_imputation_tpu.ring.kernels.qda_pallas import qda_predict_pallas
from duckdb_imputation_tpu.ring.kernels.sigma_pallas import _sizing_fast3

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
    qda_predict_kernel,
    qda_predict_plain,
    qda_scorers,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

torch.set_num_threads(2)


def _conditioned_fixture():
    """tests/test_kernels.py:375-424's fixture: −quad = AAᵀ + 0.2·I, well
    conditioned, so the JAX Cholesky is well defined."""
    rng = np.random.default_rng(41)
    keys = ((0, 1, 2), (0, 1))
    m = 1 + 2 + 5 - 1
    c_cls, chunk = 4, 256
    n = _sizing_fast3(RefSchema(num_cols=2, cat_keys=keys))[3] * chunk * 2
    x = rng.normal(size=(2, n)).astype(np.float32)
    c = np.stack([rng.integers(0, 3, n),
                  rng.integers(0, 2, n)]).astype(np.int32)
    a = rng.normal(size=(c_cls, m, m)).astype(np.float32) * 0.4
    quad = (-np.einsum("cij,ckj->cik", a, a)
            - 0.2 * np.eye(m, dtype=np.float32))
    lin = rng.normal(size=(c_cls, m)).astype(np.float32)
    b = rng.normal(size=c_cls).astype(np.float32)
    return keys, x, c, quad, lin, b, chunk


def test_qda_predict_matches_pallas_and_xla():
    """The port's prediction against the JAX Pallas kernel (interpret) and
    the JAX XLA predictor: agreement ≥ 0.999 (the Pallas scorer is split
    precision, ~1e-7 of a score); a ragged n equals the prefix."""
    keys, x, c, quad, lin, b, chunk = _conditioned_fixture()
    schema = FeatureSchema(num_cols=2, cat_keys=keys)
    ref_schema = RefSchema(num_cols=2, cat_keys=keys)
    args = [jnp.asarray(a) for a in (quad, lin, b, x, c)]
    xla = np.asarray(ref_device.qda_predict_device(*args, schema=ref_schema,
                                                   method="xla"))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(qda_predict_pallas(*args, schema=ref_schema,
                                               chunk_cols=chunk))
    got = port_device.qda_predict_device(
        *(torch.tensor(a) for a in (quad, lin, b, x, c)),
        schema=schema).numpy()
    assert got.dtype == np.int32
    assert (got == xla).mean() >= 0.999
    assert (got == pallas).mean() >= 0.999
    n2 = x.shape[1] - 177
    got2 = port_device.qda_predict_device(
        *(torch.tensor(a) for a in (quad, lin, b, x[:, :n2], c[:, :n2])),
        schema=schema, method="kernel").numpy()
    np.testing.assert_array_equal(got2, got[:n2])


def test_qda_scorers_factor_singular_psd():
    """L·Lᵀ = −quad for a singular PSD −quad (rank deficient), where a
    Cholesky factor does not exist; the factor is f32 and contiguous."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(2, 6, 3))
    quad = -np.einsum("cij,ckj->cik", a, a).astype(np.float32)
    factor, lin, b = qda_scorers(torch.tensor(quad),
                                 torch.zeros((2, 6), dtype=torch.float64),
                                 torch.zeros(2))
    assert factor.dtype == torch.float32 and factor.is_contiguous()
    assert lin.dtype == torch.float32
    f = factor.double().numpy()
    np.testing.assert_allclose(f @ np.swapaxes(f, 1, 2), -quad, atol=1e-5)
    with pytest.raises(np.linalg.LinAlgError):
        np.linalg.cholesky(-quad[0].astype(np.float64))


def test_qda_predict_ties_nan_and_misses():
    """A tie goes to the lowest class, a NaN score never wins, and a code
    outside the vocab adds nothing."""
    schema = FeatureSchema(num_cols=1, cat_keys=((0, 1, 2),))
    m = 4
    factor = torch.zeros((4, m, m))
    lin = torch.zeros((4, m))
    icpt = torch.tensor([0.0, 1.0, 1.0, float("nan")])
    lin[3, 0] = 100.0
    x = torch.tensor([[1.0, -2.0, 0.5]])
    codes = torch.tensor([[0, 3, -1]], dtype=torch.int32)
    got = qda_predict_plain(factor, lin, icpt, x, codes, schema=schema)
    assert got.tolist() == [1, 1, 1]
    lin[2, 3] = 5.0                      # category 2 favours class 2
    codes = torch.tensor([[2, 3, 2]], dtype=torch.int32)
    got = qda_predict_kernel(factor, lin, icpt, x, codes, schema=schema)
    assert got.tolist() == [2, 1, 2]


def test_qda_train_matches_reference_numeric_only():
    """On a numeric-only schema the covariances are full rank and JAX's
    f32 SVD is well defined: the port's f64 trainer matches it at rtol
    1e-4."""
    rng = np.random.default_rng(12)
    n, c_cls = 30_000, 3
    y = rng.integers(0, c_cls, n).astype(np.int32)
    mix = rng.normal(size=(c_cls, 4, 4)) * 0.3 + np.eye(4)
    z = rng.normal(size=(n, 4))
    x = (np.einsum("nij,nj->ni", mix[y], z) + y[:, None]).T.astype(
        np.float32)
    schema = FeatureSchema(num_cols=4)
    sig = sigma_from_triple(port_sum.sum_to_triple_grouped(
        torch.tensor(x), None, torch.tensor(y), schema=schema,
        num_groups=c_cls))
    got = port_device.qda_train_device(sig, float(n))
    ref = ref_device.qda_train_device(jnp.asarray(sig.numpy()),
                                      jnp.float32(n), 1)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


def _train_f64(sigmas, total):
    """The host trainer's arithmetic (models/qda.py) in f64 numpy."""
    out = []
    for s in sigmas:
        n_c = s[0, 0]
        ns = max(n_c, 1.0)
        sv = s[0, 1:]
        cov = (s[1:, 1:] - np.outer(sv, sv) / ns) / ns
        u, svals, vt = np.linalg.svd(cov)
        keep = svals > 1e-9
        inv = np.where(keep, 1.0 / np.where(keep, svals, 1.0), svals)
        inva = (vt.T * inv) @ u.T
        logdet = np.sum(np.where(keep, np.log(np.where(keep, svals, 1.0)),
                                 0.0))
        mu = sv / ns
        lin = inva @ mu
        out.append((-0.5 * inva, lin,
                    -0.5 * mu @ lin - 0.5 * logdet + np.log(n_c / total)))
    return out


def test_qda_full_onehot_fixture_agrees_with_f64_oracle():
    """BASELINE config-4 schema (4 numeric columns, two categorical columns
    of 8, P = 21), 8 classes with 90% in class 0, numerics shifted by
    class (the table chip_smoke.py's [classify] phase draws), 200k rows:
    every class covariance is exactly singular (a full one-hot block is
    collinear with the count).

    Divergence from the JAX package (ROADMAP Queue 3): its
    `qda_train_device` takes the SVD in f32 with the f64 trainer's 1e-9
    cutoff, keeps f32 noise of the null directions, and its predictors'
    Cholesky of −quad + 1e-12·I turns NaN (for every class in the JAX
    pipeline of the first such fixture, which then predicts class 0 for
    every row; on the port's sigmas, for some classes, checked below).
    The port trains in f64 and factors −quad by a clamped
    eigendecomposition: its predictions agree ≥ 0.999 with an f64 oracle
    (exact sigmas, f64 training, scores zᵀ·quad·z + lin·z + b in f64) and
    beat the prior."""
    rng = np.random.default_rng(0)
    n, c_cls = 200_000, 8
    y = np.where(rng.random(n) < 0.9, 0, rng.integers(1, c_cls, n)).astype(
        np.int32)
    shift = 2.0 * np.random.default_rng(0).normal(size=(c_cls, 4))
    x = (rng.normal(size=(4, n)) + shift[y].T).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)

    triples = port_sum.sum_to_triple_grouped(
        torch.tensor(x), torch.tensor(codes), torch.tensor(y), schema=schema,
        num_groups=c_cls)
    sigmas = sigma_from_triple(triples)
    quad, lin, b = port_device.qda_train_device(sigmas, float(n))
    ref_quad = ref_device.qda_train_device(jnp.asarray(sigmas.numpy()),
                                           jnp.float32(n), 1)[0]
    ref_chol = jnp.linalg.cholesky(-ref_quad + 1e-12 * jnp.eye(20))
    assert np.isnan(np.asarray(ref_chol)).any()
    pred = port_device.qda_predict_device(quad, lin, b, torch.tensor(x),
                                          torch.tensor(codes),
                                          schema=schema).numpy()

    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(8)[:, None]) * 1.0
                          for j in range(2)])
    sig64 = np.stack([(z * (y == g)) @ z.T for g in range(c_cls)])
    params = _train_f64(sig64, n)
    zz = z[1:]
    scores = np.stack([np.einsum("in,ij,jn->n", zz, q, zz) + li @ zz + bb
                       for q, li, bb in params])
    oracle = scores.argmax(0)
    prior = (y == 0).mean()
    assert (pred == oracle).mean() >= 0.999
    assert (pred == y).mean() > prior + 0.02
    assert (oracle == y).mean() > prior + 0.02


def test_qda_limits_raise():
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    assert _build.qda_route(schema, 8, 20) == "K3"
    # factors beyond shared memory take the wide kernel, K3w
    assert _build.qda_route(FeatureSchema(
        num_cols=4, cat_keys=(tuple(range(200)),)), 8, 204) == "K3w"
    with pytest.raises(ValueError):      # more columns than registers
        _build.qda_route(FeatureSchema(num_cols=40), 2, 40)
    with pytest.raises(ValueError):
        port_device.qda_predict_device(
            torch.zeros((1, 20, 20)), torch.zeros((1, 20)), torch.zeros(1),
            torch.zeros((4, 3)), torch.zeros((2, 3), dtype=torch.int32),
            schema=schema, method="pallas")
