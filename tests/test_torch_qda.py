"""The port's QDA path: `qda_train_device`, the table builder `qda_tables`
and the one-pass scorer `qda_predict_kernel` (K3/K3w) through its plain
version, held against the JAX package (its Pallas QDA kernel in interpret
mode, as tests/test_kernels.py runs it, and its XLA predictor) and
against f64 numpy oracles: the dense quadratic form, the clamped-eigh
factor form of earlier versions, and f64 training."""
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
    _pack,
    class_scores_plain,
    qda_predict_kernel,
    qda_predict_plain,
    qda_tables,
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


def test_qda_predict_ties_nan_and_misses():
    """A tie goes to the lowest class, a NaN score never wins, and a code
    outside the vocab adds nothing."""
    schema = FeatureSchema(num_cols=1, cat_keys=((0, 1, 2),))
    m = 4
    quad = torch.zeros((4, m, m))
    lin = torch.zeros((4, m))
    icpt = torch.tensor([0.0, 1.0, 1.0, float("nan")])
    lin[3, 0] = 100.0
    x = torch.tensor([[1.0, -2.0, 0.5]])
    codes = torch.tensor([[0, 3, -1]], dtype=torch.int32)
    got = qda_predict_plain(*qda_tables(quad, lin, icpt, schema=schema), x,
                            codes, schema=schema)
    assert got.tolist() == [1, 1, 1]
    lin[2, 3] = 5.0                      # category 2 favours class 2
    codes = torch.tensor([[2, 3, 2]], dtype=torch.int32)
    got = qda_predict_kernel(*qda_tables(quad, lin, icpt, schema=schema), x,
                             codes, schema=schema)
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
    The port trains in f64 and scores the quadratic form as it is, over
    each row's nonzero pairs: its predictions agree ≥ 0.999 with an f64 oracle
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
    """K3/K3w take the plan's limits: P up to MAX_SCORER_SIGMA_SIZE (a
    class's whole P² form; P = 1,025 passes since the scorer's plan keys
    a wide cross table on its wider column) and any column count (65
    numeric columns pass, and so does one past those a tile of 32 rows
    holds: its plan is local, `_build.qda_local`); at least one class; the
    method by name."""
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    _build.check_qda(schema, 8, 10_000_000)
    with pytest.raises(ValueError):      # no class
        _build.check_qda(schema, 0, 100)
    _build.check_qda(FeatureSchema(num_cols=65), 2, 100)
    past = next(d for d in range(65, 2000)
                if _build.qda_local(FeatureSchema(num_cols=d)))
    _build.check_qda(FeatureSchema(num_cols=past), 2, 100)   # a local plan
    assert not _build.qda_local(FeatureSchema(num_cols=past - 1))
    _build.check_qda(FeatureSchema(
        num_cols=4, cat_keys=(tuple(range(1020)),)), 2, 100)
    _build.check_qda(FeatureSchema(num_cols=4, cat_keys=(tuple(range(
        _build.MAX_SCORER_SIGMA_SIZE - 5)),)), 2, 100)
    with pytest.raises(ValueError, match="sigma size"):   # above the plan's
        _build.check_qda(FeatureSchema(num_cols=4, cat_keys=(tuple(range(
            _build.MAX_SCORER_SIGMA_SIZE)),)), 2, 100)
    with pytest.raises(ValueError):
        _build.check_qda(schema, 2, 1 << 31)
    with pytest.raises(ValueError):
        port_device.qda_predict_device(
            torch.zeros((1, 20, 20)), torch.zeros((1, 20)), torch.zeros(1),
            torch.zeros((4, 3)), torch.zeros((2, 3), dtype=torch.int32),
            schema=schema, method="pallas")


def _dense_z(x, codes, keys):
    """z̃ = [1 ‖ x ‖ onehot(codes)] f64[P, n]; a code outside the vocab
    sets nothing."""
    return np.concatenate(
        [np.ones((1, x.shape[1])), x.astype(np.float64)]
        + [(codes[j][None] == np.arange(len(k))[:, None]) * 1.0
           for j, k in enumerate(keys)])


# config 4 (P = 21, one task) and a schema past P = 88 whose plan splits
# its tables over several tasks (P = 224: a cross table of 120 × 80)
TABLE_SCHEMAS = {"config4": (4, (tuple(range(8)),) * 2),
                 "P224": (3, (tuple(range(120)), tuple(range(80)),
                              tuple(range(20))))}


@pytest.mark.parametrize("name", sorted(TABLE_SCHEMAS))
def test_qda_tables_score_the_dense_quadratic_form(name):
    """A_c packed into the plan's cells and summed over each row's cells
    equals the dense z̃ᵀ·A_c·z̃ (A_c not symmetric, random rows, codes out
    of vocab and negative): tables kept in f64 within 1e-12 of Σ|terms|,
    the f32 tables of `qda_tables` within 2⁻²³·Σ|terms| (each cell rounded
    to f32 once), Σ|terms| = Σ_ij |A_ij·z_i·z_j| for the row."""
    d, keys = TABLE_SCHEMAS[name]
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    rng = np.random.default_rng(11)
    p, c_cls, n = schema.sigma_size, 3, 400
    a = rng.normal(size=(c_cls, p, p)) * rng.lognormal(size=(1, p, p))
    x = rng.normal(size=(d, n)).astype(np.float32) * 3
    codes = np.stack([rng.integers(-1, len(k) + 2, n)
                      for k in keys]).astype(np.int32)
    z = _dense_z(x, codes, keys)
    dense = np.einsum("in,cij,jn->cn", z, a, z)
    scale = np.einsum("in,cij,jn->cn", np.abs(z), np.abs(a), np.abs(z))

    tables, plan = qda_tables(torch.tensor(a[:, 1:, 1:]),
                              torch.tensor(a[:, 0, 1:] + a[:, 1:, 0]),
                              torch.tensor(a[:, 0, 0]), schema=schema)
    assert tables.dtype == torch.float32
    assert tables.shape == (c_cls, int(plan.task_base[-1]))
    assert (plan.num_tasks > 1) == (name == "P224")
    args = (torch.tensor(x), torch.tensor(codes))
    exact = np.stack([s.numpy() for s in class_scores_plain(
        _pack(torch.tensor(a), plan), plan, *args, schema=schema)])
    assert np.all(np.abs(exact - dense) <= 1e-12 * scale)
    f32 = np.stack([s.numpy() for s in class_scores_plain(
        tables, plan, *args, schema=schema)])
    assert np.all(np.abs(f32 - dense) <= 2.0 ** -23 * scale)
    np.testing.assert_array_equal(
        qda_predict_plain(tables, plan, *args, schema=schema).numpy(),
        np.argmax(f32.astype(np.float32), 0))


def test_pair_form_equals_the_clamped_eigh_factor_form():
    """On the singular full one-hot −quad of QDA trained on the config-4
    table (every covariance is singular), the pair-form scores equal the
    scores of the factor form the scorer used before, b + lin·z − ‖Lᵀz‖²
    with L = V·diag(√λ₊) from a clamped eigendecomposition of −quad, both
    computed here in f64: within 1e-5 of max|s|, argmax agreement
    ≥ 0.999."""
    rng = np.random.default_rng(2)
    n, c_cls = 50_000, 8
    y = np.where(rng.random(n) < 0.9, 0, rng.integers(1, c_cls, n)).astype(
        np.int32)
    shift = 2.0 * np.random.default_rng(0).normal(size=(c_cls, 4))
    x = (rng.normal(size=(4, n)) + shift[y].T).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    keys = (tuple(range(8)),) * 2
    schema = FeatureSchema(num_cols=4, cat_keys=keys)
    sig = sigma_from_triple(port_sum.sum_to_triple_grouped(
        torch.tensor(x), torch.tensor(codes), torch.tensor(y),
        schema=schema, num_groups=c_cls))
    quad, lin, b = port_device.qda_train_device(sig, float(n))
    neg = -quad.double().numpy()
    lam, v = np.linalg.eigh((neg + np.swapaxes(neg, 1, 2)) / 2)
    assert (lam[:, :2] < 1e-6 * lam[:, -1:]).all()     # singular
    factor = v * np.sqrt(np.clip(lam, 0.0, None))[:, None, :]
    zz = _dense_z(x, codes, keys)[1:]
    fac = (b.double().numpy()[:, None] + lin.double().numpy() @ zz
           - (np.einsum("cij,in->cjn", factor, zz) ** 2).sum(1))
    tables, plan = qda_tables(quad, lin, b, schema=schema)
    pair = np.stack([s.numpy() for s in class_scores_plain(
        tables, plan, torch.tensor(x), torch.tensor(codes), schema=schema)])
    assert np.abs(pair - fac).max() <= 1e-5 * np.abs(fac).max()
    assert (pair.argmax(0) == fac.argmax(0)).mean() >= 0.999
