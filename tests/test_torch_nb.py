"""The port's NB path: `nb_grouped_sums` (K6) through its plain version,
`sum_to_nb_agg[_grouped]`, `nb_train_device` and `nb_predict_device`
(its tables, `nb_tables`), held against the JAX package (its Pallas NB
kernel in interpret mode, as tests/test_kernels.py runs it, and its XLA
paths) on the same inputs and against f64 numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.models import device as ref_device
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.kernels.nb_pallas import (
    sum_to_nb_agg_grouped_pallas,
)

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
    nb_grouped_sums,
    sum_to_nb_agg_grouped_kernel,
)

torch.set_num_threads(2)

KEYS = (tuple(range(8)), tuple(range(8)))
SCHEMA = FeatureSchema(num_cols=4, cat_keys=KEYS)
REF_SCHEMA = RefSchema(num_cols=4, cat_keys=KEYS)
FIELDS = ("n", "lin", "quad_diag", "lin_cat")


@pytest.fixture(scope="module")
def data():
    """tests/test_kernels.py's fixture (seed 5, 20,480 rows)."""
    rng = np.random.default_rng(5)
    n = 5 * 2048 * 2
    num = rng.normal(size=(4, n)).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    w = (rng.random(n) > 0.3).astype(np.float32)
    return num, codes, w


def assert_nb_close(got, ref):
    """test_kernels.py's tolerances: counts exact, lin within rtol 1e-6
    and atol 1e-3, quad_diag within rtol 1e-6 and atol 5e-2."""
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(got.lin_cat.numpy(), np.asarray(ref.lin_cat))
    np.testing.assert_allclose(got.lin.numpy(), np.asarray(ref.lin),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got.quad_diag.numpy(),
                               np.asarray(ref.quad_diag), rtol=1e-6,
                               atol=5e-2)


@pytest.mark.parametrize("fast", [False, True])
def test_nb_grouped_sums_plain_matches_pallas(data, fast):
    """Both bodies of the Pallas NB kernel (general f32; binary weights
    through the 3-way bf16 split) and the XLA segment sum."""
    num, codes, _ = data
    g = np.random.default_rng(6).integers(0, 5, size=num.shape[-1]).astype(
        np.int32)
    got = sum_to_nb_agg_grouped_kernel(torch.tensor(num),
                                       torch.tensor(codes), torch.tensor(g),
                                       schema=SCHEMA, num_groups=5)
    with pltpu.force_tpu_interpret_mode():
        ref = sum_to_nb_agg_grouped_pallas(num, codes, g, schema=REF_SCHEMA,
                                           num_groups=5, fast=fast)
    assert_nb_close(got, ref)
    xla = ref_sum._sum_to_nb_agg_grouped_xla(num, codes, g,
                                             schema=REF_SCHEMA, num_groups=5)
    assert_nb_close(got, xla)


def test_nb_grouped_sums_ragged_rows_weights_and_dropped_ids(data):
    """A ragged n with general weights, ids out of range (dropped), codes
    out of vocab (counted nowhere)."""
    num, codes, w = data
    k = 5000
    num, codes, w = num[:, :k], codes[:, :k].copy(), w[:k]
    codes[1, :40] = 8
    rng = np.random.default_rng(7)
    g = rng.integers(0, 3, size=k).astype(np.int32)
    g[:25] = 3
    g[25:60] = -1
    sums = nb_grouped_sums(torch.tensor(num), torch.tensor(codes),
                           torch.tensor(w), torch.tensor(g), schema=SCHEMA,
                           num_groups=3)
    assert sums.shape == (3, 1 + 8 + 16)
    with pltpu.force_tpu_interpret_mode():
        ref = sum_to_nb_agg_grouped_pallas(num, codes, g, schema=REF_SCHEMA,
                                           num_groups=3, weights=w,
                                           chunk_cols=2048)
    got = port_sum.sum_to_nb_agg_grouped(
        torch.tensor(num), torch.tensor(codes), torch.tensor(g),
        schema=SCHEMA, num_groups=3, weights=torch.tensor(w))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(ref.n))
    np.testing.assert_allclose(got.lin_cat.numpy(), np.asarray(ref.lin_cat),
                               rtol=1e-6)
    np.testing.assert_allclose(got.quad_diag.numpy(),
                               np.asarray(ref.quad_diag), rtol=1e-6,
                               atol=5e-2)
    np.testing.assert_array_equal(sums.numpy()[:, 0], got.n.numpy())


@pytest.mark.parametrize("backend", ["auto", "plain", "kernel"])
def test_sum_to_nb_agg_matches_reference(data, backend):
    num, codes, w = data
    got = port_sum.sum_to_nb_agg(torch.tensor(num), torch.tensor(codes),
                                 torch.tensor(w), schema=SCHEMA,
                                 backend=backend)
    ref = ref_sum.sum_to_nb_agg(num, codes, w, schema=REF_SCHEMA,
                                backend="xla")
    assert got.n.shape == () and got.lin.shape == (4,)
    assert_nb_close(got, ref)


def _nb_fixture(n=20_000, seed=11, classes=5):
    """Class-shifted numerics and class-dependent codes."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    mu = rng.normal(size=(classes, 4)) * 1.5
    num = (rng.normal(size=(4, n)) * 0.8 + mu[y].T).astype(np.float32)
    codes = np.stack([(y + rng.integers(0, 2, n)) % 8,
                      rng.integers(0, 8, n)]).astype(np.int32)
    return num, codes, y


def test_nb_train_and_predict_match_reference():
    """nb_train_device against JAX on the same aggregates; then
    nb_predict_device against JAX's (argmax agreement ≥ 0.999), both on
    the CPU's plain scorers."""
    num, codes, y = _nb_fixture()
    agg = port_sum.sum_to_nb_agg_grouped(
        torch.tensor(num), torch.tensor(codes), torch.tensor(y),
        schema=SCHEMA, num_groups=5)
    ragg = ref_sum.sum_to_nb_agg_grouped(num, codes, y, schema=REF_SCHEMA,
                                         num_groups=5, backend="xla")
    got = port_device.nb_train_device(agg.n, agg.lin, agg.quad_diag,
                                      agg.lin_cat)
    ref = ref_device.nb_train_device(ragg.n, ragg.lin, ragg.quad_diag,
                                     ragg.lin_cat)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    pred = port_device.nb_predict_device(
        *got, torch.tensor(num), torch.tensor(codes), schema=SCHEMA).numpy()
    rpred = np.asarray(ref_device.nb_predict_device(
        *ref, jnp.asarray(num), jnp.asarray(codes), schema=REF_SCHEMA))
    assert pred.dtype == np.int32
    assert (pred == rpred).mean() >= 0.999
    assert (pred == y).mean() > 0.8
    plain = port_device.nb_predict_device(
        *got, torch.tensor(num), torch.tensor(codes), schema=SCHEMA,
        method="plain").numpy()
    np.testing.assert_array_equal(plain, pred)


def test_nb_limits_raise():
    """n ≥ 2³¹ raises; any column count is taken (100 numeric columns:
    its plan within a block's shared memory)."""
    wide = FeatureSchema(num_cols=100, cat_keys=(tuple(range(80)),))
    _build.check_nb(wide, 10)
    assert _build.nb_plan(wide, 3).smem_bytes <= _build.WIDE_SMEM
    with pytest.raises(ValueError):
        _build.check_nb(SCHEMA, 1 << 31)
    _build.check_nb(SCHEMA, 10_000_000)


def test_nb_tables_hold_only_d_and_row_zero():
    """Naive Bayes's tables (`nb_tables`) sit on a plan without cross
    tables; of its cells only the intercept, the numerics' row-0 cells,
    the numeric diagonal and each category's count cell are nonzero; and
    they score as the f64 NB formula (within 2⁻²³ of its terms' sum), with
    the argmax of that formula."""
    num, codes, y = _nb_fixture(n=3000, seed=13)
    agg = port_sum.sum_to_nb_agg_grouped(
        torch.tensor(num), torch.tensor(codes), torch.tensor(y),
        schema=SCHEMA, num_groups=5)
    priors, mean, var, freqs = port_device.nb_train_device(
        agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
    v64 = var.double() + 1e-9
    log_freq = torch.where(freqs > 0, torch.log(freqs.double()), -1e30)
    tables, plan = port_qda.nb_tables(torch.log(priors.double()), mean, v64,
                                      log_freq, schema=SCHEMA)
    assert not plan.cross
    assert _build.SLAB_C not in plan.slabs[:, 0].tolist()
    # D (1+d)(2+d)/2, K V·(1+d): 95 cells, padded to a multiple of 4
    assert tables.shape == (5, 96)
    d = SCHEMA.num_cols
    e = plan.entries.long()
    cell = plan.task_base[e[:, 0]] + e[:, 1]
    i, j = e[:, 2], e[:, 3]
    live = torch.zeros(tables.shape[1], dtype=torch.bool)
    live[cell[((i == 0) & (j <= d)) | ((i == j) & (i > 0))]] = True
    assert not tables[:, ~live].any()
    assert tables[:, live].all()

    x64, mu, v = num.astype(np.float64), mean.double().numpy(), v64.numpy()
    lf = log_freq.numpy()
    terms = [np.log(priors.double().numpy())[:, None]
             - 0.5 * (np.log(2 * np.pi * v) + mu * mu / v).sum(1)[:, None]]
    terms += [-0.5 * x64[k] ** 2 / v[:, k:k + 1]
              + x64[k] * (mu[:, k] / v[:, k])[:, None] for k in range(d)]
    offs = (0, 8)
    terms += [lf[:, offs[j] + codes[j]] for j in range(2)]
    want = sum(terms)
    scale = sum(np.abs(t) for t in terms)
    got = np.stack([s.numpy() for s in port_qda.class_scores_plain(
        tables, plan, torch.tensor(num), torch.tensor(codes),
        schema=SCHEMA)])
    assert np.all(np.abs(got - want) <= 2.0 ** -23 * scale + 1e-9)
    pred = port_device.nb_predict_device(
        priors, mean, var, freqs, torch.tensor(num), torch.tensor(codes),
        schema=SCHEMA).numpy()
    assert (pred == want.argmax(0)).mean() >= 0.999


def _variance_case():
    """ROADMAP Queue 3's NB variance case and its NBAgg batched on the two
    classes: (num f32[2, n], y i32[n], schema, agg)."""
    rng = np.random.default_rng(0)
    n = 200_000
    y = (rng.random(n) < 0.5).astype(np.int32)
    x0 = rng.normal(size=n) + 2 * y
    x1 = np.where(y == 1, 1000.1, rng.normal(size=n) + 1000.1)
    num = np.stack([x0, x1]).astype(np.float32)
    schema = FeatureSchema(num_cols=2)
    agg = port_sum.sum_to_nb_agg_grouped(
        torch.tensor(num), None, torch.tensor(y), schema=schema,
        num_groups=2)
    return num, y, schema, agg


def test_nb_variance_case_stays_nonnegative():
    """ROADMAP Queue 3's case: 200k rows, 2 classes at ~50%, x0 ~ N(2y, 1),
    x1 exactly 1000.1 in class 1 and N(1000.1, 1) in class 0. Σx²/n −
    mean² of class 1's x1 cancels below 0 even from exact sums rounded
    once to the f32 NBAgg sections (−0.0049); trained in f64 and clamped
    at 0, every variance is ≥ 0, that one at most 0.01, no class's score is
    NaN, and accuracy is well above the 0.5 prior. x0's variances (~1,
    small means) are within 1e-3 of numpy's f64 variance of the data; x1's
    in class 0 equals the f64 trainer's arithmetic on the f32 sections
    (the sections hold Σx² ≈ 1e11 to f32: x1's variance of ~1 comes out
    ~8% off, a limit of the f32 NBAgg that centring the numerics before
    aggregation would lift)."""
    num, y, schema, agg = _variance_case()
    n = y.shape[0]
    priors, mean, var, freqs = port_device.nb_train_device(
        agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
    var = var.numpy()
    assert (var >= 0).all()
    assert var[1, 1] <= 0.01
    for c in range(2):
        want = num[0, y == c].astype(np.float64).var()
        assert abs(var[c, 0] - want) <= 1e-3 * want
    cnt = agg.n.double().numpy()
    host = (agg.quad_diag.double().numpy() / cnt[:, None]
            - (agg.lin.double().numpy() / cnt[:, None]) ** 2)
    np.testing.assert_allclose(var[0, 1], host[0, 1], rtol=1e-6)

    tables, plan = port_qda.nb_tables(
        torch.log(priors.double()), mean, torch.tensor(var).double() + 1e-9,
        torch.zeros((2, 0), dtype=torch.float64), schema=schema)
    for s in port_qda.class_scores_plain(tables, plan, torch.tensor(num),
                                         torch.zeros((0, n), dtype=torch.int32),
                                         schema=schema):
        assert not torch.isnan(s).any()
    pred = port_device.nb_predict_device(
        priors, mean, torch.tensor(var), freqs, torch.tensor(num),
        torch.zeros((0, n), dtype=torch.int32), schema=schema).numpy()
    assert (pred == y).mean() > 0.75


def test_host_nb_variance_case_stays_nonnegative():
    """The same case through the host f64 trainer and predictor
    (`models.nb_train` / `nb_predict`): class 1's variance of x1, −0.0049
    before the clamp, is ≥ 0 like every other; no class's Gaussian
    density is NaN; accuracy is well above the 0.5 prior, and the
    predictions are those of the f64 log-space formula on the same
    parameters on at least 0.999 of the rows.

    Against `nb_predict_device` they agree on class 1's rows and on at
    least 0.999 of all rows: at var + 1e-9 ≈ 1e-9 and a mean of 1000.1 the
    device scorer's f32 tables would hold x1's linear coefficient (~1e12)
    to ~6e4 if expanded around 0 (0.915 of the rows agreed so); built
    around the prior-weighted mean of the class means (`nb_center`), which
    the scorer subtracts from x, they hold it to the precision the
    decision needs. Where the two differ, the host is right."""
    from duckdb_imputation_tpu_torch import models

    num, y, schema, agg = _variance_case()
    params = models.nb_train(agg, schema, labels=[0, 1])
    p = models.NBParams.decode(params, 2)
    assert (p.var >= 0).all()
    var = p.var[:, :, None] + 1e-9
    x = num[None].astype(np.float64)
    pdf = (np.exp(-(x - p.mean[:, :, None]) ** 2 / (2 * var))
           / np.sqrt(2 * np.pi * var))
    assert not np.isnan(pdf).any()
    log_score = (np.log(p.priors)[:, None]
                 - ((x - p.mean[:, :, None]) ** 2 / (2 * var)
                    + 0.5 * np.log(2 * np.pi * var)).sum(1))
    pred = models.nb_predict(params, torch.tensor(num)).numpy()
    assert (pred == y).mean() > 0.75
    assert (pred == log_score.argmax(0)).mean() >= 0.999
    priors, mean, var_d, freqs = port_device.nb_train_device(
        agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
    pred_d = port_device.nb_predict_device(
        priors, mean, var_d, freqs, torch.tensor(num),
        torch.zeros((0, y.shape[0]), dtype=torch.int32),
        schema=schema).numpy()
    assert (pred == pred_d)[y == 1].all()
    assert (pred == pred_d).mean() >= 0.999
    assert (pred == y)[pred != pred_d].all()
