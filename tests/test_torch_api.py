"""The port's SQL-shaped surface (`duckdb_imputation_tpu_torch.api`)
against the JAX package's `api` on the same numpy columns, device="cpu":
every case of tests/test_api.py (the reference's 5-row ring table and its
golden dicts, the dynamic grid names, the iris models, the MICE surface,
the factorized join sums, pandas string categories) on both packages.

Tolerances: the ring dicts are equal (the 5-row table is exact in f32);
the factorized sums agree with JAX's and with the per-key products to
rtol 1e-5, atol 1e-4 (test_api.py's); the host trainers are f64 in both
packages, so from the same aggregate the parameter vectors agree to rtol
1e-5 and the predictions from the same parameters are equal (classes) or
within 1e-5 (regression); MICE with noise off agrees to atol 1e-4 (as in
tests/test_torch_host_mice.py)."""
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import load_iris
from sklearn.model_selection import train_test_split

from duckdb_imputation_tpu import api as ref_api
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import api
from duckdb_imputation_tpu_torch.ring.triple import _map
from duckdb_imputation_tpu_torch.table import from_numpy, from_pandas

import golden_ring as G

torch.set_num_threads(2)

CPU = dict(device="cpu")
TRIPLE_FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")
NB_FIELDS = ("n", "lin", "quad_diag", "lin_cat")


def _tree_close(got, want, fields, rtol=1e-5, atol=1e-4):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


def test_grid_function_sum(ring_test_table):
    gb, num, cat = ring_test_table
    cols = [num[:, 0], num[:, 1], num[:, 2], cat[:, 0], cat[:, 1], cat[:, 2]]
    res = api.sum_to_triple_3_3(*cols, **CPU)
    assert res.to_dict() == G.SUM_ALL
    assert res.to_dict() == ref_api.sum_to_triple_3_3(*cols).to_dict()


def test_grid_group_by(ring_test_table):
    gb, num, cat = ring_test_table
    cols = [num[:, 0], num[:, 1], num[:, 2], cat[:, 0], cat[:, 1], cat[:, 2]]
    res = api.sum_to_triple_3_3(*cols, group_by=gb - 1, **CPU)
    dicts = res.to_dict()
    assert dicts[0] == G.SUM_GB1 and dicts[1] == G.SUM_GB2
    assert dicts == ref_api.sum_to_triple_3_3(*cols, group_by=gb - 1).to_dict()


def test_grid_names_resolve_and_check_their_width(ring_test_table):
    """Any sum_to_triple_<x>_<y> / sum_to_nb_agg_<x>_<y> name resolves
    (past the reference's 20×20 grid too); a wrong column count raises
    TypeError, any other missing name AttributeError, as in JAX."""
    _, num, cat = ring_test_table
    assert api.sum_to_triple_25_25.__name__ == "sum_to_triple_25_25"
    assert api.sum_to_nb_agg_1_0(num[:, 0], **CPU).to_dict() == \
        ref_api.sum_to_nb_agg_1_0(num[:, 0]).to_dict()
    with pytest.raises(TypeError, match="expects 2 columns"):
        api.sum_to_triple_1_1(num[:, 0], **CPU)
    with pytest.raises(TypeError, match="expects 2 columns"):
        ref_api.sum_to_triple_1_1(num[:, 0])
    for mod in (api, ref_api):
        with pytest.raises(AttributeError):
            mod.sum_to_triple_x_1
    with pytest.raises(ValueError, match="precede"):
        api.sum_to_triple(cat[:, 0], num[:, 0], **CPU)


def test_lift_then_sum_identity(ring_test_table):
    gb, num, cat = ring_test_table
    cols = [num[:, 0], num[:, 1], num[:, 2], cat[:, 0], cat[:, 1], cat[:, 2]]
    fused = api.sum_to_triple(*cols, **CPU)
    lifted = api.sum_triple(api.to_cofactor(*cols, **CPU))
    assert fused.to_dict() == lifted.to_dict()
    rows = api.to_cofactor(*cols, **CPU).to_dict(style="num")
    assert rows == ref_api.to_cofactor(*cols).to_dict(style="num")
    nb_rows = api.to_nb_agg(*cols, **CPU)
    assert api.sum_nb_agg(nb_rows).to_dict() == G.NB_SUM_ALL
    assert nb_rows.to_dict("num") == ref_api.to_nb_agg(*cols).to_dict("num")


def test_multiply_and_subtract(ring_test_table):
    gb, num, cat = ring_test_table
    a = api.sum_to_triple_2_2(num[gb == 1, 1], num[gb == 1, 2],
                              cat[gb == 1, 0], cat[gb == 1, 1], **CPU)
    b = api.sum_to_triple_2_2(num[gb == 2, 0], num[gb == 2, 2],
                              cat[gb == 2, 0], cat[gb == 2, 2], **CPU)
    assert api.multiply_triple(a, b).to_dict(style="num") == G.MUL_GB1_GB2

    cols = [num[:, 0], num[:, 1], num[:, 2], cat[:, 0], cat[:, 1], cat[:, 2]]
    schema = api.sum_to_triple(*cols, **CPU).schema
    full = api.sum_to_triple(*cols, schema=schema, **CPU)
    part = api.sum_to_triple(*cols, weights=(gb == 1).astype(np.float32),
                             schema=schema, **CPU)
    rest = api.sum_to_triple(*cols, weights=(gb == 2).astype(np.float32),
                             schema=schema, **CPU)
    assert api.subtract_triple(full, part).to_dict() == rest.to_dict()


def test_nb_grid(ring_test_table):
    gb, num, cat = ring_test_table
    cols = [num[:, 0], num[:, 1], num[:, 2], cat[:, 0], cat[:, 1], cat[:, 2]]
    res = api.sum_to_nb_agg_3_3(*cols, **CPU)
    assert res.to_dict() == G.NB_SUM_ALL
    grouped = api.sum_to_nb_agg_3_3(*cols, group_by=gb - 1, **CPU)
    assert grouped.to_dict()[0] == G.NB_SUM_GB1
    a = api.sum_to_nb_agg_2_2(num[gb == 1, 1], num[gb == 1, 2],
                              cat[gb == 1, 0], cat[gb == 1, 1], **CPU)
    b = api.sum_to_nb_agg_2_2(num[gb == 2, 0], num[gb == 2, 2],
                              cat[gb == 2, 0], cat[gb == 2, 2], **CPU)
    assert api.multiply_nb_agg(a, b).to_dict(style="num") == G.NB_MUL
    assert api.sum_nb_triple(a, a).to_dict()["N"] == 4


@pytest.fixture(scope="module")
def iris_split():
    x, y = load_iris(return_X_y=True)
    return train_test_split(x.astype(np.float32), y, test_size=0.33,
                            random_state=42)


def _carried(ref_value, schema):
    """A JAX Cofactor / NBValue's aggregate carried over to the port, so
    that the trainers of the two packages see the same f32 input."""
    from duckdb_imputation_tpu_torch.ring.triple import (
        nb_agg_from_reference, triple_from_reference)
    if isinstance(ref_value, ref_api.NBValue):
        return api.NBValue(nb_agg_from_reference(ref_value.agg, **CPU),
                           schema, ref_value.batched)
    return api.Cofactor(triple_from_reference(ref_value.triple, **CPU),
                        schema, ref_value.batched)


def test_model_surface_iris(iris_split):
    """tests/test_api.py's quality bounds on the port, end to end. Each
    package's aggregate agrees with the other's (rtol 1e-6); trained from
    the same aggregate, each model's parameters are JAX's, and the port's
    predictions from JAX's parameters are JAX's (the f64 trainers amplify
    the aggregates' last-digit differences by up to ~6e-4 relative on
    iris's near-singular LDA covariance, so each package's own
    parameters are compared through the aggregates, not directly)."""
    xtr, xte, ytr, yte = iris_split
    cols = [xtr[:, j] for j in range(4)] + [ytr.astype(np.int64)]
    te_num = [xte[:, j] for j in range(4)]
    te_lin = [xte[:, j] for j in range(1, 4)] + [yte.astype(np.int64)]
    trip = api.sum_to_triple_4_1(*cols, **CPU)
    ref_trip = ref_api.sum_to_triple_4_1(*cols)
    _tree_close(trip.triple, ref_trip.triple, TRIPLE_FIELDS, rtol=1e-6,
                atol=1e-4)
    same = _carried(ref_trip, trip.schema)

    params = api.linreg_train(trip, 0, 0.001, 0.0, 2000, False, False)
    pred = api.linreg_predict(params, False, False, *te_lin, **CPU)
    assert isinstance(pred, np.ndarray)
    assert np.corrcoef(pred, xte[:, 0])[0, 1] > 0.8
    want = ref_api.linreg_train(ref_trip, 0, 0.001, 0.0, 2000, False, False)
    np.testing.assert_allclose(
        api.linreg_train(same, 0, 0.001, 0.0, 2000, False, False), want,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        api.linreg_predict(want, False, False, *te_lin, **CPU),
        ref_api.linreg_predict(want, False, False, *te_lin),
        rtol=1e-5, atol=1e-5)

    params = api.lda_train(trip, 0, 0.001, False)
    assert (api.lda_predict(params, False, *te_num, **CPU) == yte).mean() \
        > 0.9
    want = ref_api.lda_train(ref_trip, 0, 0.001, False)
    np.testing.assert_allclose(api.lda_train(same, 0, 0.001, False), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(api.lda_predict(want, False, *te_num, **CPU),
                                  ref_api.lda_predict(want, False, *te_num))

    tr_num = [xtr[:, j] for j in range(4)]
    grouped = api.sum_to_triple_4_0(*tr_num, group_by=ytr, **CPU)
    ref_grouped = ref_api.sum_to_triple_4_0(*tr_num, group_by=ytr)
    qp = api.qda_train(grouped, [0, 1, 2])
    assert (api.qda_predict(qp, False, *te_num, **CPU) == yte).mean() > 0.9
    want = ref_api.qda_train(ref_grouped, [0, 1, 2])
    np.testing.assert_allclose(
        api.qda_train(_carried(ref_grouped, grouped.schema), [0, 1, 2]),
        want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(api.qda_predict(want, False, *te_num, **CPU),
                                  ref_api.qda_predict(want, False, *te_num))

    nb = api.sum_to_nb_agg_4_0(*tr_num, group_by=ytr, **CPU)
    ref_nb = ref_api.sum_to_nb_agg_4_0(*tr_num, group_by=ytr)
    npar = api.nb_train(nb, [0, 1, 2])
    assert (api.nb_predict(npar, False, *te_num, **CPU) == yte).mean() > 0.9
    want = ref_api.nb_train(ref_nb, [0, 1, 2])
    np.testing.assert_allclose(
        api.nb_train(_carried(ref_nb, nb.schema), [0, 1, 2]), want,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(api.nb_predict(want, False, *te_num, **CPU),
                                  ref_api.nb_predict(want, False, *te_num))


def test_predict_encodes_categories_against_the_stored_vocab(iris_split):
    """A categorical predict column is encoded against the vocab in the
    parameters, an unseen value included (it contributes nothing), as in
    JAX: LDA of a label from the numerics and a categorical feature, and
    linear regression with noise from a torch.Generator (its draws are
    the port's own, so only the noise-free part is compared)."""
    xtr, xte, ytr, yte = iris_split
    band = (xtr[:, 3] > 1.0).astype(np.int64) * 3 + 2       # keys 2, 5
    band_te = (xte[:, 3] > 1.0).astype(np.int64) * 3 + 2
    band_te[:4] = 9                                          # unseen
    cols = [xtr[:, j] for j in range(3)] + [band, ytr.astype(np.int64)]
    trip = api.sum_to_triple_3_2(*cols, **CPU)
    ref_trip = ref_api.sum_to_triple_3_2(*cols)
    te = [xte[:, j] for j in range(3)] + [band_te]
    params = api.lda_train(trip, 1, 0.001, False)
    want = ref_api.lda_train(ref_trip, 1, 0.001, False)
    np.testing.assert_array_equal(api.lda_predict(params, False, *te, **CPU),
                                  ref_api.lda_predict(want, False, *te))
    params = api.linreg_train(trip, 0, 0.001, 0.0, 500, True, False)
    want = ref_api.linreg_train(ref_trip, 0, 0.001, 0.0, 500, True, False)
    te_lin = [xte[:, 1], xte[:, 2], band_te, yte.astype(np.int64)]
    plain = api.linreg_predict(params, False, False, *te_lin, **CPU)
    np.testing.assert_allclose(
        plain, ref_api.linreg_predict(want, False, False, *te_lin),
        rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(3)
    noisy = api.linreg_predict(params, True, False, *te_lin, generator=gen,
                               **CPU)
    again = api.linreg_predict(params, True, False, *te_lin,
                               generator=torch.Generator().manual_seed(3),
                               **CPU)
    np.testing.assert_array_equal(noisy, again)
    assert not np.array_equal(noisy, plain)


def test_mice_surface():
    """tests/test_api.py's MICE case on both packages: the RMSE bound,
    and the port's imputation equal to JAX's (noise off)."""
    x, y = load_iris(return_X_y=True)
    rng = np.random.default_rng(0)
    num = x.astype(np.float32)
    nn = np.zeros_like(num, bool)
    nn[rng.choice(len(x), 30, False), 0] = True
    args = (num, y[:, None].astype(np.int64), nn, np.zeros((len(x), 1), bool))
    kw = dict(con_columns_nulls=["num0"], cat_columns_nulls=[],
              mice_iters=1, linreg_iters=200, noise=False)
    out = api.run_MICE_baseline(from_numpy(*args, device="cpu"), **kw)
    rmse = np.sqrt(np.mean(
        (out.num_data.numpy()[0, nn[:, 0]] - num[nn[:, 0], 0]) ** 2))
    assert rmse < 0.6
    want = ref_api.run_MICE_baseline(ref_from_numpy(*args), **kw)
    np.testing.assert_allclose(out.num_data.numpy(),
                               np.asarray(want.num_data), rtol=0, atol=1e-4)
    for name in ("low", "high"):
        got = getattr(api, f"run_MICE_{name}")(
            from_numpy(*args, device="cpu"), **kw)
        ref = getattr(ref_api, f"run_MICE_{name}")(ref_from_numpy(*args),
                                                   **kw)
        np.testing.assert_allclose(got.num_data.numpy(),
                                   np.asarray(ref.num_data), rtol=0,
                                   atol=1e-4)


def test_factorized_sum_matches_per_key_products():
    """factorized_sum ≡ the sum over keys of multiply_triple ≡ the triple of
    the materialized join (test_api.py's case), and ≡ JAX's factorized_sum."""
    rng = np.random.default_rng(7)
    keys = 6
    n1, n2 = 40, 28
    gb1 = rng.integers(0, keys, n1)
    b = rng.normal(size=n1).astype(np.float32)
    d = rng.integers(0, 3, n1).astype(np.int64) * 2
    gb2 = rng.integers(0, keys, n2)
    a_col = rng.normal(size=n2).astype(np.float32)
    f = rng.integers(0, 2, n2).astype(np.int64) + 10

    A = api.sum_to_triple(b, d, group_by=gb1, num_groups=keys, **CPU)
    B = api.sum_to_triple(a_col, f, group_by=gb2, num_groups=keys, **CPU)
    fused = api.factorized_sum(A, B)

    total = None
    for k in range(keys):
        ak = api.Cofactor(_map(lambda x, k=k: x[k], A.triple), A.schema)
        bk = api.Cofactor(_map(lambda x, k=k: x[k], B.triple), B.schema)
        prod = api.multiply_triple(ak, bk)
        total = prod if total is None else total + prod
    _tree_close(fused.triple, _map(lambda x: x.numpy(), total.triple),
                TRIPLE_FIELDS)

    ii, jj = np.nonzero(gb1[:, None] == gb2[None, :])
    joined = api.sum_to_triple(b[ii], a_col[jj], d[ii], f[jj],
                               schema=fused.schema, **CPU)
    assert float(fused.triple.n) == len(ii)
    _tree_close(fused.triple, _map(lambda x: x.numpy(), joined.triple),
                TRIPLE_FIELDS)

    ref = ref_api.factorized_sum(
        ref_api.sum_to_triple(b, d, group_by=gb1, num_groups=keys),
        ref_api.sum_to_triple(a_col, f, group_by=gb2, num_groups=keys))
    _tree_close(fused.triple, ref.triple, TRIPLE_FIELDS)
    with pytest.raises(ValueError, match="batched"):
        api.factorized_sum(ak, bk)


def test_factorized_sum_nb_matches_per_key_products():
    rng = np.random.default_rng(3)
    keys = 4
    gb1 = rng.integers(0, keys, 30)
    x1 = rng.normal(size=30).astype(np.float32)
    c1 = rng.integers(0, 3, 30).astype(np.int64)
    gb2 = rng.integers(0, keys, 20)
    x2 = rng.normal(size=20).astype(np.float32)

    A = api.sum_to_nb_agg(x1, c1, group_by=gb1, num_groups=keys, **CPU)
    B = api.sum_to_nb_agg(x2, group_by=gb2, num_groups=keys, **CPU)
    fused = api.factorized_sum_nb(A, B)
    total = None
    for k in range(keys):
        ak = api.NBValue(_map(lambda x, k=k: x[k], A.agg), A.schema)
        bk = api.NBValue(_map(lambda x, k=k: x[k], B.agg), B.schema)
        prod = api.multiply_nb_agg(ak, bk)
        total = prod if total is None else total + prod
    _tree_close(fused.agg, _map(lambda x: x.numpy(), total.agg), NB_FIELDS)
    ref = ref_api.factorized_sum_nb(
        ref_api.sum_to_nb_agg(x1, c1, group_by=gb1, num_groups=keys),
        ref_api.sum_to_nb_agg(x2, group_by=gb2, num_groups=keys))
    _tree_close(fused.agg, ref.agg, NB_FIELDS)
    with pytest.raises(ValueError, match="batched"):
        api.factorized_sum_nb(ak, bk)


def test_mice_over_string_categories():
    """tests/test_api.py's end-to-end case on the port: MICE on a
    DataFrame with a string categorical column; imputed labels decode to
    valid category strings, as JAX's do."""
    from duckdb_imputation_tpu.mice import run_mice_baseline as ref_baseline
    from duckdb_imputation_tpu.table import from_pandas as ref_from_pandas

    from duckdb_imputation_tpu_torch import run_mice_baseline

    rng = np.random.default_rng(3)
    n = 400
    z = rng.normal(size=n)
    color = np.where(z > 0, "warm", "cool").astype(object)
    x = (z + 0.1 * rng.normal(size=n)).astype(np.float64)
    miss = rng.choice(n, n // 5, replace=False)
    color[miss] = None
    df = pd.DataFrame({"x": x, "color": color})
    out = run_mice_baseline(from_pandas(df, device="cpu"), iters=2,
                            noise=False)
    got = out.to_pandas()["color"].to_numpy()
    truth = np.where(z > 0, "warm", "cool")
    assert set(got) <= {"warm", "cool"}
    assert (got[miss] == truth[miss]).mean() > 0.9
    want = ref_baseline(ref_from_pandas(df), iters=2,
                        noise=False).to_pandas()["color"].to_numpy()
    np.testing.assert_array_equal(got, want)


def test_surface_builds_on_the_card_by_default(ring_test_table):
    """Asked for no device, the surface puts its tensors on CUDA: without
    a card the call raises; it never falls back to the CPU."""
    _, num, cat = ring_test_table
    if torch.cuda.is_available():
        res = api.sum_to_triple_1_1(num[:, 0], cat[:, 0])
        assert res.triple.n.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        api.sum_to_triple_1_1(num[:, 0], cat[:, 0])
