"""The port's host trainers and predictors (models/{sigma, linear_regression,
lda, qda, naive_bayes, io}.py) and triple validation (utils/validate.py)
against the JAX package's on the same numpy inputs.

Each trainer gets the same f32 triple in both packages (the JAX aggregate,
carried over with `triple_from_reference`), so the f64 host arithmetic is
compared alone: parameter vectors within 1e-6 relative. The f64 oracle
(tests/reference_oracle.py) holds linreg and LDA at the bounds of
tests/test_reference_oracle.py. Each predictor is fed the vector the JAX
trainer returned: codes equal, values within 1e-5. The edge cases are
those of tests/test_models_edge.py; model bundles load across packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris
from sklearn.metrics import accuracy_score
from sklearn.model_selection import train_test_split
from sklearn.preprocessing import KBinsDiscretizer

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu import models as ref
from duckdb_imputation_tpu.models import io as ref_io
from duckdb_imputation_tpu.models import sigma as ref_sigma
from duckdb_imputation_tpu.mice.partition import init_fill as ref_init_fill
from duckdb_imputation_tpu.ring import (sum_to_nb_agg_grouped as ref_nb_sum,
                                        sum_to_triple as ref_sum,
                                        sum_to_triple_grouped as ref_grouped)
from duckdb_imputation_tpu.ring.serialize import triple_to_dict
from duckdb_imputation_tpu.ring.triple import NBAgg as RefNBAgg
from duckdb_imputation_tpu.ring.triple import Triple as RefTriple
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy
from duckdb_imputation_tpu.utils import validate as ref_validate

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch import models
from duckdb_imputation_tpu_torch.models import io
from duckdb_imputation_tpu_torch.models import sigma as port_sigma
from duckdb_imputation_tpu_torch.ring.triple import (nb_agg_from_reference,
                                                     triple_from_reference)
from duckdb_imputation_tpu_torch.utils import validate

from reference_oracle import oracle_lda_train, oracle_linreg_train

torch.set_num_threads(2)

LINREG_ITERS = 1000


def port_schema(s: RefSchema) -> FeatureSchema:
    return FeatureSchema(num_cols=s.num_cols, cat_keys=tuple(s.cat_keys))


def port_triple(t):
    return triple_from_reference(t, device="cpu")


def same_params(got, want, rtol=1e-6):
    """Flat parameter vectors equal within rtol (an infinite entry, the
    intercept of an empty class, equal exactly)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def iris():
    x, y = load_iris(return_X_y=True)
    x = x.astype(np.float32)
    xtr, xte, ytr, yte = train_test_split(x, y, test_size=0.33,
                                          random_state=42)
    return xtr, xte, ytr.astype(np.int64), yte.astype(np.int64)


@pytest.fixture(scope="module")
def iris_cat():
    """KBinsDiscretizer(4, ordinal, uniform) on the first two columns
    (tests/test_models_parity.py)."""
    x, y = load_iris(return_X_y=True)
    est = KBinsDiscretizer(n_bins=4, encode="ordinal", strategy="uniform",
                           subsample=None)
    binned = est.fit_transform(x[:, :2]).astype(np.int64)
    num = x[:, 2:].astype(np.float32)
    return train_test_split(num, binned, y.astype(np.int64), test_size=0.33,
                            random_state=42)


@pytest.fixture(scope="module")
def mixed(iris_cat):
    """iris_cat with the label as a third categorical column: (schema, JAX
    triple, x_train, codes_train, x_test, codes_test)."""
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    cat_tr = np.concatenate([xtr_c, ytr[:, None]], axis=1)
    cat_te = np.concatenate([xte_c, yte[:, None]], axis=1)
    schema = RefSchema.infer(xtr_n, cat_tr)
    t = ref_sum(xtr_n.T, schema.encode(cat_tr).T, schema=schema)
    return schema, t, xtr_n, cat_tr, xte_n, cat_te


# ---------------------------------------------------------------------------
# sigma assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exclude_cat,drop_first", [
    (None, False), (0, False), (1, False), (2, False), (None, True),
    (2, True)])
def test_build_sigma_matches_reference(mixed, exclude_cat, drop_first):
    schema, t, *_ = mixed
    want, wsel = ref_sigma.build_sigma(t, schema, exclude_cat, drop_first)
    got, gsel = port_sigma.build_sigma(port_triple(t), port_schema(schema),
                                       exclude_cat, drop_first)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gsel.slots, wsel.slots)
    assert gsel.kept_cols == wsel.kept_cols
    assert gsel.schema.cat_keys == wsel.schema.cat_keys
    sel = port_sigma.select_vocab(port_schema(schema), exclude_cat,
                                  drop_first)
    np.testing.assert_array_equal(sel.slots, wsel.slots)


@pytest.mark.parametrize("label", [0, 1, 2])
def test_class_sums_match_reference(mixed, label):
    schema, t, *_ = mixed
    wsel = ref_sigma.select_vocab(schema, exclude_cat=label)
    want = ref_sigma.class_sums(t, schema, label, wsel)
    psel = port_sigma.select_vocab(port_schema(schema), exclude_cat=label)
    got = port_sigma.class_sums(port_triple(t), port_schema(schema), label,
                                psel)
    np.testing.assert_array_equal(got, want)


def test_standardize_sigma_matches_reference(mixed):
    schema, t, *_ = mixed
    want, _ = ref_sigma.build_sigma(t, schema)
    got, _ = port_sigma.build_sigma(port_triple(t), port_schema(schema))
    wm, ws = ref_sigma.standardize_sigma(want)
    gm, gs = port_sigma.standardize_sigma(got)
    for g, w in ((got, want), (gm, wm), (gs, ws)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# trainers: the port's vector against the JAX package's, then predictors fed
# the JAX vector
# ---------------------------------------------------------------------------

LINREG_CASES = {
    "numeric": dict(cats=False, normalize=False),
    "numeric_normalize": dict(cats=False, normalize=True),
    "categorical": dict(cats=True, normalize=False),
    "categorical_variance": dict(cats=True, normalize=False,
                                 compute_variance=True),
    "ridge": dict(cats=True, normalize=False, lam=0.1),
}


@pytest.fixture(scope="module")
def linreg_case(request, iris):
    xtr, xte, ytr, yte = iris
    kw = dict(request.param)
    cats = kw.pop("cats")
    cat_tr = ytr[:, None]
    schema = RefSchema.infer(xtr, cat_tr if cats else None)
    codes = schema.encode(cat_tr).T if cats else None
    t = ref_sum(xtr.T, codes, schema=schema)
    codes_te = schema.encode(yte[:, None]).T if cats else None
    return schema, t, kw, xte, codes_te


@pytest.mark.parametrize("linreg_case", list(LINREG_CASES.values()),
                         ids=list(LINREG_CASES), indirect=True)
def test_linreg_train_matches_reference(linreg_case):
    schema, t, kw, *_ = linreg_case
    want = ref.linreg_train(t, schema, label=0, max_iters=LINREG_ITERS, **kw)
    got = models.linreg_train(port_triple(t), port_schema(schema), label=0,
                              max_iters=LINREG_ITERS, **kw)
    same_params(got, want)


@pytest.mark.parametrize("linreg_case", list(LINREG_CASES.values()),
                         ids=list(LINREG_CASES), indirect=True)
def test_linreg_predict_matches_reference(linreg_case):
    schema, t, kw, xte, codes_te = linreg_case
    normalize = kw.get("normalize", False)
    params = ref.linreg_train(t, schema, label=0, max_iters=LINREG_ITERS,
                              **kw)
    want = np.asarray(ref.linreg_predict(params, xte[:, 1:].T, codes_te,
                                         normalize=normalize))
    got = models.linreg_predict(params, torch.tensor(xte[:, 1:].T.copy()),
                                None if codes_te is None
                                else torch.tensor(codes_te),
                                normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def iris_mcar_triple():
    """tests/test_reference_oracle.py's shared triple: iris with 20% MCAR
    nulls, init-filled, aggregated over the rows where the target is
    observed; with its dict form."""
    x, y = load_iris(return_X_y=True)
    rng = np.random.default_rng(42)
    num = x.astype(np.float32)
    cat = y.astype(np.int64)[:, None]
    n = len(y)
    nn = np.zeros((n, 4), bool)
    cn = np.zeros((n, 1), bool)
    nn[rng.choice(n, n // 5, replace=False), 0] = True
    nn[rng.choice(n, n // 5, replace=False), 2] = True
    cn[rng.choice(n, n // 5, replace=False), 0] = True
    t = ref_init_fill(ref_from_numpy(num, cat, nn, cn))
    w = (~cn[:, 0]).astype(np.float32)
    tri = ref_sum(t.num_data, t.cat_codes, w, schema=t.schema)
    return t.schema, tri, triple_to_dict(tri, t.schema)


def test_linreg_train_matches_oracle(iris_mcar_triple):
    """The f64 oracle's GD at the bound of test_linreg_train_param_parity."""
    schema, tri, tri_dict = iris_mcar_triple
    params = models.linreg_train(port_triple(tri), port_schema(schema),
                                 label=0, max_iters=10000,
                                 compute_variance=True)
    coeff, std = oracle_linreg_train(tri_dict, 0, max_iters=10000)
    dec = models.LinregParams.decode(params, schema.num_cols - 1,
                                     normalize=False, has_variance=True)
    oracle_flat = np.concatenate([[coeff[0]], np.delete(coeff[1:5], 0),
                                  coeff[5:]])
    ours_flat = np.concatenate([[dec.intercept], dec.num_coef, dec.cat_coef])
    np.testing.assert_allclose(ours_flat, oracle_flat.astype(np.float32),
                               rtol=2e-6)
    assert abs(dec.noise_std - std) < 2e-6 * (abs(std) + 1)


def test_lda_train_matches_oracle(iris_mcar_triple):
    """The f64 oracle's LDA at the bounds of test_lda_train_param_parity."""
    schema, tri, tri_dict = iris_mcar_triple
    params = np.asarray(models.lda_train(port_triple(tri),
                                         port_schema(schema), label=0,
                                         shrinkage=0.001), np.float64)
    w, intercept, labels, _ = oracle_lda_train(tri_dict, 0, 0.001)
    n_classes, m = w.shape[1], w.shape[0]
    assert int(params[0]) == n_classes and int(params[1]) == 0
    np.testing.assert_array_equal(params[2:2 + n_classes], labels)
    coef = params[2 + n_classes:2 + n_classes + m * n_classes]
    np.testing.assert_allclose(coef, w.T.flatten().astype(np.float32),
                               rtol=2e-5, atol=1e-6)
    icpt = params[2 + n_classes + m * n_classes:
                  2 + 2 * n_classes + m * n_classes]
    np.testing.assert_allclose(icpt, intercept.astype(np.float32), rtol=2e-6)


def _lda_numeric(iris, iris_cat):
    xtr, xte, ytr, yte = iris
    schema = RefSchema.infer(xtr, ytr[:, None])
    t = ref_sum(xtr.T, schema.encode(ytr[:, None]).T, schema=schema)
    return schema, t, 0, xte.T, None


def _lda_mixed(iris, iris_cat):
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    cat_tr = np.concatenate([xtr_c, ytr[:, None]], axis=1)
    schema = RefSchema.infer(xtr_n, cat_tr)
    t = ref_sum(xtr_n.T, schema.encode(cat_tr).T, schema=schema)
    sel = ref_sigma.select_vocab(schema, exclude_cat=2)
    return schema, t, 2, xte_n.T, sel.schema.encode(xte_c).T


def _lda_1num_4cat(iris, iris_cat):
    """tests/test_models_edge.py::test_lda_1num_4cat_normalize's table."""
    x, y = load_iris(return_X_y=True)
    est = KBinsDiscretizer(n_bins=4, encode="ordinal", strategy="uniform",
                           subsample=None)
    binned = est.fit_transform(x[:, [0, 1, 2]]).astype(np.int64)
    num = x[:, [3]].astype(np.float32)
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = train_test_split(
        num, binned, y.astype(np.int64), test_size=0.33, random_state=42)
    cat_tr = np.concatenate([xtr_c, ytr[:, None]], axis=1)
    schema = RefSchema.infer(xtr_n, cat_tr)
    t = ref_sum(xtr_n.T, schema.encode(cat_tr).T, schema=schema)
    sel = ref_sigma.select_vocab(schema, exclude_cat=3)
    return schema, t, 3, xte_n.T, sel.schema.encode(xte_c).T


def _lda_empty_class(iris, iris_cat):
    """A class that the weights remove (tests/test_models_edge.py's
    three-class data): no NaN, never predicted."""
    x, y, w = _three_class_data()
    schema = RefSchema.infer(x, y[:, None])
    t = ref_sum(x.T, schema.encode(y[:, None]).T, w, schema=schema)
    return schema, t, 0, x.T, None


LDA_CASES = {
    "numeric": (_lda_numeric, 0.0, False),
    "numeric_normalize": (_lda_numeric, 0.0, True),
    "mixed_shrinkage": (_lda_mixed, 0.01, False),
    "1num_4cat": (_lda_1num_4cat, 0.01, False),
    "1num_4cat_normalize": (_lda_1num_4cat, 0.01, True),
    "empty_class": (_lda_empty_class, 0.001, False),
}


@pytest.mark.parametrize("case", list(LDA_CASES))
def test_lda_train_and_predict_match_reference(iris, iris_cat, case):
    make, shrinkage, normalize = LDA_CASES[case]
    schema, t, label, x_te, codes_te = make(iris, iris_cat)
    want = ref.lda_train(t, schema, label=label, shrinkage=shrinkage,
                         normalize=normalize)
    got = models.lda_train(port_triple(t), port_schema(schema), label=label,
                           shrinkage=shrinkage, normalize=normalize)
    same_params(got, want)
    pred_want = np.asarray(ref.lda_predict(want, x_te, codes_te,
                                           normalize=normalize))
    pred = models.lda_predict(want, torch.tensor(np.ascontiguousarray(x_te)),
                              None if codes_te is None
                              else torch.tensor(codes_te),
                              normalize=normalize)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), pred_want)
    if case == "empty_class":
        assert not (pred == 2).any()


def _three_class_data(empty_class=2, n=400, seed=5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.int64)
    x = (y[:, None] * 1.5 + rng.normal(size=(n, 2))).astype(np.float32)
    w = (y != empty_class).astype(np.float32)  # the mask removes class 2
    return x, y, w


def _qda_numeric(iris_cat, labels):
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    schema = RefSchema.infer(xtr_n, None)
    t = ref_grouped(xtr_n.T, None, ytr, schema=schema, num_groups=3)
    return schema, t, labels, xte_n.T, None


def _qda_categorical(iris_cat, labels):
    """The drop-first path (tests/test_models_edge.py)."""
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    schema = RefSchema.infer(xtr_n, xtr_c)
    t = ref_grouped(xtr_n.T, schema.encode(xtr_c).T, ytr, schema=schema,
                    num_groups=3)
    return schema, t, labels, xte_n.T, schema.drop_first().encode(xte_c).T


def _qda_empty_class(iris_cat, labels):
    x, y, w = _three_class_data()
    schema = RefSchema.infer(x, None)
    t = ref_grouped(x.T, None, y, schema=schema, num_groups=3, weights=w)
    return schema, t, labels, x.T, None


QDA_CASES = {
    "numeric": (_qda_numeric, [0, 1, 2], False),
    "numeric_normalize": (_qda_numeric, [0, 1, 2], True),
    "drop_first": (_qda_categorical, [0, 1, 2], False),
    "drop_first_normalize": (_qda_categorical, [0, 1, 2], True),
    "noncontiguous_labels": (_qda_numeric, [-5, 3, 99], False),
    "empty_class": (_qda_empty_class, [0, 1, 2], False),
}


@pytest.mark.parametrize("case", list(QDA_CASES))
def test_qda_train_and_predict_match_reference(iris_cat, case):
    make, labels, normalize = QDA_CASES[case]
    schema, t, labels, x_te, codes_te = make(iris_cat, labels)
    want = ref.qda_train(t, schema, labels=labels, normalize=normalize)
    got = models.qda_train(port_triple(t), port_schema(schema),
                           labels=labels, normalize=normalize)
    same_params(got, want)
    pred_want = np.asarray(ref.qda_predict(want, x_te, codes_te,
                                           normalize=normalize))
    pred = models.qda_predict(want, torch.tensor(np.ascontiguousarray(x_te)),
                              None if codes_te is None
                              else torch.tensor(codes_te),
                              normalize=normalize)
    np.testing.assert_array_equal(pred.numpy(), pred_want)
    assert set(np.unique(pred.numpy())) <= set(labels)
    if case == "drop_first":
        yte = iris_cat[5]
        assert accuracy_score(yte, pred.numpy()) > 0.85
    if case == "empty_class":
        assert not np.isnan(got).any() and not (pred == 2).any()


def _nb_numeric(iris_cat, labels):
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    schema = RefSchema.infer(xtr_n, None)
    aggs = ref_nb_sum(xtr_n.T, None, ytr, schema=schema, num_groups=3)
    return schema, aggs, labels, xte_n.T, None


def _nb_mixed(iris_cat, labels):
    xtr_n, xte_n, xtr_c, xte_c, ytr, yte = iris_cat
    schema = RefSchema.infer(xtr_n, xtr_c)
    aggs = ref_nb_sum(xtr_n.T, schema.encode(xtr_c).T, ytr, schema=schema,
                      num_groups=3)
    return schema, aggs, labels, xte_n.T, schema.encode(xte_c).T


def _nb_unseen(iris_cat, labels):
    """A category never seen in training zeroes every class: class 0."""
    schema, aggs, labels, x_te, codes = _nb_mixed(iris_cat, labels)
    bad = iris_cat[3].copy()
    bad[:, 0] = 999
    return schema, aggs, labels, x_te, schema.encode(bad).T


def _nb_empty_class(iris_cat, labels):
    x, y, w = _three_class_data()
    schema = RefSchema.infer(x, None)
    aggs = ref_nb_sum(x.T, None, y, schema=schema, num_groups=3, weights=w)
    return schema, aggs, labels, x.T, None


NB_CASES = {
    "numeric": (_nb_numeric, [0, 1, 2]),
    "mixed": (_nb_mixed, [0, 1, 2]),
    "unseen_category": (_nb_unseen, [0, 1, 2]),
    "noncontiguous_labels": (_nb_numeric, [10, 40, 70]),
    "empty_class": (_nb_empty_class, [0, 1, 2]),
}


@pytest.mark.parametrize("case", list(NB_CASES))
def test_nb_train_and_predict_match_reference(iris_cat, case):
    make, labels = NB_CASES[case]
    schema, aggs, labels, x_te, codes_te = make(iris_cat, labels)
    want = ref.nb_train(aggs, schema, labels=labels)
    got = models.nb_train(nb_agg_from_reference(aggs, device="cpu"),
                          port_schema(schema), labels=labels)
    same_params(got, want)
    pred_want = np.asarray(ref.nb_predict(want, x_te, codes_te))
    pred = models.nb_predict(want, torch.tensor(np.ascontiguousarray(x_te)),
                             None if codes_te is None
                             else torch.tensor(codes_te))
    np.testing.assert_array_equal(pred.numpy(), pred_want)
    if case == "unseen_category":
        assert (pred == labels[0]).all()
    if case == "empty_class":
        assert not np.isnan(got).any() and not (pred == 2).any()


def test_nb_predict_keeps_the_running_maximum_rule():
    """The reference's max starts at 0 and moves on a strictly larger
    probability: all-zero rows get class 0 and ties the lower class."""
    schema = FeatureSchema(num_cols=1, cat_keys=((0, 1),))
    # two classes, one numeric column, category 1 never seen in class 0 nor
    # in class 1: its rows have probability 0 everywhere
    params = np.asarray([2, 2, 0, 2, 0, 1, 7, 9, 0.5, 0.5,
                         0.0, 1.0, 1.0, 0.0,
                         0.0, 1.0, 1.0, 0.0], np.float32)
    x = torch.tensor([[0.0, 0.0]])
    codes = torch.tensor([[0, 1]], dtype=torch.int32)
    got = models.nb_predict(params, x, codes)
    want = np.asarray(ref.nb_predict(params, x.numpy(), codes.numpy()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [7, 7]      # a tie, then an all-zero row
    assert models.NBParams.decode(params, schema.num_cols).n_classes == 2


def test_linreg_noise_moments(iris):
    """Stochastic regression: the noise added has the stored std (the bound
    of test_linreg_noise_distribution on iris's test rows, then the
    moments on the rows repeated 400 times), zero mean and a normal shape;
    one generator seed gives one draw."""
    xtr, xte, ytr, yte = iris
    schema = RefSchema.infer(xtr, ytr[:, None])
    t = ref_sum(xtr.T, schema.encode(ytr[:, None]).T, schema=schema)
    params = ref.linreg_train(t, schema, label=0, compute_variance=True,
                              max_iters=LINREG_ITERS)
    std = float(params[-1])
    assert std > 0
    x = torch.tensor(np.tile(xte[:, 1:].T, (1, 400)))
    codes = torch.tensor(np.tile(schema.encode(yte[:, None]).T, (1, 400)))
    base = models.linreg_predict(params, x, codes)

    def noisy(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return models.linreg_predict(params, x, codes, add_noise=True,
                                     generator=g)
    resid = (noisy(7) - base).double()
    assert abs(float(resid[:len(yte)].std()) - std) / std < 0.5
    z = resid / std
    assert abs(float(resid.std()) / std - 1.0) < 0.02
    assert abs(float(z.mean())) < 0.02
    assert abs(float((z ** 3).mean())) < 0.05
    assert abs(float((z ** 4).mean()) - 3.0) < 0.15
    assert torch.equal(noisy(7), noisy(7))
    assert not torch.equal(noisy(7), noisy(8))


# ---------------------------------------------------------------------------
# model bundles, across the packages
# ---------------------------------------------------------------------------

def _bundle(pkg, schema):
    return pkg.ModelBundle(
        model="lda", params=np.arange(7, dtype=np.float32), schema=schema,
        num_names=("a", "b"), cat_names=("c", "d"), label_name="d",
        label_kind="cat", label_keys=(3, 5), normalize=True,
        has_variance=False, cat_labels=(None, ("x", "y")),
        label_labels=("x", "y"))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_model_bundles_load_across_packages(tmp_path, direction):
    keys = ((1, 2, 4), (3, 5))
    path = str(tmp_path / "model.npz")
    if direction == "port_to_reference":
        saved = _bundle(io, FeatureSchema(num_cols=2, cat_keys=keys))
        io.save_model(path, saved)
        loaded = ref_io.load_model(path)
    else:
        saved = _bundle(ref_io, RefSchema(num_cols=2, cat_keys=keys))
        ref_io.save_model(path, saved)
        loaded = io.load_model(path)
        assert isinstance(loaded.schema, FeatureSchema)
    np.testing.assert_array_equal(loaded.params, saved.params)
    assert loaded.params.dtype == np.float32
    assert (loaded.schema.num_cols, loaded.schema.cat_keys) == (2, keys)
    for f in ("model", "num_names", "cat_names", "label_name", "label_kind",
              "label_keys", "normalize", "has_variance", "cat_labels",
              "label_labels"):
        assert getattr(loaded, f) == getattr(saved, f), f


def test_jax_trained_bundle_predicts_in_the_port(tmp_path, iris):
    """The bundle is the port's weight converter: a JAX-trained LDA saved
    by the JAX package loads in the port and predicts the JAX package's
    classes; and back."""
    xtr, xte, ytr, yte = iris
    schema = RefSchema.infer(xtr, ytr[:, None])
    t = ref_sum(xtr.T, schema.encode(ytr[:, None]).T, schema=schema)
    params = ref.lda_train(t, schema, label=0, shrinkage=0.001)
    path = str(tmp_path / "lda.npz")
    ref_io.save_model(path, ref_io.ModelBundle(
        model="lda", params=params, schema=schema,
        num_names=("a", "b", "c", "d"), cat_names=("y",), label_name="y",
        label_kind="cat", label_keys=(0, 1, 2)))
    bundle = io.load_model(path)
    got = models.lda_predict(bundle.params, torch.tensor(xte.T.copy()))
    want = np.asarray(ref.lda_predict(params, xte.T))
    np.testing.assert_array_equal(got.numpy(), want)
    io.save_model(path, bundle)
    back = ref_io.load_model(path)
    np.testing.assert_array_equal(back.params, params)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _corrupt(case, f):
    """Apply one corruption to the numpy fields f of a valid triple."""
    if case == "nan_lin":
        f["lin"][0] = np.nan
    elif case == "negative_n":
        f["n"] = np.float32(-5.0)
    elif case == "quad_asymmetric":
        f["quad"][0, 1] += 1.0
    elif case == "cat_cat_asymmetric":
        f["cat_cat"][0, 5] += 1.0
    elif case == "counts_off":
        f["lin_cat"][0] += 3.0
    elif case == "same_column_cross":
        f["cat_cat"][0, 1] = f["cat_cat"][1, 0] = 2.0
    return f


@pytest.mark.parametrize("case", ["valid", "nan_lin", "negative_n",
                                  "quad_asymmetric", "cat_cat_asymmetric",
                                  "counts_off", "same_column_cross"])
def test_validate_triple_raises_where_reference_does(mixed, case):
    schema, t, *_ = mixed
    fields = _corrupt(case, {k: np.array(getattr(t, k)) for k in
                             ("n", "lin", "quad", "lin_cat", "num_cat",
                              "cat_cat")})
    ref_t = RefTriple(**{k: jnp.asarray(v) for k, v in fields.items()})
    port_t = port_triple(ref_t)
    msgs = []
    for check, tri, sch in ((ref_validate.validate_triple, ref_t, schema),
                            (validate.validate_triple, port_t,
                             port_schema(schema))):
        try:
            check(tri, sch)
            msgs.append(None)
        except ValueError as e:
            assert type(e).__name__ == "TripleValidationError"
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == (case == "valid")


@pytest.mark.parametrize("case", ["valid", "nan_quad", "counts_off"])
def test_validate_nb_raises_where_reference_does(iris_cat, case):
    xtr_n, _, xtr_c, _, ytr, _ = iris_cat
    schema = RefSchema.infer(xtr_n, xtr_c)
    aggs = ref_nb_sum(xtr_n.T, schema.encode(xtr_c).T, np.zeros_like(ytr),
                      schema=schema, num_groups=1)
    fields = {k: np.array(getattr(aggs, k))[0] for k in
              ("n", "lin", "quad_diag", "lin_cat")}
    if case == "nan_quad":
        fields["quad_diag"][1] = np.nan
    elif case == "counts_off":
        fields["lin_cat"][-1] += 4.0
    ref_a = RefNBAgg(**{k: jnp.asarray(v) for k, v in fields.items()})
    port_a = nb_agg_from_reference(ref_a, device="cpu")
    outcomes = []
    for check, a, sch in ((ref_validate.validate_nb, ref_a, schema),
                          (validate.validate_nb, port_a,
                           port_schema(schema))):
        try:
            check(a, sch)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "valid")
