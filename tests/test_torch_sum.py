"""The torch port's plain aggregation and predictors (ring/sum.py), held
against the JAX package and the f64 oracle on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring import sum as ref_sum
from reference_oracle import _exact_triple_dict, build_sigma_from_dict

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import sum as port_sum

torch.set_num_threads(2)

KEYS = (tuple(range(8)), tuple(range(8)))
SCHEMA = FeatureSchema(num_cols=4, cat_keys=KEYS)      # BASELINE: P = 21
REF_SCHEMA = RefSchema(num_cols=4, cat_keys=KEYS)


def count_mask(schema):
    """Sigma entries that are integer counts."""
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


@pytest.fixture(scope="module")
def data():
    """More rows than one chunk of the plain Gram (port_sum.ROW_CHUNK)."""
    rng = np.random.default_rng(3)
    n = 150_000
    num = rng.normal(size=(4, n)).astype(np.float32) * 3 + 1
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    w = (rng.random(n) > 0.2).astype(np.float32)
    return num, codes, w


@pytest.mark.parametrize("n", [20_000, 150_000])
def test_masked_sigma_matches_reference_and_oracle(data, n):
    """Plain masked_sigma (one chunk; two chunks summed in f64) against
    JAX masked_sigma and the f64 oracle: counts exact; the rest within
    rtol 1e-5 (f32 sums of up to 131k terms), with an absolute floor of
    1e-6 of max|σ| for sums that cancel to near zero."""
    num, codes, w = (a[..., :n] for a in data)
    assert (n > port_sum.ROW_CHUNK) == (n == 150_000)
    got = port_sum.masked_sigma(torch.tensor(num), torch.tensor(codes),
                                torch.tensor(w), schema=SCHEMA).numpy()
    ref = np.asarray(ref_sum.masked_sigma(num, codes, w, schema=REF_SCHEMA))
    oracle, _ = build_sigma_from_dict(_exact_triple_dict(num.T, codes.T, w))
    cm = count_mask(SCHEMA)
    assert np.array_equal(got[cm], oracle[cm])
    assert np.array_equal(got[cm], ref[cm])
    assert got[0, 0] == w.sum()
    for want in (ref, oracle):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(oracle).max())
    np.testing.assert_array_equal(got, got.T)


def test_masked_sigma_no_weights_and_oov(data):
    """weights=None is all ones; out-of-vocab (= size) and negative codes
    contribute no one-hot, exactly as in the JAX package."""
    num, codes, _ = data
    codes = codes.copy()
    codes[0, :300] = 8
    codes[1, 300:500] = -1
    got = port_sum.masked_sigma(torch.tensor(num), torch.tensor(codes), None,
                                schema=SCHEMA).numpy()
    ref = np.asarray(ref_sum.masked_sigma(num, codes, None,
                                          schema=REF_SCHEMA))
    cm = count_mask(SCHEMA)
    assert np.array_equal(got[cm], ref[cm])
    assert got[0, 5:13].sum() == num.shape[1] - 300
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_onehot_and_zt_block_match_reference(data):
    num, codes, _ = data
    codes = codes[:, :50].copy()
    codes[0, 0] = 8
    codes[1, 1] = -3
    got = port_sum._zt_block(torch.tensor(num[:, :50]), torch.tensor(codes),
                             SCHEMA).numpy()
    ref = np.asarray(ref_sum._zt_block(jnp.asarray(num[:, :50]),
                                       jnp.asarray(codes), REF_SCHEMA))
    np.testing.assert_array_equal(got, ref)


def _cols(num, codes):
    return ([torch.tensor(a) for a in num], [torch.tensor(a) for a in codes],
            tuple(jnp.asarray(a) for a in num),
            tuple(jnp.asarray(a) for a in codes))


def test_linear_predict_matches_reference(data):
    num, codes, _ = data
    codes = codes.copy()
    codes[0, :100] = 8      # out of vocab
    codes[1, 100:200] = -1
    rng = np.random.default_rng(4)
    theta = rng.normal(size=SCHEMA.sigma_size).astype(np.float32)
    xp, cp, xj, cj = _cols(num, codes)
    got = port_sum.linear_predict(torch.tensor(theta), xp, cp,
                                  schema=SCHEMA).numpy()
    ref = np.asarray(ref_sum.linear_predict(jnp.asarray(theta), xj, cj,
                                            schema=REF_SCHEMA))
    # same f32 terms in the same order; XLA may contract a multiply-add
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_class_argmax_matches_reference_ties_oov_and_empty_class(data):
    """First-max ties go to the lowest class, out-of-vocab codes add
    nothing, and a -inf intercept (an empty LDA class) gives no NaN and is
    never chosen."""
    num, codes, _ = data
    codes = codes.copy()
    codes[0, :100] = 8
    codes[1, 100:200] = -1
    rng = np.random.default_rng(5)
    c_out = 6
    w = rng.normal(size=(SCHEMA.sigma_size, c_out)).astype(np.float32)
    icpt = rng.normal(size=c_out).astype(np.float32)
    w[:, 3] = w[:, 1]              # classes 1 and 3 tie on every row
    icpt[3] = icpt[1]
    w[:, 4] = 0.0                  # class 4 scores exactly 0 everywhere
    icpt[4] = 0.0
    w[:, 5] = 10.0                 # class 5 would win, but is empty
    icpt[5] = -np.inf
    xp, cp, xj, cj = _cols(num, codes)
    got = port_sum.class_argmax(torch.tensor(w), torch.tensor(icpt), xp, cp,
                                schema=SCHEMA).numpy()
    ref = np.asarray(ref_sum.class_argmax(jnp.asarray(w), jnp.asarray(icpt),
                                          xj, cj, schema=REF_SCHEMA))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    assert not np.any(got == 3) and np.any(got == 1)
    assert not np.any(got == 5)
    s5 = port_sum.class_score(torch.tensor(w), torch.tensor(icpt), 5, xp, cp,
                              schema=SCHEMA)
    assert torch.all(s5 == -torch.inf)


def test_class_argmax_all_classes_empty_picks_zero(data):
    """With every intercept -inf no score beats -inf: class 0, as in the
    JAX package's running-max argmax."""
    num, codes, _ = data
    w = np.ones((SCHEMA.sigma_size, 3), np.float32)
    icpt = np.full(3, -np.inf, np.float32)
    xp, cp, xj, cj = _cols(num[:, :64], codes[:, :64])
    got = port_sum.class_argmax(torch.tensor(w), torch.tensor(icpt), xp, cp,
                                schema=SCHEMA).numpy()
    ref = np.asarray(ref_sum.class_argmax(jnp.asarray(w), jnp.asarray(icpt),
                                          xj, cj, schema=REF_SCHEMA))
    np.testing.assert_array_equal(got, ref)
    assert np.all(got == 0)
