"""The port's factorized learning over joins (`ring.star`,
`mice.factorized`) against the JAX package on the same seeded numpy
inputs (tests/test_factorized.py's fixtures and cases).

Tolerances: the port's join aggregates are exact sums in f64 rounded to
f32 once; JAX's are f32 sums. Triples agree to rtol 1e-5 and an atol of
1e-5 of the section's largest value, and each agrees with the masked
aggregate of the materialized join within test_factorized.py's bounds.
MICE with noise off: imputed codes equal on ≥ 0.999 of the null cells;
imputed numbers within 1e-4 of JAX's, as in tests/test_torch_host_mice.py
(the two trainers see triples that differ in the last f32 digits)."""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.mice import (run_mice_factorized as ref_factorized,
                                        run_mice_star as ref_star)
from duckdb_imputation_tpu.ring.star import star_join_triple as ref_star_triple
from duckdb_imputation_tpu.schema import FeatureSchema as RefSchema
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import FeatureSchema, from_reference
from duckdb_imputation_tpu_torch.mice import (init_fill, observed_weights,
                                              run_mice_baseline,
                                              run_mice_factorized,
                                              run_mice_star)
from duckdb_imputation_tpu_torch.ring.star import (_star_permutation,
                                                   star_join_triple,
                                                   star_schema)
from duckdb_imputation_tpu_torch.ring.sum import (sum_to_triple,
                                                  sum_to_triple_grouped)
from duckdb_imputation_tpu_torch.ring.triple import factorized_join_sum

torch.set_num_threads(2)

FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")
MICE_KW = dict(iters=2, linreg_iters=300, noise=False)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype)


def _port_schema(s) -> FeatureSchema:
    return FeatureSchema(num_cols=s.num_cols, cat_keys=tuple(s.cat_keys))


def _close(got, want, rtol=1e-5, scaled_atol=1e-5, msg=""):
    for f in FIELDS:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (f, g.shape, w.shape)
        atol = scaled_atol * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{msg}:{f}")


def _two_dims(rng, k1, k2, n):
    """test_factorized.py's two-dimension case at key spaces k1, k2."""
    d1_num = rng.normal(size=(1, k1)).astype(np.float32)
    d1_cat = rng.integers(0, 3, size=(1, k1)).astype(np.int32)
    d2_num = rng.normal(size=(2, k2)).astype(np.float32)
    xf = rng.normal(size=(2, n)).astype(np.float32)
    cf = rng.integers(0, 4, size=(1, n)).astype(np.int32)
    ka = rng.integers(0, k1, n).astype(np.int32)
    kb = rng.integers(0, k2, n).astype(np.int32)
    w = rng.integers(0, 2, n).astype(np.float32)
    fs = RefSchema(num_cols=2, cat_keys=(tuple(range(4)),))
    d1s = RefSchema(num_cols=1, cat_keys=(tuple(range(3)),))
    d2s = RefSchema(num_cols=2)
    return d1_num, d1_cat, d2_num, xf, cf, ka, kb, w, fs, d1s, d2s


@pytest.mark.parametrize("keys", [(7, 5), (9000, 5)],
                         ids=["onehot_branch", "segment_branch"])
def test_star_join_triple_matches_reference(keys):
    """Both of JAX's branches: key spaces ≤ ONEHOT_KEY_LIMIT (8,192), its
    one-hot scan, and one past it (9,000 keys at small n), its
    segment-sums; the port has one path. Also equal to the masked
    aggregate of the materialized join (unique dim keys: row gathers)."""
    rng = np.random.default_rng(21)
    (d1_num, d1_cat, d2_num, xf, cf, ka, kb, w,
     fs, d1s, d2s) = _two_dims(rng, *keys, n=500)
    want = ref_star_triple(xf, cf, w, keys=(ka, kb),
                           dims=((d1_num, d1_cat), (d2_num, None)),
                           fact_schema=fs, dim_schemas=(d1s, d2s))
    pfs, pd1, pd2 = _port_schema(fs), _port_schema(d1s), _port_schema(d2s)
    got = star_join_triple(
        _t(xf), _t(cf, torch.int32), _t(w), keys=(_t(ka, torch.int64),
                                                  _t(kb, torch.int32)),
        dims=((_t(d1_num), _t(d1_cat, torch.int32)), (_t(d2_num), None)),
        fact_schema=pfs, dim_schemas=(pd1, pd2))
    _close(got, want)

    jn = np.concatenate([xf, d1_num[:, ka], d2_num[:, kb]], 0)
    jc = np.concatenate([cf, d1_cat[:, ka]], 0)
    js = star_schema(pfs, [pd1, pd2])
    mat = sum_to_triple(_t(jn), _t(jc, torch.int32), _t(w), schema=js)
    _close(got, mat, rtol=1e-5, scaled_atol=1e-6)


def test_star_join_single_dim_matches_factorized_join_sum():
    """With one dimension the star path is the two-table factorized join
    (unique dim keys), as in JAX."""
    rng = np.random.default_rng(4)
    keys, n = 6, 300
    dz = _t(rng.normal(size=(1, keys)))
    xf = _t(rng.normal(size=(1, n)))
    ka = _t(rng.integers(0, keys, n), torch.int32)
    fs = ds = FeatureSchema(num_cols=1)
    fused = star_join_triple(xf, None, None, keys=(ka,), dims=((dz, None),),
                             fact_schema=fs, dim_schemas=(ds,))
    fg = sum_to_triple_grouped(xf, None, ka, schema=fs, num_groups=keys)
    dg = sum_to_triple_grouped(dz, None, torch.arange(keys), schema=ds,
                               num_groups=keys)
    _close(fused, factorized_join_sum(fg, dg), rtol=1e-5, scaled_atol=1e-6)


def test_star_permutation_matches_reference():
    from duckdb_imputation_tpu.ring.star import (
        _star_permutation as ref_perm)
    fs = RefSchema(num_cols=2, cat_keys=((1, 2, 3),))
    dss = (RefSchema(num_cols=0, cat_keys=((0, 1),)), RefSchema(num_cols=3),
           RefSchema(num_cols=1, cat_keys=((4,), (5, 6))))
    np.testing.assert_array_equal(
        _star_permutation(_port_schema(fs), [_port_schema(d) for d in dss]),
        ref_perm(fs, dss))


@pytest.fixture(scope="module")
def star():
    """tests/test_factorized.py's star schema: fact(key, x1, x2, c1) ->
    dim(key, z, g); x1 depends mostly on the dimension's z. Plus 20% MCAR
    nulls in c1, which depends on g, so the LDA step runs over the join
    too. Returns the numpy pieces."""
    rng = np.random.default_rng(11)
    keys = 32
    dim_z = rng.normal(size=keys).astype(np.float32) * 3.0
    dim_g = rng.integers(0, 4, keys).astype(np.int64)
    n = 2000
    fk = rng.integers(0, keys, n)
    x2 = rng.normal(size=n).astype(np.float32)
    c1 = np.where(rng.random(n) < 0.9, dim_g[fk] % 3,
                  rng.integers(0, 3, n)).astype(np.int64)
    x1 = (2.0 * dim_z[fk] + 0.3 * x2
          + rng.normal(size=n).astype(np.float32) * 0.1).astype(np.float32)
    num_null = np.zeros((n, 2), bool)
    miss = rng.choice(n, n // 5, replace=False)
    num_null[miss, 0] = True
    cat_null = np.zeros((n, 1), bool)
    cat_null[rng.choice(n, n // 5, replace=False), 0] = True
    fact = (np.stack([x1, x2], 1), c1[:, None], num_null, cat_null)
    dim = (dim_z[:, None], dim_g[:, None])
    return fact, fk, dim, x1, c1, miss


def _tables(star):
    fact, fk, dim, *_ = star
    ref_fact, ref_dim = ref_from_numpy(*fact), ref_from_numpy(*dim)
    return (ref_fact, ref_dim, from_reference(ref_fact, device="cpu"),
            from_reference(ref_dim, device="cpu"))


def test_factorized_train_triple_equals_materialized_join(star):
    """The per-column training triple computed factorized (grouped fact
    aggregate × dim aggregate, contracted over keys) equals the masked
    aggregate of the materialized join, and JAX's factorized triple."""
    from duckdb_imputation_tpu.mice import init_fill as ref_init_fill
    from duckdb_imputation_tpu.mice.partition import (
        observed_weights as ref_observed)
    from duckdb_imputation_tpu.ring.sum import (
        sum_to_triple_grouped as ref_grouped)
    from duckdb_imputation_tpu.ring.triple import (
        factorized_join_sum as ref_join_sum)

    _, fk, _, *_ = star
    ref_fact, ref_dim, fact, dim = _tables(star)
    fact = init_fill(fact)
    fs, ds = fact.schema, dim.schema
    keys = dim.n_rows
    fkt = torch.tensor(fk)
    for kind in ("num", "cat"):
        w = observed_weights(fact, kind, 0)
        fused = factorized_join_sum(
            sum_to_triple_grouped(fact.num_data, fact.cat_codes, fkt,
                                  schema=fs, num_groups=keys, weights=w),
            sum_to_triple_grouped(dim.num_data, dim.cat_codes,
                                  torch.arange(keys), schema=ds,
                                  num_groups=keys))
        jn = torch.cat([fact.num_data, dim.num_data[:, fkt]])
        jc = torch.cat([fact.cat_codes, dim.cat_codes[:, fkt]])
        joined = sum_to_triple(jn, jc, w, schema=fs.concat(ds))
        _close(fused, joined, rtol=1e-5, scaled_atol=1e-6, msg=kind)

        rf = ref_init_fill(ref_fact)
        rfs, rds = rf.schema, ref_dim.schema
        want = ref_join_sum(
            ref_grouped(rf.num_data, rf.cat_codes, fk, schema=rfs,
                        num_groups=keys, weights=ref_observed(rf, kind, 0)),
            ref_grouped(ref_dim.num_data, ref_dim.cat_codes, np.arange(keys),
                        schema=rds, num_groups=keys))
        _close(fused, want, msg=kind)


def _compare_mice(got, want, star):
    """Codes equal on ≥ 0.999 of the null cells, numbers within 1e-4."""
    fact = star[0]
    cat_null = fact[3][:, 0]
    agree = (got.cat_codes.numpy()[0] == np.asarray(want.cat_codes)[0])
    assert agree[cat_null].mean() >= 0.999, agree[cat_null].mean()
    np.testing.assert_allclose(got.num_data.numpy(),
                               np.asarray(want.num_data), rtol=0, atol=1e-4)


def test_mice_factorized_matches_reference_and_beats_fact_only(star):
    """run_mice_factorized with noise off against JAX's on the same
    tables; x1 is driven by the dimension attribute, so training over the
    join reconstructs it far better than mean fill and fact-only MICE
    (test_factorized.py's bounds); the result stays on the table's
    device."""
    _, fk, _, x1_true, c1_true, miss = star
    ref_fact, ref_dim, fact, dim = _tables(star)
    out = run_mice_factorized(fact, fk, dim, **MICE_KW)
    assert out.num_data.device == fact.device
    _compare_mice(out, ref_factorized(ref_fact, fk, ref_dim, **MICE_KW), star)

    def rmse(t):
        return float(np.sqrt(np.mean(
            (t.num_data.numpy()[0, miss] - x1_true[miss]) ** 2)))

    r_fz = rmse(out)
    assert r_fz < 0.5 * rmse(init_fill(fact)), r_fz
    assert r_fz < 0.5 * rmse(run_mice_baseline(fact, **MICE_KW)), r_fz
    cm = star[0][3][:, 0]
    acc = (out.cat_values()[0][cm] == c1_true[cm]).mean()
    assert acc > 0.8, acc


def test_mice_star_matches_reference(star):
    """run_mice_star with one dimension: JAX's imputation, and the same
    as run_mice_factorized's (the single-dimension star is the two-table
    join)."""
    _, fk, _, *_ = star
    ref_fact, ref_dim, fact, dim = _tables(star)
    out = run_mice_star(fact, [fk], [dim], **MICE_KW)
    _compare_mice(out, ref_star(ref_fact, [fk], [ref_dim], **MICE_KW), star)
    two = run_mice_factorized(fact, fk, dim, **MICE_KW)
    assert (out.cat_codes == two.cat_codes).float().mean() >= 0.999
    np.testing.assert_allclose(out.num_data.numpy(), two.num_data.numpy(),
                               rtol=0, atol=1e-4)


def test_mice_star_two_dims():
    """test_factorized.py's two-dimension case (different FKs) on both
    packages: x1 driven by both dimensions is reconstructed (RMSE below a
    tenth of mean fill's), as JAX's."""
    rng = np.random.default_rng(13)
    k1, k2, n = 16, 12, 3000
    z1 = (rng.normal(size=k1) * 2).astype(np.float32)
    z2 = (rng.normal(size=k2) * 2).astype(np.float32)
    d1 = (z1[:, None], rng.integers(0, 3, k1)[:, None])
    d2 = (z2[:, None], None)
    ka = rng.integers(0, k1, n)
    kb = rng.integers(0, k2, n)
    x2 = rng.normal(size=n).astype(np.float32)
    x1 = (1.2 * z1[ka] - 0.8 * z2[kb] + 0.3 * x2).astype(np.float32)
    nn = np.zeros((n, 2), bool)
    miss = rng.choice(n, n // 4, replace=False)
    nn[miss, 0] = True
    fact = (np.stack([x1, x2], 1), rng.integers(0, 2, n)[:, None], nn,
            np.zeros((n, 1), bool))
    refs = [ref_from_numpy(*a) for a in (fact, d1, d2)]
    ports = [from_reference(r, device="cpu") for r in refs]
    out = run_mice_star(ports[0], [ka, kb], ports[1:], **MICE_KW)
    want = ref_star(refs[0], [ka, kb], refs[1:], **MICE_KW)
    np.testing.assert_allclose(out.num_data.numpy(),
                               np.asarray(want.num_data), rtol=0, atol=1e-4)
    r_star = float(np.sqrt(np.mean((out.num_data.numpy()[0, miss]
                                    - x1[miss]) ** 2)))
    r_mean = float(np.sqrt(np.mean((init_fill(ports[0]).num_data.numpy()
                                    [0, miss] - x1[miss]) ** 2)))
    assert r_star < 0.1 * r_mean, (r_star, r_mean)


@pytest.mark.parametrize("driver", ["factorized", "star"])
def test_dangling_fk_raises(star, driver):
    """A fact FK with no dimension row is an error in both packages (the
    −1 in the key → row map would gather the LAST row)."""
    _, fk, _, *_ = star
    ref_fact, ref_dim, fact, dim = _tables(star)
    dim_key = np.arange(dim.n_rows, dtype=np.int64) + 1
    bad_fk = fk.copy()
    bad_fk[0] = 0
    kw = dict(iters=1, linreg_iters=50, noise=False)
    calls = {
        "factorized": (lambda: run_mice_factorized(
            fact, bad_fk, dim, dim_key=dim_key, **kw),
            lambda: ref_factorized(ref_fact, bad_fk, ref_dim,
                                   dim_key=dim_key, **kw)),
        "star": (lambda: run_mice_star(fact, [bad_fk], [dim],
                                       dim_keys=[dim_key], **kw),
                 lambda: ref_star(ref_fact, [bad_fk], [ref_dim],
                                  dim_keys=[dim_key], **kw))}[driver]
    for call in calls:
        with pytest.raises(ValueError, match=r"dangling foreign keys .*\[0\]"):
            call()


@pytest.mark.parametrize("driver", ["factorized", "star"])
def test_non_unique_dim_key_raises(star, driver):
    """Two dimension rows with one key: prediction's gather is ambiguous,
    an error in both packages, with the same message."""
    _, fk, _, *_ = star
    ref_fact, ref_dim, fact, dim = _tables(star)
    dim_key = np.arange(dim.n_rows, dtype=np.int64)
    dim_key[1] = 0
    kw = dict(iters=1, linreg_iters=50, noise=False)
    calls = {
        "factorized": (lambda: run_mice_factorized(
            fact, fk, dim, dim_key=dim_key, **kw),
            lambda: ref_factorized(ref_fact, fk, ref_dim,
                                   dim_key=dim_key, **kw)),
        "star": (lambda: run_mice_star(fact, [fk], [dim],
                                       dim_keys=[dim_key], **kw),
                 lambda: ref_star(ref_fact, [fk], [ref_dim],
                                  dim_keys=[dim_key], **kw))}[driver]
    for call in calls:
        with pytest.raises(ValueError, match="dimension key must be unique"):
            call()
