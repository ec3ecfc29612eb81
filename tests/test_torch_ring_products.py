"""The port's ring products (`ring.triple`: triple_multiply, nb_multiply,
factorized_join_sum, factorized_join_sum_nb) and `ring.sum.onehot_block`
against the JAX package on the same seeded numpy inputs, and the ring laws
of tests/test_ring_properties.py on the port.

Tolerances: the products are one f32 multiply an entry in both packages,
so they agree to rtol 1e-6 (exactly, in practice). The join sums contract
over the key axis in f64 and round once where JAX sums in f32: rtol 1e-6
and an atol of 1e-6 of the section's largest value. On the dyadic grid of
test_ring_properties.py every f32 ring sum and product is exact, so the
laws hold with array_equal."""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring import triple as ref_triple
from duckdb_imputation_tpu.schema import FeatureSchema as RefSchema

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring import triple as port_triple
from duckdb_imputation_tpu_torch.ring.triple import (
    NBAgg, Triple, factorized_join_sum, factorized_join_sum_nb, nb_multiply,
    triple_add, triple_multiply)

from test_ring_properties import _rand_data, _rand_schema

torch.set_num_threads(2)

TRIPLE_FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")
NB_FIELDS = ("n", "lin", "quad_diag", "lin_cat")
N_TRIALS = 12


def _port_schema(s: RefSchema) -> FeatureSchema:
    return FeatureSchema(num_cols=s.num_cols, cat_keys=s.cat_keys)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _port_of(ref, cls):
    """A JAX aggregate as the port's, on the CPU."""
    return cls(**{f: _t(getattr(ref, f)) for f in
                  (TRIPLE_FIELDS if cls is Triple else NB_FIELDS)})


def _assert_close(got, want, fields, rtol=1e-6, scaled_atol=0.0, msg=""):
    for f in fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (msg, f, g.shape, w.shape)
        atol = scaled_atol * float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{msg}:{f}")


def _assert_equal(a, b, fields, msg=""):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(),
                                      err_msg=f"{msg}:{f}")


def _normal_data(rng, schema, n):
    x = rng.normal(size=(schema.num_cols, n)).astype(np.float32)
    codes = (np.stack([rng.integers(0, len(k), size=n)
                       for k in schema.cat_keys]).astype(np.int32)
             if schema.cat_cols else np.zeros((0, n), np.int32))
    return x, codes


def _both(x, codes, schema, *, nb=False, group_ids=None, num_groups=None):
    """The same aggregate from the JAX package and from the port (CPU)."""
    ps = _port_schema(schema)
    if group_ids is None:
        if nb:
            ref = ref_sum.sum_to_nb_agg(x, codes, None, schema=schema)
            got = port_sum.sum_to_nb_agg(_t(x), _t(codes, torch.int32), None,
                                         schema=ps)
        else:
            ref = ref_sum.sum_to_triple(x, codes, None, schema=schema)
            got = port_sum.sum_to_triple(_t(x), _t(codes, torch.int32), None,
                                         schema=ps)
        return ref, got
    g = group_ids.astype(np.int32)
    if nb:
        ref = ref_sum.sum_to_nb_agg_grouped(x, codes, g, schema=schema,
                                            num_groups=num_groups)
        got = port_sum.sum_to_nb_agg_grouped(
            _t(x), _t(codes, torch.int32), _t(g, torch.int32), schema=ps,
            num_groups=num_groups)
    else:
        ref = ref_sum.sum_to_triple_grouped(x, codes, g, schema=schema,
                                            num_groups=num_groups)
        got = port_sum.sum_to_triple_grouped(
            _t(x), _t(codes, torch.int32), _t(g, torch.int32), schema=ps,
            num_groups=num_groups)
    return ref, got


@pytest.mark.parametrize("seed", range(4))
def test_products_match_reference(seed):
    """triple_multiply and nb_multiply of normal data against JAX's, on
    the JAX aggregates carried over (so only the product is compared)."""
    rng = np.random.default_rng(200 + seed)
    for trial in range(4):
        sa, sb = _rand_schema(rng), _rand_schema(rng, allow_empty=False)
        xa, ca = _normal_data(rng, sa, int(rng.integers(1, 30)))
        xb, cb = _normal_data(rng, sb, int(rng.integers(1, 30)))
        ta = ref_sum.sum_to_triple(xa, ca, None, schema=sa)
        tb = ref_sum.sum_to_triple(xb, cb, None, schema=sb)
        want = ref_triple.triple_multiply(ta, tb)
        got = triple_multiply(_port_of(ta, Triple), _port_of(tb, Triple))
        _assert_close(got, want, TRIPLE_FIELDS, msg=f"t{trial}")
        na = ref_sum.sum_to_nb_agg(xa, ca, None, schema=sa)
        nb = ref_sum.sum_to_nb_agg(xb, cb, None, schema=sb)
        want = ref_triple.nb_multiply(na, nb)
        got = nb_multiply(_port_of(na, NBAgg), _port_of(nb, NBAgg))
        _assert_close(got, want, NB_FIELDS, msg=f"nb t{trial}")


@pytest.mark.parametrize("seed", range(4))
def test_join_sums_match_reference(seed):
    """factorized_join_sum(_nb) of per-key aggregates (empty keys
    included) against JAX's, each side aggregated by its own package."""
    rng = np.random.default_rng(300 + seed)
    for trial in range(3):
        sa, sb = _rand_schema(rng), _rand_schema(rng, allow_empty=False)
        keys = int(rng.integers(1, 9))
        na, nb = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        xa, ca = _normal_data(rng, sa, na)
        xb, cb = _normal_data(rng, sb, nb)
        ga, gb = rng.integers(0, keys, na), rng.integers(0, keys, nb)
        ra, pa = _both(xa, ca, sa, group_ids=ga, num_groups=keys)
        rb, pb = _both(xb, cb, sb, group_ids=gb, num_groups=keys)
        _assert_close(factorized_join_sum(pa, pb),
                      ref_triple.factorized_join_sum(ra, rb), TRIPLE_FIELDS,
                      scaled_atol=1e-6, msg=f"t{trial}")
        ra, pa = _both(xa, ca, sa, nb=True, group_ids=ga, num_groups=keys)
        rb, pb = _both(xb, cb, sb, nb=True, group_ids=gb, num_groups=keys)
        _assert_close(factorized_join_sum_nb(pa, pb),
                      ref_triple.factorized_join_sum_nb(ra, rb), NB_FIELDS,
                      scaled_atol=1e-6, msg=f"nb t{trial}")


def _materialized_product(xa, ca, xb, cb, sa, sb):
    """The port's triple over the CROSS JOIN of two row sets, the ground
    truth of triple_multiply (with a single key a join is the cross
    product)."""
    na, nb = xa.shape[-1], xb.shape[-1]
    ia, ib = np.repeat(np.arange(na), nb), np.tile(np.arange(nb), na)
    x = np.concatenate([xa[:, ia], xb[:, ib]], axis=0)
    c = np.concatenate([ca[:, ia], cb[:, ib]], axis=0)
    return port_sum.sum_to_triple(_t(x), _t(c, torch.int32), None,
                                  schema=_port_schema(sa.concat(sb)))


def test_multiply_matches_materialized_cross_join():
    """test_ring_properties.py's case on the port: exact on the dyadic
    grid."""
    rng = np.random.default_rng(102)
    for trial in range(N_TRIALS):
        sa, sb = _rand_schema(rng), _rand_schema(rng, allow_empty=False)
        na, nb = int(rng.integers(1, 12)), int(rng.integers(1, 12))
        xa, ca = _rand_data(rng, sa, na)
        xb, cb = _rand_data(rng, sb, nb)
        ta = port_sum.sum_to_triple(_t(xa), _t(ca, torch.int32), None,
                                    schema=_port_schema(sa))
        tb = port_sum.sum_to_triple(_t(xb), _t(cb, torch.int32), None,
                                    schema=_port_schema(sb))
        _assert_equal(triple_multiply(ta, tb),
                      _materialized_product(xa, ca, xb, cb, sa, sb),
                      TRIPLE_FIELDS, f"t{trial}")


def test_multiply_is_bilinear():
    """(a1 + a2)·b == a1·b + a2·b for triples and NB aggregates, exact on
    the dyadic grid (test_ring_properties.py's case on the port)."""
    rng = np.random.default_rng(103)
    for trial in range(N_TRIALS):
        sa, sb = _rand_schema(rng), _rand_schema(rng, allow_empty=False)
        pa, pb = _port_schema(sa), _port_schema(sb)
        data = [_rand_data(rng, s, int(rng.integers(1, 15)))
                for s in (sa, sa, sb)]
        (xa1, ca1), (xa2, ca2), (xb, cb) = [(_t(x), _t(c, torch.int32))
                                            for x, c in data]
        a1 = port_sum.sum_to_triple(xa1, ca1, None, schema=pa)
        a2 = port_sum.sum_to_triple(xa2, ca2, None, schema=pa)
        b = port_sum.sum_to_triple(xb, cb, None, schema=pb)
        _assert_equal(triple_multiply(triple_add(a1, a2), b),
                      triple_add(triple_multiply(a1, b),
                                 triple_multiply(a2, b)),
                      TRIPLE_FIELDS, f"t{trial}")
        n1 = port_sum.sum_to_nb_agg(xa1, ca1, None, schema=pa)
        n2 = port_sum.sum_to_nb_agg(xa2, ca2, None, schema=pa)
        nb_ = port_sum.sum_to_nb_agg(xb, cb, None, schema=pb)
        _assert_equal(nb_multiply(n1 + n2, nb_),
                      nb_multiply(n1, nb_) + nb_multiply(n2, nb_),
                      NB_FIELDS, f"nb t{trial}")


def test_join_sum_is_the_f64_sum_of_per_key_products():
    """factorized_join_sum equals Σ_g triple_multiply(a[g], b[g]) formed
    and summed in f64 and rounded once, to one f32 rounding (rtol 2⁻²³, atol 1e-9 of the section's largest
value):
    the contraction never forms the [G, m, m] products but computes the
    same sum. Large counts (keys of ~10⁴ rows on one side) make an f32
    running sum of the products lose digits that the contraction keeps."""
    rng = np.random.default_rng(7)
    keys = 6
    sa = RefSchema(num_cols=2, cat_keys=((0, 2, 4),))
    sb = RefSchema(num_cols=1, cat_keys=((10, 11),))
    xa, ca = _normal_data(rng, sa, 60_000)
    xb, cb = _normal_data(rng, sb, 40)
    xa += 100.0
    ga, gb = rng.integers(0, keys, 60_000), rng.integers(0, keys, 40)
    _, a = _both(xa, ca, sa, group_ids=ga, num_groups=keys)
    _, b = _both(xb, cb, sb, group_ids=gb, num_groups=keys)
    a64 = port_triple._map(lambda t: t.double(), a)
    b64 = port_triple._map(lambda t: t.double(), b)
    total = None
    for k in range(keys):
        prod = triple_multiply(port_triple._map(lambda t: t[k], a64),
                               port_triple._map(lambda t: t[k], b64))
        total = prod if total is None else triple_add(total, prod)
    want = port_triple._map(lambda t: t.float(), total)
    _assert_close(factorized_join_sum(a, b), want, TRIPLE_FIELDS,
                  rtol=2.0 ** -23, scaled_atol=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_onehot_block_matches_reference(seed):
    """Row-major one-hot f32[n, V] from codes i32[n, c], out-of-vocab and
    negative codes included (all-zero rows for that column)."""
    rng = np.random.default_rng(400 + seed)
    schema = _rand_schema(rng, allow_empty=False)
    if not schema.cat_cols:
        schema = RefSchema(num_cols=1, cat_keys=((1, 5, 9),))
    codes = np.stack([rng.integers(-1, len(k) + 2, size=50)
                      for k in schema.cat_keys], 1).astype(np.int32)
    want = np.asarray(ref_sum.onehot_block(codes, schema))
    got = port_sum.onehot_block(_t(codes, torch.int32),
                                _port_schema(schema)).numpy()
    assert got.shape == (50, schema.vocab_size)
    np.testing.assert_array_equal(got, want)
