"""The port's `ring.serialize` against the JAX package's on the same
seeded numpy inputs: the reference's nested dicts of a triple and of an NB
aggregate are equal, value for value, for both field-name styles (the
port's aggregate carried over from the JAX one, so the same f32 values go
in); dict → dense → dict round trips are the identity (test_ring_
properties.py's case on the port); `align_triple` / `align_nb` scatter
into a superset vocab exactly as JAX's do, batched triples included."""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.ring import serialize as ref_ser
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.schema import FeatureSchema as RefSchema

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import serialize as ser
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.triple import (nb_agg_from_reference,
                                                     triple_from_reference)

from test_ring_properties import _rand_data, _rand_schema

torch.set_num_threads(2)

TRIPLE_FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")
NB_FIELDS = ("n", "lin", "quad_diag", "lin_cat")


def _port_schema(s: RefSchema) -> FeatureSchema:
    return FeatureSchema(num_cols=s.num_cols, cat_keys=s.cat_keys)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("style", ["agg", "num"])
def test_dicts_match_reference(style):
    """Random schemas and normal data, each group of a grouped aggregate
    (a group sees a subset of the vocab: absent keys are left out)."""
    rng = np.random.default_rng(500)
    for trial in range(6):
        schema = _rand_schema(rng)
        n = int(rng.integers(1, 40))
        x, c = _rand_data(rng, schema, n)
        x = x + rng.normal(size=x.shape).astype(np.float32)
        g = rng.integers(0, 3, n).astype(np.int32)
        ref = ref_sum.sum_to_triple_grouped(x, c, g, schema=schema,
                                            num_groups=3)
        got = triple_from_reference(ref, device="cpu")
        nb_ref = ref_sum.sum_to_nb_agg_grouped(x, c, g, schema=schema,
                                               num_groups=3)
        nb_got = nb_agg_from_reference(nb_ref, device="cpu")
        ps = _port_schema(schema)
        for k in range(3):
            want = ref_ser.triple_to_dict(
                type(ref)(**{f: np.asarray(getattr(ref, f))[k]
                             for f in TRIPLE_FIELDS}), schema, style)
            have = ser.triple_to_dict(
                type(got)(**{f: getattr(got, f)[k] for f in TRIPLE_FIELDS}),
                ps, style)
            assert have == want, (trial, k)
            want = ref_ser.nb_to_dict(
                type(nb_ref)(**{f: np.asarray(getattr(nb_ref, f))[k]
                                for f in NB_FIELDS}), schema, style)
            have = ser.nb_to_dict(
                type(nb_got)(**{f: getattr(nb_got, f)[k]
                                for f in NB_FIELDS}), ps, style)
            assert have == want, (trial, k)


def test_pack_upper_matches_reference():
    rng = np.random.default_rng(501)
    for d in (0, 1, 2, 5):
        a = rng.normal(size=(d, d)).astype(np.float32)
        q = a + a.T
        packed = ser.pack_upper(torch.tensor(q))
        assert packed == ref_ser.pack_upper(q)
        np.testing.assert_array_equal(ser.unpack_upper(packed, d),
                                      ref_ser.unpack_upper(packed, d))


def test_bad_style_raises():
    schema = FeatureSchema(num_cols=1)
    t = port_sum.sum_to_triple(torch.ones((1, 3)), None, None, schema=schema)
    with pytest.raises(ValueError, match="style"):
        ser.triple_to_dict(t, schema, style="sum")


def test_serialize_round_trip_random():
    """test_ring_properties.py's round trip on the port: exact, with and
    without a given schema (a dict's own keys rebuild the schema when
    every key is present)."""
    rng = np.random.default_rng(106)
    for trial in range(12):
        schema = _rand_schema(rng)
        ps = _port_schema(schema)
        n = int(rng.integers(1, 40))
        x, c = _rand_data(rng, schema, n)
        x, c = _t(x), _t(c, torch.int32)
        t = port_sum.sum_to_triple(x, c, None, schema=ps)
        t2, s2 = ser.dict_to_triple(ser.triple_to_dict(t, ps), ps,
                                    device="cpu")
        assert s2 == ps
        for f in TRIPLE_FIELDS:
            np.testing.assert_array_equal(getattr(t2, f).numpy(),
                                          getattr(t, f).numpy(),
                                          err_msg=f"t{trial}:{f}")
        nb = port_sum.sum_to_nb_agg(x, c, None, schema=ps)
        nb2, s3 = ser.dict_to_nb(ser.nb_to_dict(nb, ps, "num"), ps,
                                 device="cpu")
        assert s3 == ps
        for f in NB_FIELDS:
            np.testing.assert_array_equal(getattr(nb2, f).numpy(),
                                          getattr(nb, f).numpy(),
                                          err_msg=f"nb t{trial}:{f}")


def test_dict_to_triple_infers_the_schema_like_the_reference(
        ring_test_table):
    """No schema given: both packages rebuild it from the dict's keys, and
    the dense sections agree."""
    _, num, cat = ring_test_table
    schema = RefSchema.infer(num, cat)
    d = ref_ser.triple_to_dict(ref_sum.sum_to_triple(
        num.T, schema.encode(cat).T, None, schema=schema), schema)
    want, ws = ref_ser.dict_to_triple(d)
    got, gs = ser.dict_to_triple(d, device="cpu")
    assert gs.cat_keys == ws.cat_keys and gs.num_cols == ws.num_cols
    for f in TRIPLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    nd = ref_ser.nb_to_dict(ref_sum.sum_to_nb_agg(
        num.T, schema.encode(cat).T, None, schema=schema), schema)
    want, ws = ref_ser.dict_to_nb(nd)
    got, gs = ser.dict_to_nb(nd, device="cpu")
    assert gs.cat_keys == ws.cat_keys
    for f in NB_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("batched", [False, True])
def test_align_matches_reference(batched):
    """Scatter into the union vocab of two schemas (keys interleaved), a
    batched triple's leading axis kept; the same schema returns the input."""
    rng = np.random.default_rng(502)
    small = RefSchema(num_cols=2, cat_keys=((1, 5), (0, 3, 7)))
    target = RefSchema(num_cols=2, cat_keys=((0, 1, 4, 5), (0, 2, 3, 7, 9)))
    x, c = _rand_data(rng, small, 30)
    if batched:
        g = rng.integers(0, 3, 30).astype(np.int32)
        ref = ref_sum.sum_to_triple_grouped(x, c, g, schema=small,
                                            num_groups=3)
        nb_ref = ref_sum.sum_to_nb_agg_grouped(x, c, g, schema=small,
                                               num_groups=3)
    else:
        ref = ref_sum.sum_to_triple(x, c, None, schema=small)
        nb_ref = ref_sum.sum_to_nb_agg(x, c, None, schema=small)
    ps, pt = _port_schema(small), _port_schema(target)
    got = ser.align_triple(triple_from_reference(ref, device="cpu"), ps, pt)
    want = ref_ser.align_triple(ref, small, target)
    for f in TRIPLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    got = ser.align_nb(nb_agg_from_reference(nb_ref, device="cpu"), ps, pt)
    want = ref_ser.align_nb(nb_ref, small, target)
    for f in NB_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    same = triple_from_reference(ref, device="cpu")
    assert ser.align_triple(same, ps, ps) is same


def test_dict_to_triple_builds_on_the_device_asked_for():
    """dict_to_triple / dict_to_nb default to the card: on a machine
    without CUDA that raises rather than quietly building on the CPU."""
    schema = FeatureSchema(num_cols=1, cat_keys=((2, 3),))
    t = port_sum.sum_to_triple(torch.ones((1, 4)),
                               torch.tensor([[0, 1, 1, 0]], dtype=torch.int32),
                               None, schema=schema)
    d = ser.triple_to_dict(t, schema)
    got, _ = ser.dict_to_triple(d, schema, device="cpu")
    assert got.cat_cat.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ser.dict_to_triple(d, schema)
