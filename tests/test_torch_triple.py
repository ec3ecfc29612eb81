"""The torch port's triples (ring/triple.py) and `sum_to_triple`, held
against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring import triple as ref_triple

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.triple import (
    NBAgg,
    Triple,
    nb_agg_from_reference,
    sigma_from_triple,
    triple_add,
    triple_from_reference,
    triple_from_sigma,
    triple_scale,
    triple_sub,
)

torch.set_num_threads(2)

KEYS = (tuple(range(8)), tuple(range(8)))
SCHEMA = FeatureSchema(num_cols=4, cat_keys=KEYS)      # BASELINE: P = 21
REF_SCHEMA = RefSchema(num_cols=4, cat_keys=KEYS)
FIELDS = ("n", "lin", "quad", "lin_cat", "num_cat", "cat_cat")


def make_inputs(n, seed):
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(4, n)) * 2 + 0.5).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    codes[0, :n // 20] = 8                 # out of vocab: adds no one-hot
    w = (rng.random(n) > 0.3).astype(np.float32)
    return num, codes, w


@pytest.mark.parametrize("batch", [(), (3,)])
def test_sigma_triple_round_trip(batch):
    """triple_from_sigma ∘ sigma_from_triple is the identity, with and
    without a leading group axis, and matches the JAX assembly."""
    rng = np.random.default_rng(1)
    p = SCHEMA.sigma_size
    a = rng.normal(size=batch + (p, p)).astype(np.float32)
    sigma = a + np.swapaxes(a, -1, -2)
    t = triple_from_sigma(torch.tensor(sigma), SCHEMA.num_cols)
    assert t.d == 4 and t.v == 16
    back = sigma_from_triple(t).numpy()
    np.testing.assert_array_equal(back, sigma)
    ref = np.asarray(ref_triple.sigma_from_triple(
        ref_triple.triple_from_sigma(jnp.asarray(sigma), 4)))
    np.testing.assert_array_equal(back, ref)


def test_ring_ops_match_reference():
    rng = np.random.default_rng(2)
    p = SCHEMA.sigma_size
    s1, s2 = (rng.normal(size=(p, p)).astype(np.float32) for _ in range(2))
    a, b = (triple_from_sigma(torch.tensor(s), 4) for s in (s1, s2))
    ra, rb = (ref_triple.triple_from_sigma(jnp.asarray(s), 4)
              for s in (s1, s2))
    for got, want in ((triple_add(a, b), ref_triple.triple_add(ra, rb)),
                      (a - b, ref_triple.triple_sub(ra, rb)),
                      (triple_sub(a, b), ra - rb),
                      (triple_scale(a, 2.5), ref_triple.triple_scale(ra, 2.5)),
                      (a + b, ra + rb)):
        assert isinstance(got, Triple)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6)
    z = Triple.zeros(SCHEMA, batch=(2,), device="cpu")
    assert z.quad.shape == (2, 4, 4) and z.cat_cat.shape == (2, 16, 16)
    nz = NBAgg.zeros(SCHEMA, device="cpu")
    assert (nz + nz).quad_diag.shape == (4,)


def test_sum_to_triple_plain_matches_reference():
    """sum_to_triple(backend='plain') against JAX sum_to_triple: counts
    exact, the rest within rtol 1e-5 of max|σ|; the JAX triple carried
    over by triple_from_reference agrees the same way."""
    num, codes, w = make_inputs(30_000, seed=3)
    got = port_sum.sum_to_triple(torch.tensor(num), torch.tensor(codes),
                                 torch.tensor(w), schema=SCHEMA,
                                 backend="plain")
    ref = ref_sum.sum_to_triple(num, codes, w, schema=REF_SCHEMA,
                                backend="xla")
    carried = triple_from_reference(ref, device="cpu")
    scale = float(np.abs(np.asarray(ref.quad)).max())
    for f in FIELDS:
        g, want, c = (getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                      getattr(carried, f).numpy())
        np.testing.assert_array_equal(c, want)
        if f in ("n", "lin_cat", "cat_cat"):
            np.testing.assert_array_equal(g, want)
        else:
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * scale)
    assert float(got.n) == w.sum()


def test_sum_to_triple_backends_and_columns():
    """'auto' and 'kernel' on CPU tensors take the plain version (the
    kernel wrapper's CPU route); None blocks and weights are allowed."""
    num, codes, w = make_inputs(5000, seed=4)
    x, c, wt = torch.tensor(num), torch.tensor(codes), torch.tensor(w)
    plain = port_sum.sum_to_triple(x, c, wt, schema=SCHEMA, backend="plain")
    for backend in ("auto", "kernel"):
        got = port_sum.sum_to_triple(x, c, wt, schema=SCHEMA,
                                     backend=backend)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(plain, f))
    only_num = port_sum.sum_to_triple(x, None, None,
                                      schema=FeatureSchema(num_cols=4))
    ref = ref_sum.sum_to_triple(num, None, None,
                                schema=RefSchema(num_cols=4), backend="xla")
    np.testing.assert_allclose(only_num.quad.numpy(), np.asarray(ref.quad),
                               rtol=1e-5)
    assert float(only_num.n) == 5000
    with pytest.raises(ValueError):
        port_sum.sum_to_triple(x, c, wt, schema=SCHEMA, backend="pallas")


def test_nb_agg_from_reference():
    num, codes, w = make_inputs(4000, seed=5)
    g = (np.arange(4000) % 3).astype(np.int32)
    ref = ref_sum.sum_to_nb_agg_grouped(num, codes, g, schema=REF_SCHEMA,
                                        num_groups=3, weights=w,
                                        backend="xla")
    got = nb_agg_from_reference(ref, device="cpu")
    assert isinstance(got, NBAgg) and got.d == 4
    for f in ("n", "lin", "quad_diag", "lin_cat"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_lift_and_sum_match_reference():
    """lift / nb_lift row by row against JAX, and their sums against the
    fused aggregates (sum_triples ∘ lift = sum_to_triple)."""
    num, codes, _ = make_inputs(300, seed=6)
    x, c = torch.tensor(num), torch.tensor(codes)
    got = port_sum.lift(x, c, schema=SCHEMA)
    ref = ref_sum.lift(num, codes, schema=REF_SCHEMA)
    assert got.quad.shape == (300, 4, 4) and got.cat_cat.shape == (300, 16, 16)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6)
    total = port_sum.sum_triples(got)
    fused = port_sum.sum_to_triple(x, c, None, schema=SCHEMA)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(total, f).numpy(),
                                   getattr(fused, f).numpy(), rtol=1e-5,
                                   atol=1e-4)
    nb = port_sum.nb_lift(x, c, schema=SCHEMA)
    rnb = ref_sum.nb_lift(num, codes, schema=REF_SCHEMA)
    for f in ("n", "lin", "quad_diag", "lin_cat"):
        np.testing.assert_allclose(getattr(nb, f).numpy(),
                                   np.asarray(getattr(rnb, f)), rtol=1e-6)
    nb_total = port_sum.sum_nb_aggs(nb)
    nb_fused = port_sum.sum_to_nb_agg(x, c, None, schema=SCHEMA)
    for f in ("n", "lin", "quad_diag", "lin_cat"):
        np.testing.assert_allclose(getattr(nb_total, f).numpy(),
                                   getattr(nb_fused, f).numpy(), rtol=1e-5,
                                   atol=1e-4)
