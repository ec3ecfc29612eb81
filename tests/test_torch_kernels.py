"""The port's two Hopper kernels, K1 (masked_gram_cols) and K2
(fused_impute_aggregate): their plain versions against the JAX package's
Pallas kernels, run in interpret mode as tests/test_kernels.py runs them,
and the Philox noise of K2. On the card, tests/test_torch_cuda.py holds
each kernel against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.kernels import sigma_fused as ref_fused
from duckdb_imputation_tpu.ring.kernels.sigma_pallas import (
    sigma_pallas_fast_cols_padded,
)

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
    philox4x32_10,
    philox_normal,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols,
    masked_gram_cols_plain,
)

torch.set_num_threads(2)

KEYS = (tuple(range(8)), tuple(range(8)))
SCHEMA = FeatureSchema(num_cols=4, cat_keys=KEYS)      # BASELINE: P = 21
REF_SCHEMA = RefSchema(num_cols=4, cat_keys=KEYS)

# The Pallas kernels split every operand into bf16 hi + lo parts for the
# TPU's matrix unit, which leaves ~2⁻¹⁶ relative error per term: sums that
# cancel differ from exact f32 sums by up to ~1e-4 relative. Counts are
# exact on both sides. The port is held to 1e-5 against the f64 sums.
SPLIT_RTOL = 2e-4


def count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def sigma_f64(num, codes, w, schema):
    """Exact f64 masked sigma of features-first numpy inputs."""
    rows = [np.ones((1, num.shape[1]))] + [num.astype(np.float64)]
    for j, size in enumerate(schema.cat_sizes):
        rows.append((codes[j][None, :] == np.arange(size)[:, None]) * 1.0)
    zt = np.concatenate(rows)
    return (zt * w) @ zt.T


def make_inputs(n, seed, oov=False):
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(4, n)) * 2 + 0.5).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    if oov:
        codes[0, :500] = 8      # = size_0: the encode() miss convention
        codes[1, 500:900] = -1
    w = (rng.random(n) > 0.3).astype(np.float32)
    return num, codes, w


def port_cols(num, codes, device="cpu"):
    return ([torch.tensor(a, device=device) for a in num],
            [torch.tensor(a, device=device) for a in codes])


def ref_cols(num, codes):
    return (tuple(jnp.asarray(a) for a in num),
            tuple(jnp.asarray(a) for a in codes))


@pytest.mark.parametrize("n,oov", [(6000, False), (12_345, True)])
def test_masked_gram_cols_plain_matches_pallas(n, oov):
    """K1's plain version against sigma_pallas_fast_cols_padded (the v3
    Pallas kernel for this schema, interpret mode) on the BASELINE schema,
    and on a ragged n with out-of-vocab and negative codes."""
    num, codes, w = make_inputs(n, seed=5, oov=oov)
    got = masked_gram_cols(*port_cols(num, codes), torch.tensor(w),
                           schema=SCHEMA).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sigma_pallas_fast_cols_padded(
            *ref_cols(num, codes), jnp.asarray(w), schema=REF_SCHEMA,
            chunk_cols=512))
    exact = sigma_f64(num, codes, w, SCHEMA)
    cm = count_mask(SCHEMA)
    assert np.array_equal(got[cm], ref[cm])
    assert np.array_equal(got[cm], exact[cm])
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, ref, rtol=SPLIT_RTOL, atol=1e-6 * scale)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-7 * scale)


def test_masked_gram_cols_weights_none_and_column_checks():
    num, codes, _ = make_inputs(1000, seed=6)
    xs, cs = port_cols(num, codes)
    got = masked_gram_cols(xs, cs, None, schema=SCHEMA)
    want = masked_gram_cols_plain(xs, cs, torch.ones(1000), schema=SCHEMA)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        masked_gram_cols(xs[:3], cs, None, schema=SCHEMA)


def _fused_inputs(kind, seed=9, n=2560):
    """Inputs of one fused step; n is a multiple of the Pallas v3 block
    (pack 5 × chunk 128). Random coefficients in sigma layout with the
    label's own rows zeroed, as the MICE loops build them."""
    num, codes, _ = make_inputs(n, seed)
    rng = np.random.default_rng(seed + 1)
    null = rng.random(n) < 0.2
    w_agg = (rng.random(n) > 0.2).astype(np.float32)
    if kind == "cat":
        r, col = 8, 0
        w_full = rng.normal(size=(21, r)).astype(np.float32)
        w_full[0] = 0.0
        w_full[5:13] = 0.0
        icpt = rng.normal(size=r).astype(np.float32)
    else:
        r, col = 1, 1
        w_full = rng.normal(size=(21, r)).astype(np.float32)
        w_full[2] = 0.0
        icpt = np.zeros(r, np.float32)
    return num, codes, null, w_agg, w_full, icpt, r, col


@pytest.mark.parametrize("kind", ["cat", "num"])
def test_fused_impute_aggregate_plain_matches_pallas(kind):
    """K2's plain version against the JAX fused_impute_aggregate (interpret
    mode): codes equal; the column within rtol 1e-5 and an absolute 1e-5
    of the column's scale (the Pallas scorer is split precision: ~1e-7 of
    each term, and terms reach several times the result); sigma within the
    split-precision tolerance of the Pallas Gram, and within 1e-5 of the
    f64 sigma of the updated table."""
    num, codes, null, w_agg, w_full, icpt, r, col = _fused_inputs(kind)
    xs, cs = port_cols(num, codes)
    new, sig = fused_impute_aggregate(
        xs, cs, torch.tensor(null), torch.tensor(w_agg),
        torch.tensor(w_full), torch.tensor(icpt), schema=SCHEMA, kind=kind,
        imp_col=col)
    with pltpu.force_tpu_interpret_mode():
        lhs = ref_fused.pack_lhs(jnp.asarray(w_full), jnp.asarray(icpt),
                                 schema=REF_SCHEMA, n_rows=r)
        ref_new, ref_sig = ref_fused.fused_impute_aggregate(
            *ref_cols(num, codes), jnp.asarray(null.astype(np.float32)),
            jnp.asarray(w_agg), lhs, schema=REF_SCHEMA, kind=kind,
            imp_col=col, n_rows=r, chunk_cols=128)
        ref_new, ref_sig = np.asarray(ref_new), np.asarray(ref_sig)
    new, sig = new.numpy(), sig.numpy()
    num2, codes2 = num.copy(), codes.copy()
    if kind == "cat":
        np.testing.assert_array_equal(new, ref_new)
        assert new.dtype == np.int32
        np.testing.assert_array_equal(new[~null], codes[col][~null])
        codes2[col] = new
    else:
        np.testing.assert_allclose(new, ref_new, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref_new).max())
        np.testing.assert_array_equal(new[~null], num[col][~null])
        num2[col] = new
    exact = sigma_f64(num2, codes2, w_agg, SCHEMA)
    scale = np.abs(exact).max()
    cm = count_mask(SCHEMA)
    if kind == "cat":
        assert np.array_equal(sig[cm], exact[cm])
    np.testing.assert_allclose(sig, ref_sig, rtol=SPLIT_RTOL,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(sig, exact, rtol=1e-5, atol=1e-7 * scale)


def test_fused_impute_aggregate_rejects_bad_arguments():
    num, codes, null, w_agg, w_full, icpt, r, col = _fused_inputs("cat",
                                                                  n=64)
    xs, cs = port_cols(num, codes)
    args = (xs, cs, torch.tensor(null), torch.tensor(w_agg),
            torch.tensor(w_full), torch.tensor(icpt))
    with pytest.raises(ValueError):
        fused_impute_aggregate(*args, schema=SCHEMA, kind="bad", imp_col=0)
    with pytest.raises(ValueError):       # noise is for numeric columns
        fused_impute_aggregate(*args, schema=SCHEMA, kind="cat", imp_col=0,
                               noise=(1, 0, torch.tensor(1.0)))


# Known-answer vectors of Philox4x32-10 (Random123's kat_vectors):
# (counter, key) -> output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    """The int64 torch Philox is the standard Philox4x32-10, in both its
    tensor and its scalar forms."""
    got = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), key)
    assert tuple(int(g[0]) for g in got) == want
    assert philox4x32_10(ctr, key) == want


def test_philox_normal_deterministic_and_keyed():
    n = 4096
    a = philox_normal(7, 3, 1, n)
    assert a.dtype == torch.float32 and a.shape == (n,)
    assert torch.equal(a, philox_normal(7, 3, 1, n))
    for other in (philox_normal(8, 3, 1, n), philox_normal(7, 4, 1, n),
                  philox_normal(7, 3, 2, n), philox_normal(7 + (1 << 32), 3,
                                                           1, n)):
        assert not torch.equal(a, other)
    # a row's draw depends on its global index only, not on n
    assert torch.equal(philox_normal(7, 3, 1, 100), a[:100])


def test_philox_normal_moments():
    z = philox_normal(12345, 0, 0, 200_000).double()
    assert torch.isfinite(z).all()
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    assert abs(float((z ** 3).mean())) < 0.03
    assert abs(float((z ** 4).mean()) - 3.0) < 0.06


def test_fused_noise_lands_only_on_null_cells():
    num, codes, null, w_agg, w_full, icpt, r, col = _fused_inputs("num")
    xs, cs = port_cols(num, codes)
    args = (xs, cs, torch.tensor(null), torch.tensor(w_agg),
            torch.tensor(w_full), torch.tensor(icpt))
    kw = dict(schema=SCHEMA, kind="num", imp_col=col)
    clean, _ = fused_impute_aggregate(*args, **kw)
    std = torch.tensor(0.5)
    noisy, _ = fused_impute_aggregate(*args, noise=(3, 2, std), **kw)
    again, _ = fused_impute_aggregate(*args, noise=(3, 2, std), **kw)
    assert torch.equal(noisy, again)
    m = torch.tensor(null)
    assert torch.equal(noisy[~m], clean[~m])
    assert torch.equal(noisy[~m], xs[col][~m])
    want = 0.5 * philox_normal(3, 2, col, len(null))[m]
    torch.testing.assert_close(noisy[m] - clean[m], want, rtol=1e-5,
                               atol=1e-5)
