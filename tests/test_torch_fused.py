"""The arithmetic of the port's redesigned fused pass on the CPU.

K2 (csrc/fused_impute_aggregate.cu) runs on K1's tensor-core kernel
(csrc/tc_gram.cuh) with an impute prologue where S is its one output tile:
`fused_impute_aggregate_split_plain` repeats that arithmetic (the column
imputed in class_score's f32 order, then the Gram of three-way bf16 parts
of the updated columns). K2w's 'cat' impute kernel scores the null rows
against W's class tiles in shared memory (`_build.impute_plan`) and merges
each tile's first max into the row's running one: `class_argmax_tiles_plain`
repeats that merge. Both are held against the JAX package (its Pallas
kernels in interpret mode, as tests/test_kernels.py runs them, and its
class_argmax) on inputs made from a numpy seed. On the card,
tests/test_torch_cuda.py holds the kernels against their plain versions.

Tolerances: codes equal; sigma within 1e-5 of max|σ| of the f64 sigma of
the updated table (the split Gram is exact to f32 accumulation), and
within the split-precision tolerance of the Pallas Gram; numeric values
within 1e-4 of the Pallas pass's (its scorer is split precision).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.kernels import sigma_fused as ref_fused
from duckdb_imputation_tpu.ring.sum import class_argmax as ref_class_argmax

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    class_argmax_tiles_plain,
    fused_impute_aggregate,
    fused_impute_aggregate_split_plain,
    score_key_plain,
)
from duckdb_imputation_tpu_torch.ring.sum import class_argmax

from test_torch_classify_wide import _cxx_constants

torch.set_num_threads(2)

SPLIT_RTOL = 2e-4   # the Pallas Gram's bf16 hi/lo split (test_torch_kernels)

# (d, vocabularies): BASELINE config 5 (P = 21) and a schema at the edge of
# the tensor cores' one output tile, 1 + 3d + V = 32 (d = 6, V = 13, P = 20)
TC_SCHEMAS = {"P21": (4, (8, 8)), "edge": (6, (8, 5))}
FAVORITA_VOCABS = (54, 33, 337, 2, 2, 22, 16, 5, 17)


def _schemas(d, vocabs):
    keys = tuple(tuple(range(v)) for v in vocabs)
    return FeatureSchema(num_cols=d, cat_keys=keys), RefSchema(
        num_cols=d, cat_keys=keys)


def sigma_f64(num, codes, w, schema):
    rows = [np.ones((1, num.shape[1]))] + [num.astype(np.float64)]
    for j, size in enumerate(schema.cat_sizes):
        rows.append((codes[j][None, :] == np.arange(size)[:, None]) * 1.0)
    zt = np.concatenate(rows)
    return (zt * w) @ zt.T


def count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def test_tc_schemas_take_the_tensor_cores():
    for d, vocabs in TC_SCHEMAS.values():
        schema, _ = _schemas(d, vocabs)
        assert _build.tc_fits(d, schema.sigma_size)
    d, vocabs = TC_SCHEMAS["edge"]
    assert 1 + 3 * d + sum(vocabs) == _build.TC_RIGHT
    assert not _build.tc_fits(d, 1 + d + sum(vocabs) + 1)   # one more code
    assert not _build.tc_fits(24, 88)


@pytest.mark.parametrize("kind", ["cat", "num"])
@pytest.mark.parametrize("name", sorted(TC_SCHEMAS))
def test_fused_split_plain_matches_pallas(name, kind):
    """K2's tensor-core arithmetic against the JAX fused_impute_aggregate
    (interpret mode) at config 5 and at the tile's edge: codes equal (the
    non-null ones unchanged), numerics within 1e-4; sigma within the
    split-precision tolerance of the Pallas Gram, and within 1e-5 of
    max|σ| of the f64 sigma of the updated table, counts exact."""
    d, vocabs = TC_SCHEMAS[name]
    schema, rschema = _schemas(d, vocabs)
    p, n = schema.sigma_size, 2560
    rng = np.random.default_rng(21 + d)
    num = (rng.normal(size=(d, n)) * 2 + 0.5).astype(np.float32)
    codes = np.stack([rng.integers(0, v, n) for v in vocabs]).astype(np.int32)
    null = rng.random(n) < 0.2
    w_agg = (rng.random(n) > 0.2).astype(np.float32)
    if kind == "cat":
        r, col = vocabs[0], 0
        w_full = rng.normal(size=(p, r)).astype(np.float32)
        w_full[1 + d:1 + d + r] = 0.0            # the label's own one-hot
        icpt = rng.normal(size=r).astype(np.float32)
    else:
        r, col = 1, 1
        w_full = rng.normal(size=(p, r)).astype(np.float32)
        w_full[1 + col] = 0.0
        icpt = np.zeros(1, np.float32)
    new, sig = fused_impute_aggregate_split_plain(
        [torch.tensor(a) for a in num], [torch.tensor(a) for a in codes],
        torch.tensor(null), torch.tensor(w_agg), torch.tensor(w_full),
        torch.tensor(icpt), schema=schema, kind=kind, imp_col=col)
    with pltpu.force_tpu_interpret_mode():
        lhs = ref_fused.pack_lhs(jnp.asarray(w_full), jnp.asarray(icpt),
                                 schema=rschema, n_rows=r)
        ref_new, ref_sig = ref_fused.fused_impute_aggregate(
            tuple(jnp.asarray(a) for a in num),
            tuple(jnp.asarray(a) for a in codes),
            jnp.asarray(null.astype(np.float32)), jnp.asarray(w_agg), lhs,
            schema=rschema, kind=kind, imp_col=col, n_rows=r,
            chunk_cols=128)
        ref_new, ref_sig = np.asarray(ref_new), np.asarray(ref_sig)
    new, sig = new.numpy(), sig.numpy()
    num2, codes2 = num.copy(), codes.copy()
    if kind == "cat":
        np.testing.assert_array_equal(new, ref_new)
        np.testing.assert_array_equal(new[~null], codes[col][~null])
        codes2[col] = new
    else:
        np.testing.assert_allclose(new, ref_new, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(new[~null], num[col][~null])
        num2[col] = new
    exact = sigma_f64(num2, codes2, w_agg, schema)
    scale = np.abs(exact).max()
    cm = count_mask(schema)
    assert np.array_equal(sig[cm], exact[cm])
    np.testing.assert_allclose(sig, exact, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(sig, ref_sig, rtol=SPLIT_RTOL,
                               atol=1e-6 * scale)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper's column equals the split arithmetic's,
    and its sigma agrees with the split Gram within 1e-5 of max|σ|."""
    d, vocabs = TC_SCHEMAS["P21"]
    schema, _ = _schemas(d, vocabs)
    rng = np.random.default_rng(3)
    n = 3000
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32))
          for _ in range(d)]
    cs = [torch.tensor(rng.integers(-1, v + 1, n).astype(np.int32))
          for v in vocabs]
    null = torch.tensor(rng.random(n) < 0.3)
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32))
    w_full = torch.tensor(rng.normal(size=(21, 8)).astype(np.float32))
    icpt = torch.tensor(rng.normal(size=8).astype(np.float32))
    args = (xs, cs, null, w, w_full, icpt)
    kw = dict(schema=schema, kind="cat", imp_col=0)
    new, sig = fused_impute_aggregate(*args, **kw)
    new_s, sig_s = fused_impute_aggregate_split_plain(*args, **kw)
    assert torch.equal(new, new_s)
    torch.testing.assert_close(sig, sig_s, rtol=0,
                               atol=1e-5 * float(sig_s.abs().max()))


# ---------------------------------------------------------------------------
# K2w: the class-tiled first max
# ---------------------------------------------------------------------------

def test_score_key_orders_like_the_floats():
    v = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf,
                      np.nan], dtype=torch.float32)
    k = score_key_plain(v)
    assert k[-1] == 0 and k[0] == 0x007FFFFF
    assert k[3] == k[4]                       # -0 and +0 compare equal
    order = k[:-1]
    assert bool((order[1:] >= order[:-1]).all())
    assert bool((order[[0, 1, 2, 4, 5, 6, 7]].diff() > 0).all())


def _argmax_inputs(r, d, vocabs, seed, n=400):
    schema, rschema = _schemas(d, vocabs)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n)).astype(np.float32)
    codes = np.stack([rng.integers(-1, v + 1, n) for v in vocabs]
                     ).astype(np.int32)
    w_full = rng.normal(size=(schema.sigma_size, r)).astype(np.float32)
    icpt = rng.normal(size=r).astype(np.float32)
    if r > 1:
        icpt[r // 2] = -np.inf                 # an empty class
    return schema, rschema, x, codes, w_full, icpt


# (R, vocabularies): one class, one tile of 32, 33 (W whole, two classes a
# lane), and favorita's class column, R = 337 past a shared-memory W
ARGMAX_CASES = {"R1": (1, (1, 6)), "R32": (32, (32, 6)),
                "R33": (33, (33, 6)), "R337": (337, FAVORITA_VOCABS[2:4])}


@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_class_argmax_tiles_plain_matches_class_argmax(case):
    """The tiled merge (at the plan's tile width and at 32 classes a tile)
    equals class_argmax and the JAX class_argmax, with equal scores on
    both sides of a tile boundary (the lower class wins), a row whose
    every score is NaN and one whose scores are -inf or NaN (class 0)."""
    r, vocabs = ARGMAX_CASES[case]
    d = 3
    schema, rschema, x, codes, w_full, icpt = _argmax_inputs(
        r, d, vocabs, seed=r)
    if r > 32:                 # class 32 (tile 2) scores as class 31 ...
        w_full[:, 32] = w_full[:, 31]
        icpt[32] = icpt[31]
        w_full[:, 0] += 50.0   # ... and class 0 (tile 1) as class r - 1
        w_full[:, r - 1] = w_full[:, 0]
        icpt[r - 1] = icpt[0]
    x[0, 7] = np.nan                        # every score NaN
    x[:, 8] = 0.0
    x[0, 8] = np.inf                        # ±inf·W: -inf or NaN, some +inf
    w_full[1, :] = -np.abs(w_full[1, :])    # W[x0] ≤ 0: inf·W is -inf
    w_full[1, :r // 3] = 0.0                # or NaN (inf·0), never +inf
    xs = [torch.tensor(a) for a in x]
    cs = [torch.tensor(a) for a in codes]
    want = class_argmax(torch.tensor(w_full), torch.tensor(icpt), xs, cs,
                        schema=schema)
    jax_want = np.asarray(ref_class_argmax(
        jnp.asarray(w_full), jnp.asarray(icpt),
        tuple(jnp.asarray(a) for a in x),
        tuple(jnp.asarray(a) for a in codes), schema=rschema))
    np.testing.assert_array_equal(want.numpy(), jax_want)
    assert int(want[7]) == 0 and int(want[8]) == 0
    ld = _build.impute_plan(schema, r)[0]
    for tile in sorted({ld, 32}):
        got = class_argmax_tiles_plain(torch.tensor(w_full),
                                       torch.tensor(icpt), xs, cs,
                                       schema=schema, ld=tile)
        assert torch.equal(got, want), tile


def test_class_argmax_tie_across_a_tile_boundary():
    """Two classes in two tiles with equal scores: the running key keeps
    the first; a later tile wins only with a strictly larger key."""
    schema, _ = _schemas(1, (40,))
    w_full = torch.zeros((schema.sigma_size, 40))
    icpt = torch.full((40,), -1.0)
    icpt[[5, 37]] = 2.0
    x, c = [torch.zeros(3)], [torch.tensor([0, 1, 2], dtype=torch.int32)]
    got = class_argmax_tiles_plain(w_full, icpt, x, c, schema=schema, ld=32)
    assert got.tolist() == [5, 5, 5]
    icpt[37] = 2.5
    got = class_argmax_tiles_plain(w_full, icpt, x, c, schema=schema, ld=32)
    assert got.tolist() == [37, 37, 37]


def test_impute_plan_at_the_path_shapes():
    """favorita_wide: W whole at R = 33 (two classes a lane), class tiles
    of 64 past batches of ≥ 1,024 null rows at R = 337; at
    P = 1,024 (R = 1,000) and at 64 + 64 columns every plan fits."""
    fav, _ = _schemas(3, FAVORITA_VOCABS)
    assert _build.impute_plan(fav, 33) == (33, 2, _build.IMP_WHOLE_BATCH)
    ld, m, batch = _build.impute_plan(fav, 337)
    assert (ld, m) == (64, 2) and batch >= _build.IMP_TILED_BATCH
    for schema, r in ((fav, 1), (fav, 33), (fav, 337),
                      (FeatureSchema(3, (tuple(range(1000)),
                                         tuple(range(20)))), 1000),
                      (FeatureSchema(64, (tuple(range(14)),) * 64), 14)):
        plan = _build.impute_plan(schema, r)
        assert len(plan) == 3     # ld, M, batch: the kernel's plan
        ld, m, batch = plan
        assert m == -(-ld // 32) <= _build.IMP_MAX_M
        assert batch % 32 == 0 and batch >= 32
        assert _build.impute_smem_bytes(schema, ld, batch) <= _build.WIDE_SMEM
        assert ld == r or ld % 32 == 0


def test_impute_constants_equal_the_kernel():
    cxx = _cxx_constants()
    for py, c in {"IMP_THREADS": "kImpThreads", "IMP_MAX_M": "kImpMaxM",
                  "IMP_FILL_ROWS": "kFillRows"}.items():
        assert getattr(_build, py) == cxx[c], (py, c)
