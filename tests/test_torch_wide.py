"""Wide schemas (P > 88) in the port against the JAX package, on the CPU:
the plain paths of K7 (masked_gram_cols, masked_gram) and K2w
(fused_impute_aggregate) against the JAX Pallas kernels in interpret mode,
K7's plan over S's nonzeros (coverage, shared memory, its tables against
the plain Gram and the JAX kernels) and limits, the unfused predictors at
P = 492, and run_mice_device on a small favorita_wide table against the JAX loop.

favorita_wide is the schema of the Kaggle "Corporacion Favorita Grocery
Sales Forecasting" data: 3 numeric columns and 9 categorical columns of
54, 33, 337, 2, 2, 22, 16, 5 and 17 levels, P = 492.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice.device_round import (
    mice_loop_device as ref_loop,
)
from duckdb_imputation_tpu.ring.kernels.sigma_fused import (
    fused_impute_aggregate as ref_fused,
    pack_lhs,
)
from duckdb_imputation_tpu.ring.kernels.sigma_pallas import (
    sigma_pallas_fast_cols_padded,
    sigma_pallas_fast_padded,
    sigma_pallas_padded,
)

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import (
    mice_loop_device,
    mice_loop_device_fused,
    run_mice_device,
)
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram,
    masked_gram_cols,
    masked_gram_cols_plain,
    wide_assemble,
    wide_tables_plain,
)

from test_torch_past_46340 import CRITEO_C18

torch.set_num_threads(2)

FAVORITA_VOCABS = (54, 33, 337, 2, 2, 22, 16, 5, 17)
FAVORITA_KEYS = tuple(tuple(range(v)) for v in FAVORITA_VOCABS)
# the wide schema of tests/test_kernels.py's fallback test: P = 125
WIDE_125 = (4, (tuple(range(120)),))
SCHEMAS = {"P125": WIDE_125, "favorita": (3, FAVORITA_KEYS)}


def favorita(n, seed, null_frac=0.2, cat_col=1):
    """A small favorita_wide table from numpy: city, state, type, cluster
    fixed by the store; family and perishable fixed by the class (Zipf
    class sizes); transactions linear in a store level, unit_sales in a
    class level and onpromotion. Returns features-first (x, codes, num
    null, cat null) with null_frac nulls in transactions and in
    categorical column `cat_col` (1: family)."""
    rng = np.random.default_rng(seed)
    city = rng.integers(0, 22, 54)
    state_of_city = rng.integers(0, 16, 22)
    stype, cluster = rng.integers(0, 5, 54), rng.integers(0, 17, 54)
    fam = rng.permutation(np.concatenate([np.arange(33),
                                          rng.integers(0, 33, 337 - 33)]))
    perish = rng.integers(0, 2, 33)
    p = 1.0 / rng.permutation(np.arange(1, 338))
    store = rng.integers(0, 54, n)
    cls = rng.choice(337, n, p=p / p.sum())
    promo = (rng.random(n) < 0.2).astype(int)
    x = np.stack([rng.normal(size=337)[cls] + 1.5 * promo
                  + 0.5 * rng.normal(size=n),
                  2.0 * rng.normal(size=54)[store] + rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([store, fam[cls], cls, perish[fam[cls]], promo,
                      city[store], state_of_city[city[store]], stype[store],
                      cluster[store]]).astype(np.int32)
    nn = np.zeros((3, n), bool)
    cn = np.zeros((9, n), bool)
    nn[1] = rng.random(n) < null_frac
    cn[cat_col] = rng.random(n) < null_frac
    return x, codes, nn, cn


def random_inputs(name, n=3000, seed=0):
    """Random x, codes (some out of vocab or negative), binary and general
    weights for one of SCHEMAS."""
    d, keys = SCHEMAS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n)).astype(np.float32)
    codes = np.stack([rng.integers(-1, len(k) + 1, n)
                      for k in keys]).astype(np.int32)
    w_bin = (rng.random(n) > 0.3).astype(np.float32)
    w_gen = rng.random(n).astype(np.float32)
    return d, keys, x, codes, w_bin, w_gen


def assert_sigma_close(got, want, counts_exact, schema):
    """Counts (N, one-hot and their cross counts) exact when asked; the
    rest within 1e-6 of max|σ| (f32 sums in other orders; the JAX kernels
    split values into bf16 hi/lo parts)."""
    got, want = np.asarray(got), np.asarray(want)
    if counts_exact:
        d = schema.num_cols
        for a, b in ((got[0, 0], want[0, 0]), (got[1 + d:, 1 + d:],
                                                 want[1 + d:, 1 + d:]),
                     (got[0, 1 + d:], want[0, 1 + d:])):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_check_schema_wide_limits():
    """K2/K2w (and K8, K3/K3w) take P up to MAX_WIDE_SIGMA_SIZE, as does
    K7's one launch of its whole plan; K7 takes P up to
    MAX_WINDOW_SIGMA_SIZE through its column windows, criteo_c18 (P =
    47,412) among them, and the scorer up to MAX_SCORER_SIGMA_SIZE. The
    narrow kernels alone (K1, K2, K4, K5) stop at MAX_SIGMA_SIZE, where
    their wrappers switch to K7, K2w and K8."""
    for name in SCHEMAS:
        schema = FeatureSchema(*SCHEMAS[name])
        assert schema.sigma_size > _build.MAX_SIGMA_SIZE
        _build.check_schema(schema, 1000, _build.MAX_WIDE_SIGMA_SIZE)
        with pytest.raises(ValueError):
            _build.check_schema(schema, 1000)
    at_limit = FeatureSchema(num_cols=3, cat_keys=(tuple(range(1020)),))
    assert at_limit.sigma_size == _build.MAX_WIDE_SIGMA_SIZE
    _build.check_schema(at_limit, 1000, _build.MAX_WIDE_SIGMA_SIZE)
    above = FeatureSchema(num_cols=4, cat_keys=(tuple(range(1020)),))
    with pytest.raises(ValueError):
        _build.check_schema(above, 1000, _build.MAX_WIDE_SIGMA_SIZE)
    _build.check_schema(above, 1000, _build.MAX_WINDOW_SIGMA_SIZE)
    _build.check_window(above, 0, above.sigma_size)
    c18 = FeatureSchema(num_cols=13, cat_keys=tuple(
        tuple(range(v)) for v in CRITEO_C18))
    assert c18.sigma_size == 47412
    _build.check_schema(c18, 1000, _build.MAX_WINDOW_SIGMA_SIZE)
    with pytest.raises(ValueError):
        _build.check_schema(c18, 1000, _build.MAX_SCORER_SIGMA_SIZE)
    past = FeatureSchema(num_cols=4, cat_keys=(tuple(range(
        _build.MAX_WINDOW_SIGMA_SIZE)),))
    with pytest.raises(ValueError):
        _build.check_schema(past, 1000, _build.MAX_WINDOW_SIGMA_SIZE)


# two categorical columns of 510 levels: one cross table of 260,100 cells,
# 2 MB in f64, far past a block's shared memory
PLAN_SCHEMAS = dict(SCHEMAS, V510x2=(2, (tuple(range(510)),) * 2))


def zero_structure(schema):
    """(i, j), i < j, inside one categorical column's one-hot block: zero
    in every S (a row sets at most one code of a column)."""
    base = 1 + schema.num_cols
    return {(base + o + a, base + o + b)
            for o, size in zip(schema.offsets, schema.cat_sizes)
            for a in range(size) for b in range(a + 1, size)}


@pytest.mark.parametrize("name", ["P125", "favorita", "V510x2"])
def test_wide_plan_covers_every_nonzero_once(name):
    """K7's plan maps each structurally nonzero entry of S's upper triangle
    to a cell exactly once, and no cell of the zero structure; every cell
    of every task reaches S (a count cell of K_j twice: (0, v) and the
    diagonal (v, v))."""
    schema = FeatureSchema(*PLAN_SCHEMAS[name])
    plan = _build.wide_plan(schema)
    p = schema.sigma_size
    task, cell, i, j = plan.entries.long().T
    pairs = list(zip(i.tolist(), j.tolist()))
    assert len(set(pairs)) == len(pairs)
    assert (i <= j).all() and (j < p).all()
    upper = {(a, b) for a in range(p) for b in range(a, p)}
    assert set(pairs) == upper - zero_structure(schema)
    flat = plan.task_base[task] + cell
    assert (cell < plan.task_base[task + 1] - plan.task_base[task]).all()
    assert torch.equal(torch.unique(flat), torch.arange(plan.task_base[-1]))
    assert len(pairs) - int(plan.task_base[-1]) == schema.vocab_size


@pytest.mark.parametrize("name", ["favorita", "V510x2", "limit"])
def test_wide_plan_tasks_fit_shared_memory(name):
    """Every task's f64 tables fit WIDE_TASK_BYTES, and with the staged
    rows and the slab records the block's shared memory fits the 227 KB a
    block may take; a task stages the code columns its slabs read (and
    every numeric column where it has a K slab); its slabs tile its
    cells, each warp's side by side; a table past the budget is split by
    its leading key into ranges that cover it; past the crossover D is
    every tile of its upper triangle, and no slab's."""
    schema = (FeatureSchema(num_cols=64, cat_keys=(tuple(range(14)),) * 64)
              if name == "limit" else FeatureSchema(*PLAN_SCHEMAS[name]))
    plan = _build.wide_plan(schema)
    d, sizes = schema.num_cols, schema.cat_sizes
    cells = plan.task_base[1:] - plan.task_base[:-1]
    assert int(cells.max()) * 8 <= _build.WIDE_TASK_BYTES
    assert _build.wide_smem_bytes(plan.max_task_cells, plan.max_stage_cols,
                                  plan.max_slabs, plan.stage_rows) <= 227 * 1024
    assert plan.stage_rows % _build.WIDE_CHUNK == 0
    assert plan.stage_rows == (128 if name == "limit" else 256)  # 108
    # columns staged at 64 + 64: two stages of 256 rows would not fit
    assert len(plan.shape_ints(1)) == _build.WIDE_PLAN_INTS
    for t in range(plan.num_tasks):
        mine = plan.slabs[plan.slabs[:, 6] == t].tolist()
        read = sorted({c for kind, p0, p1, *_ in mine if kind != _build.SLAB_D
                       for c in ((p0,) if kind == _build.SLAB_K else (p0, p1))})
        nx, nc, *cols = plan.stage_cols[t].tolist()
        assert cols[nx:nx + nc] == read and set(cols[nx + nc:]) <= {-1}
        if any(kind == _build.SLAB_K for kind, *_ in mine):
            assert cols[:nx] == list(range(d))     # K_j: every numeric
        assert len(mine) <= min(plan.max_slabs, _build.WIDE_MAX_SLABS)
    assert plan.warp_begin.tolist() == sorted(plan.warp_begin.tolist())
    assert len(plan.warp_begin) == plan.num_tasks * _build.WIDE_WARPS + 1
    ranges, used = {}, [0] * plan.num_tasks
    for s, (kind, p0, p1, p2, p3, off, task, warp) in enumerate(
            plan.slabs.tolist()):
        at = task * _build.WIDE_WARPS + warp
        assert plan.warp_begin[at] <= s < plan.warp_begin[at + 1]
        if kind == _build.SLAB_D:        # row p0 of D, cells [p1, p2)
            table, lo, hi, width = ("D", p0), p1, p2, 1
            assert p0 <= p1 and p2 - p1 <= _build.WIDE_CHUNK
        elif kind == _build.SLAB_K:      # K_p0, keys [p1, p2)
            table, lo, hi, width = ("K", p0), p1, p2, 1 + d
        else:                            # C_{p0 p1}, keys [p2, p3)
            assert kind == _build.SLAB_C and p0 < p1
            table, lo, hi, width = ("C", p0, p1), p2, p3, sizes[p1]
        assert off == used[task]         # slabs tile the task, in order
        used[task] += (hi - lo) * width
        ranges.setdefault(table, []).append((lo, hi))
    assert used == cells.tolist()
    for table, keys in ranges.items():   # key ranges cover each table
        keys.sort()
        first, last = ((table[1], 1 + d) if table[0] == "D"
                       else (0, sizes[table[1]]))
        assert keys[0][0] == first and keys[-1][1] == last
        assert all(a[1] == b[0] for a, b in zip(keys, keys[1:]))
    # past the crossover (d = 64 at "limit") D is the D kernel's tiles of
    # its upper triangle, and no slab's
    dense = plan.dense is not None
    assert dense == _build.dense_route(d)
    if dense:
        nb = _build.dense_blocks(d)
        assert plan.dense.tolist() == [[i, j] for i in range(nb)
                                       for j in range(i, nb)]
    assert len(ranges) == (0 if dense else 1 + d) + len(sizes) + sum(
        1 for j in range(len(sizes)) for k in range(j + 1, len(sizes))
        if sizes[k])
    if name == "V510x2":     # the 260,100-cell table: even key ranges
        c = ranges[("C", 0, 1)]
        assert len(c) == -(-510 * 510 // (_build.WIDE_TASK_BYTES // 8))
        widths = {hi - lo for lo, hi in c}
        assert max(widths) - min(widths) <= 16


def test_wide_plan_slices_are_a_function_of_n_and_the_plan():
    fav = _build.wide_plan(FeatureSchema(3, FAVORITA_KEYS))
    assert fav.num_tasks == 8
    assert fav.slices(1) == 1
    assert fav.slices(3000) == 94                  # one a chunk of 32 rows
    assert fav.slices(10_000_000) == 128           # 1024 blocks
    one = _build.wide_plan(FeatureSchema(*WIDE_125))
    assert one.num_tasks == 1 and one.slices(10_000_000) == 1024


@pytest.mark.parametrize("name", ["P125", "favorita"])
@pytest.mark.parametrize("weights", ["binary", "general"])
def test_wide_tables_assemble_to_the_gram(name, weights):
    """The plan's tables in plain torch (`wide_tables_plain`: f64
    index_add / bincount), scattered into S through the plan's map
    (`wide_assemble`), against masked_gram_cols_plain and the JAX kernels
    in interpret mode (sigma_pallas_fast_padded with binary weights,
    sigma_pallas_padded with general ones): counts exact with binary
    weights, the rest within 1e-6 of max|σ|."""
    d, keys, x, codes, w_bin, w_gen = random_inputs(name, seed=2)
    schema = FeatureSchema(d, keys)
    w = w_bin if weights == "binary" else w_gen
    xs, cs = list(map(torch.tensor, x)), list(map(torch.tensor, codes))
    cells = wide_tables_plain(xs, cs, torch.tensor(w), schema=schema)
    assert cells.dtype == torch.float64
    got = wide_assemble(cells, schema=schema)
    binary = weights == "binary"
    assert_sigma_close(got, masked_gram_cols_plain(
        xs, cs, torch.tensor(w), schema=schema), binary, schema)
    ref_fn = sigma_pallas_fast_padded if binary else sigma_pallas_padded
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_fn(x, codes, w,
                                 schema=RefSchema(num_cols=d, cat_keys=keys)))
    assert_sigma_close(got, want, binary, schema)


@pytest.mark.parametrize("name", ["P125", "favorita"])
def test_masked_gram_cols_wide_matches_jax(name):
    """Binary weights: the port's masked_gram_cols (plain on the CPU)
    against sigma_pallas_fast_cols_padded in interpret mode (v3 at P = 125,
    v2 at pack 1 at P = 492)."""
    d, keys, x, codes, w_bin, _ = random_inputs(name)
    schema = FeatureSchema(d, keys)
    want = sigma_pallas_fast_cols_padded(
        tuple(jnp.asarray(a) for a in x), tuple(jnp.asarray(a) for a in codes),
        jnp.asarray(w_bin), schema=RefSchema(num_cols=d, cat_keys=keys),
        interpret=True)
    got = masked_gram_cols(list(map(torch.tensor, x)),
                           list(map(torch.tensor, codes)),
                           torch.tensor(w_bin), schema=schema)
    assert_sigma_close(got, want, True, schema)


@pytest.mark.parametrize("name", ["P125", "favorita"])
@pytest.mark.parametrize("weights", ["binary", "general"])
def test_masked_gram_wide_matches_jax(name, weights):
    """The stacked entry point against the JAX stacked dispatchers under
    the TPU interpreter: sigma_pallas_fast_padded (binary weights; the v1
    sigma_pallas_fast fallback at P = 492) and sigma_pallas_padded
    (general weights, f32)."""
    d, keys, x, codes, w_bin, w_gen = random_inputs(name, seed=1)
    schema = FeatureSchema(d, keys)
    w = w_bin if weights == "binary" else w_gen
    ref_fn = (sigma_pallas_fast_padded if weights == "binary"
              else sigma_pallas_padded)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_fn(x, codes, w,
                                 schema=RefSchema(num_cols=d, cat_keys=keys)))
    got = masked_gram(torch.tensor(x), torch.tensor(codes), torch.tensor(w),
                      schema=schema)
    assert_sigma_close(got, want, weights == "binary", schema)


@pytest.mark.parametrize("kind", ["cat", "num"])
def test_fused_impute_aggregate_wide_matches_jax(kind):
    """K2w's plain path at P = 492 against the JAX fused pass (v2 at pack
    1, interpret mode): 'cat' imputes family (R = 33) from random
    coefficients, 'num' imputes transactions. The JAX kernel scores
    through a bf16 hi/lo split of the coefficients (about 2⁻¹⁶ of each
    coefficient's magnitude), so codes agree except on near-ties (≥ 0.999
    of rows) and a prediction, a sum of 13 terms of coefficients N(0, 1),
    within 1e-4 absolute. 'cat' sigma: against the JAX Gram
    (sigma_pallas_fast_cols_padded, interpret mode) of the port's own
    imputed codes, as in assert_sigma_close, so a near-tie never skips it;
    'num' sigma within 1e-5 of max|σ| of the JAX pass's."""
    n = 3072
    x, codes, nn, cn = favorita(n, seed=3)
    schema = FeatureSchema(3, FAVORITA_KEYS)
    rschema = RefSchema(num_cols=3, cat_keys=FAVORITA_KEYS)
    rng = np.random.default_rng(4)
    r, col = (33, 1) if kind == "cat" else (1, 1)
    w_full = rng.normal(size=(schema.sigma_size, r)).astype(np.float32)
    icpt = (rng.normal(size=r) if kind == "cat"
            else np.zeros(1)).astype(np.float32)
    null = cn[1] if kind == "cat" else nn[1]
    w_agg = (~(nn[1] if kind == "cat" else cn[1])).astype(np.float32)
    lhs = pack_lhs(jnp.asarray(w_full), jnp.asarray(icpt), schema=rschema,
                   n_rows=r)
    new_ref, sig_ref = ref_fused(
        tuple(jnp.asarray(a) for a in x),
        tuple(jnp.asarray(a) for a in codes),
        jnp.asarray(null, jnp.float32), jnp.asarray(w_agg), lhs,
        schema=rschema, kind=kind, imp_col=col, n_rows=r, chunk_cols=1024,
        interpret=True)
    new, sig = fused_impute_aggregate(
        list(map(torch.tensor, x)), list(map(torch.tensor, codes)),
        torch.tensor(null), torch.tensor(w_agg), torch.tensor(w_full),
        torch.tensor(icpt), schema=schema, kind=kind, imp_col=col)
    new_ref = np.asarray(new_ref)
    if kind == "cat":
        same = new.numpy() == new_ref
        assert same.mean() >= 0.999
        np.testing.assert_array_equal(new.numpy()[~null], codes[col][~null])
        imputed = codes.copy()
        imputed[col] = new.numpy()
        want = sigma_pallas_fast_cols_padded(
            tuple(jnp.asarray(a) for a in x),
            tuple(jnp.asarray(a) for a in imputed), jnp.asarray(w_agg),
            schema=rschema, interpret=True)
        assert_sigma_close(sig, want, True, schema)
    else:
        np.testing.assert_allclose(new.numpy(), new_ref, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(new.numpy()[~null], x[col][~null])
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_ref),
                                   rtol=0,
                                   atol=1e-5 * np.abs(sig_ref).max())


def test_unfused_predict_at_p492_builds_no_onehot(monkeypatch):
    """class_argmax and linear_predict at P = 492 gather coefficients per
    code: no [n, P] (or [P, n]) one-hot of the table is built."""
    x, codes, _, _ = favorita(2000, seed=5)
    schema = FeatureSchema(3, FAVORITA_KEYS)

    def refuse(*a, **k):
        raise AssertionError("a one-hot block was built")

    monkeypatch.setattr(port_sum, "onehot_block_t", refuse)
    monkeypatch.setattr(port_sum, "_zt_block", refuse)
    rng = np.random.default_rng(6)
    xs, cs = list(map(torch.tensor, x)), list(map(torch.tensor, codes))
    w = torch.tensor(rng.normal(size=(492, 33)).astype(np.float32))
    pred = port_sum.class_argmax(w, torch.zeros(33), xs, cs, schema=schema)
    theta = torch.tensor(rng.normal(size=492).astype(np.float32))
    y = port_sum.linear_predict(theta, xs, cs, schema=schema)
    assert pred.shape == (2000,) and y.shape == (2000,)


def test_mice_loop_device_wide_matches_reference():
    """The unfused and fused loops at P = 492 against the JAX unfused
    loop (kernel='xla', trainer='solve'), 2 rounds, imputing transactions
    and type (R = 5: the JAX loop's compile time grows with R·V, minutes at
    family's R = 33): type codes agree on ≥ 0.99 of the null cells (the
    LDA solves through different SVDs of a near-singular covariance),
    observed cells unchanged; on the rows whose codes all agree (≥ 0.99 of
    the rows) transactions within 1e-3 of max|x|."""
    x, c, nn, cn = favorita(3000, seed=7, cat_col=7)
    kw = dict(num_cols_to_impute=(1,), cat_cols_to_impute=(7,), iters=2)
    ref_x, ref_c, _ = ref_loop(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(nn), jnp.asarray(cn),
        jax.random.PRNGKey(0), schema=RefSchema(3, FAVORITA_KEYS),
        kernel="xla", trainer="solve", noise=False, **kw)
    ref_x, ref_c = np.asarray(ref_x), np.asarray(ref_c)
    args = tuple(torch.tensor(a) for a in (x, c, nn, cn))
    schema = FeatureSchema(3, FAVORITA_KEYS)
    for got_x, got_c in (
            mice_loop_device(*args, schema=schema, kernel="gram", **kw),
            mice_loop_device_fused(*args, schema=schema, **kw)):
        got_x, got_c = got_x.numpy(), got_c.numpy()
        assert (got_c[7][cn[7]] == ref_c[7][cn[7]]).mean() >= 0.99
        np.testing.assert_array_equal(got_c[~cn], c[~cn])
        np.testing.assert_array_equal(got_x[~nn], x[~nn])
        same = (got_c == ref_c).all(0)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(got_x[:, same], ref_x[:, same], rtol=0,
                                   atol=1e-3 * np.abs(ref_x).max())


def test_run_mice_device_wide_quality():
    """run_mice_device at P = 492, every kernel value (plain versions on
    the CPU): family accuracy on its null cells above the mode prior +
    0.02, transactions RMSE below the mean fill's."""
    x, c, nn, cn = favorita(6000, seed=8)
    truth_x, truth_c = x[1].copy(), c[1].copy()
    x = np.where(nn, 0.0, x).astype(np.float32)
    c = np.where(cn, 0, c).astype(np.int32)
    t = from_numpy(x.T, c.T, nn.T, cn.T, device="cpu")
    prior = np.bincount(truth_c[~cn[1]]).max() / (~cn[1]).sum()
    mean_fill = np.sqrt(np.mean((truth_x[~nn[1]].mean()
                                 - truth_x[nn[1]]) ** 2))
    outs = {k: run_mice_device(t, iters=2, kernel=k)
            for k in ("plain", "gram", "fused")}
    for k, out in outs.items():
        acc = (out.cat_codes[1].numpy()[cn[1]] == truth_c[cn[1]]).mean()
        rmse = np.sqrt(np.mean((out.num_data[1].numpy()[nn[1]]
                                - truth_x[nn[1]]) ** 2))
        assert acc > prior + 0.02, (k, acc, prior)
        assert rmse < mean_fill, (k, rmse, mean_fill)
    assert torch.equal(outs["gram"].cat_codes, outs["fused"].cat_codes)
