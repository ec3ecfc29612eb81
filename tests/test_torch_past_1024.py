"""K2w, K8 and K3/K3w past P = 1,024 in the port, against the JAX package,
on the CPU.

Past `_build.MAX_WIDE_SIGMA_SIZE` the fused pass (K2w) runs its impute
kernel with W read from device memory and then K7 over each column window,
the grouped Gram (K8) runs once a column window of every group's S, and the
scorers (K3/K3w) take any P of K7's window plans, their cross tables keyed
on the column of more levels where a row would pass a task. On the CPU
every wrapper takes its plain version; these tests hold those paths, the
plans they run and the scorers' tables against the JAX package (its XLA
paths, and its fused Pallas loop in interpret mode) at a schema just past
the limit: 3 numeric columns and categorical
columns of 6, 5 and 1,100 levels (P = 1,115), 3,000 rows made with numpy
from a seed, the 1,100-level column fixing the 5-level one, as item_nbr
fixes family at favorita_items (P = 4,592), whose plans are checked here
too. tests/test_torch_cuda.py holds the kernels against these plain
versions on the card.

Tolerances: grouped sigmas within 1e-5 of max|σ|, counts exact; argmax
equal on ≥ 0.999 of rows; the MICE loops as tests/test_torch_wide.py
holds them at P = 492 (codes ≥ 0.99 of the null cells, numerics within
1e-3 of max|x| where the codes agree), noise by its moments.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice.device_round import (
    run_mice_device as ref_run_mice_device,
)
from duckdb_imputation_tpu.models import device as ref_device
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import run_mice_device
from duckdb_imputation_tpu_torch.mice.sharded_round import run_mice_sharded
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.parallel.mesh import make_mesh
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
    fused_impute_aggregate_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols_plain,
    wide_assemble,
    wide_tables_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    grouped_gram_presorted,
    grouped_gram_presorted_plain,
    sort_by_group,
)

from test_torch_classify_wide import _cxx_constants

torch.set_num_threads(2)

VOCABS = (6, 5, 1100)                  # store, family, item: P = 1,115
KEYS = tuple(tuple(range(v)) for v in VOCABS)
SCHEMA = FeatureSchema(num_cols=3, cat_keys=KEYS)
REF = RefSchema(num_cols=3, cat_keys=KEYS)
# favorita_items: favorita_wide's columns and item_nbr's 4,100 items
ITEMS_VOCABS = (54, 33, 337, 2, 2, 22, 16, 5, 17, 4100)
LABELS = {"onpromotion": 4, "family": 1}


def t(a):
    return torch.tensor(a)


def items_small(n=3000, seed=0):
    """x f32[3, n], codes i32[3, n] (store, family, item), the family of
    each row fixed by its item (every item once in the first 1,100 rows,
    the rest Zipf), x1 = 2·x0 + family level + 0.3·N(0, 1); 20% MCAR
    nulls in x1 and family. Returns (x, codes, num null, cat null)."""
    rng = np.random.default_rng(seed)
    items = VOCABS[2]
    family_of_item = rng.permutation(np.arange(items) % VOCABS[1])
    share = 1.0 / rng.permutation(np.arange(1, items + 1))
    item = np.concatenate([np.arange(items), rng.choice(
        items, n - items, p=share / share.sum())])
    fam = family_of_item[item]
    x0 = rng.normal(size=n)
    x = np.stack([x0, 2.0 * x0 + rng.normal(size=VOCABS[1])[fam]
                  + 0.3 * rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([rng.integers(0, VOCABS[0], n), fam,
                      item]).astype(np.int32)
    nn = np.zeros((3, n), bool)
    cn = np.zeros((3, n), bool)
    nn[1] = rng.random(n) < 0.2
    cn[1] = rng.random(n) < 0.2
    return x, codes, nn, cn


def structural_pairs(d, sizes, cross=True):
    """Every structurally nonzero (i, j), i ≤ j, of S as one i64 key
    i·P + j: D, K_j (rows of [1 ‖ x] against j's one-hots, and their
    diagonal), and, with `cross`, every pair of one-hots of two columns."""
    p = 1 + d + sum(sizes)
    base = [1 + d + sum(sizes[:j]) for j in range(len(sizes))]
    a = torch.arange(1 + d)
    keys = [(a[:, None] * p + a[None]).triu().flatten()[
        torch.ones(1 + d, 1 + d, dtype=torch.bool).triu().flatten()]]
    for b, v in zip(base, sizes):
        oh = b + torch.arange(v)
        keys += [(a[:, None] * p + oh[None]).flatten(), oh * p + oh]
    for j in range(len(sizes) if cross else 0):
        for k in range(j + 1, len(sizes)):
            u = base[j] + torch.arange(sizes[j])
            v = base[k] + torch.arange(sizes[k])
            keys.append((u[:, None] * p + v[None]).flatten())
    return torch.cat(keys), p


def plan_places(plan, d, p):
    """The places (i·P + j) a plan's map names, with its D tiles' where
    the tile kernel takes D (`_build.dense_map`)."""
    e = plan.entries.long()
    got = [e[:, 2] * p + e[:, 3]]
    if plan.dense is not None:
        m = torch.from_numpy(_build.dense_map(plan.dense, d, plan.window))
        got.append(m[1].long() * p + m[2].long())
    return torch.cat(got)


def assert_plan_covers_once(plan, d, sizes, cross, cap):
    """Every structurally nonzero (i, j), i ≤ j, named once by the map and
    the D tiles together; no task past `cap` cells, every entry inside its
    task."""
    e = plan.entries.long()
    assert bool((e[:, 2] <= e[:, 3]).all())
    want, p = structural_pairs(d, sizes, cross)
    got = plan_places(plan, d, p)
    assert got.shape == want.shape
    assert torch.equal(torch.sort(got).values, torch.sort(want).values)
    cells = plan.task_base[1:] - plan.task_base[:-1]
    assert int(cells.max()) <= cap if cells.numel() else not e.numel()
    # every map entry names a cell inside its task
    assert bool((e[:, 1] < cells[e[:, 0]]).all())


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cross", [True, False])
@pytest.mark.parametrize("label", sorted(LABELS))
def test_qda_plan_at_favorita_items(label, cross):
    """QDA's plan (cross tables) and NB's (none) at favorita_items' schema
    without the label: no raise (item_nbr's 4,100 levels passed a 4,096-
    cell task before the cross tables were keyed on the wider column);
    every structurally nonzero (i, j) mapped once; no task above
    QDA_TASK_CELLS; every cross slab's row at most the narrower column's
    levels (≤ 337)."""
    sizes = tuple(v for j, v in enumerate(ITEMS_VOCABS)
                  if j != LABELS[label])
    schema = FeatureSchema(3, tuple(tuple(range(v)) for v in sizes))
    plan = _build.qda_plan(schema, cross=cross)
    assert plan.scorer and plan.cross == cross
    assert plan.task_cells == _build.QDA_TASK_CELLS
    assert_plan_covers_once(plan, 3, sizes, cross, _build.QDA_TASK_CELLS)
    cross_slabs = plan.slabs[plan.slabs[:, 0] == _build.SLAB_C]
    assert (cross_slabs.shape[0] > 0) == cross
    assert max((sizes[k] for k in cross_slabs[:, 2].tolist()),
               default=0) <= 337
    _build.check_qda(schema, 33, 10, cross)


def test_small_cap_keys_cross_tables_on_the_wider_column():
    """At P = 1,115 with tasks of 512 cells the cross tables with the item
    column (1,100 levels a row) are keyed on it, rows of 6 or 5 cells; the
    map covers every place once, every task ≤ 512 cells; at the default
    budget the plan is the one before (keyed on j, rows of V_k)."""
    sizes = VOCABS
    small = _build._wide_plan(3, sizes, True, True, 512)
    assert_plan_covers_once(small, 3, sizes, True, 512)
    c = small.slabs[small.slabs[:, 0] == _build.SLAB_C]
    keyed = {(int(a), int(b)) for a, b in c[:, 1:3]}
    assert keyed == {(0, 1), (2, 0), (2, 1)}
    full = _build.qda_plan(SCHEMA)
    c = full.slabs[full.slabs[:, 0] == _build.SLAB_C]
    assert {(int(a), int(b)) for a, b in c[:, 1:3]} == {(0, 1), (0, 2),
                                                         (1, 2)}
    assert_plan_covers_once(full, 3, sizes, True, _build.QDA_TASK_CELLS)


def test_qda_task_cells_and_limits():
    """The scorer's budget grows to the narrower column of a pair past
    QDA_TASK_CELLS, up to K7's task; past it (two columns of 9,000) the
    budget stays K7's and the cross table is cut by row code too, so
    check_qda takes the schema, as it takes a column past 32,768 levels
    (codes staged as i32), whose plan maps every place once (the 9,000 ×
    9,000 cut checked at its scale in tests/test_torch_wide_levels.py);
    past K7's window limit check_qda raises; P = 1,115 and favorita_items
    pass."""
    assert _build.qda_task_cells(VOCABS) == _build.QDA_TASK_CELLS
    assert _build.qda_task_cells((5000, 6001)) == 5000
    assert _build.qda_task_cells((30000,)) == _build.QDA_TASK_CELLS
    assert _build.qda_task_cells((9000, 9000)) == _build.WIDE_TASK_BYTES // 8
    _build.check_qda(SCHEMA, 3, 100)
    wide = FeatureSchema(2, (tuple(range(5000)), tuple(range(6001))))
    _build.check_qda(wide, 2, 100)
    plan = _build.qda_plan(wide)
    assert plan.task_cells == 5000 and plan.max_task_cells <= 5000
    threads, rows, group = _build.qda_tile(wide, plan, 2)
    assert _build.qda_smem_bytes(plan.max_task_cells, wide, threads * rows,
                                 group) <= _build.WIDE_SMEM
    nine = FeatureSchema(2, (tuple(range(9000)),) * 2)
    _build.check_qda(nine, 2, 100)
    assert _build._row_ranges(9000, _build.qda_task_cells(
        (9000, 9000))) == [(0, 4500), (4500, 9000)]
    levels = _build.QDA_SHORT_LEVELS + 1
    long_codes = FeatureSchema(1, (tuple(range(levels)),))
    _build.check_qda(long_codes, 2, 100)
    assert _build.qda_code_bytes(long_codes) == 4
    assert_plan_covers_once(_build.qda_plan(long_codes), 1, (levels,), True,
                            _build.QDA_TASK_CELLS)
    _build.check_qda(FeatureSchema(1, (tuple(range(
        _build.MAX_SCORER_SIGMA_SIZE - 2)),)), 2, 100)
    with pytest.raises(ValueError, match="sigma size"):
        _build.check_qda(FeatureSchema(1, (tuple(range(
            _build.MAX_SCORER_SIGMA_SIZE)),)), 2, 100)
    # naive Bayes's plan has no cross table: two wide columns pass
    _build.check_qda(nine, 2, 100, cross=False)
    assert _build.QDA_SHORT_LEVELS == _cxx_constants()["kQdaShortLevels"]


def test_impute_global_plan():
    """K2w's impute plan past P = 1,024 (W in device memory): tiles of
    32·M classes, M = ceil(R / 32) up to IMP_MAX_M, batches of
    IMP_BATCH null rows in whole warps, within shared memory, at
    favorita_items (R = 33, 337) and at K7's window limit."""
    items = FeatureSchema(3, tuple(tuple(range(v)) for v in ITEMS_VOCABS))
    assert _build.impute_global_plan(items, 33) == (64, 2, _build.IMP_BATCH)
    assert _build.impute_global_plan(items, 337) == (128, 4,
                                                     _build.IMP_BATCH)
    assert _build.impute_global_plan(items, 1) == (32, 1, _build.IMP_BATCH)
    big = FeatureSchema(64, tuple(tuple(range(700)) for _ in range(64)))
    ld, m, batch = _build.impute_global_plan(big, 700)
    assert (ld, m) == (128, 4) and batch % 32 == 0
    assert _build.impute_smem_bytes(big, 0, batch) <= _build.WIDE_SMEM
    with pytest.raises(ValueError):
        _build.impute_plan(items, 33)      # no class tile fits any more


@pytest.mark.parametrize("groups", [1, 3])
def test_k8_window_plans_per_group(groups):
    """K8 past P = 1,024 runs K7's window plans over each group's rows:
    each window's cells of each group (`wide_tables_plain` over the
    group's rows on the window's plan), assembled through the window's map,
    equal that group's plain sigma's columns: counts exact, the rest
    within 1e-6 of max|σ|."""
    x, codes, _, _ = items_small(seed=4)
    rng = np.random.default_rng(5)
    g = rng.integers(0, groups, x.shape[1]).astype(np.int32)
    w = (rng.random(x.shape[1]) > 0.25).astype(np.float32)
    xs, cs, ws, layout = sort_by_group(t(x), t(codes), t(g), schema=SCHEMA,
                                       num_groups=groups, weights=t(w))
    want = grouped_gram_presorted_plain(xs, cs, ws, layout, schema=SCHEMA)
    off = layout.offsets.tolist()
    p = SCHEMA.sigma_size
    for lo in range(0, p, _build.WINDOW_WIDTH):
        hi = min(lo + _build.WINDOW_WIDTH, p)
        plan = _build.window_plan(SCHEMA, lo, hi)
        for gg in range(groups):
            sl = slice(off[gg], off[gg + 1])
            cells = wide_tables_plain(list(xs[:, sl]), list(cs[:, sl]),
                                      ws[sl], schema=SCHEMA, plan=plan)
            got = wide_assemble(cells, schema=SCHEMA, plan=plan)
            ref = want[gg][:, lo:hi]
            scale = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 1e-6 * scale
            rows = torch.arange(p)[:, None]
            cols = torch.arange(lo, hi)[None]
            cm = ((rows == 0) | (rows > 3)) & ((cols == 0) | (cols > 3))
            assert torch.equal(got[cm], ref[cm])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["masked", "sorted"])
def test_grouped_presorted_past_1024_matches_jax(method):
    """grouped_gram_presorted's plain path (each group's S from its tables,
    as K8 builds it by windows) at G = 3 against the JAX package's
    sum_to_triple_grouped (its XLA methods): counts exact, within 1e-5 of
    max|σ|; the port's own 'auto' GROUP BY on the CPU gives the same."""
    x, codes, _, _ = items_small(seed=6)
    rng = np.random.default_rng(7)
    n = x.shape[1]
    g = rng.integers(0, 3, n).astype(np.int32)
    g[:11] = 5                                   # dropped: id past G
    w = (rng.random(n) > 0.2).astype(np.float32)
    xs, cs, ws, layout = sort_by_group(t(x), t(codes), t(g), schema=SCHEMA,
                                       num_groups=3, weights=t(w))
    got = grouped_gram_presorted(xs, cs, ws, layout, schema=SCHEMA).numpy()
    ref = np.asarray(ref_sft(ref_sum.sum_to_triple_grouped(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(g), schema=REF,
        num_groups=3, weights=jnp.asarray(w), method=method)))
    d = 3
    for gg in range(3):
        np.testing.assert_array_equal(got[gg][0, 0], ref[gg][0, 0])
        np.testing.assert_array_equal(got[gg][1 + d:, 1 + d:],
                                      ref[gg][1 + d:, 1 + d:])
        np.testing.assert_array_equal(got[gg][0, 1 + d:], ref[gg][0, 1 + d:])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    tri = port_sum.sum_to_triple_grouped(t(x), t(codes), t(g), schema=SCHEMA,
                                         num_groups=3, weights=t(w))
    assert tri.n.tolist() == [float(got[gg][0, 0]) for gg in range(3)]


def seeded_qda(classes=3, seed=8):
    """quad [C, m, m] negative definite (so the JAX XLA scorer's Cholesky
    of −quad exists), lin [C, m], intercept [C], f32, at m = P − 1; and
    the rows to score."""
    rng = np.random.default_rng(seed)
    m = SCHEMA.sigma_size - 1
    b = rng.normal(size=(classes, m, 8)) * 0.3
    quad = -(b @ b.transpose(0, 2, 1) + 0.05 * np.eye(m))
    lin = rng.normal(size=(classes, m))
    icpt = rng.normal(size=classes)
    x, codes, _, _ = items_small(seed=seed + 1)
    return (quad.astype(np.float32), lin.astype(np.float32),
            icpt.astype(np.float32), x, codes)


def test_qda_predict_past_1024_matches_jax():
    """qda_predict_device (the plain scorer over the scorer's plan) at P =
    1,115 against the JAX package's qda_predict_device(method='xla'):
    argmax equal on ≥ 0.999 of rows; over a plan of 512-cell tasks, whose
    cross tables with the item column are keyed on it, the plain scorer
    gives the same on ≥ 0.999, and its scores agree with the dense f64
    form within 1e-9 of their scale."""
    quad, lin, icpt, x, codes = seeded_qda()
    got = port_device.qda_predict_device(*map(t, (quad, lin, icpt, x,
                                                  codes)),
                                         schema=SCHEMA).numpy()
    ref = np.asarray(ref_device.qda_predict_device(
        *map(jnp.asarray, (quad, lin, icpt, x, codes)), schema=REF,
        method="xla"))
    assert (got == ref).mean() >= 0.999
    assert len(np.unique(got)) == 3
    p = SCHEMA.sigma_size
    a = torch.zeros((3, p, p), dtype=torch.float64)
    a[:, 0, 0] = t(icpt).double()
    a[:, 0, 1:] = a[:, 1:, 0] = t(lin).double() / 2
    a[:, 1:, 1:] = t(quad).double()
    small = _build._wide_plan(3, VOCABS, True, True, 512)
    tables = port_qda._pack(a, small).float()
    rekeyed = port_qda.qda_predict_plain(tables, small, t(x), t(codes),
                                         schema=SCHEMA).numpy()
    assert (rekeyed == ref).mean() >= 0.999
    z = np.concatenate([np.ones((1, x.shape[1])), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(v)[:, None]) * 1.0
                          for j, v in enumerate(VOCABS)])
    dense = np.einsum("in,cij,jn->cn", z, tables_dense(tables, small), z)
    scores = np.stack([s.numpy() for s in port_qda.class_scores_plain(
        tables, small, t(x), t(codes), schema=SCHEMA)])
    np.testing.assert_allclose(scores, dense, rtol=0,
                               atol=1e-9 * np.abs(dense).max())


def tables_dense(tables, plan):
    """The f64 form A_c [C, P, P] the f32 cells stand for: each cell at
    its first place (i, j) of the map (the plan's cells are the pair's
    sum of A[i, j] and A[j, i]), halved off the diagonal."""
    p = SCHEMA.sigma_size
    e = plan.entries.long()
    flat = plan.task_base[e[:, 0]] + e[:, 1]
    first = torch.ones(e.shape[0], dtype=torch.bool)
    seen = set()
    for r, f in enumerate(flat.tolist()):
        first[r] = f not in seen
        seen.add(f)
    e, flat = e[first], flat[first]
    out = np.zeros((tables.shape[0], p, p))
    vals = tables[:, flat].double().numpy()
    i, j = e[:, 2].numpy(), e[:, 3].numpy()
    off = i != j
    out[:, i[~off], j[~off]] = vals[:, ~off]
    out[:, i[off], j[off]] = vals[:, off] / 2
    out[:, j[off], i[off]] = vals[:, off] / 2
    return out


def test_nb_pipeline_past_1024_matches_jax():
    """The NB path at P = 1,115, label family (5 classes): the grouped NB
    aggregate, nb_train_device and nb_predict_device against the JAX
    package's (XLA): counts exact, parameters within 1e-5, argmax equal on
    ≥ 0.999 of rows, accuracy above the majority share + 0.02."""
    x, codes, _, _ = items_small(seed=10)
    y = codes[1].copy()
    keys = (KEYS[0], KEYS[2])
    schema = FeatureSchema(3, keys)
    ref_schema = RefSchema(3, keys)
    feats = np.stack([codes[0], codes[2]])
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(feats), t(y), schema=schema,
                                         num_groups=5)
    ragg = ref_sum.sum_to_nb_agg_grouped(x, feats, y, schema=ref_schema,
                                         num_groups=5, backend="xla")
    np.testing.assert_array_equal(agg.n.numpy(), np.asarray(ragg.n))
    np.testing.assert_array_equal(agg.lin_cat.numpy(),
                                  np.asarray(ragg.lin_cat))
    got = port_device.nb_train_device(agg.n, agg.lin, agg.quad_diag,
                                      agg.lin_cat)
    ref = ref_device.nb_train_device(ragg.n, ragg.lin, ragg.quad_diag,
                                     ragg.lin_cat)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    pred = port_device.nb_predict_device(*got, t(x), t(feats),
                                         schema=schema).numpy()
    rpred = np.asarray(ref_device.nb_predict_device(
        *ref, jnp.asarray(x), jnp.asarray(feats), schema=ref_schema))
    assert (pred == rpred).mean() >= 0.999
    assert (pred == y).mean() > np.bincount(y).max() / len(y) + 0.02


def nb_tables_dense(log_prior, mean, var, log_freq, schema, center):
    """nb_tables' tables as they were built before: the dense f64 A_c,
    then `_pack` into the plan's cells."""
    f64 = torch.float64
    mean = mean.to(f64) - center.to(f64)
    var = var.to(f64)
    c, d, p = mean.shape[0], schema.num_cols, schema.sigma_size
    a = torch.zeros((c, p, p), dtype=f64)
    di = torch.arange(1, 1 + d)
    vi = torch.arange(1 + d, p)
    a[:, 0, 0] = log_prior.to(f64) - 0.5 * (
        mean * mean / var + torch.log(2.0 * torch.pi * var)).sum(1)
    a[:, 0, di] = mean / var / 2
    a[:, di, 0] = mean / var / 2
    a[:, di, di] = -0.5 / var
    a[:, vi, vi] = log_freq.to(f64)
    return port_qda._pack(a, _build.qda_plan(schema, cross=False)).float()


def test_nb_tables_straight_into_the_cells_equal_the_dense_build():
    """nb_tables writes D's row 0 and diagonal and K_j's row 0 straight
    into the plan's cells: bit-equal to the dense f64 build at P = 1,115,
    with a log frequency of −1e30 and a centre."""
    rng = np.random.default_rng(12)
    c, d, v = 4, 3, SCHEMA.vocab_size
    log_prior = t(np.log(rng.dirichlet(np.ones(c))))
    mean = t(rng.normal(size=(c, d)) * 5).float()
    var = t(rng.random((c, d)) + 1e-3)
    log_freq = t(np.log(rng.random((c, v)) + 1e-6))
    log_freq[1, 7] = -1e30
    center = port_qda.nb_center(log_prior, mean)
    got, plan = port_qda.nb_tables(log_prior, mean, var, log_freq,
                                   schema=SCHEMA, center=center)
    want = nb_tables_dense(log_prior, mean, var, log_freq, SCHEMA, center)
    assert not plan.cross
    assert torch.equal(got, want)


def _mice_tables(seed):
    x, codes, nn, cn = items_small(seed=seed)
    truth = x[1].copy(), codes[1].copy()
    x = np.where(nn, 0.0, x).astype(np.float32)
    codes = np.where(cn, 0, codes).astype(np.int32)
    return x, codes, nn, cn, truth


def assert_mice_like_jax(out, ref, x, codes, nn, cn):
    got_x, got_c = out.num_data.numpy(), out.cat_codes.numpy()
    ref_x, ref_c = np.asarray(ref.num_data), np.asarray(ref.cat_codes)
    assert (got_c[1][cn[1]] == ref_c[1][cn[1]]).mean() >= 0.99
    np.testing.assert_array_equal(got_c[~cn], codes[~cn])
    np.testing.assert_array_equal(got_x[~nn], x[~nn])
    same = (got_c == ref_c).all(0)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got_x[:, same], ref_x[:, same], rtol=0,
                               atol=1e-3 * np.abs(ref_x).max())


@pytest.fixture(scope="module")
def mice_run():
    """The JAX package's run_mice_device(kernel='xla') at P = 1,115, 2
    rounds, without and with noise."""
    x, codes, nn, cn, truth = _mice_tables(seed=13)
    ref_t = ref_from_numpy(x.T, codes.T, nn.T, cn.T)
    assert ref_t.schema.sigma_size == SCHEMA.sigma_size
    ref = ref_run_mice_device(ref_t, iters=2, kernel="xla")
    ref_noise = ref_run_mice_device(ref_t, iters=2, kernel="xla",
                                    noise=True, seed=5)
    port_t = from_numpy(x.T, codes.T, nn.T, cn.T, device="cpu")
    return port_t, ref, ref_noise, (x, codes, nn, cn), truth


def test_run_mice_device_fused_past_1024_matches_jax(mice_run):
    """run_mice_device(kernel='fused') at P = 1,115 (K2w's path past 1,024:
    its plain version on the CPU) against the JAX loop: family on ≥ 0.99
    of the null cells, x1 within 1e-3 of max|x| where the codes agree,
    observed cells unchanged, and family imputed as well as JAX's (the
    item fixes it); with noise, the imputed x1's mean and spread within
    15% of the JAX loop's (different streams)."""
    port_t, ref, ref_noise, arrays, truth = mice_run
    out = run_mice_device(port_t, iters=2, kernel="fused")
    assert out.schema.sigma_size == 1115
    assert_mice_like_jax(out, ref, *arrays)
    cn = arrays[3][1]
    acc = (out.cat_codes[1].numpy()[cn] == truth[1][cn]).mean()
    ref_acc = (np.asarray(ref.cat_codes)[1][cn] == truth[1][cn]).mean()
    assert acc >= ref_acc - 0.01
    nz = run_mice_device(port_t, iters=2, kernel="fused", noise=True,
                         seed=5)
    nn = arrays[2][1]
    ours = nz.num_data.numpy()[1][nn] - out.num_data.numpy()[1][nn]
    theirs = (np.asarray(ref_noise.num_data)[1][nn]
              - np.asarray(ref.num_data)[1][nn])
    assert abs(ours.std() / theirs.std() - 1) <= 0.15
    assert abs(ours.mean() - theirs.mean()) <= 0.15 * theirs.std()


def test_run_mice_device_fused_past_1024_matches_jax_pallas(mice_run):
    """The port's fused loop at P = 1,115 against the JAX package's fused
    Pallas loop (kernel='pallas_fused', its kernels in interpret mode, as
    its own tests run them): the bounds of the XLA comparison above."""
    port_t, _, _, arrays, _ = mice_run
    x, codes, nn, cn = arrays
    with pltpu.force_tpu_interpret_mode():
        ref = ref_run_mice_device(ref_from_numpy(x.T, codes.T, nn.T, cn.T),
                                  iters=2, kernel="pallas_fused")
    out = run_mice_device(port_t, iters=2, kernel="fused")
    assert_mice_like_jax(out, ref, *arrays)


def test_run_mice_sharded_world_of_one_past_1024(mice_run, tmp_path):
    """run_mice_sharded(kernel='fused') on a gloo group of one rank at P =
    1,115 is bit-identical to run_mice_device(kernel='fused'), and so held
    to the JAX loop's bounds as well."""
    port_t, ref, _, arrays, _ = mice_run
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.world == 1 and mesh.backend == "gloo"
        got = run_mice_sharded(port_t, iters=2, mesh=mesh, kernel="fused")
    finally:
        dist.destroy_process_group()
    want = run_mice_device(port_t, iters=2, kernel="fused")
    assert torch.equal(got.num_data, want.num_data)
    assert torch.equal(got.cat_codes, want.cat_codes)
    assert_mice_like_jax(got, ref, *arrays)


@pytest.mark.parametrize("kind", ["cat", "num"])
def test_fused_wrapper_past_1024_on_cpu_is_the_plain_version(kind):
    """On CPU tensors fused_impute_aggregate past P = 1,024 is its plain
    version: the column imputed as class_argmax / class_score do it, and
    the Gram of the updated columns from S's tables (the windows' plain
    version), counts exact against an f64 sigma."""
    x, codes, nn, cn = items_small(seed=14)
    rng = np.random.default_rng(15)
    p = SCHEMA.sigma_size
    r, col = (5, 1) if kind == "cat" else (1, 1)
    w_full = rng.normal(size=(p, r)).astype(np.float32)
    icpt = rng.normal(size=r).astype(np.float32)
    null = cn[1] if kind == "cat" else nn[1]
    w_agg = (~(nn[1] if kind == "cat" else cn[1])).astype(np.float32)
    args = (list(map(t, x)), list(map(t, codes)), t(null), t(w_agg),
            t(w_full), t(icpt))
    new, sig = fused_impute_aggregate(*args, schema=SCHEMA, kind=kind,
                                      imp_col=col)
    want_new, want_sig = fused_impute_aggregate_plain(
        *args, schema=SCHEMA, kind=kind, imp_col=col)
    assert torch.equal(new, want_new) and torch.equal(sig, want_sig)
    x2, c2 = list(map(t, x)), list(map(t, codes))
    (c2 if kind == "cat" else x2)[col] = new
    assert torch.equal(sig, masked_gram_cols_plain(x2, c2, t(w_agg),
                                                   schema=SCHEMA))
    d = 3
    z = np.concatenate([np.ones((1, x.shape[1]))]
                       + [a.numpy()[None].astype(np.float64) for a in x2]
                       + [(c.numpy()[None] == np.arange(v)[:, None]) * 1.0
                          for c, v in zip(c2, VOCABS)])
    exact = (z * w_agg) @ z.T
    s = sig.numpy()
    np.testing.assert_array_equal(s[1 + d:, 1 + d:], exact[1 + d:, 1 + d:])
    np.testing.assert_allclose(s, exact, rtol=0,
                               atol=1e-5 * np.abs(exact).max())
