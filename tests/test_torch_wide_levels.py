"""A categorical column past a task's cells beside other columns, and codes
past 32,768 in the scorers, in the port, against the JAX package, on the
CPU.

Where both columns of a cross table C_jk have more levels than a task of
K7/K8 holds (`_build.WIDE_TASK_BYTES // 8` = 8,192 cells; Criteo's C7 and
C15), the plans cut the table by row code as well as by key (`_build.
_row_cut`, CB slabs), in the whole plan, in every window's residual and
keyed plans, and in the scorer's plan; the scorers stage codes as i32
past `_build.QDA_SHORT_LEVELS` levels (a US ZIP5 column's 33,791). On the
CPU every wrapper takes its plain version; these tests hold the plans
(every structurally nonzero place mapped once, no task past its budget,
a keyed pair keyed on one owner column in every window) at a lowered
budget of 64 cells, where two columns of 100 and 90 levels beside one of
3 take the cut, and the plan-driven plain versions and the entry points
against the JAX package, at that budget and at the real one (d = 2,
columns of 8,200 and 3 levels: the smallest schema past it; zip5's
scorers). tests/test_torch_cuda.py holds the kernels against these plain
versions on the card.

Tolerances: sigmas within 1e-5 of max|σ|, counts exact; the plan's
arithmetic against the dense f64 scores within 1e-9 of their scale;
argmax equal on ≥ 0.999 of rows; run_mice_wide at tests/test_torch_wide_v.
py's bounds (codes equal, numerics within 5e-3) at ridge and shrinkage
0.1, and at 1e-3 against exact f64 solves (codes equal on ≥ 0.97 of the
null rows, numerics within 5e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.models import device as ref_device
from duckdb_imputation_tpu.parallel import wide as ref_wide
from duckdb_imputation_tpu.parallel.sharded2d import (
    make_mesh_2d as ref_make_mesh_2d)
from duckdb_imputation_tpu.ring import streaming as ref_streaming
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.sum import masked_sigma as ref_masked_sigma
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.parallel import make_mesh_2d, run_mice_wide
from duckdb_imputation_tpu_torch.ring import streaming
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    keyed_tables_plain,
    masked_gram_cols_plain,
    wide_assemble,
    wide_tables_plain,
    window_order,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

from test_torch_classify_wide import _cxx_constants
from test_torch_past_1024 import (assert_plan_covers_once, plan_places,
                                  structural_pairs)

torch.set_num_threads(2)

CAP = 64                         # the lowered task budget, cells
D, SIZES = 2, (100, 90, 3)       # both wide columns pass CAP: P = 196
PAST = (8200, 3)                 # the smallest schema past 8,192: P = 8,206
ZIP5 = (33791, 5)                # a ZIP5 column beside one of 5: P = 33,801
FAVORITA = (54, 33, 337, 2, 2, 22, 16, 5, 17)
HOME_CREDIT = (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2)


def schema_of(d, sizes):
    return FeatureSchema(d, tuple(tuple(range(v)) for v in sizes))


def ref_schema_of(d, sizes):
    return RefSchema(d, tuple(tuple(range(v)) for v in sizes))


def t(a):
    return torch.tensor(a)


def table(n, d, sizes, seed):
    """x f32[d, n] (x1 = 2·x0 + N(0, 0.3²)), codes i32[c, n] Zipf over
    each column's levels, a tenth of them out of range (−1 or the size),
    weights f32[n] of 0 (a fifth) and 1, so that counts are exact."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, n))
    if d > 1:
        x[1] = 2.0 * x[0] + 0.3 * rng.normal(size=n)
    codes = []
    for v in sizes:
        share = 1.0 / np.arange(1, v + 1)
        c = rng.choice(v, n, p=share / share.sum())
        bad = rng.random(n) < 0.1
        c[bad] = np.where(rng.random(bad.sum()) < 0.5, -1, v)
        codes.append(c)
    w = rng.random(n) > 0.2
    return (x.astype(np.float32), np.stack(codes).astype(np.int32),
            w.astype(np.float32))


def window_keys(plans, p, d):
    """The places (i·P + j) the map entries of `plans` name, and their D
    tiles' (`plan_places`)."""
    return torch.cat([plan_places(pl, d, p) for pl in plans
                      if pl is not None])


def assert_windows_cover_once(plans, d, sizes):
    """The window plans' maps (and D tiles) together name every
    structurally nonzero place of S (both triangles) once."""
    upper, p = structural_pairs(d, sizes)
    i, j = upper // p, upper % p
    want = torch.cat([upper, (j * p + i)[i != j]])
    got = window_keys(plans, p, d)
    assert got.shape == want.shape
    assert torch.equal(torch.sort(got).values, torch.sort(want).values)


def assert_kernel_windows_cover_once(schema):
    """The plans K7 and K8 run S in at the default budget (each window of
    WINDOW_WIDTH columns: `keyed_window_plan`'s residual and keyed plans)
    map every structurally nonzero place of S once, no task past the
    budget."""
    p, d, sizes = schema.sigma_size, schema.num_cols, tuple(schema.cat_sizes)
    plans = []
    for lo, hi in windows(p, _build.WINDOW_WIDTH):
        residual, keyed = _build.keyed_window_plan(schema, lo, hi)
        plans += [residual, keyed and keyed.plan]
    assert_windows_cover_once(plans, d, sizes)
    assert max(map(max_cells, plans)) <= _build.WIDE_TASK_BYTES // 8


def windows(p, width):
    return [(lo, min(lo + width, p)) for lo in range(0, p, width)]


def keyed_windows(d, sizes, width, cap=CAP):
    """Each window's (lo, hi, residual, keyed) at `cap`, its columns keyed
    past P = 0 (every window keys the columns whose tables pass a task)."""
    p = 1 + d + sum(sizes)
    return [(lo, hi, *_build._keyed_window_plan(d, sizes, lo, hi, cap, 0))
            for lo, hi in windows(p, width)]


def max_cells(plan):
    return plan.max_task_cells if plan is not None else 0


# ---------------------------------------------------------------------------
# The plans at a lowered budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scorer", [False, True])
def test_whole_plans_cut_by_row_cover_once(scorer):
    """K7's and K8's whole plan (and the scorer's, QDA's with cross tables
    and NB's without) at tasks of 64 cells: every structurally nonzero
    (i, j) mapped once, no task past 64 cells, C_01 cut into CB slabs of
    at most 64 rows of the narrower column, each of at most 64 cells."""
    for cross in (True, False) if scorer else (True,):
        plan = _build._wide_plan(D, SIZES, cross, scorer, CAP)
        assert_plan_covers_once(plan, D, SIZES, cross, CAP)
        cb = plan.slabs[plan.slabs[:, 0] == _build.SLAB_CB]
        assert (cb.shape[0] > 0) == cross
        if cross:
            rows = plan.slots[plan.slabs[:, 0] == _build.SLAB_CB][:, 2:]
            assert set(map(tuple, cb[:, 1:3].tolist())) == {(0, 1)}
            assert int((rows[:, 1] - rows[:, 0]).max()) <= CAP
            assert int(((cb[:, 4] - cb[:, 3]) * (rows[:, 1] - rows[:, 0]))
                       .max()) <= CAP
            dev = plan.device_slabs[plan.slabs[:, 0] == _build.SLAB_CB]
            assert torch.equal(dev[:, 1:3], rows)
            assert torch.equal(dev[:, 3:6], cb[:, 3:6])
            # the kernel reads a C slab as the CB slab of rows [0, V_k)
            c = plan.slabs[:, 0] == _build.SLAB_C
            assert bool(c.any())
            levels = torch.tensor(SIZES)[plan.slabs[c, 2].long()].int()
            assert torch.equal(plan.slots[c, 2:], torch.stack(
                [torch.zeros_like(levels), levels], 1))
            assert torch.equal(plan.device_slabs[c, 1:3], plan.slots[c, 2:])


@pytest.mark.parametrize("width", [64, 50, 1 + D + sum(SIZES)])
def test_window_plans_cut_by_row_cover_once(width):
    """The windows of `width` columns at tasks of 64 cells: the unkeyed
    plans (`window_plan`'s cut) and the residual and keyed plans together
    each map every structurally nonzero place of S once; no task past 64
    cells; some window's plans hold a CB slab; a keyed task's key range
    and its CB slabs' keys lie inside one layer's."""
    p = 1 + D + sum(SIZES)
    unkeyed = [_build._window_plan(D, SIZES, lo, hi, CAP)
               for lo, hi in windows(p, width)]
    assert_windows_cover_once(unkeyed, D, SIZES)
    assert max(map(max_cells, unkeyed)) <= CAP
    assert any(_build.SLAB_CB in pl.slabs[:, 0].tolist() for pl in unkeyed)
    split = keyed_windows(D, SIZES, width)
    plans = [pl for *_, r, k in split for pl in (r, k and k.plan)]
    assert_windows_cover_once(plans, D, SIZES)
    assert max(map(max_cells, plans)) <= CAP
    assert any(k is not None and _build.SLAB_CB in k.plan.slabs[:, 0].tolist()
               for *_, k in split)
    for *_, k in split:
        if k is None:
            continue
        for (j, lo, hi), ly in zip(k.task_keys.tolist(), k.layer_of):
            col, a, b = k.layer_keys[ly]
            assert col == j and a <= lo < hi <= b
        slabs = k.plan.slabs
        cb = slabs[slabs[:, 0] == _build.SLAB_CB]
        tk = k.task_keys[slabs[slabs[:, 0] == _build.SLAB_CB][:, 6].long()]
        assert bool((cb[:, 3] >= tk[:, 1]).all() & (cb[:, 4] <= tk[:, 2])
                    .all())


def test_keyed_pairs_keep_one_owner_in_every_window():
    """At tasks of 64 cells both wide columns are keyed; every slab of
    C_01 in every window of 64, 50 and P columns is keyed on one column
    (the wider, 0) and lies in a keyed plan, never in a residual; so S
    assembled from any set of windows by the plans' plain arithmetic is
    exactly symmetric and equal to the plain Gram (within 1e-5 of
    max|σ|, counts exact)."""
    assert _build.keyed_columns(D, SIZES, CAP, 0) == (0, 1)
    x, codes, w = table(3000, D, SIZES, seed=1)
    xs, cs = list(t(x)), list(t(codes))
    p = 1 + D + sum(SIZES)
    want = masked_gram_cols_plain(xs, cs, t(w), schema=schema_of(D, SIZES))
    for width in (64, 50, p):
        owners = set()
        got = torch.zeros((p, p))
        for lo, hi, residual, keyed in keyed_windows(D, SIZES, width):
            if residual is not None:
                rs = residual.slabs
                cross = rs[(rs[:, 0] >= _build.SLAB_C)]
                assert not any({a, b} == {0, 1}
                               for a, b in cross[:, 1:3].tolist())
                got[:, lo:hi] += wide_assemble(wide_tables_plain(
                    xs, cs, t(w), schema=schema_of(D, SIZES),
                    plan=residual), schema=schema_of(D, SIZES),
                    plan=residual)
            if keyed is not None:
                ks = keyed.plan.slabs
                for kind, a, b in ks[:, :3].tolist():
                    if kind != _build.SLAB_K and {a, b} == {0, 1}:
                        owners.add(a)
                order = window_order(xs, cs, t(w), schema=schema_of(D, SIZES),
                                     columns=keyed.columns)
                got[:, lo:hi] += wide_assemble(
                    keyed_tables_plain(order, keyed,
                                       schema=schema_of(D, SIZES), n=3000),
                    schema=schema_of(D, SIZES), plan=keyed.plan)[0]
        assert owners == {0}
        assert torch.equal(got, got.T)
        counts = torch.ones((p, p), dtype=torch.bool)
        counts[1:1 + D, :] = counts[:, 1:1 + D] = False
        assert torch.equal(got[counts], want[counts])
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.parametrize("d,sizes", [
    (3, FAVORITA), (3, FAVORITA + (4100,)), (2, (8192, 8192)),
    (104, HOME_CREDIT), (3, (6, 5, 1100))])
def test_default_budget_keeps_the_plans_before(d, sizes):
    """At the default budget no table of the schemas the port ran before
    is cut by row (favorita_wide, favorita_items, wide16k with two columns
    of exactly 8,192 levels, Home Credit, the P = 1,115 test schema): no
    window's table has a row range, no plan a CB slab, and no window of
    their S (the whole S included) is cut into WINDOW_WIDTH windows."""
    schema = schema_of(d, sizes)
    p = schema.sigma_size
    cap = _build.WIDE_TASK_BYTES // 8
    keyed = _build.keyed_columns(d, sizes)
    for lo, hi in windows(p, _build.WINDOW_WIDTH) + [(0, p)]:
        for keys in ((), keyed):
            for tb in _build._window_tables(d, sizes, lo, hi, keys)[1]:
                kind, key, row, _, _, cells, _, v_lo = tb
                if kind == _build.SLAB_C:
                    assert (v_lo, cells) == (0, sizes[row])
                assert cells <= cap
        assert _build.window_cuts(schema, lo, hi) == [(lo, hi)]
    for cross in (True, False):
        assert _build.SLAB_CB not in _build.qda_plan(
            schema, cross).slabs[:, 0].tolist()
    if p <= _build.MAX_WIDE_SIGMA_SIZE:
        assert _build.SLAB_CB not in _build.wide_plan(schema).slabs[
            :, 0].tolist()


def test_plan_cache_keeps_each_part_within_its_bound():
    """`_build.BytesCache` keeps the least recently used results of each
    part (a device) while they fit the bound the part has as a result is
    kept, evicting only that part's; a result past its bound is not kept;
    the device plans' bound is DEVICE_PLAN_SHARE of the spare memory."""
    from duckdb_imputation_tpu_torch.ring.kernels import sigma_pallas

    bounds = {"a": 100, "b": 40}
    cache = _build.BytesCache(lambda part, held: bounds[part],
                              part=lambda out: out[0])
    made = []

    @cache
    def result(part, size):
        made.append((part, size))
        return part, torch.zeros(size, dtype=torch.uint8)

    result("a", 60), result("b", 40), result("a", 30)
    assert dict(cache.held) == {"a": 90, "b": 40}
    result("a", 60)                     # a hit: no call, now the newest
    result("a", 20)                     # evicts ("a", 30) only
    assert dict(cache.held) == {"a": 80, "b": 40}
    result("b", 41)                     # past b's bound: not kept
    assert dict(cache.held) == {"a": 80, "b": 40}
    result("a", 30), result("b", 40)
    assert made == [("a", 60), ("b", 40), ("a", 30), ("a", 20), ("b", 41),
                    ("a", 30)]
    cache.clear()
    assert not cache.store and not cache.held
    assert sigma_pallas._plan_room(None, 0) == _build.PLAN_CACHE_BYTES
    assert sigma_pallas._plan_room(torch.device("cpu"), 5) == \
        _build.PLAN_CACHE_BYTES
    assert 0 < sigma_pallas.DEVICE_PLAN_SHARE < 1


# ---------------------------------------------------------------------------
# The plan-driven plain versions against the JAX package
# ---------------------------------------------------------------------------

def test_row_cut_tables_match_jax():
    """K7's tables on the whole plan at tasks of 64 cells, and the keyed
    windows' tables over the columns' order (`keyed_tables_plain`), placed
    through their maps, against the JAX package's masked sigma: counts
    exact, within 1e-5 of max|σ|."""
    x, codes, w = table(4000, D, SIZES, seed=2)
    schema = schema_of(D, SIZES)
    ref = np.asarray(ref_masked_sigma(x, codes, w,
                                      schema=ref_schema_of(D, SIZES)))
    plan = _build._wide_plan(D, SIZES, True, False, CAP)
    xs, cs = list(t(x)), list(t(codes))
    whole = wide_assemble(wide_tables_plain(xs, cs, t(w), schema=schema,
                                            plan=plan),
                          schema=schema, plan=plan).numpy()
    p = schema.sigma_size
    keyed = np.zeros((p, p), np.float32)
    for lo, hi, residual, kp in keyed_windows(D, SIZES, 64):
        if residual is not None:
            keyed[:, lo:hi] += wide_assemble(wide_tables_plain(
                xs, cs, t(w), schema=schema, plan=residual),
                schema=schema, plan=residual).numpy()
        if kp is not None:
            order = window_order(xs, cs, t(w), schema=schema,
                                 columns=kp.columns)
            keyed[:, lo:hi] += wide_assemble(keyed_tables_plain(
                order, kp, schema=schema, n=x.shape[1]), schema=schema,
                plan=kp.plan)[0].numpy()
    counts = np.ones((p, p), bool)
    counts[1:1 + D, :] = counts[:, 1:1 + D] = False
    for got in (whole, keyed):
        np.testing.assert_array_equal(got[counts], ref[counts])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def seeded_qda(d, sizes, classes=3, seed=8):
    """quad [C, m, m] negative definite, lin [C, m], intercept [C], f32,
    at m = P − 1."""
    rng = np.random.default_rng(seed)
    m = d + sum(sizes)
    b = rng.normal(size=(classes, m, 6)) * 0.3
    quad = -(b @ b.transpose(0, 2, 1) + 0.05 * np.eye(m))
    return (quad.astype(np.float32),
            rng.normal(size=(classes, m)).astype(np.float32),
            rng.normal(size=classes).astype(np.float32))


def test_row_cut_scorer_matches_jax():
    """The scorer's plain version on a plan of 64-cell tasks, whose cross
    table is cut by row (CB slabs), against the JAX package's XLA scorer:
    argmax equal on ≥ 0.999 of rows; its scores against the dense f64
    form of its tables within 1e-9 of their scale."""
    quad, lin, icpt = seeded_qda(D, SIZES)
    x, codes, _ = table(3000, D, SIZES, seed=9)
    ref = np.asarray(ref_device.qda_predict_device(
        *map(jnp.asarray, (quad, lin, icpt, x, codes)),
        schema=ref_schema_of(D, SIZES), method="xla"))
    p = 1 + D + sum(SIZES)
    a = torch.zeros((3, p, p), dtype=torch.float64)
    a[:, 0, 0] = t(icpt).double()
    a[:, 0, 1:] = a[:, 1:, 0] = t(lin).double() / 2
    a[:, 1:, 1:] = t(quad).double()
    plan = _build._wide_plan(D, SIZES, True, True, CAP)
    assert _build.SLAB_CB in plan.slabs[:, 0].tolist()
    tables = port_qda._pack(a, plan).float()
    schema = schema_of(D, SIZES)
    got = port_qda.qda_predict_plain(tables, plan, t(x), t(codes),
                                     schema=schema).numpy()
    assert (got == ref).mean() >= 0.999
    assert len(np.unique(got)) == 3
    # the dense f64 form of the f32 cells: each cell at the first place
    # of its map entries (sorted by cell), halved off the diagonal
    e = plan.entries.long()
    flat = plan.task_base[e[:, 0]] + e[:, 1]
    e = e[torch.cat([torch.tensor([True]), flat[1:] != flat[:-1]])]
    vals = tables[:, plan.task_base[e[:, 0]] + e[:, 1]].double()
    dense = torch.zeros((3, p, p), dtype=torch.float64)
    off = e[:, 2] != e[:, 3]
    dense[:, e[~off, 2], e[~off, 3]] = vals[:, ~off]
    dense[:, e[off, 2], e[off, 3]] = vals[:, off] / 2
    dense[:, e[off, 3], e[off, 2]] = vals[:, off] / 2
    ok = [(c >= 0) & (c < v) for c, v in zip(codes, SIZES)]
    z = np.concatenate([np.ones((1, x.shape[1])), x.astype(np.float64)]
                       + [((codes[j] == np.arange(v)[:, None]) & ok[j]) * 1.0
                          for j, v in enumerate(SIZES)])
    want = np.einsum("in,cij,jn->cn", z, dense.numpy(), z)
    scores = np.stack([s.numpy() for s in port_qda.class_scores_plain(
        tables, plan, t(x), t(codes), schema=schema)])
    np.testing.assert_allclose(scores, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The real budget: the smallest schema past it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def past():
    """d = 2, columns of 8,200 and 3 levels (P = 8,206), 2,000 rows."""
    return table(2000, 2, PAST, seed=5)


def test_smallest_schema_past_the_budget_is_taken(past):
    """At P = 8,206 the checks that refused a column past 8,192 levels
    beside another pass, and the windows' plans (residual and keyed, the
    8,200-level column keyed) map every structurally nonzero place once;
    sum_to_triple's sigma equals the JAX package's (counts exact, within
    1e-5 of max|σ|)."""
    schema = schema_of(2, PAST)
    p = schema.sigma_size
    _build.check_window(schema, 0, p)
    _build.check_qda(schema, 2, 2000)
    assert _build.keyed_columns(2, PAST) == (0,)
    assert_kernel_windows_cover_once(schema)
    x, codes, w = past
    got = sigma_from_triple(port_sum.sum_to_triple(
        t(x), t(codes), t(w), schema=schema)).numpy()
    ref = np.asarray(ref_sft(ref_sum.sum_to_triple(
        x, codes, w, schema=ref_schema_of(2, PAST))))
    counts = np.ones((p, p), bool)
    counts[1:3, :] = counts[:, 1:3] = False
    np.testing.assert_array_equal(got[counts], ref[counts])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_smallest_schema_past_grouped_matches_jax(past):
    """sum_to_triple_grouped at P = 8,206, G = 2, against the JAX
    package's: each group's sigma, counts exact, within 1e-5 of max|σ|."""
    x, codes, w = past
    g = (np.arange(x.shape[1]) % 3 == 0).astype(np.int32)
    got = sigma_from_triple(port_sum.sum_to_triple_grouped(
        t(x), t(codes), t(g), schema=schema_of(2, PAST), num_groups=2,
        weights=t(w))).numpy()
    ref = np.asarray(ref_sft(ref_sum.sum_to_triple_grouped(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(g),
        schema=ref_schema_of(2, PAST), num_groups=2,
        weights=jnp.asarray(w))))
    p = got.shape[-1]
    counts = np.ones((p, p), bool)
    counts[1:3, :] = counts[:, 1:3] = False
    for gg in range(2):
        np.testing.assert_array_equal(got[gg][counts], ref[gg][counts])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_smallest_schema_past_scan_gram_matches_jax(past):
    """scan_gram's fold at P = 8,206 (nulls in x1 and in the 3-level
    column, K = 2 flags) against the JAX package's: counts exact, within
    1e-5 of max|G|; a CUDA fold's checks pass."""
    x, codes, _ = past
    num = x.astype(np.float64)
    cat = codes.astype(np.int64)
    rng = np.random.default_rng(6)
    num[1, rng.random(num.shape[1]) < 0.1] = np.nan
    cat = np.where((cat >= 0) & (cat < np.array(PAST)[:, None]), cat, 0)
    cat[1, rng.random(num.shape[1]) < 0.1] = -1
    keys = tuple(tuple(range(v)) for v in PAST)
    ss = streaming.StreamSchema(schema=FeatureSchema(2, keys),
                                nullable_num=(1,), nullable_cat=(1,),
                                n_rows=num.shape[1])
    streaming.check_fold(ss, 700)
    got = streaming.scan_gram(
        streaming.chunks_from_arrays(num, cat, chunk_rows=700), ss,
        chunk_rows=700, device="cpu").numpy()
    rss = ref_streaming.StreamSchema(schema=RefSchema(2, keys),
                                     nullable_num=(1,), nullable_cat=(1,),
                                     n_rows=num.shape[1])
    ref = np.asarray(ref_streaming.scan_gram(
        ref_streaming.chunks_from_arrays(num, cat, chunk_rows=700), rss,
        chunk_rows=700), np.float64)
    p = got.shape[0]
    assert p == 8206 + 2
    counts = np.ones((p, p), bool)
    counts[1:3, :] = counts[:, 1:3] = False
    np.testing.assert_array_equal(got[counts], ref[counts])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def dense_z(x, codes, sizes):
    """z = [1 ‖ x ‖ one-hot codes] f64[n, P] of a filled table."""
    n, d = x.shape[1], x.shape[0]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    z = np.zeros((n, 1 + d + offs[-1]))
    z[:, 0], z[:, 1:1 + d] = 1.0, x.T
    for j in range(len(sizes)):
        z[np.arange(n), 1 + d + offs[j] + codes[j]] = 1.0
    return z


def exact_lda_codes(x, codes, null, sizes, label, shrinkage):
    """run_mice_wide's LDA step (`lda_solve_wide`'s shrunk pooled
    within-class covariance, label block and intercept excluded) solved
    exactly in f64 over the rows not `null`: the class of every row."""
    z = dense_z(x, codes, sizes)
    s = z.T @ (z * (~null)[:, None])
    lo = 1 + x.shape[0] + sum(sizes[:label])
    act = np.ones(s.shape[0], bool)
    act[0] = False
    act[lo:lo + sizes[label]] = False
    n = s[0, 0]
    sfull = s[:, lo:lo + sizes[label]]
    cnt = np.maximum(sfull[0], 1.0)
    sc = sfull * act[:, None]
    low_diag = (sc * sc / cnt).sum(1)
    mu = ((act * np.diag(s)).sum() - (act * low_diag).sum()) / act.sum()
    a = ((1 - shrinkage) * (s * np.outer(act, act) - (sc / cnt) @ sc.T)
         + shrinkage * mu * np.eye(s.shape[0])) / n
    w = np.zeros_like(sc)
    w[act] = np.linalg.solve(a[np.ix_(act, act)], (sc / cnt)[act])
    icpt = -0.5 * (sfull / cnt * w).sum(0) + np.log(cnt / n)
    return (z @ w + icpt).argmax(1)


def exact_ridge(x, codes, null, sizes, label, ridge):
    """run_mice_wide's numeric step (`cg_solve_wide`'s ridge, not on the
    intercept) solved exactly in f64 over the rows not `null`: the
    prediction of every row."""
    z = dense_z(x, codes, sizes)
    s = z.T @ (z * (~null)[:, None])
    y = 1 + label
    act = np.ones(s.shape[0], bool)
    act[y] = False
    pen = act.copy()
    pen[0] = False
    a = s[np.ix_(act, act)] / s[0, 0] + ridge * np.diag(pen[act])
    theta = np.zeros(s.shape[0])
    theta[act] = np.linalg.solve(a, s[act, y] / s[0, 0])
    return z @ theta


@pytest.mark.parametrize("reg, cg_iters, tol", [
    (1e-1, 1000, 1e-9),
    (1e-3, 4000, 1e-11),          # tests/test_torch_wide_v.py's solver
], ids=["reg1e-1", "reg1e-3"])
def test_smallest_schema_past_run_mice_wide_matches_jax(past, reg, cg_iters,
                                                         tol):
    """run_mice_wide at P = 8,206 on a grid of one rank (no collective)
    against the JAX package's on its 2 × 4 virtual mesh, imputing x1 and
    the 3-level column (20% nulls each), one round, ridge and shrinkage
    `reg`. At 0.1: codes equal, numerics within 5e-3. At 1e-3 (condition
    number ~5e6) the JAX package's f32 CG stops ten times further from
    the exact solve than the port's f64-accumulated one (PERF.md §7), and
    the codes of 2% of the rows part; both steps are held against their
    f64 solve instead: the port's codes equal its on ≥ 0.97 of the null
    rows, and on ≥ 0.9 of the rows where the port and JAX part; the port's
    numerics within 5e-3 of the exact ridge over the port's codes."""
    x, codes, _ = past
    rng = np.random.default_rng(7)
    n = x.shape[1]
    codes = np.where((codes >= 0) & (codes < np.array(PAST)[:, None]),
                     codes, 0).astype(np.int32)
    codes[1] = (x[0] > 0.3).astype(np.int32) + (x[0] > -0.3)
    nn = np.zeros_like(x, bool)
    cn = np.zeros_like(codes, bool)
    nn[1] = rng.random(n) < 0.2
    cn[1] = rng.random(n) < 0.2
    kw = dict(iters=1, ridge=reg, shrinkage=reg, cg_iters=cg_iters,
              tol=tol)
    got_x, got_c = run_mice_wide(
        t(x), t(codes), t(nn), t(cn), schema=schema_of(2, PAST),
        mesh=make_mesh_2d(1, 1, device="cpu"), **kw)
    ref_x, ref_c = ref_wide.run_mice_wide(
        x, codes, nn, cn, schema=ref_schema_of(2, PAST),
        mesh=ref_make_mesh_2d(2, 4), **kw)
    got_x, got_c = got_x.numpy(), got_c.numpy()
    ref_x, ref_c = np.asarray(ref_x), np.asarray(ref_c)
    if reg == 1e-1:
        np.testing.assert_array_equal(got_c, ref_c)
        np.testing.assert_allclose(got_x, ref_x, rtol=5e-3, atol=5e-3)
        return
    xf = x.astype(np.float64)                 # the mean and mode fill
    xf[1, nn[1]] = xf[1, ~nn[1]].mean()
    cf = codes.copy()
    cf[1, cn[1]] = np.bincount(codes[1, ~cn[1]], minlength=PAST[1]).argmax()
    lda = exact_lda_codes(xf, cf, cn[1], PAST, 1, reg)
    null = cn[1]
    np.testing.assert_array_equal(got_c[:, ~null], codes[:, ~null])
    agree = (got_c[1, null] == lda[null]).mean()
    parted = null & (got_c[1] != ref_c[1])
    assert agree >= 0.97, agree
    assert parted.sum() > 0
    assert (got_c[1, parted] == lda[parted]).mean() >= 0.9
    assert (ref_c[1, parted] != lda[parted]).mean() >= 0.9
    cf[1] = got_c[1]
    pred = exact_ridge(xf, cf, nn[1], PAST, 1, reg)
    np.testing.assert_array_equal(got_x[:, ~nn[1]], x[:, ~nn[1]])
    np.testing.assert_allclose(got_x[1, nn[1]], pred[nn[1]], rtol=5e-3,
                               atol=5e-3)


def test_lda_solve_at_shrinkage_1e3_against_exact(past):
    """Why run_mice_wide's codes part from the JAX package's at shrinkage
    1e-3 (the test above): both packages' `lda_solve_wide` on the port's
    sigma of the table that test's LDA step solves (x1 and the label
    filled; P = 8,206; 4,000 CG steps, tol 1e-11) against the exact f64
    solve of the same system (condition number ~5e6). The port's CG stops
    on its own test within a few checks: its recurrence residual passes
    1e-11·‖M‖ while the true one stays above 1e-5 of it, the accuracy an
    f32 CG attains here. That residual is below 2e-4 and its classes
    equal the exact solve's on ≥ 0.97 of the null rows; the JAX package's
    CG ends further from the exact solve (residual and error each larger)
    and its classes part from the exact ones on more rows. Prints the
    figures (pytest -s)."""
    from duckdb_imputation_tpu_torch.parallel import wide as port_wide

    x, codes, _ = past
    rng = np.random.default_rng(7)
    n = x.shape[1]
    codes = np.where((codes >= 0) & (codes < np.array(PAST)[:, None]),
                     codes, 0).astype(np.int32)
    codes[1] = (x[0] > 0.3).astype(np.int32) + (x[0] > -0.3)
    x = x.copy()
    x1_null = rng.random(n) < 0.2
    x[1, x1_null] = x[1, ~x1_null].astype(np.float64).mean()
    null = rng.random(n) < 0.2
    codes[1, null] = np.bincount(codes[1, ~null]).argmax()
    schema, mesh = schema_of(2, PAST), make_mesh_2d(1, 1, device="cpu")
    w8 = (~null).astype(np.float32)
    sig = port_wide.sigma_wide(t(x), t(codes), t(w8), schema=schema,
                               mesh=mesh)
    kw = dict(label=1, shrinkage=1e-3, iters=4000, tol=1e-11)
    port_wide._pcg.steps = 0
    wp = port_wide.lda_solve_wide(sig, mesh=mesh, schema=schema,
                                  **kw)[0].double().numpy()
    steps = port_wide._pcg.steps
    rmesh = ref_make_mesh_2d(2, 4)
    wj = np.asarray(ref_wide.lda_solve_wide(
        ref_wide.sigma_wide(x, codes, w8, schema=ref_schema_of(2, PAST),
                            mesh=rmesh), mesh=rmesh,
        schema=ref_schema_of(2, PAST), **kw)[0], np.float64)
    s = sig.double().numpy()
    lo, nc = 1 + 2 + PAST[0], PAST[1]
    act = np.ones(s.shape[0], bool)
    act[0] = False
    act[lo:lo + nc] = False
    cnt = np.maximum(s[0, lo:lo + nc], 1.0)
    sc = s[:, lo:lo + nc] * act[:, None]
    mu = ((act * np.diag(s)).sum()
          - (act * (sc * sc / cnt).sum(1)).sum()) / act.sum()
    a = (((1 - 1e-3) * (s * np.outer(act, act) - (sc / cnt) @ sc.T)
          + 1e-3 * mu * np.eye(s.shape[0])) / s[0, 0])[np.ix_(act, act)]
    rhs = (sc / cnt)[act]
    we = np.linalg.solve(a, rhs)
    exact = exact_lda_codes(x.astype(np.float64), codes, null, PAST, 1,
                            1e-3)[null]
    z = dense_z(x.astype(np.float64), codes, PAST)[null]

    def figures(w):
        icpt = (-0.5 * (s[:, lo:lo + nc] / cnt * w).sum(0)
                + np.log(cnt / s[0, 0]))
        return (np.linalg.norm(a @ w[act] - rhs) / np.linalg.norm(rhs),
                np.linalg.norm(w[act] - we) / np.linalg.norm(we),
                ((z @ w + icpt).argmax(1) == exact).mean())

    port, jax_ = figures(wp), figures(wj)
    print(f"lda 1e-3, {null.sum()} null rows: relative residual, error, "
          f"classes equal to the exact solve's: port {port} after {steps} "
          f"CG steps, JAX {jax_}")
    assert steps < 4000 and 1e-5 < port[0] < 2e-4 and port[2] >= 0.97
    assert jax_[0] > port[0] and jax_[1] > port[1] and jax_[2] < port[2]


def test_order_pass_takes_the_widest_columns():
    """The order pass of a keyed column (window_order.cu: a warp's V
    counters and two chunks of rows in shared memory) takes criteo_mid's
    rows (1 + 13 + 17 ints) beside C15's 14,992 counters and zip5's (1 +
    4 + 2) beside 33,791, with room to spare; criteo_mid keys C7 and C15
    and 8 more columns."""
    criteo = (1460, 583, 305, 24, 12517, 633, 3, 5683, 3194, 27, 14992,
              10, 2173, 4, 18, 15, 105)
    for levels, cols in ((14992, 1 + 13 + len(criteo)),
                         (ZIP5[0], 1 + 4 + 2)):
        stride = _build.order_stride(cols)
        _build.check_order_stride(levels, stride)
        assert _build.order_piece(levels, 2 * stride) == 2 * stride
    assert _build.keyed_columns(13, criteo) == (0, 1, 2, 4, 5, 7, 8, 10, 12,
                                                16)


# ---------------------------------------------------------------------------
# zip5: codes past 32,768 in the scorers
# ---------------------------------------------------------------------------

def test_zip5_scorer_limits():
    """A column of 33,791 levels: check_qda takes it for QDA and NB (its
    codes staged as i32), and the tile qda_tile picks fits shared memory
    at 4-byte codes; at 32,768 levels the codes stay i16, and beside 200
    columns the scorer's tile stages more numeric columns before its plan
    turns local (`qda_local`); the constant equals the kernel's."""
    zip5 = schema_of(4, ZIP5)
    assert _build.qda_code_bytes(zip5) == 4
    assert _build.qda_code_bytes(schema_of(4, (32768, 5))) == 2
    assert _build.QDA_SHORT_LEVELS == _cxx_constants()["kQdaShortLevels"]
    assert _build.SLAB_CB == _cxx_constants()["kSlabCB"]
    for cross in (True, False):
        _build.check_qda(zip5, 2, 1000, cross)
        plan = _build.qda_plan(zip5, cross)
        threads, rows, group = _build.qda_tile(zip5, plan, 2)
        assert _build.qda_smem_bytes(plan.max_task_cells, zip5,
                                     threads * rows, group) <= _build.WIDE_SMEM
    def first_local(levels):
        sizes = (levels,) + (2,) * 199
        return next(d for d in range(1, 1000) if _build.qda_local(
            schema_of(d, sizes)))
    assert first_local(ZIP5[0]) < first_local(32768)


def test_zip5_nb_pipeline_matches_jax():
    """The NB path at zip5 (label the 5-level column, the ZIP5 column and
    4 numerics its features), 1,000 rows: the grouped NB aggregate and
    nb_train_device against the JAX package's (counts exact, parameters
    within 1e-5), and nb_predict_device (K3w's plain version over the
    scorer's plan, codes past 32,768) against the naive Bayes scores of
    the JAX package's parameters in f64 (its nb_predict_device builds a
    dense C × P × P quad, 23 GB here): argmax equal on ≥ 0.999 of rows,
    accuracy above the majority share + 0.02."""
    rng = np.random.default_rng(11)
    n = 1000
    y = rng.integers(0, 5, n).astype(np.int32)
    x = (rng.normal(size=(4, n)) + y[None] * 0.8).astype(np.float32)
    zipc = rng.integers(0, ZIP5[0], (1, n)).astype(np.int32)
    zipc[0, :5] = ZIP5[0] - 1 - np.arange(5)       # codes past 32,768
    keys = (tuple(range(ZIP5[0])),)
    schema, rschema = FeatureSchema(4, keys), RefSchema(4, keys)
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(zipc), t(y), schema=schema,
                                         num_groups=5)
    ragg = ref_sum.sum_to_nb_agg_grouped(x, zipc, y, schema=rschema,
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
    pred = port_device.nb_predict_device(*got, t(x), t(zipc),
                                         schema=schema).numpy()
    priors, mean, var, freqs = (np.asarray(r, np.float64) for r in ref)
    var = np.maximum(var, 0.0) + 1e-9
    log_freq = np.where(freqs > 0, np.log(np.maximum(freqs, 1e-38)), -1e30)
    xs = x.astype(np.float64)
    score = (np.log(np.maximum(priors, 1e-38))[:, None]
             - 0.5 * ((xs[None] - mean[:, :, None]) ** 2 / var[:, :, None]
                      + np.log(2 * np.pi * var)[:, :, None]).sum(1)
             + log_freq[:, zipc[0]])
    assert (pred == score.argmax(0)).mean() >= 0.999
    assert (pred == y).mean() > np.bincount(y).max() / n + 0.02
