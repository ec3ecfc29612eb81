"""The port past the shared-memory column limits, on the CPU, against the
JAX package: K_j cut by column range (KB slabs) where a task staging
every numeric column beside a code column passes shared memory (d ≥ 835;
K7's and K8's whole plan and windows, K2w's Gram), the scorer's local
plans (K3/K3w past 756 numeric columns: MNIST's 784 pixels, Epsilon's
2,000 columns), K2w's impute plans with x read from device memory (d ≥
881 at R = 33; d ≥ 1,801 past P = 1,024) and the order pass copying rows
of 1 + d + c ints in pieces. Each plan fits a block's shared memory and
maps every structurally nonzero place once; its plain walk equals the
JAX package's sigma or scorer; the MICE loop and the QDA / NB pipelines
at those widths equal JAX's (or the f64 oracle, for QDA).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_past_smem.py -q
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    keyed_tables_plain,
    masked_gram_window_keyed_plain,
    wide_assemble,
    wide_tables_plain,
    window_order,
)

from test_torch_classify_wide import _train_f64
from test_torch_past_1024 import assert_plan_covers_once
from test_torch_wide_levels import assert_windows_cover_once

torch.set_num_threads(2)

WHOLE = (835, (3,))       # one past K7's K_j beside a code column, P = 839
WINDOWS = (1100, (2,))    # past P = 1,024: two windows, P = 1,103
EPSILON = (2000, (2,))    # Epsilon with its label as a column, P = 2,003


def schemas(d, sizes):
    keys = tuple(tuple(range(v)) for v in sizes)
    return FeatureSchema(num_cols=d, cat_keys=keys), RefSchema(
        num_cols=d, cat_keys=keys)


def t(a):
    return torch.tensor(a)


def table(d, sizes, n, seed):
    """x f32[d, n] from a rank-8 factor model plus noise, codes i32[c, n]
    uniform with a tenth out of range (−1 or the size), binary weights
    (so that counts are exact)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(8, n))
    x = (rng.normal(size=(d, 8)) @ f
         + 0.5 * rng.normal(size=(d, n))).astype(np.float32)
    codes = np.stack([rng.integers(0, v, n) for v in sizes])
    bad = rng.random(codes.shape) < 0.1
    codes[bad] = np.where(rng.random(bad.sum()) < 0.5, -1,
                          np.repeat(np.array(sizes)[:, None], n, 1)[bad])
    w = (rng.random(n) > 0.2).astype(np.float32)
    return x, codes.astype(np.int32), w


def jax_sigma(x, codes, w, ref_schema, groups=None):
    """The JAX package's sigma (XLA), or one per group."""
    if groups is None:
        return np.asarray(ref_sft(ref_sum.sum_to_triple(
            jnp.asarray(x), jnp.asarray(codes), jnp.asarray(w),
            schema=ref_schema, backend="xla")), np.float64)
    return np.asarray(ref_sft(ref_sum.sum_to_triple_grouped(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(groups),
        schema=ref_schema, num_groups=int(groups.max()) + 1,
        weights=jnp.asarray(w), method="masked")), np.float64)


def assert_sigma_close(got, want, d):
    """Counts exact (the constant and one-hot rows and columns), the rest
    within 1e-5 of max|σ|; S exactly symmetric."""
    got = np.asarray(got, np.float64)
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))
    idx = [0] + list(range(1 + d, got.shape[-1]))
    np.testing.assert_array_equal(got[..., idx, :][..., idx],
                                  want[..., idx, :][..., idx])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def kinds(*plans):
    return {k for pl in plans if pl is not None
            for k in pl.slabs[:, 0].tolist()}


# ---------------------------------------------------------------------------
# The plans and their plain walks against JAX's sigma
# ---------------------------------------------------------------------------

def test_whole_plan_past_k7_limit_matches_jax():
    """K7's one-launch plan at 835 numeric columns beside one of 3 levels
    (P = 839), K_j cut by column range and D on the D kernel's tiles:
    within shared memory, every structurally nonzero place mapped once by
    the slabs and the tiles (i ≤ j, so S = Sᵀ), no task past its budget,
    each KB slab's task staging its own columns; its cells placed by its
    map equal JAX's sigma."""
    (d, sizes), n = WHOLE, 400
    schema, ref_schema = schemas(d, sizes)
    plan = _build.wide_plan(schema)
    assert plan.smem_bytes <= _build.WIDE_SMEM
    # D on the tensor cores past the crossover: its tiles, no D slab
    assert kinds(plan) == {_build.SLAB_KB} and plan.dense is not None
    assert_plan_covers_once(plan, d, sizes, True, _build.WIDE_TASK_BYTES // 8)
    assert plan.max_stage_x < d
    for sl, slot in zip(plan.slabs.tolist(), plan.slots.tolist()):
        if sl[0] == _build.SLAB_KB:
            row = plan.stage_cols[sl[6]].tolist()
            a0 = max(slot[2], 1)
            cols = row[2:2 + row[0]]
            assert cols[slot[1] + a0 - 1:slot[1] + slot[3] - 1] == list(
                range(a0 - 1, slot[3] - 1))
    x, codes, w = table(d, sizes, n, 0)
    got = wide_assemble(wide_tables_plain(list(t(x)), list(t(codes)), t(w),
                                          schema=schema, plan=plan),
                        schema=schema, plan=plan)
    assert_sigma_close(got.numpy(), jax_sigma(x, codes, w, ref_schema), d)


def test_window_plans_past_k7_limit_match_jax():
    """K7's windows at 1,100 numeric columns beside one of 2 levels (P =
    1,103): each window's residual plan within shared memory, KB slabs
    only in the column ranges with a place in the window, the windows'
    maps covering every structurally nonzero place of S once; their cells
    placed by their maps equal JAX's sigma."""
    (d, sizes), n = WINDOWS, 300
    schema, ref_schema = schemas(d, sizes)
    p = schema.sigma_size
    x, codes, w = table(d, sizes, n, 1)
    got, plans = np.zeros((p, p)), []
    for lo in range(0, p, _build.WINDOW_WIDTH):
        hi = min(lo + _build.WINDOW_WIDTH, p)
        residual, keyed = _build.keyed_window_plan(schema, lo, hi)
        assert keyed is None and residual.smem_bytes <= _build.WIDE_SMEM
        assert _build.SLAB_KB in kinds(residual)
        plans.append(residual)
        got[:, lo:hi] = wide_assemble(wide_tables_plain(
            list(t(x)), list(t(codes)), t(w), schema=schema, plan=residual),
            schema=schema, plan=residual).numpy()
    assert_windows_cover_once(plans, d, sizes)
    assert_sigma_close(got, jax_sigma(x, codes, w, ref_schema), d)


@pytest.mark.parametrize("name", ["whole", "windows"])
def test_k8_plans_past_k7_limit_match_jax(name):
    """K8's plans at the same schemas (its whole plan at P = 839, its
    windows at P = 1,103: the plans K7 runs, walked a group at a time)
    over group-sorted rows of 3 groups: each group's S from the plain walk
    equals JAX's grouped sigma."""
    (d, sizes), n = (WHOLE if name == "whole" else WINDOWS), 300
    schema, ref_schema = schemas(d, sizes)
    x, codes, w = table(d, sizes, n, 2)
    g = np.sort(np.random.default_rng(3).integers(0, 3, n)).astype(np.int32)
    offsets = t(np.searchsorted(g, np.arange(4)).astype(np.int64))
    p = schema.sigma_size
    if name == "whole":
        plan = _build.wide_plan(schema)
        got = np.stack([wide_assemble(wide_tables_plain(
            list(t(x[:, a:b])), list(t(codes[:, a:b])), t(w[a:b]),
            schema=schema, plan=plan), schema=schema, plan=plan).numpy()
            for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())])
    else:
        got = np.zeros((3, p, p))
        for lo in range(0, p, _build.WINDOW_WIDTH):
            hi = min(lo + _build.WINDOW_WIDTH, p)
            got[:, :, lo:hi] = masked_gram_window_keyed_plain(
                list(t(x)), list(t(codes)), t(w), schema=schema, lo=lo,
                width=hi - lo, offsets=offsets).numpy()
    assert_sigma_close(got, jax_sigma(x, codes, w, ref_schema, g), d)


def test_keyed_windows_past_k7_limit_match_jax():
    """A keyed column beside 900 numeric columns (1,500 levels, P =
    2,401): its K_J as KB tables, a layer each (so a keyed task stages
    only its columns), every window's plans within shared memory and
    covering S once, the order's rows of 1 + d + c ints; the keyed walk
    over the order plus the residual equals JAX's sigma."""
    d, sizes, n = 900, (1500,), 400
    schema, ref_schema = schemas(d, sizes)
    p = schema.sigma_size
    x, codes, w = table(d, sizes, n, 4)
    xs, cs, ws = list(t(x)), list(t(codes)), t(w)
    got, plans = np.zeros((p, p)), []
    for lo in range(0, p, _build.WINDOW_WIDTH):
        hi = min(lo + _build.WINDOW_WIDTH, p)
        residual, keyed = _build.keyed_window_plan(schema, lo, hi)
        plans += [residual, keyed.plan]
        assert keyed.columns == (0,)
        assert kinds(keyed.plan) == {_build.SLAB_KB}
        assert keyed.layers == len(_build._k_ranges(d, _build.KB_COLS))
        assert keyed.plan.smem_bytes <= _build.WIDE_SMEM
        if residual is not None:
            got[:, lo:hi] += wide_assemble(wide_tables_plain(
                xs, cs, ws, schema=schema, plan=residual), schema=schema,
                plan=residual).numpy()
        order = window_order(xs, cs, ws, schema=schema, columns=(0,))
        got[:, lo:hi] += wide_assemble(keyed_tables_plain(
            order, keyed, schema=schema, n=n), schema=schema,
            plan=keyed.plan)[0].numpy()
    assert_windows_cover_once(plans, d, sizes)
    assert_sigma_close(got, jax_sigma(x, codes, w, ref_schema), d)


def test_epsilon_plans_fit_and_cover_once():
    """Epsilon's full-width plans (2,000 numeric columns beside its label,
    P = 2,003): K7's two windows within shared memory and covering every
    structurally nonzero place once, no keyed column; the scorer's plans
    at P = 2,001 (QDA's local plan covering once, NB's its row 0 and
    diagonal) and their tiles within shared memory; K2w's impute plan
    past P = 1,024 taken, x read from device memory."""
    d, sizes = EPSILON
    schema, _ = schemas(d, sizes)
    p = schema.sigma_size
    plans = []
    for lo in range(0, p, _build.WINDOW_WIDTH):
        residual, keyed = _build.keyed_window_plan(
            schema, lo, min(lo + _build.WINDOW_WIDTH, p))
        assert keyed is None and residual.smem_bytes <= _build.WIDE_SMEM
        plans.append(residual)
    assert_windows_cover_once(plans, d, sizes)
    scorer = FeatureSchema(num_cols=d)
    qda = _build.qda_plan(scorer)
    assert qda.local and qda.max_stage_x <= _build.QDA_LOCAL_X
    assert_plan_covers_once(qda, d, (), True, _build.QDA_TASK_CELLS)
    nb = _build.qda_plan(scorer, cross=False)
    e = nb.entries.long()
    assert bool(((e[:, 2] == 0) | (e[:, 2] == e[:, 3])).all())
    assert e.shape[0] == (1 + d) + d
    for plan, classes in ((qda, 2), (nb, 2)):
        threads, rows, group = _build.qda_tile(scorer, plan, classes)
        assert _build.qda_smem_bytes(plan.max_task_cells, scorer,
                                     threads * rows, group,
                                     plan.max_stage_x) <= _build.WIDE_SMEM
    ld, _, batch = _build.impute_global_plan(schema, 2)
    assert not _build.impute_x_terms(schema, 0, batch)
    assert _build.impute_smem_bytes(schema, 0, batch) <= _build.WIDE_SMEM


def test_impute_and_order_plans_past_their_limits():
    """K2w's impute plans one past a batch of x: W whole at 900 numeric
    columns beside 33 classes (P = 934) and W in device memory at 2,000
    (P = 2,003), x read from device memory; the order pass of a keyed
    column of 5,000 levels beside 1,000 numeric columns (rows of 1,008
    ints) taken, in pieces of whole 32-byte sectors."""
    schema, _ = schemas(900, (33,))
    ld, m, batch = _build.impute_plan(schema, 33)
    assert (ld, m) == (33, 2) and batch >= 32
    assert not _build.impute_x_terms(schema, ld, batch)
    assert _build.impute_smem_bytes(schema, ld, batch) <= _build.WIDE_SMEM
    schema, _ = schemas(*EPSILON)
    assert _build.impute_global_plan(schema, 2) == (32, 1, _build.IMP_BATCH)
    stride = _build.order_stride(1 + 1000 + 1)
    assert stride == 1008
    _build.check_order_stride(5000, stride)
    piece = _build.order_piece(5000, stride)
    assert piece < stride and piece % 8 == 0
    assert 4 * _build.order_warp_ints(5000, piece) <= _build.WIDE_SMEM


# ---------------------------------------------------------------------------
# The MICE loop and the classifiers against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,sizes", [(840, (3,)), (1100, (2,))])
def test_run_mice_device_matches_jax(d, sizes):
    """run_mice_device(kernel='plain') past K7's K_j limit (P = 844, one
    launch on the card; P = 1,103, its windows) against JAX's
    kernel='xla', noise off, a round over two numeric columns and the
    categorical one: codes equal, numerics within 1e-3 of these unit-scale
    values (the two SVD solvers part by up to ~4e-4 at hundreds of
    coefficients, tests/test_torch_many_cols.py)."""
    n = 3000
    rng = np.random.default_rng(5)
    f = rng.normal(size=(8, n))
    x = (rng.normal(size=(d, 8)) @ f
         + rng.normal(size=(d, n))).astype(np.float32)
    codes = np.argmax(rng.normal(size=(sizes[0], 8)) @ f
                      + rng.gumbel(size=(sizes[0], n)), 0)[None].astype(
                          np.int32)
    nn = np.zeros(x.shape, bool)
    cn = np.zeros(codes.shape, bool)
    nn[0] = rng.random(n) < 0.2
    nn[d - 1] = rng.random(n) < 0.2
    cn[0] = rng.random(n) < 0.2
    schema, ref_schema = schemas(d, sizes)
    kw = dict(num_null_cols=(0, d - 1), cat_null_cols=(0,), iters=1,
              noise=False)
    got = run_mice_device(from_numpy(x, codes, nn, cn, schema=schema,
                                     rows_first=False, device="cpu"),
                          kernel="plain", **kw)
    ref = ref_run_mice_device(ref_from_numpy(x, codes, nn, cn,
                                             schema=ref_schema,
                                             rows_first=False),
                              kernel="xla", **kw)
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(ref.cat_codes))
    np.testing.assert_allclose(got.num_data.numpy(),
                               np.asarray(ref.num_data), rtol=1e-4,
                               atol=1e-3)


def mnist_like(n, seed, active=48):
    """MNIST's width: 784 pixels in [0, 1], 10 classes. Pixels are class
    templates plus noise, clipped, on `active` central pixels; the rest
    (the borders) are 0 in every row, so each class covariance is
    singular, as MNIST's is. Returns (x f32[784, n], y i32[n])."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    on = rng.choice(784, active, replace=False)
    templ = rng.random((10, active))
    x = np.zeros((784, n), np.float32)
    x[on] = np.clip(templ[y].T + 0.25 * rng.normal(size=(active, n)), 0, 1)
    return x, y


def test_qda_pipeline_at_mnist_width_matches_f64_oracle():
    """GROUP BY label → qda_train_device → qda_predict_device at 784
    pixels over 10 classes: the scorer's plan is local (a task stages its
    own ≤ 128 columns); its predictions agree ≥ 0.999 with the f64 oracle
    of tests/test_torch_classify_wide.py (exact class sigmas, f64
    training, zᵀ·quad·z + lin·z + b in f64) and beat the majority
    share."""
    n = 800
    x, y = mnist_like(n, 6)
    schema = FeatureSchema(num_cols=784)
    assert _build.qda_plan(schema).local
    sig = port_sum.sum_to_triple_grouped(t(x), torch.zeros((0, n),
                                                           dtype=torch.int32),
                                         t(y), schema=schema, num_groups=10)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple
    quad, lin, b = port_device.qda_train_device(sigma_from_triple(sig),
                                                float(n))
    pred = port_device.qda_predict_device(
        quad, lin, b, t(x), torch.zeros((0, n), dtype=torch.int32),
        schema=schema).numpy()
    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)])
    sig64 = np.stack([(z * (y == g)) @ z.T for g in range(10)])
    zz = z[1:]
    oracle = np.stack([np.einsum("in,ij,jn->n", zz, q, zz) + li @ zz + bb
                       for q, li, bb in _train_f64(sig64, n)]).argmax(0)
    assert (pred == oracle).mean() >= 0.999
    assert (pred == y).mean() > np.bincount(y).max() / n + 0.02


def test_nb_pipeline_at_mnist_width_matches_jax():
    """The NB path at 784 pixels over 10 classes (a local plan of row 0
    and the diagonal): the grouped NB aggregate, nb_train_device and
    nb_predict_device against the JAX package's (XLA): counts exact,
    parameters within 1e-5, argmax equal on ≥ 0.999 of rows."""
    n = 2000
    x, y = mnist_like(n, 7)
    x = x + 1e-3 * np.random.default_rng(8).random(x.shape).astype(
        np.float32)                           # NB needs each variance > 0
    codes = np.zeros((0, n), np.int32)
    schema, ref_schema = schemas(784, ())
    assert _build.qda_plan(schema, cross=False).local
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(codes), t(y), schema=schema,
                                         num_groups=10)
    ragg = ref_sum.sum_to_nb_agg_grouped(x, codes, y, schema=ref_schema,
                                         num_groups=10, backend="xla")
    np.testing.assert_array_equal(agg.n.numpy(), np.asarray(ragg.n))
    got = port_device.nb_train_device(agg.n, agg.lin, agg.quad_diag,
                                      agg.lin_cat)
    ref = ref_device.nb_train_device(ragg.n, ragg.lin, ragg.quad_diag,
                                     ragg.lin_cat)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    pred = port_device.nb_predict_device(*got, t(x), t(codes),
                                         schema=schema).numpy()
    rpred = np.asarray(ref_device.nb_predict_device(
        *ref, jnp.asarray(x), jnp.asarray(codes), schema=ref_schema))
    assert (pred == rpred).mean() >= 0.999


def test_local_scorer_matches_jax_qda_predict():
    """The scorer's plain walk over a local plan (784 numeric columns,
    every structurally nonzero place mapped once, at most QDA_LOCAL_X
    columns a task; 3 classes of negative definite quadratic forms, so
    that JAX's XLA scorer's Cholesky exists) against the JAX package's
    qda_predict_device(method='xla'): argmax equal on ≥ 0.999 of rows;
    its scores agree with the dense f64 form within 1e-9 of their
    scale."""
    d, classes, n = 784, 3, 300
    schema, ref_schema = schemas(d, ())
    rng = np.random.default_rng(9)
    b = rng.normal(size=(classes, d, 8)) * 0.3
    quad = -(b @ b.transpose(0, 2, 1) + 0.05 * np.eye(d)).astype(np.float32)
    lin = rng.normal(size=(classes, d)).astype(np.float32)
    icpt = rng.normal(size=classes).astype(np.float32)
    x = rng.normal(size=(d, n)).astype(np.float32)
    codes = np.zeros((0, n), np.int32)
    tables, plan = port_qda.qda_tables(t(quad), t(lin), t(icpt),
                                       schema=schema)
    assert plan.local and plan.max_stage_x <= _build.QDA_LOCAL_X
    assert_plan_covers_once(plan, d, (), True, _build.QDA_TASK_CELLS)
    scores = np.stack([s.numpy() for s in port_qda.class_scores_plain(
        tables, plan, t(x), t(codes), schema=schema)])
    got = scores.astype(np.float32).argmax(0)
    ref = np.asarray(ref_device.qda_predict_device(
        *map(jnp.asarray, (quad, lin, icpt, x, codes)), schema=ref_schema,
        method="xla"))
    assert (got == ref).mean() >= 0.999
    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)])
    a = np.zeros((classes, 1 + d, 1 + d))
    a[:, 0, 0] = icpt
    a[:, 0, 1:] = a[:, 1:, 0] = lin / 2
    a[:, 1:, 1:] = quad
    dense = np.einsum("in,cij,jn->cn", z, a, z)
    np.testing.assert_allclose(scores, dense, rtol=0,
                               atol=1e-6 * np.abs(dense).max())
