"""The port at schemas of many columns, on the CPU, against the JAX
package: the Home Credit schema (Kaggle "Home Credit Default Risk"
application_train.csv: 104 numeric columns, 16 categorical, P = 245; 83
categorical columns in its stream fold), UCI SECOM (590 numeric columns,
P = 591; 590 one-level null flags in its fold, P + K = 1,181) and d = 80
(P = 81): sigma, the MICE loop, the stream fold and the QDA / NB
pipelines. Then the kernels' plans at those schemas and at the extremes
(P = 88 of 87 numeric or 87 one-level columns, P = 1,024 of 1,023
numeric columns, past 1,024 with more than 88 columns of each kind and
one of 4,100 levels): each fits a block's shared memory and maps its
cells to the plain Gram; one past each limit shared memory once set is
taken.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_many_cols.py -q
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
from duckdb_imputation_tpu.ring import streaming as ref_stream
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import run_mice_device
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.ring import streaming
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
    nb_assemble,
    nb_cells_plain,
    nb_grouped_sums_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    keyed_tables_plain,
    masked_gram_cols_plain,
    masked_gram_window_plain,
    wide_assemble,
    wide_tables_plain,
    window_order,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

from test_torch_classify_wide import _train_f64

torch.set_num_threads(2)

# Home Credit's 16 categorical columns (NAME_CONTRACT_TYPE .. EMERGENCY-
# STATE_MODE), and the six of them with nulls
HOME_CREDIT = (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2)
HC_NULL_CATS = (4, 9, 12, 13, 14, 15)


def _factor_table(rng, n, d, sizes, rank=8):
    """Numerics from a rank-8 Gaussian factor model plus noise, codes the
    argmax of a linear function of the factors (imputation can beat a
    mean fill); returns (factors, x f32[d, n], codes i32[c, n])."""
    f = rng.normal(size=(rank, n))
    x = (rng.normal(size=(d, rank)) @ f
         + 0.5 * rng.normal(size=(d, n))).astype(np.float32)
    codes = np.stack([np.argmax(rng.normal(size=(v, rank)) @ f
                                + rng.gumbel(size=(v, n)), 0)
                      for v in sizes]).astype(np.int32) if sizes else \
        np.zeros((0, n), np.int32)
    return f, x, codes


def home_credit(n, seed=0):
    """The Home Credit schema at n rows: nulls in 61 numeric and the six
    categorical columns of HC_NULL_CATS, shares spread over 0.1%-70% (an
    assumption: the file's columns span that range); TARGET ~8% positive
    from a logistic function of the factors."""
    rng = np.random.default_rng(seed)
    f, x, codes = _factor_table(rng, n, 104, HOME_CREDIT)
    shares = np.geomspace(0.001, 0.7, 67)
    cols = [("n", j) for j in range(61)] + [("c", j) for j in HC_NULL_CATS]
    nn = np.zeros(x.shape, bool)
    cn = np.zeros(codes.shape, bool)
    for (kind, j), s in zip(cols, rng.permutation(shares)):
        (nn if kind == "n" else cn)[j] = rng.random(n) < s
    score = rng.normal(size=8) @ f
    y = (score > np.quantile(score, 0.92)).astype(np.int32)
    return x, codes, nn, cn, y


def secom(n, seed=0):
    """The SECOM schema at n rows: 590 numerics, nulls at 4.5% in every
    column (an assumption), pass/fail with the file's 104 fails in 1,567
    rows (6.6%)."""
    rng = np.random.default_rng(seed)
    f, x, _ = _factor_table(rng, n, 590, ())
    nn = rng.random(x.shape) < 0.045
    score = rng.normal(size=8) @ f
    y = (score > np.quantile(score, 1 - 104 / 1567)).astype(np.int32)
    return x, np.zeros((0, n), np.int32), nn, np.zeros((0, n), bool), y


def d80(n, seed=0):
    """80 numerics (P = 81, the narrow route), nulls in five of them."""
    rng = np.random.default_rng(seed)
    f, x, _ = _factor_table(rng, n, 80, ())
    nn = np.zeros(x.shape, bool)
    for j in (3, 40, 79):
        nn[j] = rng.random(n) < 0.2
    y = (rng.normal(size=8) @ f > 0).astype(np.int32)
    return x, np.zeros((0, n), np.int32), nn, np.zeros((0, n), bool), y


MAKERS = {"home_credit": (home_credit, 3000, HOME_CREDIT),
          "secom": (secom, 1567, ()), "d80": (d80, 3000, ())}


def schemas(name):
    d = {"home_credit": 104, "secom": 590, "d80": 80}[name]
    keys = tuple(tuple(range(v)) for v in MAKERS[name][2])
    return FeatureSchema(num_cols=d, cat_keys=keys), RefSchema(
        num_cols=d, cat_keys=keys)


def t(a):
    return torch.tensor(a)


# ---------------------------------------------------------------------------
# (a) the port's plain path against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MAKERS))
def test_sum_to_triple_matches_jax(name):
    """sigma at each schema with binary weights: counts exact, the rest
    within 1e-5 of max|σ| (f32 accumulation in another order)."""
    make, n, _ = MAKERS[name]
    x, codes, _, _, y = make(n)
    schema, ref_schema = schemas(name)
    w = (y == 0).astype(np.float32)
    got = sigma_from_triple(port_sum.sum_to_triple(
        t(x), t(codes), t(w), schema=schema)).numpy().astype(np.float64)
    want = np.asarray(ref_sft(ref_sum.sum_to_triple(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(w),
        schema=ref_schema, backend="xla")), np.float64)
    p, d = schema.sigma_size, schema.num_cols
    idx = [0] + list(range(1 + d, p))
    np.testing.assert_array_equal(got[np.ix_(idx, idx)],
                                  want[np.ix_(idx, idx)])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name,num,cat,atol", [
    ("home_credit", (0, 60), (0,), 1e-3), ("secom", (0, 295, 589), (), 1e-3),
    ("d80", (3, 40, 79), (), 1e-4)])
def test_run_mice_device_matches_jax(name, num, cat, atol):
    """run_mice_device(kernel='plain') against JAX's kernel='xla', noise
    off, a round over numeric columns (past the 88 a kernel parameter
    holds among them at SECOM) and a categorical one with nulls: codes
    equal; numerics within 1e-4 at d = 80 (tests/test_torch_mice.py's
    bound: the two SVD solvers round differently), within 1e-3 of these
    unit-scale values at 104 and 590 coefficients, where the two solvers'
    predictions were seen to part by up to 4.4e-4."""
    make, n, _ = MAKERS[name]
    x, codes, nn, cn, _ = make(n, seed=1)
    schema, ref_schema = schemas(name)
    if name == "home_credit":
        cat = tuple(HC_NULL_CATS[j] for j in cat)
    kw = dict(num_null_cols=num, cat_null_cols=cat, iters=1, noise=False)
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
                               atol=atol)


@pytest.mark.parametrize("name", ["home_credit", "secom"])
def test_scan_gram_matches_jax(name):
    """The stream fold's extended Gram, streamed from host arrays in
    chunks: Home Credit's c + K = 16 + 67 = 83 categorical columns (P + K
    = 312, K7's one launch on the card) and SECOM's 590 one-level null
    flags (P + K = 1,181: K7's windows, the flags' cross tables as CM
    slabs): check_fold takes both; counts exact, the rest within 1e-6 of
    max|G|."""
    make, n, _ = MAKERS[name]
    x, codes, nn, cn, _ = make(n, seed=2)
    num = np.where(nn, np.nan, x).astype(np.float32)
    cat = np.where(cn, -1, codes).astype(np.int64)
    src = streaming.chunks_from_arrays(num, cat, nn, cn, chunk_rows=1000)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert ext.cat_cols == {"home_credit": 83, "secom": 590}[name]
    streaming.check_fold(ss, n)
    got = streaming.scan_gram(src, ss, chunk_rows=700, device="cpu")
    rsrc = ref_stream.chunks_from_arrays(num, cat, nn, cn, chunk_rows=1000)
    rss, _ = ref_stream.scan_schema(rsrc, collect_dirty=False)
    want = np.asarray(ref_stream.scan_gram(rsrc, rss, chunk_rows=700),
                      np.float64)
    got = got.numpy().astype(np.float64)
    p, d = ss.schema.sigma_size, ss.schema.num_cols
    idx = [0] + list(range(1 + d, got.shape[0]))
    np.testing.assert_array_equal(got[np.ix_(idx, idx)],
                                  want[np.ix_(idx, idx)])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _oracle(x, codes, y, keys, n):
    """The f64 oracle of tests/test_torch_classify_wide.py: exact class
    sigmas, f64 training, zᵀ·quad·z + lin·z + b in f64."""
    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(len(k))[:, None]) * 1.0
                          for j, k in enumerate(keys)])
    sig64 = np.stack([(z * (y == g)) @ z.T for g in range(2)])
    zz = z[1:]
    return np.stack([np.einsum("in,ij,jn->n", zz, q, zz) + li @ zz + bb
                     for q, li, bb in _train_f64(sig64, n)]).argmax(0)


@pytest.mark.parametrize("name,n", [("home_credit", 3000),
                                    ("secom", 12_000), ("d80", 3000)])
def test_qda_pipeline_matches_f64_oracle(name, n):
    """GROUP BY label (TARGET; SECOM's pass/fail) → qda_train_device →
    qda_predict_device: the predictions agree ≥ 0.999 with the f64 oracle
    (the JAX package's own QDA predictor is NaN on singular covariances:
    ROADMAP Queue 3). SECOM at 12,000 rows of its schema: its fail class
    needs more rows than its 590 numerics for a covariance of full
    rank."""
    make = MAKERS[name][0]
    x, codes, _, _, y = make(n, seed=4)
    schema, _ = schemas(name)
    sig = sigma_from_triple(port_sum.sum_to_triple_grouped(
        t(x), t(codes), t(y), schema=schema, num_groups=2))
    quad, lin, b = port_device.qda_train_device(sig, float(n))
    pred = port_device.qda_predict_device(quad, lin, b, t(x), t(codes),
                                          schema=schema).numpy()
    oracle = _oracle(x, codes, y, schema.cat_keys, n)
    assert (pred == oracle).mean() >= 0.999


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_nb_pipeline_matches_jax(name):
    """GROUP BY label NB aggregate → nb_train_device → nb_predict_device
    against the JAX package: counts exact, parameters within 1e-5,
    predictions agreeing ≥ 0.999."""
    make, n, _ = MAKERS[name]
    x, codes, _, _, y = make(n, seed=5)
    schema, ref_schema = schemas(name)
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(codes), t(y),
                                         schema=schema, num_groups=2)
    ragg = ref_sum.sum_to_nb_agg_grouped(x, codes, y, schema=ref_schema,
                                         num_groups=2, backend="xla")
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
    pred = port_device.nb_predict_device(*got, t(x), t(codes),
                                         schema=schema).numpy()
    rpred = np.asarray(ref_device.nb_predict_device(
        *ref, jnp.asarray(x), jnp.asarray(codes), schema=ref_schema))
    assert (pred == rpred).mean() >= 0.999


# ---------------------------------------------------------------------------
# (b) the kernels' plans at those schemas and at the extremes
# ---------------------------------------------------------------------------

def _schema(d, sizes):
    return FeatureSchema(num_cols=d, cat_keys=tuple(tuple(range(v))
                                                    for v in sizes))


PLAN_SCHEMAS = {
    "home_credit": (104, HOME_CREDIT),
    "home_credit_fold": (104, HOME_CREDIT + (1,) * 67),
    "secom": (590, ()),
    "p1024_d1023": (1023, ()),
    "many_small": (50, (1,) * 100 + (2,) * 30),   # 8,385 cross tables: CM
}
WINDOW_SCHEMAS = {
    "secom_fold": (590, (1,) * 590),
    "past1024": (100, (4100,) + (3,) * 89),
}


def _inputs(schema, n, seed=0):
    rng = np.random.default_rng(seed)
    x = [t(rng.normal(size=n).astype(np.float32))
         for _ in range(schema.num_cols)]
    c = [t(rng.integers(-1, v + 1, n).astype(np.int32))
         for v in schema.cat_sizes]
    w = t(rng.random(n).astype(np.float32))
    return x, c, w


def _assert_close(got, want):
    """Within 1e-5 of max|σ| (f32 sums in another order)."""
    scale = float(want.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(PLAN_SCHEMAS))
def test_wide_plan_fits_and_maps_the_gram(name):
    """K7's one-launch plan (P ≤ 1,024): within a block's shared memory;
    its cells (`wide_tables_plain`) placed by its map (`wide_assemble`)
    equal the plain Gram; a task with a K_j table stages every numeric
    column, the others only what their slabs read."""
    schema = _schema(*PLAN_SCHEMAS[name])
    plan = _build.wide_plan(schema)
    assert plan.smem_bytes <= _build.WIDE_SMEM
    assert plan.max_task_cells <= _build.WIDE_TASK_BYTES // 8
    for t_, row in enumerate(plan.stage_cols.tolist()):
        kinds = set(plan.slabs[plan.slabs[:, 6] == t_, 0].tolist())
        nx = row[0]
        if _build.SLAB_K in kinds:
            assert nx == schema.num_cols
    if name == "many_small":
        assert _build.SLAB_CM in set(plan.slabs[:, 0].tolist())
    x, c, w = _inputs(schema, 400)
    got = wide_assemble(wide_tables_plain(x, c, w, schema=schema,
                                          plan=plan), schema=schema,
                        plan=plan)
    _assert_close(got, masked_gram_cols_plain(x, c, w, schema=schema))


@pytest.mark.parametrize("name", sorted(WINDOW_SCHEMAS))
def test_window_plans_fit_and_map_the_gram(name):
    """K7's windows past P = 1,024: SECOM's fold (590 numerics beside 590
    one-level flags: no keyed column, the flags' cross tables as CM slabs)
    and 100 numeric and 90 categorical columns with one of 4,100 levels
    (keyed, its order's rows of 1 + d + c ints, more than the 177 the
    order's parameter holds): each window's residual and keyed plans
    within shared memory, and their cells, placed by their maps, equal the
    plain window."""
    schema = _schema(*WINDOW_SCHEMAS[name])
    p, n = schema.sigma_size, 300
    x, c, w = _inputs(schema, n, seed=1)
    want = masked_gram_window_plain(x, c, w, schema=schema, lo=0, width=p)
    keyed_any = False
    for lo in range(0, p, _build.WINDOW_WIDTH):
        hi = min(lo + _build.WINDOW_WIDTH, p)
        residual, keyed = _build.keyed_window_plan(schema, lo, hi)
        got = torch.zeros((p, hi - lo))
        if residual is not None:
            assert residual.smem_bytes <= _build.WIDE_SMEM
            got += wide_assemble(wide_tables_plain(
                x, c, w, schema=schema, plan=residual), schema=schema,
                plan=residual)
        if keyed is not None:
            keyed_any = True
            assert keyed.plan.smem_bytes <= _build.WIDE_SMEM
            order = window_order(x, c, w, schema=schema,
                                 columns=keyed.columns)
            stride = order.rows.shape[-1]
            assert stride == _build.order_stride(
                1 + schema.num_cols + schema.cat_cols)
            assert stride > _build.ORDER_INLINE
            _build.check_order_stride(max(schema.cat_sizes), stride)
            got += wide_assemble(keyed_tables_plain(
                order, keyed, schema=schema, n=n), schema=schema,
                plan=keyed.plan)[0]
        _assert_close(got, want[:, lo:hi])
    assert keyed_any == (name == "past1024")
    if name == "secom_fold":
        residual = _build.keyed_window_plan(schema, 0, 1024)[0]
        assert _build.SLAB_CM in set(residual.slabs[:, 0].tolist())


@pytest.mark.parametrize("name,d,sizes", [
    ("p88_d87", 87, ()), ("p88_flags87", 0, (1,) * 87),
    ("home_credit", 104, HOME_CREDIT), ("secom", 590, ()),
    ("p1024_d1023", 1023, ()), ("past1024", 100, (4100,) + (3,) * 89)])
def test_nb_plan_fits_and_maps_the_sums(name, d, sizes):
    """The NB kernel's plan over 3 groups at each schema: within shared
    memory, and its cells (`nb_cells_plain`) placed by `nb_assemble`
    equal the plain sums."""
    schema = _schema(d, sizes)
    plan = _build.nb_plan(schema, 3)
    assert plan.smem_bytes <= _build.WIDE_SMEM
    rng = np.random.default_rng(2)
    n = 300
    x = t(rng.normal(size=(d, n)).astype(np.float32))
    c = (t(np.stack([rng.integers(-1, v + 1, n) for v in sizes]
                    ).astype(np.int32)) if sizes
         else torch.zeros((0, n), dtype=torch.int32))
    g = t(rng.integers(-1, 4, n).astype(np.int32))
    got = nb_assemble(nb_cells_plain(x, c, None, g, plan=plan, schema=schema),
                      plan=plan, schema=schema)
    want = nb_grouped_sums_plain(x, c, None, g, schema=schema, num_groups=3)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name,d,sizes", [
    ("p88_d87", 87, ()), ("p88_flags87", 0, (1,) * 87),
    ("home_credit", 104, HOME_CREDIT), ("secom", 590, ()),
    ("past1024", 100, (4100,) + (3,) * 89)])
def test_qda_and_impute_plans_fit(name, d, sizes):
    """K3/K3w's tile (`qda_tile`) and K2w's impute plans fit shared memory
    at each schema: `impute_plan` (W's class tiles, P ≤ 1,024) and
    `impute_global_plan` (W in device memory, past it) for the widest
    categorical column."""
    schema = _schema(d, sizes)
    _build.check_qda(schema, 2, 1000)
    plan = _build.qda_plan(schema)
    threads, rows, group = _build.qda_tile(schema, plan, 2)
    assert _build.qda_smem_bytes(plan.max_task_cells, schema, threads * rows,
                                 group) <= _build.WIDE_SMEM
    if not sizes:
        return
    r = max(sizes)
    if schema.sigma_size <= _build.MAX_WIDE_SIGMA_SIZE:
        ld, _, batch = _build.impute_plan(schema, r)
        assert _build.impute_smem_bytes(schema, ld, batch) <= _build.WIDE_SMEM
    ld, _, batch = _build.impute_global_plan(schema, r)
    assert _build.impute_smem_bytes(schema, 0, batch) <= _build.WIDE_SMEM


def test_narrow_route_takes_87_columns():
    """P = 88 of 87 numeric columns or 87 one-level columns: the narrow
    kernels' checks take both (each kind within the 88 the kernel
    parameter holds), off the tensor cores."""
    for schema in (_schema(87, ()), _schema(0, (1,) * 87)):
        assert schema.sigma_size == _build.MAX_SIGMA_SIZE
        _build.check_schema(schema, 1000)
        assert not _build.tc_fits(schema.num_cols, schema.sigma_size)
        assert max(schema.num_cols, schema.cat_cols) < _build.INLINE_COLS


@pytest.mark.parametrize("limit", ["k7_beside_codes", "k3_tile",
                                   "k2w_batch", "order_stride"])
def test_limits_shared_memory_sets(limit):
    """The column limits shared memory set, each now taken one past it:
    K7/K8 staging a K_j task's every numeric column beside a code column
    (past it K_j as KB slabs of few columns), K3/K3w a tile of 32 rows of
    x in f64 (past it a local plan), K2w's impute kernel a batch of 32
    rows' x (past it x read from device memory, W whole at R = 33 and W
    in device memory), the window order two chunks of 32 rows of a keyed
    column's copy (past it pieces of a row): at the limit the old route,
    one past it the new one, within shared memory."""
    if limit == "k7_beside_codes":
        d = next(d for d in range(800, 900)
                 if _build._k_room(d + 1) < d + 2)
        at, past = (_build.wide_plan(_schema(e, (3,))) for e in (d, d + 1))
        assert _build.SLAB_K in at.slabs[:, 0].tolist()
        assert _build.SLAB_KB in past.slabs[:, 0].tolist()
        assert _build.SLAB_K not in past.slabs[:, 0].tolist()
        assert max(at.smem_bytes, past.smem_bytes) <= _build.WIDE_SMEM
        # a K or KB slab's slots end with its columns a_lo, a_hi of [1 ‖ x]
        # (a K slab's 0, 1 + d: what the plain walkers read); a KB slab's
        # device record carries a_hi in place of j
        for plan, e in ((at, d), (past, d + 1)):
            kind = plan.slabs[:, 0]
            k, kb = kind == _build.SLAB_K, kind == _build.SLAB_KB
            assert (plan.slots[k, 2] == 0).all()
            assert (plan.slots[k, 3] == 1 + e).all()
            assert torch.equal(plan.slots[kb, 2], plan.slabs[kb, 4])
            assert torch.equal(plan.device_slabs[kb, 1], plan.slots[kb, 3])
            assert torch.equal(plan.device_slabs[k, 1], plan.slabs[k, 1])
    elif limit == "k3_tile":
        q = next(d for d in range(700, 800)
                 if _build.qda_local(_schema(d + 1, ())))
        for e in (q, q + 1):
            schema = _schema(e, ())
            _build.check_qda(schema, 2, 100)
            plan = _build.qda_plan(schema)
            assert plan.local == (e > q)
            threads, rows, group = _build.qda_tile(schema, plan, 2)
            assert _build.qda_smem_bytes(
                plan.max_task_cells, schema, threads * rows, group,
                plan.max_stage_x if plan.local else None) <= _build.WIDE_SMEM
    elif limit == "k2w_batch":
        def x_terms(d, sizes, plan_of):
            """Whether K2w keeps x in shared memory, and its bytes."""
            schema = _schema(d, sizes)
            ld, _, batch = plan_of(schema, max(sizes))
            tile = 0 if plan_of is _build.impute_global_plan else ld
            return (_build.impute_x_terms(schema, tile, batch),
                    _build.impute_smem_bytes(schema, tile, batch))

        for sizes, plan_of in (((33,), _build.impute_plan),
                               ((2,) * 3 + (1100,), _build.impute_global_plan)):
            d = next(d for d in range(800, 2000)
                     if not x_terms(d + 1, sizes, plan_of)[0])
            assert x_terms(d, sizes, plan_of)[0]
            assert max(x_terms(d, sizes, plan_of)[1],
                       x_terms(d + 1, sizes, plan_of)[1]) <= _build.WIDE_SMEM
    else:
        s = next(s for s in range(8, 2000, 8)
                 if _build.order_piece(4100, s + 8) < s + 8)
        _build.check_order_stride(4100, s + 8)
        assert _build.order_piece(4100, s) == s
        piece = _build.order_piece(4100, s + 8)
        assert piece % 8 == 0 and 4 * _build.order_warp_ints(
            4100, piece) <= _build.WIDE_SMEM


def test_fold_plans_build_in_seconds():
    """SECOM's fold (P + K = 1,181, 590 flags: 173,755 cross tables of one
    cell, merged into CM slabs) plans both windows in well under a
    minute on one CPU core (~5 s; chip_smoke.py's [secom] prints the
    seconds on the card's host)."""
    import time

    schema = _schema(590, (1,) * 590)
    t0 = time.perf_counter()
    for lo in (0, 1024):
        _build.keyed_window_plan(schema, lo, min(lo + 1024, 1181))
    assert time.perf_counter() - t0 < 60
