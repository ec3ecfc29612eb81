"""The classifier path at wide schemas (P > 88) in the port, on the CPU:
the plain versions of K8 (the wide grouped Gram, behind `grouped_gram`
and `grouped_gram_presorted`), K6w (the NB sums for F > 256) and K3w (QDA
scoring over a plan of several tasks) against the JAX package's Pallas
kernels in interpret mode (as its own tests run them) and its XLA paths;
the whole wide pipeline against the JAX package and an f64 oracle; the
dispatch of each wrapper by its `_build` limits; and QDA scoring at the
schema limit the plan sets.
"""
import contextlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.models import device as ref_device
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.kernels import sigma_pallas_grouped as ref_g
from duckdb_imputation_tpu.ring.kernels.nb_pallas import (
    sum_to_nb_agg_grouped_pallas,
)
from duckdb_imputation_tpu.ring.kernels.qda_pallas import qda_predict_pallas
from duckdb_imputation_tpu.ring.kernels.sigma_pallas import (
    _fast_cols_use_v3,
    _sizing_fast3,
)
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import nb_pallas as port_nb
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels import (
    sigma_pallas_grouped as port_g,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    wide_assemble,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

torch.set_num_threads(2)

# (a): 3 numeric columns, categorical columns of 120 and 20: P = 144
KEYS_144 = (tuple(range(120)), tuple(range(20)))
SCHEMA_144 = FeatureSchema(num_cols=3, cat_keys=KEYS_144)
REF_144 = RefSchema(num_cols=3, cat_keys=KEYS_144)
# (b): d = 3, categorical columns of 200 and 60: F = 1 + 6 + 260 = 267
KEYS_NB = (tuple(range(200)), tuple(range(60)))
# (c): d = 4, two categorical columns of 48: m = 100, a v3 layout
KEYS_QDA = (tuple(range(48)), tuple(range(48)))


def t(a):
    return torch.tensor(a)


def grouped_inputs(groups, n=3001, seed=0):
    """Codes uniform with some out of vocab and negative, ids in [0, G)
    with some out of range, binary and general weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n)).astype(np.float32)
    codes = np.stack([rng.integers(-1, 122, n),
                      rng.integers(0, 20, n)]).astype(np.int32)
    g = rng.integers(0, groups, n).astype(np.int32)
    g[:37] = groups + 2
    g[37:60] = -1
    w = {"binary": (rng.random(n) > 0.3).astype(np.float32),
         "general": rng.random(n).astype(np.float32)}
    return x, codes, g, w


def count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def assert_grouped_close(got, want, schema, counts_exact):
    """Counts exact (binary weights); the rest within 1e-5 of each
    group's max|σ|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    cm = count_mask(schema)
    for g in range(got.shape[0]):
        if counts_exact:
            np.testing.assert_array_equal(got[g][cm], want[g][cm])
        scale = max(float(np.abs(want[g]).max()), 1.0)
        np.testing.assert_allclose(got[g], want[g], rtol=0,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# (a) the wide grouped Gram (K8's plain versions) at P = 144
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [3, 12])
@pytest.mark.parametrize("weights", ["binary", "general"])
def test_wide_grouped_gram_unsorted_matches_jax(groups, weights):
    """The unsorted entry (`grouped_gram`, plain) against the JAX unsorted
    Pallas kernel (f32 body, interpret mode) and JAX's masked path."""
    x, codes, g, ws = grouped_inputs(groups)
    w = ws[weights]
    assert port_g.unsorted_group_limit(SCHEMA_144) is None   # any G
    got = port_g.grouped_gram(t(x), t(codes), t(w), t(g), schema=SCHEMA_144,
                              num_groups=groups).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = ref_g.sum_to_triple_grouped_unsorted(
            x, codes, g, schema=REF_144, num_groups=groups, weights=w,
            fast=False, chunk_cols=512)
    binary = weights == "binary"
    assert_grouped_close(got, ref_sft(ref), SCHEMA_144, binary)
    masked = ref_sum.sum_to_triple_grouped(x, codes, g, schema=REF_144,
                                           num_groups=groups, weights=w,
                                           method="masked")
    assert_grouped_close(got, ref_sft(masked), SCHEMA_144, binary)


@pytest.mark.parametrize("groups", [3, 12])
@pytest.mark.parametrize("weights", ["binary", "general"])
def test_wide_grouped_gram_presorted_matches_jax(groups, weights):
    """sort_by_group + the presorted entry (`grouped_gram_presorted`,
    plain) against JAX's sort + sorted-slab Pallas kernel
    (`sum_to_triple_grouped_pallas`, f32 body, interpret mode) and its
    masked path."""
    x, codes, g, ws = grouped_inputs(groups, seed=1)
    w = ws[weights]
    x_s, c_s, w_s, layout = port_g.sort_by_group(
        t(x), t(codes), t(g), schema=SCHEMA_144, num_groups=groups,
        weights=t(w))
    got = port_g.grouped_gram_presorted(x_s, c_s, w_s, layout,
                                        schema=SCHEMA_144).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = ref_g.sum_to_triple_grouped_pallas(
            x, codes, g, schema=REF_144, num_groups=groups, weights=w,
            fast=False, chunk_cols=512)
    binary = weights == "binary"
    assert_grouped_close(got, ref_sft(ref), SCHEMA_144, binary)
    masked = ref_sum.sum_to_triple_grouped(x, codes, g, schema=REF_144,
                                           num_groups=groups, weights=w,
                                           method="masked")
    assert_grouped_close(got, ref_sft(masked), SCHEMA_144, binary)


@pytest.mark.parametrize("method", ["auto", "masked", "sorted", "kernel"])
def test_wide_sum_to_triple_grouped_methods(method):
    """`sum_to_triple_grouped` at P = 144 with every method (on the CPU
    'kernel' reaches the plain versions of K8's entries)."""
    x, codes, g, ws = grouped_inputs(12, seed=2)
    got = port_sum.sum_to_triple_grouped(
        t(x), t(codes), t(g), schema=SCHEMA_144, num_groups=12,
        weights=t(ws["binary"]), method=method)
    ref = ref_sum.sum_to_triple_grouped(x, codes, g, schema=REF_144,
                                        num_groups=12, weights=ws["binary"],
                                        method="masked")
    assert_grouped_close(sigma_from_triple(got).numpy(), ref_sft(ref),
                         SCHEMA_144, True)


def test_plain_grouped_gram_forms_exact_products():
    """`grouped_sigma` sums the f32 products (z_i·w)·z_j in f64: on values
    whose f32 sums would round, it equals an f64 numpy Gram of the same
    f32 products rounded once."""
    rng = np.random.default_rng(4)
    n = 50_000
    x = (rng.normal(size=(3, n)) * 1000 + 1e4).astype(np.float32)
    codes = np.stack([rng.integers(0, 120, n),
                      rng.integers(0, 20, n)]).astype(np.int32)
    g = rng.integers(0, 2, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    got = port_sum.grouped_sigma(t(x), t(codes), t(w), t(g),
                                 schema=SCHEMA_144, num_groups=2).numpy()
    z = np.concatenate([np.ones((1, n), np.float32), x]
                       + [(codes[j][None] == np.arange(s)[:, None])
                          .astype(np.float32) for j, s in ((0, 120),
                                                          (1, 20))])
    for k in range(2):
        zw = (z * (w * (g == k)).astype(np.float32)).astype(np.float64)
        want = (zw @ z.astype(np.float64).T).astype(np.float32)
        np.testing.assert_array_equal(got[k], want)


@pytest.mark.parametrize("groups", [3, 12])
@pytest.mark.parametrize("weights", ["binary", "general"])
def test_wide_grouped_tables_assemble_to_the_grams(groups, weights):
    """K8's tables in plain torch (`grouped_wide_tables_plain`: K7's plan
    over each group's sorted rows), scattered through the plan's map
    (`wide_assemble`), against grouped_gram_presorted_plain and the JAX
    sorted-slab Pallas kernel (f32 body, interpret mode): counts exact
    with binary weights, the rest within 1e-5 of each group's max|σ|."""
    x, codes, g, ws = grouped_inputs(groups, seed=2)
    w = ws[weights]
    x_s, c_s, w_s, layout = port_g.sort_by_group(
        t(x), t(codes), t(g), schema=SCHEMA_144, num_groups=groups,
        weights=t(w))
    cells = port_g.grouped_wide_tables_plain(x_s, c_s, w_s, layout,
                                             schema=SCHEMA_144)
    assert cells.shape == (groups, int(
        _build.wide_plan(SCHEMA_144).task_base[-1]))
    got = wide_assemble(cells, schema=SCHEMA_144).numpy()
    binary = weights == "binary"
    assert_grouped_close(got, port_g.grouped_gram_presorted_plain(
        x_s, c_s, w_s, layout, schema=SCHEMA_144), SCHEMA_144, binary)
    with pltpu.force_tpu_interpret_mode():
        ref = ref_g.sum_to_triple_grouped_pallas(
            x, codes, g, schema=REF_144, num_groups=groups, weights=w,
            fast=False, chunk_cols=512)
    assert_grouped_close(got, ref_sft(ref), SCHEMA_144, binary)


# ---------------------------------------------------------------------------
# (b) the wide NB sums (K6w's plain version) at F = 267
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["none", "general"])
def test_wide_nb_sums_match_pallas(weights):
    """`nb_grouped_sums` (plain) at d = 3 and categorical columns of 200
    and 60 (F = 267 > 256) against the JAX Pallas NB kernel (interpret
    mode; the bf16-split body without weights, the f32 one with general
    weights): counts exact, x sums within rtol 1e-6 (+ the test_kernels.py
    absolute slack)."""
    rng = np.random.default_rng(8)
    n = 3 * 2048
    x = rng.normal(size=(3, n)).astype(np.float32)
    codes = np.stack([rng.integers(0, 201, n),
                      rng.integers(-1, 60, n)]).astype(np.int32)
    g = rng.integers(0, 5, n).astype(np.int32)
    g[:30] = 7
    w = None if weights == "none" else rng.random(n).astype(np.float32)
    schema = FeatureSchema(num_cols=3, cat_keys=KEYS_NB)
    assert _build.nb_features(schema) == 267
    got = port_nb.nb_grouped_sums(t(x), t(codes),
                                  None if w is None else t(w), t(g),
                                  schema=schema, num_groups=5).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = sum_to_nb_agg_grouped_pallas(
            x, codes, g, schema=RefSchema(num_cols=3, cat_keys=KEYS_NB),
            num_groups=5, weights=w, chunk_cols=2048)
    d = 3
    counts = np.concatenate([np.asarray(ref.n)[:, None],
                             np.asarray(ref.lin_cat)], 1)
    got_counts = np.concatenate([got[:, :1], got[:, 1 + 2 * d:]], 1)
    if w is None:
        np.testing.assert_array_equal(got_counts, counts)
    else:
        np.testing.assert_allclose(got_counts, counts, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got[:, 1:1 + d], np.asarray(ref.lin),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got[:, 1 + d:1 + 2 * d],
                               np.asarray(ref.quad_diag), rtol=1e-6,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# (c) QDA scoring at m = 100, a v3 schema of the JAX package
# ---------------------------------------------------------------------------

def qda_wide_fixture(c_cls=8):
    """tests/test_torch_qda.py's well-conditioned fixture (−quad = AAᵀ +
    0.2·I) at d = 4 and two categorical columns of 48 (m = 100)."""
    rng = np.random.default_rng(41)
    ref_schema = RefSchema(num_cols=4, cat_keys=KEYS_QDA)
    m = 4 + 96
    chunk = 256
    n = _sizing_fast3(ref_schema)[3] * chunk * 2
    x = rng.normal(size=(4, n)).astype(np.float32)
    c = np.stack([rng.integers(0, 48, n),
                  rng.integers(0, 48, n)]).astype(np.int32)
    a = rng.normal(size=(c_cls, m, m)).astype(np.float32) * 0.1
    quad = (-np.einsum("cij,ckj->cik", a, a)
            - 0.2 * np.eye(m, dtype=np.float32))
    lin = rng.normal(size=(c_cls, m)).astype(np.float32)
    b = rng.normal(size=c_cls).astype(np.float32) * 5
    return ref_schema, x, c, quad, lin, b, chunk


def test_wide_qda_predict_matches_pallas_and_xla():
    """At C = 8, m = 100 (the factors of the JAX package's scorer would
    take 323 KB; the port's tables 8 × 2,800 cells, one task) the JAX
    package scores this v3 schema with its Pallas kernel: the port's plain
    scorer agrees ≥ 0.999 with that kernel (interpret mode) and with
    `_qda_predict_xla`."""
    ref_schema, x, c, quad, lin, b, chunk = qda_wide_fixture()
    assert _fast_cols_use_v3(ref_schema)
    schema = FeatureSchema(num_cols=4, cat_keys=KEYS_QDA)
    tables, plan = port_qda.qda_tables(t(quad), t(lin), t(b), schema=schema)
    # D, two K of 48 × 5, a C of 48 × 48: 2,799 cells, padded to 2,800
    assert tables.shape == (8, 2800)
    assert plan.num_tasks == 1
    got = port_device.qda_predict_device(
        *(t(a) for a in (quad, lin, b, x, c)), schema=schema).numpy()
    args = [jnp.asarray(a) for a in (quad, lin, b, x, c)]
    xla = np.asarray(ref_device._qda_predict_xla(*args, schema=ref_schema))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(qda_predict_pallas(*args, schema=ref_schema,
                                               chunk_cols=chunk))
    assert (got == xla).mean() >= 0.999
    assert (got == pallas).mean() >= 0.999
    # several classes win, so the comparison is not a trivial one
    assert len(np.unique(got)) >= 4


# ---------------------------------------------------------------------------
# (d) the whole wide pipeline, against the JAX package and an f64 oracle
# ---------------------------------------------------------------------------

def favorita_classify_small(n=20_000, seed=3, family_sales=0.7):
    """A reduced favorita_classify table from numpy, labelled by family (6
    families here): numeric unit_sales (class level + 1.5·promo + noise),
    transactions (store level + noise), oil; categorical store 20, class
    60 (each class in one family, family a function of the class),
    perishable 2 (a function of the family), type 5 (a function of the
    store). P = 1 + 3 + 87 = 91 > 88. unit_sales carries
    `family_sales`·family. Returns (x, codes, y, keys)."""
    rng = np.random.default_rng(seed)
    fam_of_class = rng.permutation(np.arange(60) % 6)
    perish_of_fam = np.array([0, 1, 0, 1, 1, 0])
    type_of_store = rng.integers(0, 5, 20)
    store = rng.integers(0, 20, n)
    cls = rng.choice(60, n, p=(w := 1.0 / rng.permutation(
        np.arange(1, 61))) / w.sum())
    promo = rng.random(n) < 0.2
    y = fam_of_class[cls].astype(np.int32)
    x = np.stack([rng.normal(size=60)[cls] + 1.5 * promo
                  + 0.5 * rng.normal(size=n) + family_sales * y,
                  2.0 * rng.normal(size=20)[store] + rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([store, cls, perish_of_fam[y],
                      type_of_store[store]]).astype(np.int32)
    keys = (tuple(range(20)), tuple(range(60)), (0, 1), tuple(range(5)))
    return x, codes, y, keys


def _train_f64(sigmas, total):
    """The host trainer's arithmetic (models/qda.py) in f64 numpy."""
    out = []
    for s in sigmas:
        n_c = s[0, 0]
        ns = max(n_c, 1.0)
        sv = s[0, 1:]
        cov = (s[1:, 1:] - np.outer(sv, sv) / ns) / ns
        u, svals, vt = np.linalg.svd(cov)
        keep = svals > 1e-9
        inv = np.where(keep, 1.0 / np.where(keep, svals, 1.0), svals)
        inva = (vt.T * inv) @ u.T
        logdet = np.sum(np.where(keep, np.log(np.where(keep, svals, 1.0)),
                                 0.0))
        mu = sv / ns
        lin = inva @ mu
        out.append((-0.5 * inva, lin,
                    -0.5 * mu @ lin - 0.5 * logdet + np.log(n_c / total)))
    return out


def test_wide_qda_pipeline_matches_jax_aggregates_and_f64_oracle():
    """GROUP BY label → qda_train_device → qda_predict_device at P = 91:
    the per-class sigmas equal JAX's (counts exact, 1e-5 of each class's
    max|σ|); the predictions agree ≥ 0.999 with an f64 oracle (exact
    sigmas, f64 training, zᵀ·quad·z + lin·z + b in f64) and beat the
    prior. The JAX package's own predictor is not the yardstick here: its
    Cholesky of −quad + 1e-12·I is NaN on these singular one-hot
    covariances (ROADMAP Queue 3)."""
    x, codes, y, keys = favorita_classify_small()
    n, classes = x.shape[1], 6
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    ref_schema = RefSchema(num_cols=3, cat_keys=keys)
    assert schema.sigma_size == 91
    sig = sigma_from_triple(port_sum.sum_to_triple_grouped(
        t(x), t(codes), t(y), schema=schema, num_groups=classes))
    ref = ref_sft(ref_sum.sum_to_triple_grouped(
        x, codes, y, schema=ref_schema, num_groups=classes, method="masked"))
    assert_grouped_close(sig.numpy(), ref, schema, True)
    quad, lin, b = port_device.qda_train_device(sig, float(n))
    tables, plan = port_qda.qda_tables(quad, lin, b, schema=schema)
    assert tables.shape == (classes, int(plan.task_base[-1]))
    assert plan.num_tasks == 1               # K3
    pred = port_device.qda_predict_device(quad, lin, b, t(x), t(codes),
                                          schema=schema).numpy()

    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(len(k))[:, None]) * 1.0
                          for j, k in enumerate(keys)])
    sig64 = np.stack([(z * (y == g)) @ z.T for g in range(classes)])
    zz = z[1:]
    scores = np.stack([np.einsum("in,ij,jn->n", zz, q, zz) + li @ zz + bb
                       for q, li, bb in _train_f64(sig64, n)])
    oracle = scores.argmax(0)
    prior = np.bincount(y).max() / n
    assert (pred == oracle).mean() >= 0.999
    assert (pred == y).mean() > prior + 0.02


def test_qda_cannot_learn_a_label_fixed_by_a_feature():
    """Where the label is a function of a categorical feature (family of
    class) and no numeric column carries it, pseudo-inverse QDA does not
    beat the prior, in the f64 oracle as in the port, which agree: a row's
    class one-hot lies in the null space of every other family's
    covariance (which the pseudo-inverse ignores), so only the true family
    pays the Mahalanobis cost of it. NB (a zero frequency scores −1e30)
    classifies the same table. (At favorita_classify's family label QDA
    still beats the prior, through the numeric columns.)"""
    x, codes, y, keys = favorita_classify_small(family_sales=0.0)
    n, classes = x.shape[1], 6
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    sig = sigma_from_triple(port_sum.sum_to_triple_grouped(
        t(x), t(codes), t(y), schema=schema, num_groups=classes))
    quad, lin, b = port_device.qda_train_device(sig, float(n))
    pred = port_device.qda_predict_device(quad, lin, b, t(x), t(codes),
                                          schema=schema).numpy()
    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(len(k))[:, None]) * 1.0
                          for j, k in enumerate(keys)])
    sig64 = np.stack([(z * (y == g)) @ z.T for g in range(classes)])
    zz = z[1:]
    oracle = np.stack([np.einsum("in,ij,jn->n", zz, q, zz) + li @ zz + bb
                       for q, li, bb in _train_f64(sig64, n)]).argmax(0)
    prior = np.bincount(y).max() / n
    assert (pred == oracle).mean() >= 0.999
    assert (oracle == y).mean() < prior + 0.02
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(codes), t(y),
                                         schema=schema, num_groups=classes)
    nb = port_device.nb_predict_device(
        *port_device.nb_train_device(agg.n, agg.lin, agg.quad_diag,
                                     agg.lin_cat),
        t(x), t(codes), schema=schema).numpy()
    assert (nb == y).mean() > 0.99


def test_wide_nb_pipeline_matches_jax():
    """GROUP BY label NB aggregate → nb_train_device → nb_predict_device at
    P = 91 (F = 94) against the JAX package on the same inputs: the
    aggregates and parameters at the tolerances of tests/test_torch_nb.py,
    predictions agreeing ≥ 0.999."""
    x, codes, y, keys = favorita_classify_small(seed=5)
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    ref_schema = RefSchema(num_cols=3, cat_keys=keys)
    agg = port_sum.sum_to_nb_agg_grouped(t(x), t(codes), t(y),
                                         schema=schema, num_groups=6)
    ragg = ref_sum.sum_to_nb_agg_grouped(x, codes, y, schema=ref_schema,
                                         num_groups=6, backend="xla")
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
    assert (pred == y).mean() > np.bincount(y).max() / len(y) + 0.02


# ---------------------------------------------------------------------------
# (e) the dispatch: each wrapper picks K8, K6w or K3w by its _build limits
# ---------------------------------------------------------------------------

def _cxx_constants():
    """constexpr ints of the kernel sources, their expressions resolved."""
    raw = {}
    for f in _build.CSRC.glob("*.cu*"):
        for name, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);",
                f.read_text()):
            raw[name] = expr
    values = {}

    def value(name):
        if name not in values:
            expr = re.sub(r"\b(k\w+)\b", lambda m: str(value(m.group(1))),
                          raw[name])
            values[name] = int(eval(expr, {"__builtins__": {}}))
        return values[name]
    return {name: value(name) for name in raw}


def test_limit_constants_equal_the_kernels():
    cxx = _cxx_constants()
    pairs = {"CHUNK_ROWS": "kChunk", "MAX_SIGMA_SIZE": "kMaxP",
             "MAX_WIDE_SIGMA_SIZE": "kMaxWideP",
             "MAX_WINDOW_SIGMA_SIZE": "kMaxWindowP",
             "MAX_SCORER_SIGMA_SIZE": "kMaxScorerP", "WIDE_CHUNK": "kWideChunk",
             "WIDE_WARPS": "kWideWarps", "WIDE_TASK_BYTES": "kWideTaskBytes",
             "WIDE_SLAB_INTS": "kWideSlabInts", "SLAB_D": "kSlabD",
             "SLAB_K": "kSlabK", "SLAB_C": "kSlabC", "SLAB_CR": "kSlabCR",
             "WIDE_MAX_SLABS": "kWideMaxSlabs", "WIDE_SMEM": "kWideSmem",
             "WIDE_STAGE_ROWS": "kThreads", "WIDE_PLAN_INTS": "kWidePlanInts",
             "KEYED_TASK_INTS": "kKeyedTaskInts",
             "INLINE_COLS": "kInlineCols",
             "ORDER_INLINE": "kOrderInline", "SLAB_CM": "kSlabCM",
             "MAX_UNSORTED_GROUPS": "kMaxUnsortedGroups",
             "NB_PLAN_INTS": "kNbPlanInts", "TC_ROWS": "kTcRows",
             "TC_A": "kTcA", "TC_RIGHT": "kTcRight",
             "NB_SLAB_CODES": "kNbSlabCodes",
             "QDA_THREADS": "kQdaThreads", "QDA_MAX_GROUP": "kQdaMaxGroup",
             "QDA_MAX_SUMS": "kQdaMaxSums", "SLAB_KB": "kSlabKB",
             "QDA_LOCAL_ZEROS": "kQdaLocalZeros"}
    for py, c in pairs.items():
        assert getattr(_build, py) == cxx[c], (py, c)
    assert "grouped_wide_gram.cu" in _build.SOURCES
    assert all((_build.CSRC / s).exists() for s in _build.SOURCES)


def test_unsorted_group_limit_by_p():
    """K4's register budget up to P = 88; above, no limit: the unsorted
    entry sorts the rows and runs K8, which takes any number of groups."""
    narrow = FeatureSchema(num_cols=3, cat_keys=(tuple(range(5)),) * 2)
    assert port_g.unsorted_group_limit(narrow) == _build.MAX_UNSORTED_GROUPS
    favorita = (54, 33, 337, 2, 22, 16, 5, 17)        # label onpromotion
    for d, keys in ((3, KEYS_144),
                    (3, tuple(tuple(range(v)) for v in favorita)),
                    (4, (tuple(range(1019)),))):
        schema = FeatureSchema(num_cols=d, cat_keys=keys)
        assert schema.sigma_size > _build.MAX_SIGMA_SIZE
        assert port_g.unsorted_group_limit(schema) is None
        _build.check_schema(schema, 1000, _build.MAX_WIDE_SIGMA_SIZE)


def test_nb_and_qda_routes():
    """The NB kernel, one launch for any G and F (K6 up to F = 256, K6w
    above): its plan's tasks fit a block's shared memory and one task
    holds config 3 at G = 5 and G = 100, favorita's family labels take
    two; K3 for a plan of one task (a block of half the threads), K3w for
    several, each with the most classes a step (≤ 4, ≤ C) whose tile of 8
    / group rows a thread its shared memory holds."""
    config3 = FeatureSchema(num_cols=8, cat_keys=(tuple(range(8)),) * 4)
    at_limit = FeatureSchema(num_cols=3, cat_keys=(tuple(range(249)),))
    assert _build.nb_features(at_limit) == 256      # K6; above, K6w
    above = FeatureSchema(num_cols=3, cat_keys=(tuple(range(250)),))
    _build.check_nb(above, 10_000_000)
    favorita = FeatureSchema(num_cols=3, cat_keys=tuple(
        tuple(range(v)) for v in (54, 337, 2, 2, 22, 16, 5, 17)))
    assert _build.nb_features(favorita) == 462
    for schema, groups, tasks in ((config3, 5, 1), (config3, 100, 1),
                                  (at_limit, 1, 1), (above, 40, 2),
                                  (favorita, 33, 2)):
        plan = _build.nb_plan(schema, groups)
        assert plan.num_tasks == tasks, (schema, groups)
        assert plan.max_task_cells <= _build.WIDE_TASK_BYTES // 8
        assert _build.wide_smem_bytes(
            plan.max_task_cells, plan.max_stage_cols, plan.max_slabs,
            plan.stage_rows) <= _build.WIDE_SMEM
        assert int(plan.task_base[-1]) == groups * _build.nb_features(schema)
    # one group's row past a task: cut by code range, one launch still
    long_row = FeatureSchema(num_cols=1, cat_keys=(
        tuple(range(_build.WIDE_TASK_BYTES // 8 + 1)),))
    _build.check_nb(long_row, 10)
    plan = _build.nb_plan(long_row, 2)
    assert plan.max_task_cells <= _build.WIDE_TASK_BYTES // 8
    assert int(plan.task_base[-1]) == 2 * _build.nb_features(long_row)

    config4 = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    assert _build.qda_plan(config4).num_tasks == 1             # K3
    assert _build.qda_plan(FeatureSchema(
        num_cols=4, cat_keys=KEYS_QDA)).num_tasks == 1
    # favorita_classify, label family: QDA's tables (with the cross tables)
    # take several tasks, NB's (D and K_j only) one
    assert _build.qda_plan(favorita).num_tasks > 1             # K3w
    assert _build.qda_plan(favorita, cross=False).num_tasks == 1
    # (schema, cross, classes) → (threads, rows, group): config 4's QDA
    # and NB and family's NB (one task: the most classes a step), family's
    # QDA (several tasks: the largest tile), and one or two classes
    shapes = {(config4, True, 8): (256, 2, 4),
              (config4, False, 8): (256, 2, 4),
              (favorita, True, 33): (1024, 4, 2),
              (favorita, False, 33): (256, 2, 4),
              (favorita, True, 2): (1024, 4, 2),
              (config4, True, 1): (256, 8, 1)}
    for (schema, cross, classes), want in shapes.items():
        plan = _build.qda_plan(schema, cross)
        threads, rows, group = _build.qda_tile(schema, plan, classes)
        assert (threads, rows, group) == want, (classes, cross)
        assert plan.scorer and not (plan.task_base % 4).any()
        assert plan.max_task_cells <= _build.QDA_TASK_CELLS
        assert _build.qda_smem_bytes(plan.max_task_cells, schema,
                                     threads * rows, group) <= _build.WIDE_SMEM
    # at family four classes a step would fit too, with half the tile
    plan = _build.qda_plan(favorita)
    assert _build.qda_smem_bytes(plan.max_task_cells, favorita, 1024 * 2,
                                 4) <= _build.WIDE_SMEM
    with pytest.raises(ValueError):
        _build.check_qda(favorita, 0, 100)


def test_group_chunks_never_cross_a_group():
    """K8's (and K5's) group-aligned chunks: group g owns chunks cum[g] ..
    cum[g + 1], ceil(rows / chunk) of them; every row of a chunk lies in
    its group."""
    counts = torch.tensor([0, 1, 127, 128, 129, 0, 300])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(counts, 0)])
    cum = _build.group_chunks(offsets, _build.WIDE_CHUNK)
    assert _build.WIDE_CHUNK == 32
    assert cum.tolist() == [0, 0, 1, 5, 9, 14, 14, 24]
    for g in range(len(counts)):
        for ch in range(int(cum[g]), int(cum[g + 1])):
            lo = int(offsets[g]) + (ch - int(cum[g])) * _build.WIDE_CHUNK
            assert int(offsets[g]) <= lo < int(offsets[g + 1])


class _FailingLib:
    """Stands for the kernel library: records each entry called and fails
    every launch with CUDA error 719."""
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "dit_error_string":
            return lambda rc: b"unspecified launch failure"

        def launch(*args):
            self.calls.append(name)
            return 719
        return launch


def _wide_calls():
    """(wrapper, counter, C entry, call) of each wide route."""
    x, codes, g, ws = grouped_inputs(3, n=600)
    xt, ct, gt = t(x), t(codes.clip(0, 19)), t(g.clip(0, 2))
    layout = port_g.GroupLayout(torch.tensor([0, 300, 600]), 2)
    nb_schema = FeatureSchema(num_cols=3, cat_keys=KEYS_NB)
    plan = _build.qda_plan(nb_schema)        # a cross table of 200 × 60
    assert plan.num_tasks > 1
    xq = t(np.zeros((3, 600), np.float32))
    return [
        (port_g.grouped_gram_presorted, "wide_launches",
         "dit_grouped_wide_gram",
         lambda: port_g.grouped_gram(xt, ct, None, gt, schema=SCHEMA_144,
                                     num_groups=3)),
        (port_g.grouped_gram_presorted, "wide_launches",
         "dit_grouped_wide_gram",
         lambda: port_g.grouped_gram_presorted(xt, ct, torch.ones(600),
                                               layout, schema=SCHEMA_144)),
        (port_nb.nb_grouped_sums, "launches", "dit_nb_grouped_sums",
         lambda: port_nb.nb_grouped_sums(xt, ct, None, gt, schema=nb_schema,
                                         num_groups=3)),
        (port_qda.qda_predict_kernel, "wide_launches", "dit_qda_predict",
         lambda: port_qda.qda_predict_kernel(
             torch.zeros((8, int(plan.task_base[-1]))), plan, xq, ct,
             schema=nb_schema)),
    ]


@pytest.mark.parametrize("which", range(4))
def test_wide_routes_reach_their_kernels(monkeypatch, which):
    """On a wide schema each wrapper calls its wide entry (K8, K6w, K3w);
    with the launch made to fail it raises and counts nothing, and never
    falls back to its plain version. The device checks and the stream are
    stubbed so that the kernel route runs here."""
    lib = _FailingLib()
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "check_cuda",
                        lambda tensors, checks: torch.device("cpu"))
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    wrapper, counter, entry, call = _wide_calls()[which]
    before = (wrapper.launches, getattr(wrapper, counter))
    with pytest.raises(RuntimeError, match="launch failure"):
        call()
    assert lib.calls == [entry]
    assert (wrapper.launches, getattr(wrapper, counter)) == before


@pytest.mark.parametrize("which", range(4))
def test_wide_build_failure_propagates(monkeypatch, which):
    """A kernel that does not build raises out of each wide route."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "check_cuda",
                        lambda tensors, checks: torch.device("cpu"))
    monkeypatch.setattr(_build, "load", no_nvcc)
    _, _, _, call = _wide_calls()[which]
    with pytest.raises(RuntimeError, match="nvcc"):
        call()


# ---------------------------------------------------------------------------
# (f) QDA scoring at the plan's schema limit
# ---------------------------------------------------------------------------

def test_qda_schema_limit_as_built():
    """K3/K3w take any column count and P up to MAX_SCORER_SIGMA_SIZE, in one
    code path: past the 32 + 32 of the factor scorer, 40 numeric and 40
    categorical columns score through the plain version as the dense f64
    form ranks them; at 64 + 64 and P = 1,024 the tile shrinks to fit a
    block's shared memory, and one level more (P = 1,025) passes too; 65
    numeric or 65 one-level categorical columns are taken, their tiles
    within shared memory; the numeric columns a tile of 32 rows holds are
    taken, and one more too, its plan local (`qda_local`: a task stages
    its own columns), within shared memory; P past MAX_SCORER_SIGMA_SIZE
    raises."""
    rng = np.random.default_rng(9)
    keys = tuple(tuple(range(3)) for _ in range(40))
    schema = FeatureSchema(num_cols=40, cat_keys=keys)
    p, c_cls, n = schema.sigma_size, 4, 300
    a = rng.normal(size=(c_cls, p, p))
    x = rng.normal(size=(40, n)).astype(np.float32)
    codes = rng.integers(-1, 4, size=(40, n)).astype(np.int32)
    _build.check_qda(schema, c_cls, n)
    got = port_device.qda_predict_device(
        t(a[:, 1:, 1:]), t(a[:, 0, 1:] + a[:, 1:, 0]), t(a[:, 0, 0]), t(x),
        t(codes), schema=schema).numpy()
    z = np.concatenate([np.ones((1, n)), x.astype(np.float64)]
                       + [(codes[j][None] == np.arange(3)[:, None]) * 1.0
                          for j in range(40)])
    want = np.einsum("in,cij,jn->cn", z, a, z).argmax(0)
    assert (got == want).mean() >= 0.99

    at_limit = FeatureSchema(num_cols=64, cat_keys=tuple(
        tuple(range(14 if j < 63 else 1024 - 65 - 14 * 63))
        for j in range(64)))
    assert at_limit.sigma_size == _build.MAX_WIDE_SIGMA_SIZE
    _build.check_qda(at_limit, 2, 1000)
    plan = _build.qda_plan(at_limit)
    threads, rows, group = _build.qda_tile(at_limit, plan, 2)
    assert threads * rows < _build.QDA_THREADS * _build.QDA_MAX_SUMS
    assert _build.qda_smem_bytes(plan.max_task_cells, at_limit,
                                 threads * rows, group) <= _build.WIDE_SMEM
    _build.check_qda(FeatureSchema(num_cols=64, cat_keys=tuple(
        tuple(range(14 if j < 63 else 1024 - 64 - 14 * 63))
        for j in range(64))), 2, 1000)
    staged = _last_staged()
    for wide in (FeatureSchema(num_cols=65),
                 FeatureSchema(num_cols=4, cat_keys=((0,),) * 65),
                 FeatureSchema(num_cols=staged),
                 FeatureSchema(num_cols=staged + 1)):
        _build.check_qda(wide, 2, 1000)
        plan = _build.qda_plan(wide)
        assert plan.local == (wide.num_cols > staged)
        threads, rows, group = _build.qda_tile(wide, plan, 2)
        assert _build.qda_smem_bytes(
            plan.max_task_cells, wide, threads * rows, group,
            plan.max_stage_x if plan.local else None) <= _build.WIDE_SMEM
    with pytest.raises(ValueError):
        _build.check_qda(FeatureSchema(num_cols=64, cat_keys=tuple(
            tuple(range(14 if j < 63 else _build.MAX_SCORER_SIGMA_SIZE
                        - 64 - 14 * 63))
            for j in range(64))), 2, 1000)


def _last_staged(sizes=()) -> int:
    """The most numeric columns beside categorical columns of `sizes`
    whose scorer's plan stages every numeric column a tile (not
    `_build.qda_local`)."""
    d = 1
    while not _build.qda_local(FeatureSchema(
            num_cols=d + 1, cat_keys=tuple(tuple(range(v)) for v in sizes))):
        d += 1
    return d
