"""The arithmetic of the port's redesigned K1 and NB kernels on the CPU.

K1 (csrc/tc_gram.cuh) forms S = Zᵀ·diag(w)·Z on the tensor cores from
three bf16 parts of every f32 value; `masked_gram_split_plain` repeats
that arithmetic in plain torch. The NB kernel (csrc/nb_grouped_sums.cu)
forms keyed f64 sums into the tables of `_build.nb_plan`; `nb_cells_plain`
and `nb_assemble` repeat them. Both are held against the JAX package (its
Pallas kernels in interpret mode, as tests/test_kernels.py runs them) and
against f64 numpy (tests/reference_oracle.py for the binary-weight Gram),
on inputs made from a numpy seed. On the card, tests/test_torch_cuda.py
holds the kernels against their plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.kernels.nb_pallas import (
    sum_to_nb_agg_grouped_pallas,
)
from duckdb_imputation_tpu.ring.kernels.sigma_pallas import (
    sigma_pallas_fast_cols_padded,
    sigma_pallas_padded,
)

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
    nb_assemble,
    nb_cells_plain,
    nb_grouped_sums_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_split_plain,
    split3_plain,
)

from reference_oracle import _exact_triple_dict, build_sigma_from_dict

torch.set_num_threads(2)

# (d, vocabularies): BASELINE config 5 (P = 21, K1's tensor-core tile) and
# one near K1's limit with many numerics (P = 88, d = 24: its CUDA cores)
K1_SCHEMAS = {"P21": (4, (8, 8)), "P88": (24, (21, 21, 21))}


# ---------------------------------------------------------------------------
# K1: the three-way bf16 split and the Gram of the parts
# ---------------------------------------------------------------------------

def _f32(bits):
    return torch.tensor(np.asarray(bits, np.uint32).view(np.float32))


def test_split3_is_exact_across_exponents():
    """h + m + l == v bit for bit for random mantissas at every exponent
    from 2⁻¹¹⁰ to 2¹²⁶, both signs, zero, and the subnormals that are
    multiples of 2⁻¹³³; each part is a bf16 value; for smaller subnormals
    the lost residual is below 2⁻¹³³."""
    rng = np.random.default_rng(0)
    exps = np.arange(-110, 127)
    mant = rng.integers(0, 1 << 23, size=(len(exps), 64), dtype=np.uint32)
    sign = rng.integers(0, 2, size=mant.shape, dtype=np.uint32) << 31
    bits = sign | ((exps[:, None] + 127).astype(np.uint32) << 23) | mant
    sub = (rng.integers(1, 1 << 7, 200, dtype=np.uint32) << 16)  # k·2⁻¹³³
    v = torch.cat([_f32(bits.ravel()), _f32(sub), -_f32(sub),
                   torch.tensor([0.0, -0.0, 1.0, -3.5])])
    h, m, l = split3_plain(v)
    assert torch.equal(h + m + l, v)
    for part in (h, m, l):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(h, v.to(torch.bfloat16).float())
    tiny = _f32(rng.integers(1, 1 << 16, 200, dtype=np.uint32))
    h, m, l = split3_plain(tiny)
    assert float((h + m + l - tiny).abs().max()) < 2.0 ** -133


def _k1_inputs(name, n, seed, general, oov=False):
    d, sizes = K1_SCHEMAS[name]
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(d, n)) * 2 + 0.5).astype(np.float32)
    codes = np.stack([rng.integers(0, s, n) for s in sizes]).astype(np.int32)
    if oov:
        codes[0, :n // 10] = sizes[0]
        codes[-1, n // 10:n // 5] = -1
    w = (rng.random(n).astype(np.float32) if general
         else (rng.random(n) > 0.3).astype(np.float32))
    keys = tuple(tuple(range(s)) for s in sizes)
    return num, codes, w, FeatureSchema(num_cols=d, cat_keys=keys), RefSchema(
        num_cols=d, cat_keys=keys)


def _count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def _sigma_f64(num, codes, w, schema):
    rows = [np.ones((1, num.shape[1]))] + [num.astype(np.float64)]
    for j, size in enumerate(schema.cat_sizes):
        rows.append((codes[j][None, :] == np.arange(size)[:, None]) * 1.0)
    zt = np.concatenate(rows)
    return (zt * w.astype(np.float64)) @ zt.T


@pytest.mark.parametrize("name", list(K1_SCHEMAS))
@pytest.mark.parametrize("general", [False, True])
def test_split_gram_matches_pallas_and_the_f64_oracle(name, general):
    """The Gram of the parts, folded and rounded once, against the JAX
    Pallas kernel (binary weights: sigma_pallas_fast_cols_padded; general:
    sigma_pallas_padded; interpret mode) and the f64 oracle
    (tests/reference_oracle.py with binary weights, f64 numpy with
    general): counts exact, everything within 1e-6 of max|σ| of the f64
    sums (each part product exact, f64 sums, one rounding) and within the
    Pallas kernels' own split error (~2⁻¹⁶ a term, 2e-4 relative) of
    theirs."""
    n = 3000
    num, codes, w, schema, ref_schema = _k1_inputs(name, n, 7, general)
    got = masked_gram_split_plain(
        [torch.tensor(a) for a in num], [torch.tensor(a) for a in codes],
        torch.tensor(w), schema=schema).numpy()
    with pltpu.force_tpu_interpret_mode():
        if general:
            ref = np.asarray(sigma_pallas_padded(
                jnp.asarray(num), jnp.asarray(codes), jnp.asarray(w),
                schema=ref_schema, chunk_cols=512))
        else:
            ref = np.asarray(sigma_pallas_fast_cols_padded(
                tuple(jnp.asarray(a) for a in num),
                tuple(jnp.asarray(a) for a in codes), jnp.asarray(w),
                schema=ref_schema, chunk_cols=512))
    if general:
        exact = _sigma_f64(num, codes, w, schema)
    else:
        exact, _ = build_sigma_from_dict(_exact_triple_dict(num.T, codes.T,
                                                            w))
    scale = np.abs(exact).max()
    cm = _count_mask(schema)
    if not general:
        assert np.array_equal(got[cm], exact[cm])
        assert np.array_equal(got[cm], ref[cm])
    assert np.abs(got - exact).max() <= 1e-6 * scale
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6 * scale)
    assert np.array_equal(got, got.T)


def test_split_gram_codes_out_of_vocab_add_nothing():
    num, codes, w, schema, _ = _k1_inputs("P21", 2000, 3, False, oov=True)
    got = masked_gram_split_plain(
        [torch.tensor(a) for a in num], [torch.tensor(a) for a in codes],
        torch.tensor(w), schema=schema).numpy()
    exact = _sigma_f64(num, codes, w, schema)
    cm = _count_mask(schema)
    assert np.array_equal(got[cm], exact[cm])
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()


@pytest.mark.parametrize("d,sizes,fits", [
    (4, (8, 8), True), (24, (21, 21, 21), False), (87, (), False),
    (0, (87,), False), (1, (3, 3, 3), True), (0, (20,), True),
    (0, (21,), False), (10, (), True), (11, (), False), (8, (8,), False)])
def test_tc_fits_one_output_tile(d, sizes, fits):
    """K1 takes the tensor cores exactly where S is the kernel's one output
    tile: the three parts of each a in 64 left features (P ≤ 21) and the
    right features, three parts of each x and one for the constant and each
    one-hot, in 32; BASELINE config 5 fits."""
    p = 1 + d + sum(sizes)
    right = 1 + 3 * d + sum(sizes)
    assert _build.tc_fits(d, p) == fits
    assert fits == (3 * p <= 64 and right <= _build.TC_RIGHT)


# ---------------------------------------------------------------------------
# NB: the keyed sums of the plan's cells
# ---------------------------------------------------------------------------

NB_KEYS = (tuple(range(8)),) * 4        # BASELINE config 3: d = 8, c = 4


def _nb_inputs(n, groups, seed, general):
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(8, n)) * 3 + 1).astype(np.float32)
    codes = rng.integers(0, 8, size=(4, n)).astype(np.int32)
    codes[1, :40] = 8                    # out of vocab: counted nowhere
    codes[2, 40:90] = -1
    g = rng.integers(0, groups, n).astype(np.int32)
    g[:25] = groups                      # out of range: dropped
    g[25:60] = -1
    w = rng.random(n).astype(np.float32) if general else None
    return num, codes, g, w


@pytest.mark.parametrize("groups,cap,general", [
    (40, 8192, False), (40, 256, False), (40, 256, True), (5, 8192, True),
    (1, 8192, False)])
def test_nb_plan_cells_match_plain_sums(groups, cap, general):
    """The plan's cells, assembled to [G, F], against `_nb_sums` (the plain
    version): G = 40, past the old kernel's 32 groups a launch; a budget of
    256 cells that splits every table into several tasks; ids outside [0,
    G) and codes out of vocab; weights None and general. Counts exact
    (weights None), x and x² sums within 1e-6 relative (the same f32
    terms, summed in f64 in another order)."""
    schema = FeatureSchema(num_cols=8, cat_keys=NB_KEYS)
    num, codes, g, w = _nb_inputs(4000, groups, groups, general)
    plan = _build._nb_plan(8, (8,) * 4, groups, cap)
    if cap == 256:
        assert plan.num_tasks > 1
    f = _build.nb_features(schema)
    assert sorted(plan.out_index.tolist()) == list(range(groups * f))
    args = (torch.tensor(num), torch.tensor(codes),
            None if w is None else torch.tensor(w), torch.tensor(g))
    got = nb_assemble(nb_cells_plain(*args, plan=plan, schema=schema),
                      plan=plan, schema=schema)
    want = nb_grouped_sums_plain(*args, schema=schema, num_groups=groups)
    if w is None:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 17:], want[:, 17:])
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("fast", [False, True])
def test_nb_plan_cells_match_pallas(fast):
    """The plan's cells at G = 40, split over several tasks, against
    sum_to_nb_agg_grouped_pallas in interpret mode, both bodies (fast:
    binary weights through the bf16 split; not fast: general f32), at the
    tolerances of tests/test_torch_nb.py: counts exact, lin within rtol
    1e-6 and atol 1e-3, quad_diag within rtol 1e-6 and atol 5e-2."""
    schema = FeatureSchema(num_cols=8, cat_keys=NB_KEYS)
    ref_schema = RefSchema(num_cols=8, cat_keys=NB_KEYS)
    groups = 40
    num, codes, g, _ = _nb_inputs(6000, groups, 11, False)
    plan = _build._nb_plan(8, (8,) * 4, groups, 512)
    assert plan.num_tasks > 1
    got = nb_assemble(nb_cells_plain(torch.tensor(num), torch.tensor(codes),
                                     None, torch.tensor(g), plan=plan,
                                     schema=schema),
                      plan=plan, schema=schema).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = sum_to_nb_agg_grouped_pallas(num, codes, g, schema=ref_schema,
                                           num_groups=groups, fast=fast,
                                           chunk_cols=2048)
    np.testing.assert_array_equal(got[:, 0], np.asarray(ref.n))
    np.testing.assert_array_equal(got[:, 17:], np.asarray(ref.lin_cat))
    np.testing.assert_allclose(got[:, 1:9], np.asarray(ref.lin), rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(got[:, 9:17], np.asarray(ref.quad_diag),
                               rtol=1e-6, atol=5e-2)


@pytest.mark.parametrize("general", [False, True])
def test_nb_plan_splits_a_long_row_by_code_range(general):
    """A categorical column of 300 values under a budget of 256 cells: each
    group's row of its table is cut by code range into slabs of its own
    kind (NB_SLAB_CODES), codes out of vocab and ids outside [0, G) add
    nothing; the assembled cells equal `_nb_sums` (counts exact with no
    weights, the rest within 1e-6 relative) and JAX's
    sum_to_nb_agg_grouped_pallas in interpret mode (general f32 body; its
    counts exact, its sums at the tolerances of tests/test_torch_nb.py)."""
    keys = (tuple(range(300)), tuple(range(8)))
    schema = FeatureSchema(num_cols=2, cat_keys=keys)
    groups, n = 3, 4000
    rng = np.random.default_rng(21)
    num = (rng.normal(size=(2, n)) * 3 + 1).astype(np.float32)
    codes = np.stack([rng.integers(-1, 301, n),
                      rng.integers(0, 9, n)]).astype(np.int32)
    g = rng.integers(-1, groups + 1, n).astype(np.int32)
    w = rng.random(n).astype(np.float32) if general else None
    plan = _build._nb_plan(2, (300, 8), groups, 256)
    code_slabs = [s for s in plan.slabs.tolist()
                  if s[0] == _build.NB_SLAB_CODES]
    assert len(code_slabs) == 2 * groups        # two code ranges a group
    assert all(s[1] == 0 and s[4] - s[3] <= 256 for s in code_slabs)
    assert sorted(plan.out_index.tolist()) == list(range(
        groups * _build.nb_features(schema)))
    args = (torch.tensor(num), torch.tensor(codes),
            None if w is None else torch.tensor(w), torch.tensor(g))
    got = nb_assemble(nb_cells_plain(*args, plan=plan, schema=schema),
                      plan=plan, schema=schema)
    want = nb_grouped_sums_plain(*args, schema=schema, num_groups=groups)
    if w is None:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 5:], want[:, 5:])
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    if general:
        return
    with pltpu.force_tpu_interpret_mode():
        ref = sum_to_nb_agg_grouped_pallas(
            num, codes, g, schema=RefSchema(num_cols=2, cat_keys=keys),
            num_groups=groups, fast=False, chunk_cols=2048)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 0], np.asarray(ref.n))
    np.testing.assert_array_equal(got[:, 5:], np.asarray(ref.lin_cat))
    np.testing.assert_allclose(got[:, 1:3], np.asarray(ref.lin), rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(got[:, 3:5], np.asarray(ref.quad_diag),
                               rtol=1e-6, atol=5e-2)


def test_nb_plan_takes_a_column_longer_than_a_task():
    """A column of 20,000 values, more than a task's 8,192 cells: the NB
    kernel's checks accept it, and its plan cuts each group's row into
    three code ranges, every task within its budget, every place of [G, F]
    once."""
    schema = FeatureSchema(num_cols=3, cat_keys=(tuple(range(20_000)),
                                                 tuple(range(33))))
    _build.check_nb(schema, 10_000_000)
    plan = _build.nb_plan(schema, 4)
    assert sum(s[0] == _build.NB_SLAB_CODES
               for s in plan.slabs.tolist()) == 3 * 4
    assert plan.max_task_cells <= _build.WIDE_TASK_BYTES // 8
    assert _build.wide_smem_bytes(plan.max_task_cells, plan.max_stage_cols,
                                  plan.max_slabs, plan.stage_rows
                                  ) <= _build.WIDE_SMEM
    assert sorted(plan.out_index.tolist()) == list(range(
        4 * _build.nb_features(schema)))


def test_nb_plan_at_favorita_classify():
    """One launch for any G and F: family (G = 33, F = 462) takes two tasks
    of at most 8,192 cells (the class column's 33 × 337 table split by
    group range), onpromotion (G = 2, F = 493) one; D is cut into slabs of
    at most `d_terms` terms, the count whose warps' loads cost least: one
    term a slab at family, where nine K_j slabs leave seven warps of two
    tasks free, and at most five at config 3 (G = 5: four K_j slabs)."""
    fam = (54, 337, 2, 2, 22, 16, 5, 17)
    plan = _build._nb_plan(3, fam, 33)
    assert plan.num_tasks == 2
    assert plan.max_task_cells <= _build.WIDE_TASK_BYTES // 8
    k_class = [s for s in plan.slabs.tolist()
               if s[0] == _build.SLAB_K and s[1] == 1]
    assert len(k_class) > 1                      # split by group range
    d_slabs = [s for s in plan.slabs.tolist() if s[0] == _build.SLAB_D]
    assert all(s[4] - s[1] <= plan.d_terms for s in d_slabs)
    assert plan.d_terms == 1
    assert len(d_slabs) == 7
    assert 1 < _build._nb_plan(8, (8,) * 4, 5).d_terms <= 5
    assert _build._nb_plan(3, (54, 33, 337, 2, 22, 16, 5, 17), 2
                           ).num_tasks == 1
    assert len(plan.shape_ints(512)) == _build.NB_PLAN_INTS


class _RecordingLib:
    """Stands for the kernel library: records each entry called; every
    launch fails (CUDA error 719), so no kernel needs to run here."""
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "dit_gram_entries":
            return lambda p: 16
        if name == "dit_error_string":
            return lambda rc: b"unspecified launch failure"

        def launch(*args):
            self.calls.append(name)
            return 719
        return launch


@pytest.mark.parametrize("name,entry", [("P21", "dit_masked_gram"),
                                        ("P88", "dit_masked_gram_cores")])
def test_k1_route_by_tensor_core_tile(monkeypatch, name, entry):
    """K1 takes the tensor cores for a schema whose S is their one output
    tile (BASELINE config 5) and its CUDA-core route for any other (P = 88
    with 24 numerics); either raises on a failed launch."""
    import contextlib
    import types

    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)
    num, codes, w, schema, _ = _k1_inputs(name, 300, 1, False)
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "check_cuda",
                        lambda tensors, checks: torch.device("cpu"))
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    assert _build.tc_fits(schema.num_cols, schema.sigma_size) == (
        name == "P21")
    with pytest.raises(RuntimeError, match="launch failure"):
        masked_gram_cols([torch.tensor(a) for a in num],
                         [torch.tensor(a) for a in codes], torch.tensor(w),
                         schema=schema)
    assert lib.calls == [entry]
