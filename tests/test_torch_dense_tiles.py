"""D on the tensor cores, on the CPU, against the JAX package: past the
crossover (`_build.dense_route`, d ≥ DENSE_MIN_D numeric columns) K7's,
K8's and K2w's plans hold no D slab, and D, the dense (1+d)×(1+d) block
of [1 ‖ x] in S, is the D kernel's (csrc/dense_gram.cu) in 64 × 64 tiles
of its upper triangle (`_build.dense_tiles`). The plans' slabs and the
tiles together map every structurally nonzero place of S (or of a window)
once; below the crossover the plans are the ones with D slabs, unchanged.
The plain walk of a plan and its tiles (`wide_tables_plain`, whose cells
the tiles' follow, placed by `wide_assemble`) and the D kernel's plain
version (`dense_gram_plain`) equal the JAX package's sigma within 1e-5 of
max|σ|, counts exact, S exactly symmetric (across windows too): the
whole S just past the crossover, the windows of a schema past P = 1,024,
K8's groups, and the Gram of K2w's fused 'num' and 'cat' passes.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dense_tiles.py -q
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu.ring.kernels import sigma_fused as ref_fused

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    dense_gram,
    dense_gram_plain,
    dense_tables_plain,
    wide_assemble,
    wide_tables_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    grouped_wide_tables_plain,
    sort_by_group,
)

from test_torch_past_1024 import assert_plan_covers_once
from test_torch_past_smem import (assert_sigma_close, jax_sigma, kinds,
                                  schemas, t, table)
from test_torch_wide_levels import assert_windows_cover_once

torch.set_num_threads(2)

PAST = (_build.DENSE_MIN_D, (54, 33))     # just past the crossover, P > 88
HOME_CREDIT = (104, (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2))
SECOM = (590, ())
WINDOWS = (1100, (2,))                    # past P = 1,024: P = 1,103
# below the crossover: favorita_wide, criteo's 13 numerics, and one short;
# each with the digests (`plan_digest`) of its whole plan and of its window
# [2, min(P, 300)) as the port made them with D slabs before the tile route
BELOW = {"favorita_wide": (3, (54, 33, 337, 2, 2, 22, 16, 5, 17),
                           "797ed0e49a32be42", "3347cf08722e0a00"),
         "criteo": (13, (1460, 583, 305, 24),
                    "fa281c48e9b19336", "5fab663a04700091"),
         "one_short": (15, (54, 33), "3ee1e3b5a6dc0c3f", "48b22cc97a20fb45")}
PLAN_FIELDS = ("slabs", "warp_begin", "task_base", "entries", "stage_cols",
               "slots")


def windows(p):
    return [(lo, min(lo + _build.WINDOW_WIDTH, p))
            for lo in range(0, p, _build.WINDOW_WIDTH)]


def plan_digest(plan) -> str:
    """The first 16 hex digits of the SHA-256 of a plan's tensors
    (PLAN_FIELDS: each one's name, shape, dtype and bytes)."""
    h = hashlib.sha256()
    for f in PLAN_FIELDS:
        v = getattr(plan, f).contiguous()
        h.update(f.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def gram_of_plan(x, codes, w, schema, plan):
    """S (or a window of it) from the plan's slabs and D tiles, placed by
    its map: what K7 writes."""
    return wide_assemble(wide_tables_plain(
        list(t(x)), list(t(codes)), t(w), schema=schema, plan=plan),
        schema=schema, plan=plan).numpy()


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,sizes", [PAST, HOME_CREDIT, SECOM],
                         ids=["past", "home_credit", "secom"])
def test_whole_plan_past_crossover_holds_no_d_slab(d, sizes):
    """K7's one-launch plan past the crossover: no D slab, every tile of
    D's upper triangle, the slabs' map and the tiles' places naming every
    structurally nonzero (i, j) once; with no categorical column a plan
    of no task (D is all of S)."""
    schema, _ = schemas(d, sizes)
    assert _build.dense_route(d)
    plan = _build.wide_plan(schema)
    assert _build.SLAB_D not in kinds(plan)
    nb = _build.dense_blocks(d)
    assert plan.dense.tolist() == [[i, j] for i in range(nb)
                                   for j in range(i, nb)]
    assert (plan.num_tasks == 0) == (not sizes)
    assert_plan_covers_once(plan, d, sizes, True,
                            _build.WIDE_TASK_BYTES // 8)


@pytest.mark.parametrize("d,sizes", [WINDOWS, SECOM], ids=["d1100", "secom"])
def test_window_plans_past_crossover_cover_once(d, sizes):
    """The windows' plans past the crossover (`keyed_window_plan`: each
    window of 1,024 of a schema past P = 1,024; `window_plan` of three
    odd windows of SECOM): no D slab, each window's tiles those with a
    place in it, slabs and tiles naming every place of S (both triangles)
    once."""
    schema, _ = schemas(d, sizes)
    p = schema.sigma_size
    cuts = (windows(p) if p > _build.MAX_WIDE_SIGMA_SIZE
            else [(0, 200), (200, 257), (257, p)])
    plans = []
    for lo, hi in cuts:
        if p > _build.MAX_WIDE_SIGMA_SIZE:
            residual, keyed = _build.keyed_window_plan(schema, lo, hi)
            assert keyed is None
        else:
            residual = _build.window_plan(schema, lo, hi)
        assert _build.SLAB_D not in kinds(residual)
        assert residual.dense.tolist() == _build.dense_tiles(
            d, lo, hi).tolist()
        plans.append(residual)
    assert_windows_cover_once(plans, d, sizes)


@pytest.mark.parametrize("name", sorted(BELOW))
def test_plans_below_crossover_are_the_d_slab_plans(name):
    """Below the crossover the kernels' plans are the plans with D slabs
    the port made before the tile route, tensor for tensor (their pinned
    digests): K7's whole plan, and a window's; no tiles."""
    d, sizes, whole, window = BELOW[name]
    schema, _ = schemas(d, sizes)
    assert not _build.dense_route(d)
    plan = _build.wide_plan(schema)
    assert plan.dense is None and _build.SLAB_D in kinds(plan)
    assert plan_digest(plan) == whole
    part = _build.window_plan(schema, 2, min(schema.sigma_size, 300))
    assert part.dense is None and _build.SLAB_D in kinds(part)
    assert plan_digest(part) == window


def test_dense_slices_are_the_same_in_every_window():
    """The D kernel's row slices depend on n, d and G only, and each
    window's tiles are those of the whole D that have a place there."""
    d = WINDOWS[0]
    whole = {tuple(x) for x in _build.dense_tiles(d, 0, d + 1).tolist()}
    for lo, hi in windows(d + 3):
        tiles = _build.dense_tiles(d, lo, hi)
        assert {tuple(x) for x in tiles.tolist()} <= whole
    assert _build.dense_tiles(d, d + 1, d + 3) is None
    assert _build.dense_slices(400_000, 2000) == 2
    assert _build.dense_slices(10_000_000, 104) == 352
    assert _build.dense_slices(100, 104, 3) == 1


# ---------------------------------------------------------------------------
# The plain walks against JAX
# ---------------------------------------------------------------------------

def test_whole_gram_just_past_crossover_matches_jax():
    """S at d = DENSE_MIN_D beside two categorical columns (P = 104): the
    plan's slabs and tiles placed by their maps, and the D kernel's plain
    version (all of S, and `dense_gram` on CPU tensors), against JAX's
    sigma."""
    (d, sizes), n = PAST, 400
    schema, ref_schema = schemas(d, sizes)
    x, codes, w = table(d, sizes, n, 11)
    want = jax_sigma(x, codes, w, ref_schema)
    got = gram_of_plan(x, codes, w, schema, _build.wide_plan(schema))
    assert_sigma_close(got, want, d)
    m = 1 + d
    dg = dense_gram_plain(list(t(x)), t(w), schema=schema).numpy()
    np.testing.assert_array_equal(dg[:m, :m], got[:m, :m])
    assert not dg[m:].any() and not dg[:, m:].any()
    np.testing.assert_array_equal(
        dense_gram(list(t(x)), t(w), schema=schema).numpy(), dg)


def test_windows_past_1024_match_jax_and_stay_symmetric():
    """The two windows of a schema past P = 1,024 (1,100 numeric columns
    beside a column of 2 levels): each window's residual plan and its D
    tiles, placed by their maps, assemble S exactly symmetric across the
    windows and equal to JAX's sigma; the D kernel's plain version over a
    window equals the same columns of it over all of S, bit for bit."""
    (d, sizes), n = WINDOWS, 300
    schema, ref_schema = schemas(d, sizes)
    p = schema.sigma_size
    x, codes, w = table(d, sizes, n, 12)
    got = np.zeros((p, p), np.float32)
    for lo, hi in windows(p):
        residual, _ = _build.keyed_window_plan(schema, lo, hi)
        got[:, lo:hi] = gram_of_plan(x, codes, w, schema, residual)
    assert_sigma_close(got, jax_sigma(x, codes, w, ref_schema), d)
    whole = dense_gram_plain(list(t(x)), t(w), schema=schema)
    for lo, hi in windows(p) + [(700, 1100)]:
        np.testing.assert_array_equal(
            dense_gram_plain(list(t(x)), t(w), schema=schema, lo=lo,
                             width=hi - lo).numpy(),
            whole[:, lo:hi].numpy())


def test_k8_three_groups_match_jax():
    """K8's entry past the crossover (Home Credit's schema), 3 groups
    after sort_by_group: each group's S from the plan's slabs and tiles
    walked a group at a time (`grouped_wide_tables_plain`), and D from the
    D kernel's plain version over the group offsets, against JAX's grouped
    sigma."""
    (d, sizes), n = HOME_CREDIT, 300
    schema, ref_schema = schemas(d, sizes)
    x, codes, w = table(d, sizes, n, 13)
    g = np.random.default_rng(14).integers(0, 3, n).astype(np.int32)
    xs, cs, ws, layout = sort_by_group(t(x), t(codes), t(g), schema=schema,
                                       num_groups=3, weights=t(w))
    cells = grouped_wide_tables_plain(xs, cs, ws, layout, schema=schema)
    plan = _build.wide_plan(schema)
    assert cells.shape[-1] == (int(plan.task_base[-1])
                               + plan.dense.shape[0] * _build.DENSE_CELLS)
    got = wide_assemble(cells, schema=schema).numpy()
    want = jax_sigma(x, codes, w, ref_schema, g)
    assert_sigma_close(got, want, d)
    dg = dense_gram_plain(list(xs), ws, schema=schema,
                          offsets=layout.offsets).numpy()
    m = 1 + d
    np.testing.assert_array_equal(dg[:, :m, :m], got[:, :m, :m])


@pytest.mark.parametrize("kind", ["num", "cat"])
def test_k2w_fused_entries_match_jax(kind):
    """K2w's fused pass past the crossover (d = DENSE_MIN_D beside two
    categorical columns): the new column as JAX's fused kernel imputes it
    (interpret mode), and the Gram of the updated columns from the plan's
    slabs and D tiles (K7's cells, then the D kernel's) against JAX's
    fused sigma and the port's plain pass."""
    d, sizes = PAST
    schema, ref_schema = schemas(d, sizes)
    p, n = schema.sigma_size, 256
    x, codes, w = table(d, sizes, n, 15)
    codes = np.where(codes < 0, 0, np.minimum(codes, np.array(
        sizes)[:, None] - 1)).astype(np.int32)
    rng = np.random.default_rng(16)
    null = rng.random(n) < 0.2
    if kind == "cat":
        r, col = sizes[1], 1
        w_full = rng.normal(size=(p, r)).astype(np.float32)
        w_full[1 + d + sizes[0]:] = 0.0          # the label's own one-hot
        icpt = rng.normal(size=r).astype(np.float32)
    else:
        r, col = 1, d - 1
        w_full = 0.1 * rng.normal(size=(p, r)).astype(np.float32)
        w_full[1 + col] = 0.0
        icpt = np.zeros(1, np.float32)
    new, sig = fused_impute_aggregate(
        list(t(x)), list(t(codes)), t(null), t(w), t(w_full), t(icpt),
        schema=schema, kind=kind, imp_col=col)
    with pltpu.force_tpu_interpret_mode():
        lhs = ref_fused.pack_lhs(jnp.asarray(w_full), jnp.asarray(icpt),
                                 schema=ref_schema, n_rows=r)
        ref_new, ref_sig = ref_fused.fused_impute_aggregate(
            tuple(jnp.asarray(a) for a in x),
            tuple(jnp.asarray(a) for a in codes),
            jnp.asarray(null.astype(np.float32)), jnp.asarray(w), lhs,
            schema=ref_schema, kind=kind, imp_col=col, n_rows=r,
            chunk_cols=128)
        ref_new, ref_sig = np.asarray(ref_new), np.asarray(ref_sig, np.float64)
    x2, codes2 = x.copy(), codes.copy()
    if kind == "cat":
        np.testing.assert_array_equal(new.numpy(), ref_new)
        codes2[col] = new.numpy()
    else:
        np.testing.assert_allclose(new.numpy(), ref_new, rtol=0, atol=1e-4)
        x2[col] = new.numpy()
    got = gram_of_plan(x2, codes2, w, schema, _build.wide_plan(schema))
    assert_sigma_close(got, jax_sigma(x2, codes2, w, ref_schema), d)
    scale = np.abs(ref_sig).max()
    np.testing.assert_allclose(got, ref_sig, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, sig.numpy(), rtol=0, atol=1e-5 * scale)


def test_dense_tables_are_the_tiles_of_one_product():
    """The tiles' cells are the blocks of the f64 product of [w·z ‖ pad]
    and [z ‖ pad] (z = [1 ‖ x]), in tile order, a-major."""
    d, n = 70, 50
    rng = np.random.default_rng(17)
    x = rng.normal(size=(d, n)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    tiles = _build.dense_tiles(d, 0, 1 + d)
    cells = dense_tables_plain(list(t(x)), t(w), tiles, d).numpy()
    z = np.zeros((128, n), np.float32)
    z[0], z[1:1 + d] = 1.0, x
    full = (z * w).astype(np.float64) @ z.astype(np.float64).T
    for k, (i, j) in enumerate(tiles.tolist()):
        np.testing.assert_allclose(      # f64 sums in another order
            cells[k * 4096:(k + 1) * 4096].reshape(64, 64),
            full[64 * i:64 * i + 64, 64 * j:64 * j + 64], rtol=1e-12,
            atol=1e-12 * np.abs(full).max())
