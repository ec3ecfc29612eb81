"""The port's delta MICE loop (mice/device_round.py: build_union_gather,
mice_loop_device_delta, run_mice_device_delta) and partitions
(mice/partition.py) against the JAX package on the same numpy inputs, on
the CPU; the delta loop against the port's own full loop at the quality
bounds of tests/test_mice.py::test_mice_device_delta_matches_full; and the
delta loop's noise against the fused loop's Philox draw, row for row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import load_iris

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice import partition as ref_partition
from duckdb_imputation_tpu.mice.device_round import (
    build_union_gather as ref_union,
    mice_loop_device_delta as ref_delta_loop,
    run_mice_device_delta as ref_run_delta,
)
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import from_numpy
from duckdb_imputation_tpu_torch.mice import (
    build_partitions,
    build_union_gather,
    gather_rows,
    init_fill,
    mice_loop_device_delta,
    observed_weights,
    run_mice_device,
    run_mice_device_delta,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import philox_normal
from duckdb_imputation_tpu_torch.ring.sum import masked_sigma

from test_torch_wide import favorita

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def iris_mcar():
    """iris with 20% MCAR nulls in s_length (num 0), p_width (num 3) and
    target (cat 0), as tests/test_mice.py builds it."""
    x, y = load_iris(return_X_y=True)
    rng = np.random.default_rng(42)
    n = len(x)
    num = x.astype(np.float32).copy()
    cat = y[:, None].astype(np.int64).copy()
    num_null = np.zeros_like(num, bool)
    cat_null = np.zeros_like(cat, bool)
    for j in (0, 3):
        num_null[rng.choice(n, n // 5, replace=False), j] = True
    cat_null[rng.choice(n, n // 5, replace=False), 0] = True
    return num, cat, num_null, cat_null


@pytest.fixture(scope="module")
def favorita_small():
    """favorita_wide (P = 492) at 3,000 rows, nulls in transactions and
    type (R = 5; see test_torch_wide.py on the JAX loop's compile time)."""
    x, c, nn, cn = favorita(3000, seed=11, cat_col=7)
    return x.T, c.T, nn.T, cn.T


def test_build_partitions_matches_reference(iris_mcar):
    """Every field equals the JAX package's; the port's indices are int64
    tensors on the table's device."""
    ref = ref_partition.build_partitions(ref_from_numpy(*iris_mcar))
    got = build_partitions(from_numpy(*iris_mcar, device="cpu"))
    np.testing.assert_array_equal(got.null_counts.numpy(), ref.null_counts)
    assert got.null_counts.dtype == torch.int32
    for a, b in ((got.num_dirty_idx, ref.num_dirty_idx),
                 (got.cat_dirty_idx, ref.cat_dirty_idx)):
        assert len(a) == len(b)
        for ga, rb in zip(a, b):
            assert ga.dtype == torch.int64
            np.testing.assert_array_equal(ga.numpy(), rb)
    np.testing.assert_array_equal(got.complete_idx.numpy(), ref.complete_idx)
    np.testing.assert_array_equal(got.all_null_idx.numpy(), ref.all_null_idx)


def test_observed_weights_and_gather_rows_match_reference(iris_mcar):
    t_ref, t = ref_from_numpy(*iris_mcar), from_numpy(*iris_mcar, device="cpu")
    for kind, j in (("num", 0), ("num", 3), ("cat", 0)):
        np.testing.assert_array_equal(
            observed_weights(t, kind, j).numpy(),
            np.asarray(ref_partition.observed_weights(t_ref, kind, j)))
    idx = np.array([3, 0, 149, 77, 3])
    for a, b in zip(gather_rows(t, idx),
                    ref_partition.gather_rows(t_ref, idx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("blk", [1, 8, 1024])
@pytest.mark.parametrize("lists", ["disjoint", "overlapping", "empty"])
def test_build_union_gather_matches_reference(blk, lists):
    """The bucketed gather equals the JAX package's for the same lists;
    blk=None gives the exact sorted union with valid all ones."""
    rng = np.random.default_rng(3)
    ix = {"disjoint": [np.arange(0, 300, 3), np.arange(1, 300, 3)],
          "overlapping": [rng.choice(5000, 700, replace=False),
                          rng.choice(5000, 900, replace=False)],
          "empty": []}[lists]
    want_idx, want_valid = ref_union(ix, blk)
    got_idx, got_valid = build_union_gather(ix, blk)
    assert got_idx.dtype == torch.int64 and got_valid.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    exact, ones = build_union_gather(
        [torch.as_tensor(a) for a in ix], None)
    union = np.unique(np.concatenate(ix)) if ix else np.zeros(0, np.int64)
    np.testing.assert_array_equal(exact.numpy(), union)
    assert ones.shape == exact.shape and bool((ones == 1).all())


def _loop_args(t_np):
    """The filled table, its null columns and their dirty-row lists."""
    x, c, nn, cn = t_np
    t = init_fill(from_numpy(x, c, nn, cn, device="cpu"))
    parts = build_partitions(t)
    num_cols = tuple(j for j, ix in enumerate(parts.num_dirty_idx)
                     if ix.numel())
    cat_cols = tuple(j for j, ix in enumerate(parts.cat_dirty_idx)
                     if ix.numel())
    lists = ([parts.num_dirty_idx[j].numpy() for j in num_cols]
             + [parts.cat_dirty_idx[j].numpy() for j in cat_cols])
    return t, num_cols, cat_cols, lists


@pytest.mark.parametrize("name", ["iris", "favorita"])
def test_mice_loop_device_delta_matches_reference(iris_mcar, favorita_small,
                                                  name):
    """The loop itself on the same filled table and the same bucketed union
    (padding aliased to row 0) against the JAX loop with kernel='xla', 2
    rounds: codes agree on ≥ 0.99 of the cells (iris: all of them), x
    within 1e-3 of max|x| (the two SVD solvers of full − delta round
    differently); observed cells unchanged."""
    t_np = iris_mcar if name == "iris" else favorita_small
    t, num_cols, cat_cols, lists = _loop_args(t_np)
    idx, valid = build_union_gather(lists, 8)
    ridx, rvalid = ref_union(lists, 8)
    kw = dict(num_cols_to_impute=num_cols, cat_cols_to_impute=cat_cols,
              iters=2)
    keys = tuple(t.schema.cat_keys)
    ref_x, ref_c, _ = ref_delta_loop(
        jnp.asarray(t.num_data.numpy()), jnp.asarray(t.cat_codes.numpy()),
        jnp.asarray(t.num_null.numpy()), jnp.asarray(t.cat_null.numpy()),
        jax.random.PRNGKey(0), ridx, rvalid,
        schema=RefSchema(num_cols=t.schema.num_cols, cat_keys=keys),
        kernel="xla", **kw)
    ref_x, ref_c = np.asarray(ref_x), np.asarray(ref_c)
    for kernel in ("plain", "gram"):
        got_x, got_c = mice_loop_device_delta(
            t.num_data, t.cat_codes, t.num_null, t.cat_null, idx, valid,
            schema=t.schema, kernel=kernel, **kw)
        agree = (got_c.numpy() == ref_c).mean()
        assert agree == 1.0 if name == "iris" else agree >= 0.99, agree
        np.testing.assert_allclose(got_x.numpy(), ref_x, rtol=0,
                                   atol=1e-3 * np.abs(ref_x).max())
        obs = ~t.num_null
        assert torch.equal(got_x[obs], t.num_data[obs])


@pytest.mark.parametrize("name", ["iris", "favorita"])
def test_run_mice_device_delta_matches_reference(iris_mcar, favorita_small,
                                                 name):
    """run_mice_device_delta (exact union, no bucket) against the JAX
    package's (kernel='xla', bucketed union), 2 rounds, at the bounds of
    the loop test above."""
    t_np = iris_mcar if name == "iris" else favorita_small
    ref = ref_run_delta(ref_from_numpy(*t_np), iters=2, kernel="xla")
    ref_x, ref_c = np.asarray(ref.num_data), np.asarray(ref.cat_codes)
    for kernel in ("auto", "plain", "gram"):
        got = run_mice_device_delta(from_numpy(*t_np, device="cpu"), iters=2,
                                    kernel=kernel)
        agree = (got.cat_codes.numpy() == ref_c).mean()
        assert agree == 1.0 if name == "iris" else agree >= 0.99, agree
        np.testing.assert_allclose(got.num_data.numpy(), ref_x, rtol=0,
                                   atol=1e-3 * np.abs(ref_x).max())


@pytest.mark.parametrize("kernel", ["auto", "plain", "gram"])
def test_delta_matches_full_quality(iris_mcar, kernel):
    """The port's delta loop against its own full loop at the bounds of
    tests/test_mice.py::test_mice_device_delta_matches_full: imputed RMSE
    ≤ 1.15·full + 0.02, observed cells identical, codes agree > 0.95."""
    num, cat, num_null, cat_null = iris_mcar
    full = run_mice_device(from_numpy(*iris_mcar, device="cpu"), iters=2)
    delta = run_mice_device_delta(from_numpy(*iris_mcar, device="cpu"),
                                  iters=2, kernel=kernel)
    for j in (0, 3):
        mask = num_null[:, j]
        rmse_f = np.sqrt(np.mean((full.num_data[j].numpy()[mask]
                                  - num[mask, j]) ** 2))
        rmse_d = np.sqrt(np.mean((delta.num_data[j].numpy()[mask]
                                  - num[mask, j]) ** 2))
        assert rmse_d < rmse_f * 1.15 + 0.02, (j, rmse_d, rmse_f)
    obs = ~num_null[:, 0]
    np.testing.assert_array_equal(delta.num_data[0].numpy()[obs],
                                  full.num_data[0].numpy()[obs])
    agree = (delta.cat_codes.numpy() == full.cat_codes.numpy()).mean()
    assert agree > 0.95, agree


def test_philox_normal_keyed_by_global_rows():
    """A draw keyed by row ids equals the draw of those rows in the full
    arange(n) stream, whatever the order or the compact layout."""
    full = philox_normal(9, 2, 1, 5000)
    rows = torch.tensor([4999, 0, 17, 2048, 17, 3001])
    np.testing.assert_array_equal(
        philox_normal(9, 2, 1, rows.numel(), rows=rows).numpy(),
        full[rows].numpy())


def test_delta_noise_is_the_fused_loops_draw():
    """One round, one numeric column with nulls: the noise the delta loop
    adds to each null cell (noisy − clean) is the fused loop's for that
    row: the same Philox draw (seed, round, column, global row) times a
    residual std that the two loops compute from the same sigma by other
    sums (within 1e-4 relative)."""
    rng = np.random.default_rng(12)
    n = 4000
    z = rng.normal(size=n)
    x = np.stack([z, 2 * z + 0.5 * rng.normal(size=n),
                  rng.normal(size=n)], 1).astype(np.float32)
    c = rng.integers(0, 4, (n, 1))
    nn = np.zeros((n, 3), bool)
    nn[:, 1] = rng.random(n) < 0.1
    t = from_numpy(x, c, nn, np.zeros((n, 1), bool), device="cpu")
    deltas = {}
    for name, run in (("delta", run_mice_device_delta),
                      ("fused", lambda t, **k: run_mice_device(
                          t, kernel="fused", **k))):
        clean = run(t, iters=1)
        noisy = run(t, iters=1, noise=True, seed=21)
        np.testing.assert_array_equal(clean.num_data[1][~t.num_null[1]],
                                      noisy.num_data[1][~t.num_null[1]])
        deltas[name] = (noisy.num_data[1] - clean.num_data[1])[t.num_null[1]]
    np.testing.assert_allclose(deltas["delta"].numpy(),
                               deltas["fused"].numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float(deltas["delta"].std()) > 0.3


def test_delta_loop_full_sigma_and_round_offset(iris_mcar):
    """full_sigma, given, replaces the loop's own full aggregation;
    round_offset keys the noise of each round."""
    t = init_fill(from_numpy(*iris_mcar, device="cpu"))
    parts = build_partitions(t)
    idx, valid = build_union_gather(
        [parts.num_dirty_idx[0], parts.num_dirty_idx[3],
         parts.cat_dirty_idx[0]], None)
    kw = dict(schema=t.schema, num_cols_to_impute=(0, 3),
              cat_cols_to_impute=(0,), iters=2, noise=True, seed=4)
    args = (t.num_data, t.cat_codes, t.num_null, t.cat_null, idx, valid)
    base = mice_loop_device_delta(*args, **kw)
    full = masked_sigma(t.num_data, t.cat_codes, None, schema=t.schema)
    given = mice_loop_device_delta(*args, full, **kw)
    assert all(torch.equal(a, b) for a, b in zip(base, given))
    shifted = mice_loop_device_delta(*args, round_offset=5, **kw)
    assert not torch.equal(base[0][t.num_null], shifted[0][t.num_null])


def test_run_mice_device_delta_rejects_unported_and_unknown(iris_mcar):
    t = from_numpy(*iris_mcar, device="cpu")
    with pytest.raises(ValueError):      # 'gd' is ported; no other trainer
        run_mice_device_delta(t, iters=1, trainer="newton")
    for kernel in ("fused", "xla"):
        with pytest.raises(ValueError):
            run_mice_device_delta(t, iters=1, kernel=kernel)
