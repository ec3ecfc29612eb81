"""The port's wide-V path over a 2-D process grid (gloo on the CPU):
`parallel.sharded2d` (`make_mesh_2d`, `sum_to_triple_sharded2d`) and
`parallel.wide` (`sigma_wide`, the column-sharded CG solves, `predict_wide`,
the MICE column steps and `run_mice_wide`), on grids of 1 × 1, 1 × 2,
2 × 1 and 2 × 2 ranks, held against the JAX package's `parallel.wide` on
the conftest's 2 × 4 virtual mesh at each test of tests/test_wide.py with
its sizes and bounds (CG 2e-3; `run_mice_wide` codes equal, numerics
5e-3; LDA recovery > 0.95), and each rank's block against its shape P ×
cols_per.

The ranks are processes of tests/torch_wide_worker.py (torch only; a
FileStore in a temporary directory), all four grids started together once
for the module, under one deadline after which every child is killed. The
JAX side runs here, once for the module.
"""
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.models.lda import LDAParams, lda_train
from duckdb_imputation_tpu.parallel import wide as ref_wide
from duckdb_imputation_tpu.parallel.sharded2d import (
    make_mesh_2d as ref_make_mesh_2d)
from duckdb_imputation_tpu.ring.sum import _zt_block
from duckdb_imputation_tpu.ring.sum import masked_sigma as ref_masked_sigma
from duckdb_imputation_tpu.ring.sum import sum_to_triple as ref_sum_to_triple

from duckdb_imputation_tpu_torch.parallel import make_mesh_2d
from duckdb_imputation_tpu_torch.parallel.sharded2d import cols_per_rank

import torch_wide_worker as worker

GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2))
DEADLINE_S = 300
WORKER = os.path.join(os.path.dirname(__file__), "torch_wide_worker.py")


def ref_schema(vocabs):
    return RefSchema(num_cols=2, cat_keys=tuple(tuple(range(v))
                                                for v in vocabs))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{(n_data, n_model): [rank 0's results, ...]} of the worker, every
    grid's ranks started at once; killed at the deadline."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for nd, nm in GRIDS:
        d = tmp_path_factory.mktemp(f"grid{nd}x{nm}")
        procs[nd, nm] = (d, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(nd), str(nm), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(nd * nm)])
    end = time.monotonic() + DEADLINE_S
    logs = {}
    try:
        for grid, (_, ps) in procs.items():
            for r, p in enumerate(ps):
                logs[grid, r] = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))[0]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = {}
    for grid, (d, ps) in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, (
                f"grid {grid} rank {r} failed:\n{logs[grid, r]}")
        out[grid] = [dict(np.load(d / f"out{r}.npz"))
                     for r in range(len(ps))]
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results of every case on its 2 × 4 mesh."""
    mesh = ref_make_mesh_2d(2, 4)
    ref = {}
    num, codes, w, vocabs = worker.wide_data(n=2048, vocab=512)
    ref["sigma"] = np.asarray(ref_masked_sigma(num, codes, w,
                                               schema=ref_schema(vocabs)))
    num, codes, w, vocabs = worker.wide_data(n=4096, vocab=256)
    sig = ref_wide.sigma_wide(num, codes, w, schema=ref_schema(vocabs),
                              mesh=mesh)
    ref["cg"] = np.asarray(ref_wide.cg_solve_wide(
        sig, mesh=mesh, label=2, p=3 + sum(vocabs), ridge=1e-2, iters=2000,
        tol=1e-9))
    x, codes, null, vocabs, _ = worker.column_step_fixture()
    ref["step"] = np.asarray(ref_wide.mice_column_step_wide(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(null),
        schema=ref_schema(vocabs), mesh=mesh, label=1, ridge=1e-4,
        iters=3000, tol=1e-10))
    num, codes, w, vocabs = worker.lda_fixture()
    rs = ref_schema(vocabs)
    wv, icpt = ref_wide.lda_solve_wide(
        ref_wide.sigma_wide(num, codes, w, schema=rs, mesh=mesh), mesh=mesh,
        schema=rs, label=0, shrinkage=1e-3, iters=3000, tol=1e-10)
    ref["lda"] = (np.asarray(wv), np.asarray(icpt))
    ref["lda_dense"] = LDAParams.decode(
        np.asarray(lda_train(ref_sum_to_triple(num, codes, w, schema=rs),
                             rs, label=0, shrinkage=1e-3)),
        num_cols=2, normalize=False)
    num, codes, nn, cn, vocabs = worker.mice_fixture()
    xw, cw = ref_wide.run_mice_wide(
        num, codes, nn, cn, schema=ref_schema(vocabs), mesh=mesh, iters=2,
        ridge=1e-3, shrinkage=1e-3, cg_iters=4000, tol=1e-11)
    ref["mice"] = (np.asarray(xw), np.asarray(cw))
    num, corrupted, null, _, vocabs = worker.cat_step_fixture()
    ref["cat"] = np.asarray(ref_wide.mice_cat_step_wide(
        jnp.asarray(num), jnp.asarray(corrupted), jnp.asarray(null),
        schema=ref_schema(vocabs), mesh=mesh, label=0, shrinkage=1e-3,
        iters=800, tol=1e-8))
    num, codes, coeff, vocabs = worker.predict_fixture()
    rs = ref_schema(vocabs)
    ref["pred"] = np.asarray(ref_wide.predict_wide(
        jnp.asarray(num), jnp.asarray(codes), jnp.asarray(coeff), schema=rs,
        mesh=mesh, label=1))
    theta = coeff.copy()
    theta[2] = 0.0
    ref["pred_host"] = theta @ np.asarray(_zt_block(
        jnp.asarray(num), jnp.asarray(codes), rs))
    return ref


def data_rows(ranks, grid, key):
    """A row-sharded result: the data ranks' rows in order (each from model
    rank 0), after checking that every model rank of a data rank holds the
    same."""
    nd, nm = grid
    parts = []
    for d in range(nd):
        first = ranks[d * nm][key]
        for m in range(1, nm):
            np.testing.assert_array_equal(ranks[d * nm + m][key], first)
        parts.append(first)
    return np.concatenate(parts, axis=-1)


def replicated(ranks, key):
    """A result every rank holds the same: checked bit-equal, returned."""
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


def assert_sigma_close(got, want, d=2):
    """Counts exact (N, one-hot and cross counts), the rest within 1e-5 of
    max|σ|."""
    counts = np.zeros(want.shape, bool)
    counts[0, 0] = True
    counts[0, 1 + d:] = counts[1 + d:, 0] = True
    counts[1 + d:, 1 + d:] = True
    np.testing.assert_array_equal(got[counts], want[counts])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

def test_grid_of_one_runs_no_collective():
    grid = make_mesh_2d(1, 1, device="cpu")
    assert grid.data.group is None and grid.model.group is None
    assert (grid.data.rank, grid.data.world, grid.model.rank,
            grid.model.world) == (0, 1, 0, 1)
    with pytest.raises(ValueError):
        make_mesh_2d(1, 2, device="cpu")


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ranks_sit_on_the_grid(grids, grid):
    nd, nm = grid
    coords = [tuple(r["coords"]) for r in grids[grid]]
    assert coords == [(d, m) for d in range(nd) for m in range(nm)]


# ---------------------------------------------------------------------------
# tests/test_wide.py, case by case, on every grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sigma_wide_stays_sharded(grids, jax_side, grid):
    """A rank's block is P × cols_per, the same on every data rank of its
    model rank; the blocks side by side, and the gathered triple, are the
    JAX package's masked sigma."""
    nd, nm = grid
    ranks = grids[grid]
    p = 3 + 2 * 512
    cols_per = cols_per_rank(p, nm)
    want = jax_side["sigma"]
    for r in ranks:
        assert r["sigma_block"].shape == (p, cols_per)
    blocks = [ranks[m]["sigma_block"] for m in range(nm)]
    for d in range(1, nd):
        for m in range(nm):
            np.testing.assert_array_equal(ranks[d * nm + m]["sigma_block"],
                                          blocks[m])
    got = np.concatenate(blocks, 1)
    assert not got[:, p:].any()
    assert_sigma_close(got[:, :p], want)
    np.testing.assert_array_equal(replicated(ranks, "sigma_gathered"),
                                  got[:, :p])


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cg_matches_dense_solve(grids, jax_side, grid):
    """The column-sharded CG equals an f64 dense ridge solve of the same
    normal equations and the JAX package's CG, at 2e-3."""
    ranks = grids[grid]
    nm = grid[1]
    coeff = replicated(ranks, "cg_coeff")
    p, label, ridge = 3 + 2 * 256, 2, 1e-2
    assert coeff[label] == -1.0
    sigma = np.concatenate([ranks[m]["cg_block"] for m in range(nm)],
                           1)[:, :p].astype(np.float64)
    keep = [i for i in range(p) if i != label]
    nrows = max(sigma[0, 0], 1.0)
    dd = np.ones(p - 1)
    dd[0] = 0.0
    a = sigma[np.ix_(keep, keep)] / nrows + ridge * np.diag(dd)
    ref = np.linalg.solve(a, sigma[keep, label] / nrows)
    np.testing.assert_allclose(coeff[keep], ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(coeff, jax_side["cg"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_wide_mice_column_step(grids, jax_side, grid):
    """P = 4,099: the imputation recovers x1 ≈ 0.5·x0 on the null rows
    (RMSE < 0.25), leaves the observed rows untouched, and agrees with the
    JAX package's step."""
    x, _, null, _, num = worker.column_step_fixture()
    got = data_rows(grids[grid], grid, "step_x")
    assert got.shape == x.shape
    want = 0.5 * num[0][null]
    assert np.sqrt(np.mean((got[1][null] - want) ** 2)) < 0.25
    np.testing.assert_array_equal(got[1][~null], num[1][~null])
    np.testing.assert_array_equal(got[0], x[0])
    np.testing.assert_allclose(got, jax_side["step"], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_lda_wide_matches_dense(grids, jax_side, grid):
    """The sharded-operator LDA equals the dense trainer (models.lda_train)
    and the JAX package's sharded LDA, at 2e-3; the intercept row and the
    label block are zero."""
    ranks = grids[grid]
    wv, icpt = replicated(ranks, "lda_w"), replicated(ranks, "lda_icpt")
    params = jax_side["lda_dense"]
    p = 3 + 3 + 13
    active = [i for i in range(1, p) if not 3 <= i < 6]
    np.testing.assert_allclose(wv[active], params.coef, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(icpt, params.intercept, rtol=2e-3, atol=2e-3)
    assert np.all(wv[0] == 0) and np.all(wv[3:6] == 0)
    np.testing.assert_allclose(wv, jax_side["lda"][0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(icpt, jax_side["lda"][1], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_run_mice_wide_matches_jax(grids, jax_side, grid):
    """Mixed-table wide-V MICE (mean/mode init, LDA, ridge CG, 2 rounds):
    codes equal to the JAX package's, numerics within 5e-3."""
    xw = data_rows(grids[grid], grid, "mice_x")
    cw = data_rows(grids[grid], grid, "mice_c")
    rx, rc = jax_side["mice"]
    np.testing.assert_array_equal(cw, rc)
    np.testing.assert_allclose(xw, rx, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_wide_mice_cat_step_4k(grids, jax_side, grid):
    """P = 4,099 (a label of 3 classes beside a 4,093-level column): the
    sharded LDA recovers the class of the null rows (> 0.95) and keeps the
    observed codes."""
    _, corrupted, null, cls, _ = worker.cat_step_fixture()
    got = data_rows(grids[grid], grid, "cat_codes")
    assert (got[0][null] == cls[null]).mean() > 0.95
    np.testing.assert_array_equal(got[0][~null], cls[~null])
    np.testing.assert_array_equal(got[1], corrupted[1])
    assert (got[0] == jax_side["cat"][0]).mean() > 0.95


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_predict_wide_matches_host(grids, jax_side, grid):
    """Prediction over each row's codes equals θᵀZ on the host and the JAX
    package's predict_wide."""
    got = data_rows(grids[grid], grid, "pred")
    np.testing.assert_allclose(got, jax_side["pred_host"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, jax_side["pred"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sigma_wide_16k_per_rank_memory(grids, grid):
    """P = 16,387 (a dense sigma of 1.07 GB f32): a rank holds P ×
    cols_per, never the full matrix; N on the ones diagonal, every one-hot
    column's counts sum to 2n."""
    nd, nm = grid
    n, p = 512, 3 + 2 * 8192
    cols_per = cols_per_rank(p, nm)
    full_bytes = p * p * 4
    for r in grids[grid]:
        assert tuple(r["v16k_shape"]) == (p, cols_per)
        assert int(r["v16k_nbytes"]) * nm < full_bytes * 1.01 + 4 * p * nm
        assert int(r["v16k_nbytes"]) <= full_bytes // nm + 4 * p * cols_per
    for d in range(nd):
        s00, onehot = grids[grid][d * nm]["v16k_spots"]
        assert s00 == n
        np.testing.assert_allclose(onehot, 2 * n, rtol=1e-6)
