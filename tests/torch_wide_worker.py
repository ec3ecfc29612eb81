"""One rank of the port's wide-V checks on a 2-D gloo grid over the CPU.

    python tests/torch_wide_worker.py RANK N_DATA N_MODEL DIR

Joins an (N_DATA · N_MODEL)-rank gloo group through a FileStore in DIR,
makes the n_data × n_model grid (`parallel.sharded2d.make_mesh_2d`), runs
every case of tests/test_torch_wide_v.py on its rows and columns, and
writes its results to DIR/out<RANK>.npz. Imports torch and the port only,
never jax: the test compares the results with the JAX package in its own
process. The fixture makers below are numpy only (tests/test_wide.py's
tables, seeds and sizes); the test imports them to build the same tables
for the JAX side.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as np


def wide_data(n=4096, vocab=2048, seed=0):
    """tests/test_wide.py's `_wide_data`: (num f32[2, n], codes i32[2, n],
    w f32[n], vocab): x1 = 0.5·x0 + 0.1·eps, two code columns of `vocab`
    levels, 25% zero weights."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(2, n)).astype(np.float32)
    num[1] = 0.5 * num[0] + 0.1 * rng.normal(size=n).astype(np.float32)
    codes = rng.integers(0, vocab, size=(2, n)).astype(np.int32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    return num, codes, w, (vocab, vocab)


def column_step_fixture():
    """test_wide_mice_column_step: P = 4,099, 20% of x1 null and set to
    99. Returns (x, codes, null, vocabs, num)."""
    num, codes, _, vocabs = wide_data(n=8192, vocab=2048, seed=3)
    rng = np.random.default_rng(7)
    null = rng.random(8192) < 0.2
    x = num.copy()
    x[1] = np.where(null, 99.0, x[1])
    return x, codes, null, vocabs, num


def lda_fixture():
    """test_lda_wide_matches_dense (seed 21, 4,096 rows, classes 3)."""
    rng = np.random.default_rng(21)
    n = 4096
    cls = rng.integers(0, 3, size=n)
    num = np.stack([cls - 1.0 + 0.4 * rng.normal(size=n),
                    rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([cls, rng.integers(0, 13, size=n)]).astype(np.int32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    return num, codes, w, (3, 13)


def mice_fixture():
    """test_run_mice_wide_matches_dense (seed 33, 4,096 rows): (num,
    codes, num_null, cat_null, vocabs)."""
    rng = np.random.default_rng(33)
    n = 4096
    cls = rng.integers(0, 3, size=n)
    z = rng.normal(size=n)
    num = np.stack([cls - 1.0 + 0.3 * z,
                    0.7 * (cls - 1.0) + 0.2 * rng.normal(size=n)]
                   ).astype(np.float32)
    codes = np.stack([cls, rng.integers(0, 11, size=n)]).astype(np.int32)
    num_null = np.zeros((2, n), bool)
    cat_null = np.zeros((2, n), bool)
    num_null[1, rng.random(n) < 0.2] = True
    cat_null[0, rng.random(n) < 0.2] = True
    return num, codes, num_null, cat_null, (3, 11)


def cat_step_fixture():
    """test_wide_mice_cat_step_4k (seed 17, 2,048 rows, P = 4,099): (num,
    corrupted codes, null, cls, vocabs)."""
    rng = np.random.default_rng(17)
    n, vbig = 2048, 4093
    cls = rng.integers(0, 3, size=n)
    num = np.stack([cls * 2.0 + 0.3 * rng.normal(size=n),
                    rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([cls, rng.integers(0, vbig, size=n)]).astype(np.int32)
    null = rng.random(n) < 0.2
    corrupted = codes.copy()
    corrupted[0] = np.where(null, (cls + 1) % 3, cls)
    return num, corrupted, null, cls, (3, vbig)


def predict_fixture():
    """test_predict_wide_matches_host (seeds 5 and 11): (num, codes,
    coeff, vocabs)."""
    num, codes, _, vocabs = wide_data(n=1000, vocab=128, seed=5)
    rng = np.random.default_rng(11)
    coeff = rng.normal(size=3 + sum(vocabs)).astype(np.float32)
    coeff[2] = -1.0
    return num, codes, coeff, vocabs


def v16k_fixture():
    """test_sigma_wide_16k_per_device_memory (seed 2, 512 rows, two
    columns of 8,192 levels: P = 16,387)."""
    rng = np.random.default_rng(2)
    n, vocab = 512, 8192
    num = rng.normal(size=(2, n)).astype(np.float32)
    codes = rng.integers(0, vocab, size=(2, n)).astype(np.int32)
    return num, codes, np.ones(n, np.float32), (vocab, vocab)


def _main(rank: int, n_data: int, n_model: int, out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.parallel import (
        cg_solve_wide, initialize, lda_solve_wide, make_mesh_2d,
        mice_cat_step_wide, mice_column_step_wide, predict_wide,
        run_mice_wide, shutdown, sigma_wide, sum_to_triple_sharded2d)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    torch.set_num_threads(1)
    world = n_data * n_model
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    initialize("gloo", store=store, world_size=world, rank=rank,
               device="cpu", timeout=datetime.timedelta(seconds=120))
    grid = make_mesh_2d(n_data, n_model, device="cpu")
    out = {"coords": np.array([grid.data.rank, grid.model.rank])}
    t = torch.tensor

    def schema(d, vocabs):
        return FeatureSchema(num_cols=d, cat_keys=tuple(
            tuple(range(v)) for v in vocabs))

    # sigma_wide / sum_to_triple_sharded2d at P = 1,027
    num, codes, w, vocabs = wide_data(n=2048, vocab=512)
    s = schema(2, vocabs)
    out["sigma_block"] = sigma_wide(t(num), t(codes), t(w), schema=s,
                                    mesh=grid, shard_rows=True).numpy()
    out["sigma_gathered"] = sigma_from_triple(sum_to_triple_sharded2d(
        t(num), t(codes), t(w), schema=s, mesh=grid,
        shard_rows=True)).numpy()

    # cg_solve_wide at P = 515
    num, codes, w, vocabs = wide_data(n=4096, vocab=256)
    s = schema(2, vocabs)
    block = sigma_wide(t(num), t(codes), t(w), schema=s, mesh=grid,
                       shard_rows=True)
    out["cg_coeff"] = cg_solve_wide(block, mesh=grid, label=2,
                                    p=s.sigma_size, ridge=1e-2, iters=2000,
                                    tol=1e-9).numpy()
    out["cg_block"] = block.numpy()

    # mice_column_step_wide at P = 4,099
    x, codes, null, vocabs, _ = column_step_fixture()
    out["step_x"] = mice_column_step_wide(
        t(x), t(codes), t(null), schema=schema(2, vocabs), mesh=grid,
        label=1, ridge=1e-4, iters=3000, tol=1e-10,
        shard_rows=True).numpy()

    # lda_solve_wide at P = 19
    num, codes, w, vocabs = lda_fixture()
    s = schema(2, vocabs)
    block = sigma_wide(t(num), t(codes), t(w), schema=s, mesh=grid,
                       shard_rows=True)
    wv, icpt = lda_solve_wide(block, mesh=grid, schema=s, label=0,
                              shrinkage=1e-3, iters=3000, tol=1e-10)
    out["lda_w"], out["lda_icpt"] = wv.numpy(), icpt.numpy()

    # run_mice_wide at P = 17
    num, codes, nn, cn, vocabs = mice_fixture()
    xw, cw = run_mice_wide(t(num), t(codes), t(nn), t(cn),
                           schema=schema(2, vocabs), mesh=grid, iters=2,
                           ridge=1e-3, shrinkage=1e-3, cg_iters=4000,
                           tol=1e-11, shard_rows=True)
    out["mice_x"], out["mice_c"] = xw.numpy(), cw.numpy()

    # mice_cat_step_wide at P = 4,099
    num, corrupted, null, _, vocabs = cat_step_fixture()
    out["cat_codes"] = mice_cat_step_wide(
        t(num), t(corrupted), t(null), schema=schema(2, vocabs), mesh=grid,
        label=0, shrinkage=1e-3, iters=800, tol=1e-8,
        shard_rows=True).numpy()

    # predict_wide at P = 259
    num, codes, coeff, vocabs = predict_fixture()
    out["pred"] = predict_wide(t(num), t(codes), t(coeff),
                               schema=schema(2, vocabs), mesh=grid, label=1,
                               shard_rows=True).numpy()

    # sigma_wide at P = 16,387: the block's shape and bytes, and spot
    # values of the rank that owns column 0
    num, codes, w, vocabs = v16k_fixture()
    block = sigma_wide(t(num), t(codes), t(w), schema=schema(2, vocabs),
                       mesh=grid, shard_rows=True)
    out["v16k_shape"] = np.array(block.shape)
    out["v16k_nbytes"] = np.array(block.numel() * block.element_size())
    out["v16k_spots"] = np.array([float(block[0, 0]),
                                  float(block[3:, 0].double().sum())])
    del block

    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    shutdown()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
          sys.argv[4])
