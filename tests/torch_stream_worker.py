"""One rank of the port's streaming fold over a mesh, on gloo over the CPU.

    python tests/torch_stream_worker.py RANK WORLD DIR

Joins a `world`-rank gloo group through a FileStore in DIR, streams the
fixture below with `scan_gram(..., mesh=...)` (each rank folds its
row_shard of every chunk, one all-reduce at the end) and with
`run_mice_stream(..., mesh=...)`, and writes its results to
DIR/out<RANK>.npz. Imports torch and the port only, never jax. The
fixture maker is numpy only; tests/test_torch_streaming.py imports it.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as np

CHUNK_ROWS = 512


def stream_fixture(seed=0, n=4000, miss=0.08):
    """tests/test_streaming.py's `_make_data`: 3 numeric columns from a
    latent, a categorical column from its sign (values 2 and 9) and one
    of 3 levels; `miss` MCAR nulls in every column. Returns (num_in
    f32[3, n] with NaN, cat_in i64[2, n] with -1, num, cat, num_null,
    cat_null)."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=n)
    num = np.stack([lat * 2 + rng.normal(size=n) * .3,
                    -lat + rng.normal(size=n) * .3,
                    rng.normal(size=n)]).astype(np.float32)
    cat = np.stack([(lat > 0).astype(np.int64) * 7 + 2,
                    rng.integers(0, 3, size=n)])
    num_null = rng.random((3, n)) < miss
    cat_null = rng.random((2, n)) < miss
    return (np.where(num_null, np.nan, num), np.where(cat_null, -1, cat),
            num, cat, num_null, cat_null)


def _main(rank: int, world: int, out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.parallel import initialize, shutdown
    from duckdb_imputation_tpu_torch.ring.streaming import (
        chunks_from_arrays, scan_gram, scan_schema)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    mesh = initialize("gloo", store=store, world_size=world, rank=rank,
                      device="cpu", timeout=datetime.timedelta(seconds=60))
    num_in, cat_in = stream_fixture(seed=8, n=3100)[:2]
    src = chunks_from_arrays(num_in, cat_in, chunk_rows=900)
    ss, _ = scan_schema(src, collect_dirty=False)
    out = {"gram": scan_gram(src, ss, chunk_rows=CHUNK_ROWS,
                             mesh=mesh).numpy()}
    res = run_mice_stream(src, iters=2, noise=False, engine="device",
                          chunk_rows=CHUNK_ROWS, mesh=mesh)
    out["x"] = res.dirty.num_data.numpy()
    out["c"] = res.dirty.cat_codes.numpy()
    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    shutdown()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
