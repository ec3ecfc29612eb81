"""One rank of the port's overlapped-aggregation checks on gloo over the
CPU.

    python tests/torch_overlap_worker.py RANK WORLD DIR

Joins a `world`-rank gloo group through a FileStore in DIR, runs
`parallel.sum_to_triple_overlapped` and `parallel.sum_to_triple_sharded`
on its row shard of each case, records the order in which the overlapped
path calls its window Gram, issues its all-reduces and waits on them, and
writes its results to DIR/out<RANK>.npz. Imports torch and the port only,
never jax: tests/test_torch_overlap.py compares the results with the JAX
package in its own process. The case makers below are numpy only; the
test imports them to build the same inputs for the JAX side.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as np

# (case, n_stripes): n_stripes that divide P and that do not, one stripe,
# and more stripes than the ring tables' P, whose stripes past P are empty
CASES = (("table", 5), ("table", 4), ("table", 1), ("table", 20),
         ("wide", 4), ("wide", 5), ("no_numeric", 3))


def case_inputs(name: str):
    """(num f32[n, d] or None, cat [n, c], w f32[n]) of a case:
    tests/test_sharded.py's `table` (seed 3, 10,000 rows, P = 17), its
    categorical columns alone (the no-numeric-column case, :267), and
    the schema of its HLO check (:231; 2 numeric columns, 2 categorical
    of 30 levels, P = 63) at 6,001 rows."""
    if name in ("table", "no_numeric"):
        rng = np.random.default_rng(3)
        n = 10_000
        num = rng.normal(size=(n, 4)).astype(np.float32)
        cat = rng.integers(0, 6, size=(n, 2)) * 3 + 1
        rng.integers(0, 5, size=n)                      # the group ids
        w = rng.integers(0, 2, size=n).astype(np.float32)
        return (None if name == "no_numeric" else num), cat, w
    rng = np.random.default_rng(17)
    n = 6001
    num = rng.normal(size=(n, 2)).astype(np.float32)
    cat = rng.integers(0, 30, size=(n, 2))
    w = (rng.random(n) < 0.7).astype(np.float32)
    return num, cat, w


def _main(rank: int, world: int, out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.parallel import (
        initialize, local_shard, shutdown, sum_to_triple_overlapped,
        sum_to_triple_sharded)
    from duckdb_imputation_tpu_torch.parallel import overlap
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    mesh = initialize("gloo", store=store, world_size=world, rank=rank,
                      device="cpu", timeout=datetime.timedelta(seconds=60))

    # every window call, all-reduce issue and wait of the overlapped path,
    # in order
    events = []
    window, issue = overlap.masked_gram_window, overlap.all_reduce_async

    class Handle:
        def __init__(self, work, lo):
            self.work, self.lo = work, lo

        def wait(self):
            events.append(("wait", self.lo))
            return self.work.wait()

    def traced_window(*args, lo, width, **kw):
        events.append(("window", lo))
        return window(*args, lo=lo, width=width, **kw)

    def traced_issue(t, m, *args, **kw):
        lo = events[-1][1]
        events.append(("issue", lo))
        return Handle(issue(t, m, *args, **kw), lo)

    overlap.masked_gram_window = traced_window
    overlap.all_reduce_async = traced_issue

    out = {}
    for name, n_stripes in CASES:
        num, cat, w = case_inputs(name)
        num = np.zeros((len(cat), 0), np.float32) if num is None else num
        schema = FeatureSchema.infer(num, cat)
        x = torch.tensor(num.T.copy())
        c = torch.tensor(schema.encode(cat).T.copy())
        wt = torch.tensor(w)
        tag = f"{name}_{n_stripes}"
        events.clear()
        got = sum_to_triple_overlapped(
            local_shard(x, mesh) if name != "no_numeric" else None,
            local_shard(c, mesh), local_shard(wt, mesh), schema=schema,
            mesh=mesh, n_stripes=n_stripes)
        out[tag] = sigma_from_triple(got).numpy()
        out[tag + "_events"] = np.array(repr(events))
        out[tag + "_sharded"] = sigma_from_triple(sum_to_triple_sharded(
            local_shard(x, mesh), local_shard(c, mesh),
            local_shard(wt, mesh), schema=schema, mesh=mesh)).numpy()
        # shard_rows: the whole arrays on every rank, each summing its share
        out[tag + "_shard_rows"] = sigma_from_triple(sum_to_triple_overlapped(
            x, c, wt, schema=schema, mesh=mesh, n_stripes=n_stripes,
            shard_rows=True)).numpy()

    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    shutdown()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
