"""One rank of the port's row-sharded checks on gloo over the CPU.

    python tests/torch_sharded_worker.py RANK WORLD DIR

Joins a `world`-rank gloo group through a FileStore in DIR, runs every
check of tests/test_torch_sharded.py for that world size on its row shard
of each fixture, and writes its results to DIR/out<RANK>.npz (rank 0 also
the results every rank holds the same). Imports torch and the port only,
never jax: the test compares the results with the JAX package in its own
process. The fixture makers below are numpy only; the test imports them
to build the same tables for the JAX side.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import sys

import numpy as np

KEYS_A = ((1, 2, 3), (10,))
KEYS_B = ((2, 3, 9), (10, 20, 30))
# ranks 2 and 3 of a 4-rank world: an empty vocabulary and a short one
KEYS_EXTRA = (((), (30, 40)), ((9,), ()))


def sums_fixture():
    """tests/test_sharded.py's `table` (seed 3, 10,000 rows) and the second
    join side of its factorized test (seed 9): (num f32[n, 4], cat [n, 2],
    g i32[n], w f32[n], k1 i32[n], num2 f32[n2, 2], cat2 [n2, 1],
    k2 i32[n2])."""
    rng = np.random.default_rng(3)
    n = 10_000
    num = rng.normal(size=(n, 4)).astype(np.float32)
    cat = rng.integers(0, 6, size=(n, 2)) * 3 + 1
    g = rng.integers(0, 5, size=n).astype(np.int32)
    w = rng.integers(0, 2, size=n).astype(np.float32)
    rng = np.random.default_rng(9)
    keys = 16
    k1 = rng.integers(0, keys, n).astype(np.int32)
    n2 = 3000
    num2 = rng.normal(size=(n2, 2)).astype(np.float32)
    cat2 = rng.integers(0, 3, size=(n2, 1)) * 5
    k2 = rng.integers(0, keys, n2).astype(np.int32)
    return num, cat, g, w, k1, num2, cat2, k2


def mice_fixture(n=20_003, seed=11, null_frac=0.2, dirty_row0=False):
    """tests/test_sharded.py's MICE table: x1 = 3·x0 + x2 exactly, c0 from
    x0; `null_frac` MCAR nulls in numeric 1 and categorical 0. Returns
    (num [n, 4], cat [n, 1], nn, cn)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = ((z[:, 0] > 0).astype(int) * 3 + 4)[:, None]
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    k = int(n * null_frac)
    nn[rng.choice(n, k, False), 1] = True
    cn[rng.choice(n, k, False), 0] = True
    if dirty_row0:
        nn[0, 1] = True
    return num, cat, nn, cn


def noise_fixture():
    """tests/test_sharded.py's mesh-invariance table (seed 21, 4,096
    rows): a = 3·b + 0.1·eps with 25% nulls, c from b with 20%."""
    rng = np.random.default_rng(21)
    n = 4096
    b = rng.normal(size=n).astype(np.float32)
    a = 3 * b + 0.1 * rng.normal(size=n).astype(np.float32)
    cat = ((b > 0).astype(np.int64) * 5 + 2)[:, None]
    nn = np.zeros((n, 2), bool)
    nn[rng.choice(n, n // 4, False), 0] = True
    cn = np.zeros((n, 1), bool)
    cn[rng.choice(n, n // 5, False), 0] = True
    return np.stack([a, b], 1), cat, nn, cn


def factorized_fixture():
    """tests/test_sharded.py's factorized MICE case (seed 5): (dim num,
    dim cat, fk, fact num, fact cat, nn)."""
    rng = np.random.default_rng(5)
    keys, n = 8, 4000
    dz = (rng.normal(size=keys) * 2).astype(np.float32)
    dim_cat = rng.integers(0, 3, keys)[:, None]
    fk = rng.integers(0, keys, n)
    x2 = rng.normal(size=n).astype(np.float32)
    x1 = (1.5 * dz[fk] + 0.5 * x2).astype(np.float32)
    nn = np.zeros((n, 2), bool)
    nn[rng.choice(n, n // 4, replace=False), 0] = True
    fact_cat = rng.integers(0, 2, n)[:, None]
    return dz[:, None], dim_cat, fk, np.stack([x1, x2], 1), fact_cat, nn


def ckpt_fixture():
    """tests/test_aux.py's checkpoint table (seed 3, 4,096 rows)."""
    return mice_fixture(n=4096, seed=3)


def _main(rank: int, world: int, out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from duckdb_imputation_tpu_torch import (FeatureSchema, from_numpy,
                                             run_mice_device,
                                             run_mice_device_delta,
                                             run_mice_factorized)
    from duckdb_imputation_tpu_torch.mice import (run_mice_sharded,
                                                  run_mice_sharded_delta)
    from duckdb_imputation_tpu_torch.parallel import (
        barrier, build_vocab_sharded, factorized_join_sum_sharded,
        initialize, local_shard, shutdown, sum_to_triple_grouped_sharded,
        sum_to_triple_sharded, union_vocab)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple
    from duckdb_imputation_tpu_torch.utils.checkpoint import (
        load_table_arrays, save_table)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    mesh = initialize("gloo", store=store, world_size=world, rank=rank,
                      device="cpu", timeout=datetime.timedelta(seconds=60))
    out = {}

    def keep(name, value):
        out[name] = (value.numpy() if isinstance(value, torch.Tensor)
                     else np.asarray(value))

    # the aggregates over the rank's rows, one all-reduce each
    num, cat, g, w, k1, num2, cat2, k2 = sums_fixture()
    schema = FeatureSchema.infer(num, cat)
    s2 = FeatureSchema.infer(num2, cat2)
    x, c = torch.tensor(num.T), torch.tensor(schema.encode(cat).T)
    x2, c2 = torch.tensor(num2.T), torch.tensor(s2.encode(cat2).T)
    shard = functools.partial(local_shard, mesh=mesh)
    keep("sum", sigma_from_triple(sum_to_triple_sharded(
        shard(x), shard(c), shard(torch.tensor(w)), schema=schema,
        mesh=mesh)))
    keep("grouped", sigma_from_triple(sum_to_triple_grouped_sharded(
        shard(x), shard(c), shard(torch.tensor(g)), schema=schema,
        num_groups=5, mesh=mesh)))
    keep("join", sigma_from_triple(factorized_join_sum_sharded(
        shard(x), shard(c), shard(torch.tensor(k1)), shard(x2), shard(c2),
        shard(torch.tensor(k2)), schema1=schema, schema2=s2, num_keys=16,
        mesh=mesh)))
    keep("join_replicated", sigma_from_triple(factorized_join_sum_sharded(
        x, c, torch.tensor(k1), x2, c2, torch.tensor(k2), schema1=schema,
        schema2=s2, num_keys=16, mesh=mesh, shard_rows=True)))

    keys = ([KEYS_A, KEYS_B] + list(KEYS_EXTRA))[rank]
    vocab = union_vocab(keys, mesh)
    keep("vocab", np.array(repr(vocab)))
    keep("vocab_built", np.array(repr(build_vocab_sharded(
        shard(torch.tensor(cat.T)), mesh))))

    def table(arrays):
        return local_shard(from_numpy(*arrays, device="cpu"), mesh)

    def run(name, fn, arrays, **kw):
        got = fn(table(arrays), mesh=mesh, **kw)
        keep(name + "_x", got.num_data)
        keep(name + "_c", got.cat_codes)
        return got

    # run_mice_sharded / _delta on n = 20,003 (uneven shards)
    mice = mice_fixture()
    delta = mice_fixture(null_frac=0.05, dirty_row0=True)
    for k in ("plain", "gram", "fused"):
        run(f"mice_{k}", run_mice_sharded, mice, iters=2, kernel=k)
    run("mice_auto", run_mice_sharded, mice, iters=2, gd_iters=300)
    for k in ("plain", "gram"):
        run(f"delta_{k}", run_mice_sharded_delta, delta, iters=2, kernel=k)

    # noisy runs: the draws are keyed by global rows, not by shard
    noisy = noise_fixture()
    for name, fn, k in (("noise_plain", run_mice_sharded, "plain"),
                        ("noise_fused", run_mice_sharded, "fused"),
                        ("noise_delta", run_mice_sharded_delta, "plain")):
        run(name, fn, noisy, iters=2, kernel=k, noise=True, seed=7)
        run(name + "_off", fn, noisy, iters=2, kernel=k, noise=False, seed=7)

    # world size 1: bit-identical to the single-device loops, same kernel
    if world == 1:
        def same(name, a, b):
            keep("same_" + name, torch.equal(a.num_data, b.num_data)
                 and torch.equal(a.cat_codes, b.cat_codes))
        whole = from_numpy(*mice, device="cpu")
        for k in ("plain", "gram", "fused"):
            same(k, run_mice_sharded(whole, iters=2, kernel=k, mesh=mesh),
                 run_mice_device(whole, iters=2, kernel=k))
        same("fused_noise",
             run_mice_sharded(from_numpy(*noisy, device="cpu"), iters=2,
                              kernel="fused", noise=True, seed=7, mesh=mesh),
             run_mice_device(from_numpy(*noisy, device="cpu"), iters=2,
                             kernel="fused", noise=True, seed=7))
        whole = from_numpy(*delta, device="cpu")
        for k in ("plain", "gram"):
            same("delta_" + k,
                 run_mice_sharded_delta(whole, iters=2, kernel=k, mesh=mesh),
                 run_mice_device_delta(whole, iters=2, kernel=k))
        same("delta_noise",
             run_mice_sharded_delta(from_numpy(*noisy, device="cpu"),
                                    iters=2, noise=True, seed=7, mesh=mesh),
             run_mice_device_delta(from_numpy(*noisy, device="cpu"),
                                   iters=2, noise=True, seed=7))

    # every row on rank 0, none on the others: they all-reduce zero
    # sigmas (no launch), so rank 0 runs the single-device loop bit for bit
    if world > 1:
        whole = from_numpy(*noisy, device="cpu")
        mine = whole if rank == 0 else dataclasses.replace(
            whole, **{f: getattr(whole, f)[:, :0] for f in (
                "num_data", "cat_codes", "num_null", "cat_null")})
        ok = True
        # (the unfused loops draw their noise differently: 'gram' without)
        for fn, ref, kw in (
                (run_mice_sharded, run_mice_device,
                 dict(kernel="fused", noise=True)),
                (run_mice_sharded, run_mice_device, dict(kernel="gram")),
                (run_mice_sharded_delta, run_mice_device_delta,
                 dict(noise=True))):
            got = fn(mine, iters=2, seed=7, mesh=mesh, **kw)
            if rank == 0:
                want = ref(whole, iters=2, seed=7, **kw)
                ok = ok and torch.equal(got.num_data, want.num_data) and \
                    torch.equal(got.cat_codes, want.cat_codes)
            else:
                ok = ok and got.num_data.shape == (2, 0)
        keep("empty_ranks", ok)

    # factorized MICE with the sharded grouped aggregate (replicated tables,
    # each rank summing its share of the rows)
    dim_x, dim_c, fk, fact_x, fact_c, fnn = factorized_fixture()
    dim = from_numpy(dim_x, dim_c, device="cpu")
    fact = from_numpy(fact_x, fact_c, fnn, np.zeros((len(fk), 1), bool),
                      device="cpu")
    got = run_mice_factorized(
        fact, torch.tensor(fk), dim, iters=2, linreg_iters=200, noise=False,
        grouped_aggregate=functools.partial(
            sum_to_triple_grouped_sharded, mesh=mesh, shard_rows=True))
    keep("factorized_x", got.num_data)

    # checkpoints: killed after 2 rounds, resumed to 4, against 4 straight
    ck = ckpt_fixture()
    path = os.path.join(out_dir, "ckpt")
    for name, fn, kw in (
            ("fused", run_mice_sharded, dict(kernel="fused")),
            ("plain", run_mice_sharded, dict(kernel="plain")),
            ("delta", run_mice_sharded_delta, dict(kernel="plain"))):
        kw = dict(kw, noise=True, seed=9, mesh=mesh)
        straight = fn(table(ck), iters=4, **kw)
        p = f"{path}_{name}"
        fn(table(ck), iters=2, checkpoint_path=p, **kw)       # "killed"
        resumed = fn(table(ck), iters=4, checkpoint_path=p, **kw)
        keep(f"ckpt_{name}", torch.equal(straight.num_data, resumed.num_data)
             and torch.equal(straight.cat_codes, resumed.cat_codes))
        for why, change in (("seed", dict(seed=10)), ("iters", dict(iters=3))):
            try:
                fn(table(ck), checkpoint_path=p,
                   **dict(dict(kw, iters=4), **change))
                keep(f"ckpt_{name}_{why}_raised", "")
            except ValueError as e:
                keep(f"ckpt_{name}_{why}_raised", str(e))
        if name == "plain" and world > 1:
            # the last rank's file alone of another run: every rank raises
            last = f"{p}.rank{world - 1}of{world}"
            if rank == world - 1:
                saved, extra, arrays = load_table_arrays(last, "cpu")
                extra["fingerprint"]["seed"] = 11
                save_table(last, saved, extra, arrays)
            barrier(mesh)
            try:
                fn(table(ck), iters=4, checkpoint_path=p, **kw)
                keep("ckpt_tampered_raised", "")
            except ValueError as e:
                keep("ckpt_tampered_raised", str(e))

    # ranks called with different settings all raise, none waits
    try:
        run_mice_sharded(table(ck), iters=2 + (rank > 0), mesh=mesh)
        keep("agree_raised", "")
    except ValueError as e:
        keep("agree_raised", str(e))

    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    shutdown()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
