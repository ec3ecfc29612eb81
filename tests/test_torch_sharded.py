"""The port's row-sharded path over `torch.distributed` (gloo on the CPU):
`parallel` (the mesh, `union_vocab`, `local_shard`, the sharded
aggregates), `init_fill` over a mesh, and `run_mice_sharded` /
`run_mice_sharded_delta` with their checkpoints, at world sizes 1, 2 and
4, held against the port's single-process functions and against the JAX
package's `parallel` and `mice.sharded_round` on the conftest's 8-device
virtual mesh, at tests/test_sharded.py's sizes and bounds.

The ranks are processes of tests/torch_sharded_worker.py (torch only; a
FileStore in a temporary directory), all three world sizes started
together once for the module, under one deadline after which every child
is killed. The JAX side runs here.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice.sharded_round import (
    run_mice_sharded as ref_run_mice_sharded,
    run_mice_sharded_delta as ref_run_mice_sharded_delta,
)
from duckdb_imputation_tpu.parallel import (
    factorized_join_sum_sharded as ref_join_sharded,
    make_mesh as ref_make_mesh,
    sum_to_triple_grouped_sharded as ref_grouped_sharded,
    sum_to_triple_sharded as ref_sum_sharded,
)
from duckdb_imputation_tpu.ring.triple import (
    sigma_from_triple as ref_sigma_from_triple,
)
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import (FeatureSchema, from_numpy,
                                         run_mice_factorized)
from duckdb_imputation_tpu_torch.mice.partition import init_fill
from duckdb_imputation_tpu_torch.parallel import (
    factorized_join_sum_sharded,
    local_shard,
    make_mesh,
    row_shard,
    sum_to_triple_grouped_sharded,
    sum_to_triple_sharded,
    union_vocab,
)
from duckdb_imputation_tpu_torch.ring.sum import (sum_to_triple,
                                                  sum_to_triple_grouped)
from duckdb_imputation_tpu_torch.ring.triple import (factorized_join_sum,
                                                     sigma_from_triple)
from duckdb_imputation_tpu_torch.utils.checkpoint import table_checksum

import torch_sharded_worker as worker

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
DEADLINE_S = 150
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of the worker, every
    world size's ranks started at once; killed at the deadline."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        procs[world] = (d, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    end = time.monotonic() + DEADLINE_S
    logs = {}
    try:
        for world, (_, ps) in procs.items():
            for r, p in enumerate(ps):
                logs[world, r] = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))[0]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = {}
    for world, (d, ps) in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, (
                f"world {world} rank {r} failed:\n{logs[world, r]}")
        out[world] = [dict(np.load(d / f"out{r}.npz"))
                      for r in range(world)]
    return out


def rows(ranks_out, name):
    """The ranks' rows of a table result, concatenated in rank order."""
    return np.concatenate([o[name] for o in ranks_out], axis=-1)


# ---------------------------------------------------------------------------
# The mesh helpers, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,world", [(10, 4), (20_003, 2), (3, 4), (0, 2)])
def test_row_shard_covers_the_rows_in_order(n, world):
    bounds = [row_shard(n, r, world) for r in range(world)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_mesh_of_one_runs_no_collective():
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    assert union_vocab(((3, 1, 3), ()), mesh) == ((1, 3), ())
    t = from_numpy(*worker.mice_fixture(n=101), device="cpu")
    a, b = init_fill(t), init_fill(t, mesh)
    assert torch.equal(a.num_data, b.num_data)
    assert torch.equal(a.cat_codes, b.cat_codes)
    assert torch.equal(local_shard(t.num_data, mesh), t.num_data)


def test_checksum_of_shards_is_the_tables():
    """table_checksum keys each cell by its global row, so the shards'
    checksums (offset by their first rows) sum to the whole table's, and
    any observed value or null flag changes it."""
    t = from_numpy(*worker.mice_fixture(n=1001), device="cpu")
    whole = table_checksum(t)
    parts = 0
    for r in range(3):
        lo, _ = row_shard(t.n_rows, r, 3)
        parts += table_checksum(local_shard(t, rank=r, world=3), lo)
    assert parts % 2_147_483_629 == whole
    x = t.num_data.clone()
    x[0, 5] += 1.0
    nn = t.num_null.clone()
    nn[2, 7] = True
    assert table_checksum(dataclasses.replace(t, num_data=x)) != whole
    assert table_checksum(dataclasses.replace(t, num_null=nn)) != whole


# ---------------------------------------------------------------------------
# The sharded aggregates against one process and the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sums():
    """The port's single-process sigmas and the JAX package's sharded ones
    (8-device mesh) of the worker's aggregate fixture."""
    num, cat, g, w, k1, num2, cat2, k2 = worker.sums_fixture()
    schema, s2 = FeatureSchema.infer(num, cat), FeatureSchema.infer(num2, cat2)
    x, c = torch.tensor(num.T), torch.tensor(schema.encode(cat).T)
    x2, c2 = torch.tensor(num2.T), torch.tensor(s2.encode(cat2).T)
    port = {
        "sum": sigma_from_triple(sum_to_triple(x, c, torch.tensor(w),
                                               schema=schema)),
        "grouped": sigma_from_triple(sum_to_triple_grouped(
            x, c, torch.tensor(g), schema=schema, num_groups=5)),
        "join": sigma_from_triple(factorized_join_sum(
            sum_to_triple_grouped(x, c, torch.tensor(k1), schema=schema,
                                  num_groups=16),
            sum_to_triple_grouped(x2, c2, torch.tensor(k2), schema=s2,
                                  num_groups=16))),
    }
    rs, rs2 = RefSchema.infer(num, cat), RefSchema.infer(num2, cat2)
    mesh = ref_make_mesh()
    rc, rc2 = rs.encode(cat).T, rs2.encode(cat2).T
    ref = {
        "sum": ref_sigma_from_triple(ref_sum_sharded(
            num.T, rc, w, schema=rs, mesh=mesh)),
        "grouped": ref_sigma_from_triple(ref_grouped_sharded(
            num.T, rc, g, schema=rs, num_groups=5, mesh=mesh)),
        "join": ref_sigma_from_triple(ref_join_sharded(
            num.T, rc, k1, num2.T, rc2, k2, schema1=rs, schema2=rs2,
            num_keys=16, mesh=mesh)),
    }
    return ({k: v.numpy() for k, v in port.items()},
            {k: np.asarray(v) for k, v in ref.items()},
            {"sum": schema, "grouped": schema, "join": schema.concat(s2)})


def assert_sigma_close(got, want, schema):
    """Counts exact (N, the one-hot counts and cross counts), the rest
    within 1e-5 of max|σ| (per group)."""
    d = schema.num_cols
    counts = np.zeros(got.shape[-2:], bool)
    counts[0, 0] = True
    counts[0, 1 + d:] = counts[1 + d:, 0] = True
    counts[1 + d:, 1 + d:] = True
    np.testing.assert_array_equal(got[..., counts], want[..., counts])
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("what", ["sum", "grouped", "join"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_aggregates_match_one_process_and_jax(ranks, sums, world,
                                                      what):
    port, ref, schemas = sums
    for o in ranks[world]:          # every rank holds the same result
        np.testing.assert_array_equal(o[what], ranks[world][0][what])
    got = ranks[world][0][what]
    assert_sigma_close(got, port[what], schemas[what])
    assert_sigma_close(got, ref[what], schemas[what])
    if what == "join":
        assert_sigma_close(ranks[world][0]["join_replicated"], port[what],
                           schemas[what])


def test_sharded_aggregates_without_a_group():
    """A mesh of one: the sharded aggregates are the single-process ones,
    bit for bit, and a rank with no rows sums zeros without a kernel."""
    num, cat, g, w, k1, num2, cat2, k2 = worker.sums_fixture()
    schema = FeatureSchema.infer(num, cat)
    x, c = torch.tensor(num.T), torch.tensor(schema.encode(cat).T)
    mesh = make_mesh(device="cpu")
    assert torch.equal(
        sigma_from_triple(sum_to_triple_sharded(x, c, torch.tensor(w),
                                                schema=schema, mesh=mesh)),
        sigma_from_triple(sum_to_triple(x, c, torch.tensor(w),
                                        schema=schema)))
    assert torch.equal(
        sigma_from_triple(sum_to_triple_grouped_sharded(
            x, c, torch.tensor(g), schema=schema, num_groups=5, mesh=mesh)),
        sigma_from_triple(sum_to_triple_grouped(
            x, c, torch.tensor(g), schema=schema, num_groups=5)))
    empty = sum_to_triple_grouped_sharded(
        x[:, :0], c[:, :0], torch.zeros(0, dtype=torch.int32),
        schema=schema, num_groups=3, mesh=mesh)
    assert not sigma_from_triple(empty).any()
    assert sigma_from_triple(empty).shape == (3, schema.sigma_size,
                                              schema.sigma_size)
    joined = factorized_join_sum_sharded(
        x, c, torch.tensor(k1), torch.tensor(num2.T),
        torch.tensor(FeatureSchema.infer(num2, cat2).encode(cat2).T),
        torch.tensor(k2), schema1=schema,
        schema2=FeatureSchema.infer(num2, cat2), num_keys=16, mesh=mesh)
    assert torch.isfinite(sigma_from_triple(joined)).all()


@pytest.mark.parametrize("world", WORLDS)
def test_union_vocab_of_unequal_lengths(ranks, world):
    want = {1: worker.KEYS_A, 2: ((1, 2, 3, 9), (10, 20, 30)),
            4: ((1, 2, 3, 9), (10, 20, 30, 40))}[world]
    for o in ranks[world]:
        assert str(o["vocab"]) == repr(want)


@pytest.mark.parametrize("world", WORLDS)
def test_build_vocab_sharded_is_the_whole_vocab(ranks, world):
    _, cat, *_ = worker.sums_fixture()
    want = tuple(tuple(int(v) for v in np.unique(cat[:, j]))
                 for j in range(cat.shape[1]))
    for o in ranks[world]:
        assert str(o["vocab_built"]) == repr(want)


# ---------------------------------------------------------------------------
# run_mice_sharded / run_mice_sharded_delta against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mice():
    """JAX's run_mice_sharded and run_mice_sharded_delta on the 8-device
    mesh (rows padded to it), tests/test_sharded.py's calls."""
    mesh = ref_make_mesh()
    full = ref_run_mice_sharded(ref_from_numpy(*worker.mice_fixture()),
                                iters=2, gd_iters=300, noise=False,
                                mesh=mesh)
    delta = ref_run_mice_sharded_delta(
        ref_from_numpy(*worker.mice_fixture(null_frac=0.05,
                                            dirty_row0=True)),
        iters=2, noise=False, mesh=mesh)
    return {"mice": (np.asarray(full.num_data), np.asarray(full.cat_codes)),
            "delta": (np.asarray(delta.num_data),
                      np.asarray(delta.cat_codes))}


def assert_mice_like_jax(xs, cs, ref, fixture):
    """tests/test_sharded.py's bounds: imputed x within atol 1e-2, codes
    equal on ≥ 0.999 of the null cells, RMSE of x1 below 0.05 against the
    noiseless truth, observed cells unchanged."""
    num, cat, nn, cn = fixture
    xd, cd = ref
    np.testing.assert_allclose(xs[1, nn[:, 1]], xd[1, nn[:, 1]], atol=1e-2)
    assert (cs[0, cn[:, 0]] == cd[0, cn[:, 0]]).mean() >= 0.999
    rmse = float(np.sqrt(np.mean((xs[1, nn[:, 1]] - num[nn[:, 1], 1]) ** 2)))
    assert rmse < 0.05, rmse
    np.testing.assert_array_equal(xs[~nn.T], num.T[~nn.T])


@pytest.mark.parametrize("kernel", ["plain", "gram", "fused", "auto"])
@pytest.mark.parametrize("world", WORLDS)
def test_run_mice_sharded_matches_jax(ranks, jax_mice, world, kernel):
    out = ranks[world]
    assert_mice_like_jax(rows(out, f"mice_{kernel}_x"),
                         rows(out, f"mice_{kernel}_c"), jax_mice["mice"],
                         worker.mice_fixture())


@pytest.mark.parametrize("kernel", ["plain", "gram"])
@pytest.mark.parametrize("world", WORLDS)
def test_run_mice_sharded_delta_matches_jax(ranks, jax_mice, world, kernel):
    out = ranks[world]
    assert_mice_like_jax(rows(out, f"delta_{kernel}_x"),
                         rows(out, f"delta_{kernel}_c"), jax_mice["delta"],
                         worker.mice_fixture(null_frac=0.05,
                                             dirty_row0=True))


@pytest.mark.parametrize("case", ["plain", "gram", "fused", "fused_noise",
                                  "delta_plain", "delta_gram",
                                  "delta_noise"])
def test_world_of_one_is_the_single_device_loop(ranks, case):
    """At world size 1 (gloo), run_mice_sharded / _delta are bit-identical
    to run_mice_device / _delta with the same kernel (noise on: the fused
    and delta loops, whose Philox draws are keyed by global rows)."""
    assert bool(ranks[1][0][f"same_{case}"])


@pytest.mark.parametrize("world", WORLDS[1:])
def test_ranks_without_rows(ranks, world):
    """All rows on rank 0, none on the others (who all-reduce zero sigmas
    without a launch): rank 0's fused and delta runs with noise and its
    gram run are run_mice_device's / _delta's bit for bit, and the others
    return empty shards."""
    for o in ranks[world]:
        assert bool(o["empty_ranks"])


@pytest.mark.parametrize("loop", ["plain", "fused", "delta"])
def test_noise_does_not_depend_on_the_world_size(ranks, loop):
    """Noisy runs at world sizes 1, 2 and 4: test_sharded.py's
    mesh-invariance bounds (rtol 1e-4, atol 5e-4, codes equal); the
    noise is real (differs from the noiseless run)."""
    name = f"noise_{loop}"
    x = {w: rows(ranks[w], name + "_x") for w in WORLDS}
    c = {w: rows(ranks[w], name + "_c") for w in WORLDS}
    for w in (1, 2):
        np.testing.assert_allclose(x[w], x[4], rtol=1e-4, atol=5e-4)
        np.testing.assert_array_equal(c[w], c[4])
    nn = worker.noise_fixture()[2]
    off = rows(ranks[4], name + "_off_x")
    assert not np.allclose(off[0, nn[:, 0]], x[4][0, nn[:, 0]])


@pytest.mark.parametrize("world", WORLDS)
def test_factorized_mice_with_the_sharded_aggregate(ranks, world):
    """run_mice_factorized with grouped_aggregate=
    sum_to_triple_grouped_sharded (replicated tables, each rank summing
    its share of the rows) matches the plain run to 1e-3, on every rank."""
    dim_x, dim_c, fk, fact_x, fact_c, fnn = worker.factorized_fixture()
    plain = run_mice_factorized(
        from_numpy(fact_x, fact_c, fnn, np.zeros((len(fk), 1), bool),
                   device="cpu"),
        torch.tensor(fk), from_numpy(dim_x, dim_c, device="cpu"), iters=2,
        linreg_iters=200, noise=False)
    for o in ranks[world]:
        np.testing.assert_allclose(o["factorized_x"], plain.num_data.numpy(),
                                   rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Checkpoints of the sharded loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop", ["fused", "plain", "delta"])
@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_kill_and_resume_is_bit_identical(ranks, world, loop):
    """Killed after 2 of 4 rounds (noise on) and resumed: every rank's
    rows equal the uninterrupted run's bit for bit."""
    for o in ranks[world]:
        assert bool(o[f"ckpt_{loop}"])


@pytest.mark.parametrize("loop", ["fused", "plain", "delta"])
@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_of_another_run_raises_on_every_rank(ranks, world, loop):
    """A resume with another seed, or with fewer rounds than the file
    completed, raises ValueError on every rank (none waits on the
    others), naming the field. When only the last rank's file is of
    another run, that rank names the field and the others name it."""
    for r, o in enumerate(ranks[world]):
        seed = str(o[f"ckpt_{loop}_seed_raised"])
        assert "field 'seed' is 9 in the file and 10 in this run" in seed
        assert f"rank{r}of{world}" in seed
        rounds = str(o[f"ckpt_{loop}_iters_raised"])
        assert "completed 4 rounds, more than the 3 asked for" in rounds
        if loop == "plain" and world > 1:
            tampered = str(o["ckpt_tampered_raised"])
            if r == world - 1:
                assert "field 'seed' is 11 in the file" in tampered
            else:
                assert (f"the checkpoint of rank {world - 1} under"
                        in tampered)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_ranks_called_with_other_settings_all_raise(ranks, world):
    """Rank 0 asked for 2 rounds, the others for 3: every rank raises
    before the first collective of a round instead of hanging."""
    for o in ranks[world]:
        assert "called with different settings" in str(o["agree_raised"])
