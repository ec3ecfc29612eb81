"""The port's pipelined sharded aggregate,
`parallel.sum_to_triple_overlapped` (sigma in column stripes of K7's
window Gram, each stripe's all-reduce issued asynchronously before the
next stripe), at world sizes 1, 2 and 4 on gloo over the CPU, against the
JAX package's `sum_to_triple_overlapped` on the conftest's 8-device
virtual mesh and against the port's `sum_to_triple_sharded`, at
tests/test_sharded.py::test_overlapped_equals_sharded's bounds: n,
lin_cat and cat_cat exact; quad, lin and num_cat within rtol 1e-6, atol
1e-3. The counterpart of its HLO check (test_overlapped_hlo_has_per_
stripe_collectives): each rank issues one all-reduce a stripe, each before
the next stripe's window call, and waits on them after the last.

The ranks are processes of tests/torch_overlap_worker.py (torch only; a
FileStore in a temporary directory), all three world sizes started
together once for the module under one deadline after which every child
is killed. The JAX side runs here.
"""
import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.parallel import (
    make_mesh as ref_make_mesh,
    sum_to_triple_overlapped as ref_overlapped,
)
from duckdb_imputation_tpu.ring.triple import (
    sigma_from_triple as ref_sigma_from_triple,
)

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.parallel import (
    all_reduce_async,
    make_mesh,
    sum_to_triple_overlapped,
    sum_to_triple_sharded,
)
from duckdb_imputation_tpu_torch.parallel.overlap import stripe_bounds
from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
from duckdb_imputation_tpu_torch.ring.triple import (sigma_from_triple,
                                                     triple_from_sigma)

import torch_overlap_worker as worker

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
DEADLINE_S = 150
WORKER = os.path.join(os.path.dirname(__file__), "torch_overlap_worker.py")
TAGS = [f"{name}_{k}" for name, k in worker.CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's results, ...]} of the worker, every world size's
    ranks started at once; killed at the deadline."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"overlap{world}")
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


def schema_of(name):
    num, cat, _ = worker.case_inputs(name)
    d = 0 if num is None else num.shape[1]
    return FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(int(v) for v in np.unique(cat[:, j]))
        for j in range(cat.shape[1])))


def assert_overlap_bounds(got, want, d, what):
    """tests/test_sharded.py:205-228's bounds on two sigmas f32[P, P]."""
    g = triple_from_sigma(torch.tensor(np.array(got)), d)
    w = triple_from_sigma(torch.tensor(np.array(want)), d)
    for f in ("n", "lin_cat", "cat_cat"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      getattr(w, f).numpy(),
                                      err_msg=f"{what}: {f}")
    for f in ("quad", "lin", "num_cat"):
        np.testing.assert_allclose(getattr(g, f).numpy(),
                                   getattr(w, f).numpy(), rtol=1e-6,
                                   atol=1e-3, err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def reference():
    """JAX's sum_to_triple_overlapped of every case on the 8-device mesh,
    as a sigma."""
    out = {}
    for name, k in worker.CASES:
        num, cat, w = worker.case_inputs(name)
        schema = RefSchema.infer(num, cat)
        over = ref_overlapped(None if num is None else num.T,
                              schema.encode(cat).T, w, schema=schema,
                              mesh=ref_make_mesh(), n_stripes=k)
        out[f"{name}_{k}"] = np.asarray(ref_sigma_from_triple(over))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", TAGS)
def test_overlapped_matches_jax_and_sharded(ranks, reference, world, tag):
    name = tag.rsplit("_", 1)[0]
    d = schema_of(name).num_cols
    results = ranks[world]
    got = results[0][tag]
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[tag], got,
                                      err_msg=f"rank {r} differs")
        # whole arrays on every rank, each summing its row_shard
        np.testing.assert_array_equal(res[tag + "_shard_rows"], got)
    assert_overlap_bounds(got, results[0][tag + "_sharded"], d,
                          f"world {world} vs sum_to_triple_sharded")
    assert_overlap_bounds(got, reference[tag], d,
                          f"world {world} vs the JAX package")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", TAGS)
def test_one_async_all_reduce_a_stripe(ranks, world, tag):
    """Each rank: window k, then stripe k's all-reduce issued, before
    window k + 1; one all-reduce a non-empty stripe; the waits after the
    last issue."""
    name, k = tag.rsplit("_", 1)
    los = [lo for lo, _ in stripe_bounds(schema_of(name).sigma_size,
                                         int(k))]
    want = ([e for lo in los for e in (("window", lo), ("issue", lo))]
            + [("wait", lo) for lo in los])
    for res in ranks[world]:
        assert ast.literal_eval(str(res[tag + "_events"])) == want


@pytest.mark.parametrize("p,k,want", [
    (17, 5, [(0, 4), (4, 8), (8, 12), (12, 16), (16, 17)]),
    (17, 4, [(0, 5), (5, 10), (10, 15), (15, 17)]),
    (63, 4, [(0, 16), (16, 32), (32, 48), (48, 63)]),
    (17, 1, [(0, 17)]),
    (5, 8, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]),
])
def test_stripe_bounds(p, k, want):
    assert stripe_bounds(p, k) == want


def test_stripe_bounds_refuse_no_stripes():
    with pytest.raises(ValueError, match="n_stripes"):
        stripe_bounds(17, 0)


def test_mesh_of_one_without_a_group():
    """No process group: no collective (all_reduce_async returns None),
    and the overlapped sigma is the single-process aggregate's."""
    mesh = make_mesh(device="cpu")
    assert all_reduce_async(torch.ones(3), mesh) is None
    num, cat, w = worker.case_inputs("wide")
    schema = schema_of("wide")
    x = torch.tensor(num.T.copy())
    c = torch.tensor(schema.encode(cat).T.copy())
    wt = torch.tensor(w)
    got = sum_to_triple_overlapped(x, c, wt, schema=schema, mesh=mesh,
                                   n_stripes=5)
    assert_overlap_bounds(sigma_from_triple(got).numpy(),
                          sigma_from_triple(sum_to_triple(
                              x, c, wt, schema=schema)).numpy(),
                          schema.num_cols, "mesh of one")
    again = sum_to_triple_overlapped(x, c, wt, schema=schema, n_stripes=5)
    assert torch.equal(sigma_from_triple(got), sigma_from_triple(again))
    whole = sum_to_triple_sharded(x, c, wt, schema=schema, mesh=mesh)
    assert_overlap_bounds(sigma_from_triple(got).numpy(),
                          sigma_from_triple(whole).numpy(),
                          schema.num_cols, "vs sharded, mesh of one")
