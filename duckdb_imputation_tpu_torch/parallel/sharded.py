"""Row-sharded cofactor aggregation: each rank's rows through the port's
kernels, one all-reduce as the combine.

Counterpart of `duckdb_imputation_tpu.parallel.sharded`
(`sum_to_triple_sharded`, `sum_to_triple_grouped_sharded`,
`build_vocab_sharded`, `factorized_join_sum_sharded`): the data-parallel
form of the reference's per-thread SumStates merged by SumStateCombine
(sum_state.cpp:10-114). Each rank aggregates ITS rows with
`ring.sum.sum_to_triple` (K1, or K7 above P = 88, on a CUDA table) or
`sum_to_triple_grouped` (K4, K5 or K8), and one all-reduce of the sigma
f32[P, P], or of the [G, P, P] stack, is the whole communication.

The JAX package pads the rows to a multiple of the mesh size with
zero-weight rows; the port's kernels take any row count, so nothing is
padded, and a rank with no rows all-reduces a zero sigma without a
launch. Inputs are each rank's own rows; `shard_rows=True` takes whole
arrays that every rank holds the same and sums the rank's `row_shard` of
them (a replicated table aggregated in parallel, as `run_mice_factorized`
calls its grouped aggregate).
"""
from __future__ import annotations

import torch

from ..ring.sum import _normalize_inputs, sum_to_triple, sum_to_triple_grouped
from ..ring.triple import Triple, sigma_from_triple, triple_from_sigma
from ..schema import FeatureSchema
from .mesh import Mesh, all_reduce, make_mesh, row_shard
from .multihost import union_vocab


def _rows(x, c, w, g, mesh: Mesh, shard_rows: bool):
    """The rank's rows of the (normalized) inputs."""
    if not shard_rows:
        return x, c, w, g
    lo, hi = row_shard(x.shape[-1], mesh.rank, mesh.world)
    return (x[:, lo:hi].contiguous(), c[:, lo:hi].contiguous(),
            None if w is None else w[lo:hi].contiguous(),
            None if g is None else g[lo:hi].contiguous())


def _combine(t: Triple, mesh: Mesh, d: int) -> Triple:
    """All-reduce a triple's sigma (one collective) and slice it back."""
    return triple_from_sigma(all_reduce(sigma_from_triple(t).contiguous(),
                                        mesh), d)


def sum_to_triple_sharded(x_num=None, codes=None, weights=None, *,
                          schema: FeatureSchema, mesh: Mesh | None = None,
                          shard_rows: bool = False) -> Triple:
    """`sum_to_triple` of every rank's rows, summed over the mesh: each
    rank aggregates its x_num f32[d, n_r], codes i32[c, n_r] and weights
    f32[n_r] (None = ones), then one all-reduce of the sigma. Every rank
    returns the same Triple."""
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    mesh = mesh or make_mesh(device=x.device)
    x, c, w, _ = _rows(x, c, w, None, mesh, shard_rows)
    if x.shape[-1] == 0:
        local = Triple.zeros(schema, device=x.device)
    else:
        local = sum_to_triple(x, c, w, schema=schema)
    return _combine(local, mesh, schema.num_cols)


def sum_to_triple_grouped_sharded(x_num, codes, group_ids, *,
                                  schema: FeatureSchema, num_groups: int,
                                  weights=None, mesh: Mesh | None = None,
                                  shard_rows: bool = False) -> Triple:
    """Sharded GROUP BY aggregation: `sum_to_triple_grouped` of each
    rank's rows (group ids outside [0, G) add nothing), then one
    all-reduce of the [G, P, P] stack. Every rank returns the same Triple
    batched on [G]; skewed groups cost no rank more than its rows."""
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    g = torch.as_tensor(group_ids, device=x.device).to(torch.int32)
    mesh = mesh or make_mesh(device=x.device)
    x, c, w, g = _rows(x, c, w, g, mesh, shard_rows)
    if x.shape[-1] == 0:
        local = Triple.zeros(schema, (num_groups,), device=x.device)
    else:
        local = sum_to_triple_grouped(x, c, g, schema=schema,
                                      num_groups=num_groups, weights=w)
    return _combine(local, mesh, schema.num_cols)


def build_vocab_sharded(cat_data, mesh: Mesh | None = None
                        ) -> tuple[tuple[int, ...], ...]:
    """Distributed vocabulary build (partition.cpp:722-747's
    build_list_of_uniq_categoricals): each rank's sorted uniques of its
    raw categorical rows cat_data [c, n_r], then `union_vocab`."""
    cat = torch.as_tensor(cat_data)
    local = tuple(tuple(torch.unique(cat[j]).tolist())
                  for j in range(cat.shape[0]))
    return union_vocab(local, mesh)


def factorized_join_sum_sharded(x1=None, codes1=None, keys1=None, x2=None,
                                codes2=None, keys2=None, *,
                                schema1: FeatureSchema,
                                schema2: FeatureSchema, num_keys: int,
                                weights1=None, weights2=None,
                                mesh: Mesh | None = None,
                                shard_rows: bool = False) -> Triple:
    """The sharded factorized join-aggregate: each side's per-key triples
    summed over the ranks' rows (`sum_to_triple_grouped_sharded`, one
    all-reduce a side), then `ring.triple.factorized_join_sum` of the two
    [G]-batched triples, computed the same on every rank: the join costs
    no communication."""
    from ..ring.triple import factorized_join_sum

    kw = dict(num_groups=num_keys, mesh=mesh, shard_rows=shard_rows)
    t1 = sum_to_triple_grouped_sharded(x1, codes1, keys1, schema=schema1,
                                       weights=weights1, **kw)
    t2 = sum_to_triple_grouped_sharded(x2, codes2, keys2, schema=schema2,
                                       weights=weights2, **kw)
    return factorized_join_sum(t1, t2)
