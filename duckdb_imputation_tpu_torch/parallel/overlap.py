"""Pipeline-overlapped aggregation: each sigma stripe's all-reduce runs
behind the next stripe's Gram.

Counterpart of `duckdb_imputation_tpu.parallel.overlap`
(`sum_to_triple_overlapped`), the PP/overlap analogue of the reference's
thread combine that SURVEY.md §2 (parallelism item 5) asks for: the
exchange of partial triples overlapped with the next cofactor compute.
For a narrow schema the sigma all-reduce is a few KB and costs nothing;
for a wide one (big vocabularies) it is P × P f32 at megabytes, and one
all-reduce after all compute leaves the link idle during the Gram and the
card idle during the exchange.

Sigma is computed in column stripes, stripe k being S[:, lo:lo + w] of
width w = ⌈P / n_stripes⌉ (the last one narrower where n_stripes does not
divide P), each by one launch of K7 over the window on the rank's rows
(`ring.kernels.sigma_pallas.masked_gram_window`; its plain version on CPU
tensors). Each stripe's all-reduce is issued asynchronously
(`mesh.all_reduce_async`) before stripe k + 1 launches: the collective
waits only for stripe k, so it runs beside the next window's kernel, as
the JAX package's per-stripe psum inside its scan lets XLA issue it. Then
the rank waits on every handle and assembles S.

Conventions of `sharded.sum_to_triple_sharded`: inputs are each rank's
own rows, or whole arrays every rank holds with `shard_rows=True`;
nothing is padded (the JAX package pads the rows to the mesh and, inside,
to its `row_chunk` tile, which has no counterpart here), and a rank with
no rows all-reduces zero stripes without a launch. The result equals the
unstriped sharded path's: count-valued sections exactly, sums up to f32
accumulation order (striping partitions sigma's columns; each column
still reduces over the same ranks).
"""
from __future__ import annotations

import torch

from ..ring.kernels.sigma_pallas import masked_gram_window
from ..ring.sum import _normalize_inputs
from ..ring.triple import Triple, triple_from_sigma
from ..schema import FeatureSchema
from .mesh import Mesh, all_reduce_async, make_mesh
from .sharded import _rows


def stripe_bounds(p: int, n_stripes: int) -> list[tuple[int, int]]:
    """[lo, hi) of each non-empty stripe of P columns cut into n_stripes
    of width ⌈P / n_stripes⌉ (the JAX package pads sigma to n_stripes·w
    columns; the stripes past P are empty here and are skipped)."""
    if n_stripes < 1:
        raise ValueError(f"n_stripes must be at least 1, got {n_stripes}")
    width = -(-p // n_stripes)
    return [(lo, min(lo + width, p)) for lo in range(0, p, width)]


def sum_to_triple_overlapped(x_num=None, codes=None, weights=None, *,
                             schema: FeatureSchema, mesh: Mesh | None = None,
                             n_stripes: int = 4,
                             shard_rows: bool = False) -> Triple:
    """Sharded `sum_to_triple` with the collective pipelined against
    compute in `n_stripes` column stripes: each rank's x_num f32[d, n_r],
    codes i32[c, n_r] and weights f32[n_r] (None = ones), one K7 window
    launch and one asynchronous all-reduce a stripe. Same result as
    `sum_to_triple_sharded`; worth it when `schema.sigma_size` is large
    enough that the sigma all-reduce is no longer free (wide
    vocabularies). Every rank returns the same Triple."""
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    mesh = mesh or make_mesh(device=x.device)
    x, c, w, _ = _rows(x, c, w, None, mesh, shard_rows)
    x_cols, code_cols = list(x.contiguous()), list(c.contiguous())
    stripes, handles = [], []
    for lo, hi in stripe_bounds(schema.sigma_size, n_stripes):
        stripe = masked_gram_window(x_cols, code_cols, w, schema=schema,
                                    lo=lo, width=hi - lo)
        stripes.append(stripe)
        handles.append(all_reduce_async(stripe, mesh))
    for h in handles:
        if h is not None:
            h.wait()
    return triple_from_sigma(torch.cat(stripes, dim=1), schema.num_cols)
