"""K6 and K6w: the grouped naive-Bayes sums, per group Σ w·[1 ‖ x ‖ x² ‖
onehot].

Counterpart of `duckdb_imputation_tpu/ring/kernels/nb_pallas.py`
(`sum_to_nb_agg_grouped_pallas`, the Pallas kernel `_nb_grouped_pallas`
with its bodies `_nb_kernel` and `_nb_kernel_fast`). `nb_grouped_sums`
launches the hand-written CUDA kernel (`csrc/nb_grouped_sums.cu`) for
CUDA tensors, K6 for F ≤ 256 features and K6w, the same kernel over
ceil(F / 256) feature ranges, above (`_build.nb_ranges`), and takes its
plain version, `nb_grouped_sums_plain`, only for CPU tensors. Both give
f32[G, F] with F = 1 + 2d + V: the 1 column is the (weighted) count, then
Σx, Σx², and the category counts. Rows whose id
lies outside [0, G) are dropped; a code outside [0, size) counts nowhere.
Counts are exact and the x sums are added in f64 across threads and
blocks, so reruns are bit-identical.
"""
from __future__ import annotations

import torch

from ...schema import FeatureSchema
from ..sum import _nb_from_sums, _nb_sums
from ..triple import NBAgg
from . import _build


def nb_grouped_sums_plain(x_num, codes, weights, group_ids, *,
                          schema: FeatureSchema, num_groups: int
                          ) -> torch.Tensor:
    """Plain torch version of `nb_grouped_sums`: the segment-sum matmul
    of `ring.sum._nb_sums`, transposed to [G, F]."""
    return _nb_sums(x_num, codes, weights, group_ids, schema=schema,
                    num_groups=num_groups).T


def nb_grouped_sums(x_num, codes, weights, group_ids, *,
                    schema: FeatureSchema, num_groups: int) -> torch.Tensor:
    """Per-group NB sums f32[G, F] of x_num f32[d, n], codes i32[c, n],
    weights f32[n] or None (all ones), group_ids i32[n].

    CUDA tensors launch the kernel, one launch per 32 groups (the groups
    a launch holds in shared memory), each counted in
    `nb_grouped_sums.launches` (K6, F ≤ 256) or
    `nb_grouped_sums.wide_launches` (K6w, F above); CPU tensors take the
    plain version."""
    tensors = [x_num, codes, group_ids] + ([] if weights is None
                                           else [weights])
    if _build.on_cpu(tensors):
        return nb_grouped_sums_plain(x_num, codes, weights, group_ids,
                                     schema=schema, num_groups=num_groups)
    n = group_ids.shape[-1]
    _build.check_nb(schema, n)
    _build.check_groups(num_groups)
    if x_num.shape[0] != schema.num_cols or codes.shape[0] != schema.cat_cols:
        raise ValueError("block heights do not match the schema")
    device = _build.check_cuda(
        tensors,
        [(x_num, torch.float32, (schema.num_cols, n), "x_num"),
         (codes, torch.int32, (schema.cat_cols, n), "codes"),
         (group_ids, torch.int32, (n,), "group_ids")]
        + ([] if weights is None
           else [(weights, torch.float32, (n,), "weights")]))
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=device)
    lib = _build.load()
    f = _build.nb_features(schema)
    wide = _build.nb_ranges(schema) > 1
    nblocks = _build.grid_blocks(n)
    batch = min(num_groups, _build.MAX_NB_GROUPS)
    partial = torch.empty(batch * f * nblocks, dtype=torch.float64,
                          device=device)
    out = torch.empty((num_groups, f), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    x_ptrs = _build.pointers(list(x_num))
    c_ptrs = _build.pointers(list(codes))
    for base in range(0, num_groups, batch):
        groups = min(batch, num_groups - base)
        with torch.cuda.device(device):
            rc = lib.lib.dit_nb_grouped_sums(
                x_ptrs, schema.num_cols, c_ptrs, _build.int_array(sizes),
                len(sizes), weights.data_ptr(), group_ids.data_ptr(), base,
                groups, n, partial.data_ptr(), nblocks, out[base].data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on_error(lib, rc, "nb_grouped_sums")
        if wide:
            nb_grouped_sums.wide_launches += 1
        else:
            nb_grouped_sums.launches += 1
    return out


nb_grouped_sums.launches = 0
nb_grouped_sums.wide_launches = 0


def sum_to_nb_agg_grouped_kernel(x_num, codes, group_ids, *,
                                 schema: FeatureSchema, num_groups: int,
                                 weights=None) -> NBAgg:
    """Grouped NB aggregate through `nb_grouped_sums`: an NBAgg batched on
    [G]. The 'kernel' route of `ring.sum.sum_to_nb_agg_grouped` and
    `sum_to_nb_agg`."""
    sums = nb_grouped_sums(x_num, codes, weights, group_ids, schema=schema,
                           num_groups=num_groups)
    return _nb_from_sums(sums.T, schema)
