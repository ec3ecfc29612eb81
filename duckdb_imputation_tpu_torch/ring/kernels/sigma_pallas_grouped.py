"""K4, K5 and K8: the grouped masked Gram (GROUP BY), one sigma per group.

Counterpart of `duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py`:

- `grouped_gram` (K4, `csrc/grouped_gram.cu`) takes rows in any order with
  the group id riding along as data: one pass, no grouping prep, up to
  `unsorted_group_limit(schema)` groups. It stands for the Pallas kernels
  behind `sum_to_triple_grouped_unsorted`.
- `sort_by_group` sorts the rows by group once (a stable torch sort, plus
  the segment offsets); `grouped_gram_presorted` (K5, same source) then
  aggregates the sorted rows, any number of groups, as often as needed
  (the sort-once, aggregate-many pattern of per-class models). It stands
  for the sorted-slab Pallas kernels behind `sum_to_triple_grouped_pallas`
  and `sum_to_triple_grouped_presorted`. The TPU's pad-then-payload sort
  (`_device_group_sort`) and its block padding exist to avoid TPU gathers
  and are not ported: nothing is padded here.
- `sum_to_triple_grouped_kernel` takes K4 up to the limit and a sort plus
  K5 above it, the dispatch of `sum_to_triple_grouped(method='pallas')`.
- Above P = 88 `grouped_gram_presorted` runs K8
  (`csrc/grouped_wide_gram.cu`, K7's plan over S's nonzeros and K7's
  kernel, over group-sorted rows, up to `_build.MAX_WIDE_SIGMA_SIZE`, any
  number of groups), its launches counted on `.wide_launches`;
  `grouped_gram` there sorts the rows and hands them to it.
  `grouped_wide_tables_plain` is the plain version of its tables, one
  set per group (`sigma_pallas.wide_assemble` makes them sigmas).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors. Rows whose id lies outside [0, G) are
dropped; a code outside [0, size) contributes nothing. Counts are exact
and reruns bit-identical, as in K1.
"""
from __future__ import annotations

import dataclasses

import torch

from ...schema import FeatureSchema
from ..sum import grouped_sigma, masked_sigma
from ..triple import Triple, triple_from_sigma
from . import _build
from .sigma_pallas import wide_plan_args, wide_tables_plain


def unsorted_group_limit(schema: FeatureSchema) -> int | None:
    """Most groups the unsorted entry `grouped_gram` takes. Up to P = 88 it
    runs K4, where each thread keeps one 4×4 f32 register tile per group,
    and 8 tiles (128 of a thread's 255 registers) is the budget. Above, None:
    it sorts the rows and runs K8, which takes any number of groups."""
    if schema.sigma_size <= _build.MAX_SIGMA_SIZE:
        return _build.MAX_UNSORTED_GROUPS
    return None


def _kernel_inputs(x_num, codes, weights, schema, n, extra):
    """Checks shared by K4, K5 and K8; returns (device, weights)."""
    _build.check_schema(schema, n, _build.MAX_WIDE_SIGMA_SIZE)
    if x_num.shape[0] != schema.num_cols or codes.shape[0] != schema.cat_cols:
        raise ValueError("block heights do not match the schema")
    device = _build.check_cuda(
        [x_num, codes] + ([] if weights is None else [weights])
        + [t for t, *_ in extra],
        [(x_num, torch.float32, (schema.num_cols, n), "x_num"),
         (codes, torch.int32, (schema.cat_cols, n), "codes")]
        + ([] if weights is None
           else [(weights, torch.float32, (n,), "weights")])
        + list(extra))
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=device)
    return device, weights


def grouped_gram_plain(x_num, codes, weights, group_ids, *,
                       schema: FeatureSchema, num_groups: int
                       ) -> torch.Tensor:
    """Plain torch version of `grouped_gram`: `ring.sum.grouped_sigma`."""
    return grouped_sigma(x_num, codes, weights, group_ids, schema=schema,
                         num_groups=num_groups)


def grouped_gram(x_num, codes, weights, group_ids, *, schema: FeatureSchema,
                 num_groups: int) -> torch.Tensor:
    """Per-group masked sigma f32[G, P, P] of rows in any order (K4; above
    P = 88 `sort_by_group` and `grouped_gram_presorted`, K8). x_num f32[d,
    n], codes i32[c, n], weights f32[n] or None (all ones), group_ids
    i32[n]; G ≥ 1 and at most unsorted_group_limit(schema), else ValueError.

    CUDA tensors launch the kernel (one K4 launch counted in
    `grouped_gram.launches`; K8's on `grouped_gram_presorted`); CPU tensors
    take the plain version."""
    tensors = [x_num, codes, group_ids] + ([] if weights is None
                                           else [weights])
    if _build.on_cpu(tensors):
        return grouped_gram_plain(x_num, codes, weights, group_ids,
                                  schema=schema, num_groups=num_groups)
    n = group_ids.shape[-1]
    _build.check_groups(num_groups, unsorted_group_limit(schema))
    device, weights = _kernel_inputs(
        x_num, codes, weights, schema, n,
        [(group_ids, torch.int32, (n,), "group_ids")])
    p = schema.sigma_size
    if p > _build.MAX_SIGMA_SIZE:
        return grouped_gram_presorted(
            *sort_by_group(x_num, codes, group_ids, schema=schema,
                           num_groups=num_groups, weights=weights),
            schema=schema)
    lib = _build.load()
    nblocks = _build.grid_blocks(n)
    partial = torch.empty(num_groups * lib.lib.dit_gram_entries(p) * nblocks,
                          dtype=torch.float64, device=device)
    out = torch.empty((num_groups, p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_grouped_gram(
            _build.pointers(list(x_num)), schema.num_cols,
            _build.pointers(list(codes)), _build.int_array(sizes),
            len(sizes), weights.data_ptr(), group_ids.data_ptr(),
            num_groups, n, p, partial.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "grouped_gram")
    grouped_gram.launches += 1
    return out


grouped_gram.launches = 0


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Rows sorted by group: group g owns sorted rows offsets[g] ..
    offsets[g + 1]; rows past offsets[G] had ids outside [0, G)."""
    offsets: torch.Tensor  # i64[G + 1], on the rows' device
    num_groups: int


def sort_by_group(x_num, codes, group_ids, *, schema: FeatureSchema,
                  num_groups: int, weights=None):
    """One-time grouping prep for repeated grouped aggregation: a stable
    sort of the rows by group id. Returns (x_sorted f32[d, n], codes_sorted
    i32[c, n], weights_sorted f32[n], GroupLayout), each block contiguous.
    Rows with ids outside [0, G) sort after the last group and are never
    aggregated."""
    n = group_ids.shape[-1]
    if x_num.shape[0] != schema.num_cols or codes.shape[0] != schema.cat_cols:
        raise ValueError("block heights do not match the schema")
    g = group_ids.to(torch.int64)
    key = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num_groups + 1)[:num_groups]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    w = (torch.ones(n, dtype=torch.float32, device=group_ids.device)
         if weights is None else weights.to(torch.float32))
    return (x_num[:, order].contiguous(), codes[:, order].contiguous(),
            w[order].contiguous(), GroupLayout(offsets, num_groups))


def grouped_gram_presorted_plain(x_sorted, codes_sorted, w_sorted,
                                 layout: GroupLayout, *,
                                 schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `grouped_gram_presorted`: one masked sigma
    per segment (reads the offsets on the host)."""
    p = schema.sigma_size
    off = layout.offsets.tolist()
    out = torch.zeros((layout.num_groups, p, p), dtype=torch.float32,
                      device=w_sorted.device)
    for g in range(layout.num_groups):
        lo, hi = off[g], off[g + 1]
        if hi > lo:
            out[g] = masked_sigma(x_sorted[:, lo:hi], codes_sorted[:, lo:hi],
                                  w_sorted[lo:hi], schema=schema)
    return out


def grouped_wide_tables_plain(x_sorted, codes_sorted, w_sorted,
                              layout: GroupLayout, *,
                              schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of K8's tables: `wide_tables_plain` over each
    group's rows, f64[G, cells] (reads the offsets on the host)."""
    off = layout.offsets.tolist()
    return torch.stack([
        wide_tables_plain(list(x_sorted[:, lo:hi]),
                          list(codes_sorted[:, lo:hi]), w_sorted[lo:hi],
                          schema=schema)
        for lo, hi in zip(off[:-1], off[1:])])


def grouped_gram_presorted(x_sorted, codes_sorted, w_sorted,
                           layout: GroupLayout, *,
                           schema: FeatureSchema) -> torch.Tensor:
    """Per-group masked sigma f32[G, P, P] of rows laid out by
    `sort_by_group` (K5, or K8 above P = 88), any number of groups. The
    weights may differ from the sort's (a per-round mask in sorted row
    order).

    CUDA tensors launch the kernel (one launch counted in
    `grouped_gram_presorted.launches`, or for K8 in
    `grouped_gram_presorted.wide_launches`); CPU tensors take the plain
    version."""
    off = layout.offsets
    tensors = [x_sorted, codes_sorted, w_sorted, off]
    if _build.on_cpu(tensors):
        return grouped_gram_presorted_plain(x_sorted, codes_sorted, w_sorted,
                                            layout, schema=schema)
    n = w_sorted.shape[-1]
    num_groups = layout.num_groups
    _build.check_groups(num_groups)
    device, _ = _kernel_inputs(
        x_sorted, codes_sorted, w_sorted, schema, n,
        [(off, torch.int64, (num_groups + 1,), "layout.offsets")])
    p = schema.sigma_size
    lib = _build.load()
    sizes = schema.cat_sizes
    if p > _build.MAX_SIGMA_SIZE:
        # K8: K7's plan and slices over group-aligned chunks
        plan, partial = wide_plan_args(schema, n, device, groups=num_groups)
        cum = _build.group_chunks(off, _build.WIDE_CHUNK)
        out = torch.zeros((num_groups, p, p), dtype=torch.float32,
                          device=device)
        with torch.cuda.device(device):
            rc = lib.lib.dit_grouped_wide_gram(
                _build.pointers(list(x_sorted)), schema.num_cols,
                _build.pointers(list(codes_sorted)), _build.int_array(sizes),
                len(sizes), w_sorted.data_ptr(), off.data_ptr(),
                cum.data_ptr(), num_groups, n, p, *plan,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on_error(lib, rc, "grouped_gram_presorted")
        grouped_gram_presorted.wide_launches += 1
        return out
    cum = _build.group_chunks(off, _build.CHUNK_ROWS)
    nblocks = _build.grid_blocks(n)
    partial = torch.empty(lib.lib.dit_gram_entries(p) * (nblocks + num_groups),
                          dtype=torch.float64, device=device)
    out = torch.empty((num_groups, p, p), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.lib.dit_presorted_gram(
            _build.pointers(list(x_sorted)), schema.num_cols,
            _build.pointers(list(codes_sorted)), _build.int_array(sizes),
            len(sizes), w_sorted.data_ptr(), off.data_ptr(), cum.data_ptr(),
            num_groups, n, p, partial.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "grouped_gram_presorted")
    grouped_gram_presorted.launches += 1
    return out


grouped_gram_presorted.launches = 0
grouped_gram_presorted.wide_launches = 0


def sum_to_triple_grouped_unsorted(x_num, codes, group_ids, *,
                                   schema: FeatureSchema, num_groups: int,
                                   weights=None) -> Triple:
    """GROUP BY aggregation in one pass with no grouping prep (K4)."""
    return triple_from_sigma(
        grouped_gram(x_num, codes, weights, group_ids, schema=schema,
                     num_groups=num_groups), schema.num_cols)


def sum_to_triple_grouped_presorted(x_sorted, codes_sorted, w_sorted,
                                    layout: GroupLayout, *,
                                    schema: FeatureSchema) -> Triple:
    """Grouped aggregation over rows laid out by `sort_by_group` (K5)."""
    return triple_from_sigma(
        grouped_gram_presorted(x_sorted, codes_sorted, w_sorted, layout,
                               schema=schema), schema.num_cols)


def sum_to_triple_grouped_kernel(x_num, codes, group_ids, *,
                                 schema: FeatureSchema, num_groups: int,
                                 weights=None) -> Triple:
    """GROUP BY aggregation through the grouped kernels: K4 up to
    `unsorted_group_limit(schema)` groups, `sort_by_group` and K5 above;
    above P = 88 `sort_by_group` and K8 for any number of groups."""
    limit = unsorted_group_limit(schema)
    if limit is None or num_groups <= limit:
        return sum_to_triple_grouped_unsorted(
            x_num, codes, group_ids, schema=schema, num_groups=num_groups,
            weights=weights)
    x_s, c_s, w_s, layout = sort_by_group(
        x_num, codes, group_ids, schema=schema, num_groups=num_groups,
        weights=weights)
    return sum_to_triple_grouped_presorted(x_s, c_s, w_s, layout,
                                           schema=schema)
