"""K4, K5 and K8: the grouped masked Gram (GROUP BY), one sigma per group.

Counterpart of `duckdb_imputation_tpu/ring/kernels/sigma_pallas_grouped.py`:

- `sort_by_group` sorts the rows by group once (a stable torch sort, plus
  the segment offsets); `grouped_gram_presorted` (K5,
  `csrc/grouped_gram.cu`) then aggregates the sorted rows, any number of
  groups, as often as needed (the sort-once, aggregate-many pattern of
  per-class models). It stands for the sorted-slab Pallas kernels behind
  `sum_to_triple_grouped_pallas` and `sum_to_triple_grouped_presorted`.
  Where `_build.tc_fits` holds it runs on K1's tensor-core body over
  group-aligned steps of 128 rows (`presorted_gram_split_plain` is its
  arithmetic in plain torch), else on K1's CUDA-core scheme. The TPU's
  pad-then-payload sort (`_device_group_sort`) and its block padding
  exist to avoid TPU gathers and are not ported.
- `grouped_gram` (K4, same source) takes rows in any order with the group
  id riding along as data, up to `unsorted_group_limit(schema)` groups: a
  stable group order of the ids made by the kernel itself
  (`group_order_plain` its arithmetic), then K5's kernels over the rows
  through it. It stands for the Pallas kernels behind
  `sum_to_triple_grouped_unsorted`.
- `sum_to_triple_grouped_kernel` takes K4 up to the limit and a sort plus
  K5 above it, the dispatch of `sum_to_triple_grouped(method='pallas')`.
- Above P = 88 `grouped_gram_presorted` runs K8
  (`csrc/grouped_wide_gram.cu`, K7's plan over S's nonzeros and K7's
  kernel, over group-sorted rows, any number of groups), its launches
  counted on `.wide_launches`: one up to `_build.MAX_WIDE_SIGMA_SIZE`,
  past it one a column window of `_build.WINDOW_WIDTH` over the window's
  plans (`_build.keyed_window_plan`: the residual over the group-sorted
  rows, the keyed tasks over the rows ordered once a call by (group,
  code) of each keyed column, `window_order`), each writing its columns
  of every group's S, up to K7's window limit; `grouped_gram` there sorts
  the rows and hands them to it. Past the crossover in d
  (`_build.dense_route`) D is the D kernel's (`sigma_pallas.launch_dense`
  over the group offsets, once a call), and K8 launches only where its
  plans have a task.
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
from .sigma_pallas import (fold_parts, launch_dense, launch_keyed,
                           masked_gram_window_plain, split_operands,
                           wide_plan_args, wide_tables_plain, window_columns,
                           window_order, window_plans)


def unsorted_group_limit(schema: FeatureSchema) -> int | None:
    """Most groups the unsorted entry `grouped_gram` takes. Up to P = 88 it
    runs K4, at most 8 groups: its group order takes one warp ballot per
    group per chunk, and the shared arrays of `group_count_kernel` and
    `group_scatter_kernel` (csrc/grouped_gram.cu) are sized for 8 groups;
    past that a sort and K5 cost less. Above P = 88, None: it sorts the
    rows and runs K8, which takes any number of groups."""
    if schema.sigma_size <= _build.MAX_SIGMA_SIZE:
        return _build.MAX_UNSORTED_GROUPS
    return None


def grouped_route(schema: FeatureSchema) -> str:
    """The body K4 and K5 run for `schema`: 'tensor_cores' where
    `_build.tc_fits` holds (K1's tensor-core body), 'cuda_cores' for any
    other P ≤ 88, 'wide' (a sort and K8) above."""
    if schema.sigma_size > _build.MAX_SIGMA_SIZE:
        return "wide"
    if _build.tc_fits(schema.num_cols, schema.sigma_size):
        return "tensor_cores"
    return "cuda_cores"


def _kernel_inputs(x_num, codes, weights, schema, n, extra):
    """Checks shared by K4, K5 and K8; returns (device, weights)."""
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
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
    d = schema.num_cols
    nblocks, _ = _build.presorted_grid(d, p, n)
    partial = torch.empty(_entries(lib, d, p) * (nblocks + num_groups),
                          dtype=torch.float64, device=device)
    counts = torch.empty(num_groups * _build.ORDER_BLOCKS, dtype=torch.int64,
                         device=device)
    off_cum = torch.empty(2 * (num_groups + 1), dtype=torch.int64,
                          device=device)
    idx = torch.empty(n, dtype=torch.int32, device=device)
    out = torch.empty((num_groups, p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_grouped_gram(
            _build.pointers(list(x_num)), d, _build.pointers(list(codes)),
            _build.int_array(sizes), len(sizes), weights.data_ptr(),
            group_ids.data_ptr(), num_groups, n, p, counts.data_ptr(),
            off_cum.data_ptr(), idx.data_ptr(), partial.data_ptr(), nblocks,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "grouped_gram")
    grouped_gram.launches += 1
    return out


grouped_gram.launches = 0


def _entries(lib, d: int, p: int) -> int:
    """f64 entries of one (block, group) slot of K4's and K5's partial."""
    return _build.TC_A ** 2 if _build.tc_fits(d, p) else \
        lib.lib.dit_gram_entries(p)


def group_order_plain(group_ids, num_groups: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K4's group order (csrc/grouped_gram.cu:
    group_count_kernel, group_scan_kernel, group_scatter_kernel): the rows
    cut into `_build.order_geometry(n)`'s B slices; count[g, b], the rows of
    group g in slice b, scanned in (group, block) order into first[g, b];
    offsets[g] = first[g, 0], offsets[G] the rows with an id in [0, G);
    such a row of slice b at first[g, b] + its rank among the slice's
    earlier rows of group g. Returns (offsets i64[G + 1], order
    i64[offsets[G]]): the stable order of those rows by id."""
    n = group_ids.shape[-1]
    dev = group_ids.device
    blocks, per = _build.order_geometry(n)
    g = group_ids.long()
    ok = (g >= 0) & (g < num_groups)
    rows = torch.arange(n, device=dev)[ok]
    key = g[ok] * blocks + rows // per
    counts = torch.bincount(key, minlength=num_groups * blocks)
    first = torch.cumsum(counts, 0) - counts
    offsets = torch.cat([first.view(num_groups, blocks)[:, 0],
                         counts.sum().reshape(1)])
    srt = torch.sort(key, stable=True).indices
    rank = torch.empty_like(key)
    rank[srt] = torch.arange(key.shape[0], device=dev) - first[key[srt]]
    order = torch.empty_like(rows)
    order[first[key] + rank] = rows
    return offsets, order


def presorted_steps_plain(offsets, rows: int, nblocks: int):
    """K5's steps (GroupRows in csrc/grouped_gram.cu): the group-aligned
    steps of `rows` rows (`_build.group_chunks`), cpb of them to a block in
    order. Returns (group, block, first), i64[C] each: each step's group,
    block and first position, in step order; and cum i64[G + 1]. A step's
    slot is block + group."""
    cum = _build.group_chunks(offsets, rows)
    total = int(cum[-1])
    cpb = max(-(-total // nblocks), 1)
    steps = torch.arange(total, device=offsets.device)
    group = torch.searchsorted(cum[1:], steps, right=True)
    first = offsets[group] + (steps - cum[group]) * rows
    return group, steps // cpb, first, cum


def presorted_gram_split_plain(x_cols, code_cols, weights, offsets, *,
                               schema: FeatureSchema, order=None
                               ) -> torch.Tensor:
    """Plain torch version of K5's arithmetic on the tensor cores
    (csrc/grouped_gram.cu over tc_gram.cuh), used by no path, f32[G, P, P]:
    each step of `presorted_steps_plain` (TC_ROWS rows of one group, the
    positions past the group's end zero rows) as the Gram of its rows'
    three-way bf16 parts (`split_operands`; each product exact) in f64,
    folded into S′ (`fold_parts`) and added in f64 into the slot (block,
    group) of its step; each group's slots summed over the blocks that met
    it in block order, rounded to f32 once. x_cols, code_cols, weights:
    the columns a position reads, sorted by group (`offsets`), or with
    `order` (K4's, `group_order_plain`) the columns in any order, position
    i reading row order[i]."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    num_groups = offsets.shape[0] - 1
    n = (x_cols + code_cols + [weights])[0].shape[-1]
    dev = offsets.device
    w = torch.ones(n, device=dev) if weights is None else weights
    # row n, a zero row: what a position past its group's end reads
    left, right = split_operands(
        [torch.cat([x, x.new_zeros(1)]) for x in x_cols],
        [torch.cat([c, c.new_full((1,), -1)]) for c in code_cols],
        torch.cat([w.float(), w.new_zeros(1)]), schema=schema)
    nblocks = _build.tc_grid(n)
    group, block, first, cum = presorted_steps_plain(offsets, _build.TC_ROWS,
                                                     nblocks)
    pos = first[:, None] + torch.arange(_build.TC_ROWS, device=dev)
    valid = pos < offsets[group + 1][:, None]
    src = torch.where(valid, pos, 0)
    if order is not None:
        src = order[src]
    src = torch.where(valid, src, n)
    steps = fold_parts(left[:, src].permute(1, 0, 2)
                       @ right[:, src].permute(1, 2, 0), schema=schema)
    p = schema.sigma_size
    slots = torch.zeros((nblocks + num_groups, p, p), dtype=torch.float64,
                        device=dev)
    slots.index_add_(0, block + group, steps)
    cpb = max(-(-int(cum[-1]) // nblocks), 1)
    out = torch.zeros((num_groups, p, p), dtype=torch.float64, device=dev)
    for g in range(num_groups):
        lo, hi = int(cum[g]), int(cum[g + 1])
        for b in range(lo // cpb, (hi - 1) // cpb + 1) if hi > lo else ():
            out[g] += slots[b + g]
    upper = out.float()
    return upper + upper.triu(1).transpose(-1, -2)


def grouped_gram_split_plain(x_num, codes, weights, group_ids, *,
                             schema: FeatureSchema, num_groups: int
                             ) -> torch.Tensor:
    """Plain torch version of K4's arithmetic on the tensor cores, used by
    no path: `group_order_plain`, then `presorted_gram_split_plain` over
    the rows through the order."""
    offsets, order = group_order_plain(group_ids, num_groups)
    return presorted_gram_split_plain(list(x_num), list(codes), weights,
                                      offsets, schema=schema, order=order)


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
    per segment (reads the offsets on the host); past
    MAX_WIDE_SIGMA_SIZE each from S's tables (`masked_gram_window_plain`,
    no dense Z), as the kernel builds it by windows."""
    p = schema.sigma_size
    off = layout.offsets.tolist()
    out = torch.zeros((layout.num_groups, p, p), dtype=torch.float32,
                      device=w_sorted.device)
    for g in range(layout.num_groups):
        lo, hi = off[g], off[g + 1]
        if hi <= lo:
            continue
        if p > _build.MAX_WIDE_SIGMA_SIZE:
            out[g] = masked_gram_window_plain(
                list(x_sorted[:, lo:hi]), list(codes_sorted[:, lo:hi]),
                w_sorted[lo:hi], schema=schema, lo=0, width=p)
        else:
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
    `grouped_gram_presorted.wide_launches`, one a column window past
    MAX_WIDE_SIGMA_SIZE); CPU tensors take the plain version."""
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
    if p > _build.MAX_WIDE_SIGMA_SIZE:
        return _presorted_windows(x_sorted, codes_sorted, w_sorted, off,
                                  num_groups, n, schema, device, lib)
    if p > _build.MAX_SIGMA_SIZE:
        # K8: K7's plan and slices over group-aligned chunks (where it has
        # a task), and past the crossover the D kernel over each group's
        # rows
        plan, partial, tasks = wide_plan_args(schema, n, device,
                                              groups=num_groups)
        out = torch.zeros((num_groups, p, p), dtype=torch.float32,
                          device=device)
        cols = _build.column_args(list(x_sorted), list(codes_sorted), sizes,
                                  device)
        if tasks:
            cum = _build.group_chunks(off, _build.WIDE_CHUNK)
            with torch.cuda.device(device):
                rc = lib.lib.dit_grouped_wide_gram(
                    *cols, w_sorted.data_ptr(), off.data_ptr(),
                    cum.data_ptr(), num_groups, n, p, *plan,
                    partial.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
            _build.raise_on_error(lib, rc, "grouped_gram_presorted")
            grouped_gram_presorted.wide_launches += 1
        if _build.dense_route(schema.num_cols):
            launch_dense(lib, list(x_sorted), w_sorted, n, device, schema, 0,
                         p, out, p, p * p, off, cols[-1])
        return out
    d = schema.num_cols
    nblocks, rows = _build.presorted_grid(d, p, n)
    cum = _build.group_chunks(off, rows)
    partial = torch.empty(_entries(lib, d, p) * (nblocks + num_groups),
                          dtype=torch.float64, device=device)
    out = torch.empty((num_groups, p, p), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.lib.dit_presorted_gram(
            _build.pointers(list(x_sorted)), d,
            _build.pointers(list(codes_sorted)), _build.int_array(sizes),
            len(sizes), w_sorted.data_ptr(), off.data_ptr(), cum.data_ptr(),
            num_groups, n, p, partial.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "grouped_gram_presorted")
    grouped_gram_presorted.launches += 1
    return out


def _presorted_windows(x_sorted, codes_sorted, w_sorted, off, num_groups,
                       n, schema, device, lib) -> torch.Tensor:
    """K8 past MAX_WIDE_SIGMA_SIZE: one launch a column window of
    WINDOW_WIDTH (`window_plans`), each writing S_g[:, lo:hi]
    of every group into out f32[G, P, P]: its residual plan over the
    group-sorted rows, its f64 partial sized for that plan's cells and the
    groups, and its keyed tasks over the rows ordered by (group, code) of
    each keyed column, one order pass (`window_order`) for all windows;
    counted on `.wide_launches` a window where either plan has a task.
    Past the crossover D by one launch of the D kernel over every group's
    S first (`launch_dense`)."""
    p, sizes = schema.sigma_size, tuple(schema.cat_sizes)
    x_cols, code_cols = list(x_sorted), list(codes_sorted)
    lows = range(0, p, _build.WINDOW_WIDTH)
    order = window_order(x_cols, code_cols, w_sorted, schema=schema,
                         columns=window_columns(schema, lows,
                                                _build.WINDOW_WIDTH),
                         offsets=off)
    cum = _build.group_chunks(off, _build.WIDE_CHUNK)
    out = torch.zeros((num_groups, p, p), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    cols = _build.column_args(x_cols, code_cols, sizes, device)
    if _build.dense_route(schema.num_cols):
        launch_dense(lib, x_cols, w_sorted, n, device, schema, 0, p, out, p,
                     p * p, off, cols[-1])
    for lo in lows:
        width = min(_build.WINDOW_WIDTH, p - lo)
        residual, keyed = window_plans(schema, lo, lo + width, device)
        if residual is not None and residual.num_tasks:
            slices = residual.slices(n)
            partial = torch.empty(
                residual.cells * (slices + num_groups - 1),
                dtype=torch.float64, device=device)
            with torch.cuda.device(device):
                rc = lib.lib.dit_grouped_wide_gram_window(
                    *cols, w_sorted.data_ptr(),
                    off.data_ptr(), cum.data_ptr(), num_groups, n, p, lo,
                    width, p, p * p,
                    *(t.data_ptr() for t in residual.tensors),
                    _build.int_array(residual.shape_ints(slices)),
                    partial.data_ptr(), out[:, :, lo:].data_ptr(), stream)
            _build.raise_on_error(lib, rc, "grouped_gram_presorted")
        if keyed is not None:
            launch_keyed(keyed, order, n, device, schema, lo, width,
                         out[:, :, lo:], p, p * p, lib,
                         "grouped_gram_presorted", cols[-1])
        if keyed is not None or (residual is not None
                                 and residual.num_tasks):
            grouped_gram_presorted.wide_launches += 1
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
