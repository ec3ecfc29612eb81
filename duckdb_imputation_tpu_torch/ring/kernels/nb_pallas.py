"""K6 and K6w: the grouped naive-Bayes sums, per group Σ w·[1 ‖ x ‖ x² ‖
onehot].

Counterpart of `duckdb_imputation_tpu/ring/kernels/nb_pallas.py`
(`sum_to_nb_agg_grouped_pallas`, the Pallas kernel `_nb_grouped_pallas`
with its bodies `_nb_kernel` and `_nb_kernel_fast`). `nb_grouped_sums`
launches the hand-written CUDA kernel (`csrc/nb_grouped_sums.cu`) for
CUDA tensors, one launch for any number of groups and features (named K6
for F ≤ 256, K6w above): keyed sums over each row's nonzero terms into
the tables of `_build.nb_plan`. It takes its plain version,
`nb_grouped_sums_plain`, only for CPU tensors. Both give f32[G, F] with
F = 1 + 2d + V: the 1 column is the (weighted) count, then Σx, Σx², and
the category counts. Rows whose id lies outside [0, G) are dropped; a
code outside [0, size) counts nowhere. Counts are exact and the x sums are
added in f64 beyond 32 rows, so reruns are bit-identical.

`nb_cells_plain` computes the kernel's cells in plain torch and
`nb_assemble` places cells into [G, F] through the plan's map, as the
kernel's reduction does: the CPU tests hold the plan with them.
"""
from __future__ import annotations

import functools

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


def nb_cells_plain(x_num, codes, weights, group_ids, *, plan: _build.NbPlan,
                   schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of the NB kernel's cells: every cell of `plan`,
    task after task, f64[cells], a keyed sum in f64 of the f32 terms as the
    kernel forms them (w, w·x, w·(x·x); w at each code)."""
    n = group_ids.shape[-1]
    d = schema.num_cols
    w = (torch.ones(n) if weights is None else weights).to(torch.float32)
    g = group_ids.long()
    x = x_num.to(torch.float32)
    terms = torch.cat([w[None], x * w, (x * x) * w]).to(torch.float64)
    out = torch.zeros(int(plan.task_base[-1]), dtype=torch.float64)
    for kind, j, p1, p2, p3, off, task, _ in plan.slabs.tolist():
        at = int(plan.task_base[task]) + off
        if kind == _build.SLAB_D:         # terms j .. p3 of groups p1 .. p2
            ok = (g >= p1) & (g < p2)
            table = torch.zeros((p2 - p1, p3 - j), dtype=torch.float64)
            table.index_add_(0, g[ok] - p1, terms[j:p3, ok].T)
        else:
            # K_j: codes [0, V_j) of groups p1 .. p2, or codes p2 .. p3 of
            # group p1
            c = codes[j].long()
            lo, hi, u_lo, u_hi = ((p1, p2, 0, schema.cat_sizes[j])
                                  if kind == _build.SLAB_K
                                  else (p1, p1 + 1, p2, p3))
            ok = (g >= lo) & (g < hi) & (c >= u_lo) & (c < u_hi)
            table = torch.bincount((g[ok] - lo) * (u_hi - u_lo) + c[ok] - u_lo,
                                   weights=w[ok].double(),
                                   minlength=(hi - lo) * (u_hi - u_lo))
        out[at:at + table.numel()] = table.reshape(-1)
    return out


def nb_assemble(cells: torch.Tensor, *, plan: _build.NbPlan,
                schema: FeatureSchema) -> torch.Tensor:
    """f32[G, F] from the plan's cells f64[cells], each rounded to f32
    once and written to its place (`NbPlan.out_index`)."""
    out = torch.empty(plan.groups * _build.nb_features(schema),
                      dtype=torch.float32, device=cells.device)
    out[plan.out_index.long().to(cells.device)] = cells.float()
    return out.reshape(plan.groups, -1)


@functools.lru_cache(maxsize=32)
def _device_plan(d: int, sizes: tuple[int, ...], groups: int, device):
    plan = _build._nb_plan(d, sizes, groups)
    return tuple(t.to(device) for t in (
        plan.device_slabs, plan.warp_begin, plan.task_base, plan.stage_cols,
        plan.out_index))


def nb_grouped_sums(x_num, codes, weights, group_ids, *,
                    schema: FeatureSchema, num_groups: int) -> torch.Tensor:
    """Per-group NB sums f32[G, F] of x_num f32[d, n], codes i32[c, n],
    weights f32[n] or None (all ones), group_ids i32[n].

    CUDA tensors launch the kernel once, for any G and F, counted in
    `nb_grouped_sums.launches`; CPU tensors take the plain version."""
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
    lib = _build.load()
    sizes = tuple(schema.cat_sizes)
    plan = _build.nb_plan(schema, num_groups)
    plan_tensors = _device_plan(schema.num_cols, sizes, num_groups, device)
    slices = plan.slices(n)
    partial = torch.empty(int(plan.task_base[-1]) * slices,
                          dtype=torch.float64, device=device)
    out = torch.empty((num_groups, _build.nb_features(schema)),
                      dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.lib.dit_nb_grouped_sums(
            *_build.column_args(list(x_num), list(codes), sizes, device),
            None if weights is None else weights.data_ptr(),
            group_ids.data_ptr(), n,
            *(t.data_ptr() for t in plan_tensors),
            _build.int_array(plan.shape_ints(slices)), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "nb_grouped_sums")
    nb_grouped_sums.launches += 1
    return out


nb_grouped_sums.launches = 0


def sum_to_nb_agg_grouped_kernel(x_num, codes, group_ids, *,
                                 schema: FeatureSchema, num_groups: int,
                                 weights=None) -> NBAgg:
    """Grouped NB aggregate through `nb_grouped_sums`: an NBAgg batched on
    [G]. The 'kernel' route of `ring.sum.sum_to_nb_agg_grouped` and
    `sum_to_nb_agg`."""
    sums = nb_grouped_sums(x_num, codes, weights, group_ids, schema=schema,
                           num_groups=num_groups)
    return _nb_from_sums(sums.T, schema)
