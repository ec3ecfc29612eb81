"""K1 and K7: the masked Gram over per-column inputs, S = Zᵀ·diag(w)·Z.

Counterpart of `sigma_pallas_fast_cols_padded` in
`duckdb_imputation_tpu/ring/kernels/sigma_pallas.py` (which dispatches the
Pallas kernels `sigma_pallas_fast3_cols` and `sigma_pallas_fast2_cols`):
the aggregation of the MICE device loops, fed by the columnar carry
directly, so a stacked [d, n] block never exists. `masked_gram` is the
same kernels' entry point for stacked blocks (`sum_to_triple`).

Both dispatch by the sigma size P, as the JAX dispatchers fall to pack = 1
and a wider tile: P ≤ 88 takes K1 (`csrc/masked_gram.cu`, one 4×4 tile of
S a thread), P > 88 takes K7 (`csrc/wide_gram.cu`, S tiled in 64×64
regions over the grid, structurally zero regions skipped), up to
`_build.MAX_WIDE_SIGMA_SIZE`. CUDA tensors launch a kernel; the plain
versions (`masked_gram_cols_plain`, `masked_gram_plain`) run only for CPU
tensors. Kernels and plain versions round the cross-chunk sum from f64 to
f32 once, so one-hot counts are exact past 2²⁴ rows, and take any row
count: nothing is padded.
"""
from __future__ import annotations

import torch

from ...schema import FeatureSchema
from ..sum import _stack_cols, masked_sigma
from . import _build


def masked_gram_cols_plain(x_cols, code_cols, weights, *,
                           schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `masked_gram_cols` (chunked f32 matmuls,
    summed in f64)."""
    x, c = _stack_cols(x_cols, code_cols, schema)
    return masked_sigma(x, c, weights, schema=schema)


def _launch(x_cols, code_cols, weights, n: int, device, schema,
            wrapper) -> torch.Tensor:
    """One launch of K1, or of K7 when P > 88, over per-column [n] tensors
    on `device`, checked first; shared by both entry points. Adds one to
    `wrapper.launches` (K1) or `wrapper.wide_launches` (K7) once the
    launch succeeded."""
    what = wrapper.__name__
    _build.check_schema(schema, n, _build.MAX_WIDE_SIGMA_SIZE)
    tensors = x_cols + code_cols + ([] if weights is None else [weights])
    if tensors:
        device = _build.check_cuda(
            tensors,
            [(t, torch.float32, (n,), f"x_cols[{j}]")
             for j, t in enumerate(x_cols)]
            + [(t, torch.int32, (n,), f"code_cols[{j}]")
               for j, t in enumerate(code_cols)]
            + ([] if weights is None
               else [(weights, torch.float32, (n,), "weights")]))
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=device)
    lib = _build.load()
    p = schema.sigma_size
    if p > _build.MAX_SIGMA_SIZE:
        out = _launch_wide(x_cols, code_cols, weights, n, device, schema,
                           lib, what)
        wrapper.wide_launches += 1
        return out
    nblocks = _build.grid_blocks(n)
    partial = torch.empty(lib.lib.dit_gram_entries(p) * nblocks,
                          dtype=torch.float64, device=device)
    out = torch.empty((p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_masked_gram(
            _build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes), weights.data_ptr(), n, p,
            partial.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, what)
    wrapper.launches += 1
    return out


def wide_plan(schema, n: int, lib: _build.Library, device,
              groups: int = 0):
    """K7's region list as a C array, its count, the row slices, and the
    f64 scratch for the per-(region, slice) partials; shared with K2w, and
    with K8, whose partials are (region, slice + group) slots."""
    regions = _build.wide_regions(schema)
    slices = _build.wide_slices(n, len(regions))
    partial = torch.empty(
        len(regions) * (slices + groups) * lib.lib.dit_wide_region_entries(),
        dtype=torch.float64, device=device)
    flat = _build.int_array([lo for pair in regions for lo in pair])
    return flat, len(regions), slices, partial


def _launch_wide(x_cols, code_cols, weights, n, device, schema, lib, what):
    p = schema.sigma_size
    flat, nregions, slices, partial = wide_plan(schema, n, lib, device)
    out = torch.zeros((p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_wide_gram(
            _build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes), weights.data_ptr(), n, p,
            flat, nregions, slices, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, what)
    return out


def masked_gram_cols(x_cols, code_cols, weights, *,
                     schema: FeatureSchema) -> torch.Tensor:
    """Masked sigma f32[P, P] of per-column inputs: x_cols d × f32[n],
    code_cols c × i32[n] (local codes; a code outside [0, size_j)
    contributes nothing), weights f32[n] or None (all ones).

    CUDA tensors launch a kernel: K1 for P ≤ 88 (one launch counted in
    `masked_gram_cols.launches`), K7 above (counted in
    `masked_gram_cols.wide_launches`); CPU tensors take the plain
    version."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    if len(x_cols) != schema.num_cols or len(code_cols) != schema.cat_cols:
        raise ValueError("column counts do not match the schema")
    tensors = x_cols + code_cols + ([] if weights is None else [weights])
    if not tensors:
        raise ValueError("need at least one column or the weights")
    if _build.on_cpu(tensors):
        return masked_gram_cols_plain(x_cols, code_cols, weights,
                                      schema=schema)
    return _launch(x_cols, code_cols, weights, tensors[0].shape[-1],
                   tensors[0].device, schema, masked_gram_cols)


masked_gram_cols.launches = 0
masked_gram_cols.wide_launches = 0


def masked_gram_plain(x_num, codes, weights, *,
                      schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `masked_gram`: `ring.sum.masked_sigma`."""
    return masked_sigma(x_num, codes, weights, schema=schema)


def masked_gram(x_num, codes, weights, *, schema: FeatureSchema
                ) -> torch.Tensor:
    """Masked sigma f32[P, P] of stacked blocks x_num f32[d, n] and codes
    i32[c, n] (either may have no rows): K1 or K7 through a stacked entry
    point. Counterpart of the Pallas kernels that
    `sum_to_triple(backend='pallas')` reaches (`sigma_pallas`,
    `sigma_pallas_fast` (the wide fallback), `sigma_pallas_fast2`,
    `sigma_pallas_fast3`).

    Each row of a contiguous block is one of the kernels' column pointers,
    so nothing is copied. CUDA tensors launch K1 for P ≤ 88 (counted in
    `masked_gram.launches`) or K7 above (`masked_gram.wide_launches`); CPU
    tensors take the plain version."""
    if x_num.shape[0] != schema.num_cols or codes.shape[0] != schema.cat_cols:
        raise ValueError("block heights do not match the schema")
    n = x_num.shape[-1]
    if codes.shape[-1] != n:
        raise ValueError(f"codes: {codes.shape[-1]} rows, x_num: {n}")
    tensors = [x_num, codes] + ([] if weights is None else [weights])
    if _build.on_cpu(tensors):
        return masked_gram_plain(x_num, codes, weights, schema=schema)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must all lie on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    for t, name in ((x_num, "x_num"), (codes, "codes")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return _launch(list(x_num.unbind(0)), list(codes.unbind(0)), weights,
                   n, x_num.device, schema, masked_gram)


masked_gram.launches = 0
masked_gram.wide_launches = 0
