"""K1: the masked Gram over per-column inputs, S = Zᵀ·diag(w)·Z.

Counterpart of `sigma_pallas_fast_cols_padded` in
`duckdb_imputation_tpu/ring/kernels/sigma_pallas.py` (which dispatches the
Pallas kernels `sigma_pallas_fast3_cols` and `sigma_pallas_fast2_cols`):
the aggregation of the MICE device loops, fed by the columnar carry
directly, so a stacked [d, n] block never exists. `masked_gram` is the
same kernel's entry point for stacked blocks (`sum_to_triple`).

`masked_gram_cols` launches the hand-written CUDA kernel
(`csrc/masked_gram.cu`) for CUDA tensors and takes its plain version,
`masked_gram_cols_plain`, only for CPU tensors. Both round the cross-chunk
sum from f64 to f32 once, so one-hot counts are exact past 2²⁴ rows, and
both take any row count: nothing is padded.
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
            what: str) -> torch.Tensor:
    """One launch of K1 over per-column [n] tensors on `device`, checked
    first; shared by both entry points, which each count their own."""
    _build.check_schema(schema, n)
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
    return out


def masked_gram_cols(x_cols, code_cols, weights, *,
                     schema: FeatureSchema) -> torch.Tensor:
    """Masked sigma f32[P, P] of per-column inputs: x_cols d × f32[n],
    code_cols c × i32[n] (local codes; a code outside [0, size_j)
    contributes nothing), weights f32[n] or None (all ones).

    CUDA tensors launch the kernel (one launch counted in
    `masked_gram_cols.launches`); CPU tensors take the plain version."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    if len(x_cols) != schema.num_cols or len(code_cols) != schema.cat_cols:
        raise ValueError("column counts do not match the schema")
    tensors = x_cols + code_cols + ([] if weights is None else [weights])
    if not tensors:
        raise ValueError("need at least one column or the weights")
    if _build.on_cpu(tensors):
        return masked_gram_cols_plain(x_cols, code_cols, weights,
                                      schema=schema)
    out = _launch(x_cols, code_cols, weights, tensors[0].shape[-1],
                  tensors[0].device, schema, "masked_gram_cols")
    masked_gram_cols.launches += 1
    return out


masked_gram_cols.launches = 0


def masked_gram_plain(x_num, codes, weights, *,
                      schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `masked_gram`: `ring.sum.masked_sigma`."""
    return masked_sigma(x_num, codes, weights, schema=schema)


def masked_gram(x_num, codes, weights, *, schema: FeatureSchema
                ) -> torch.Tensor:
    """Masked sigma f32[P, P] of stacked blocks x_num f32[d, n] and codes
    i32[c, n] (either may have no rows): K1 through a stacked entry point.
    Counterpart of the Pallas kernels that `sum_to_triple(backend='pallas')`
    reaches (`sigma_pallas`, `sigma_pallas_fast`, `sigma_pallas_fast2`,
    `sigma_pallas_fast3`) for P ≤ 88; a wider schema raises, as K1 does.

    Each row of a contiguous block is one of K1's column pointers, so
    nothing is copied. CUDA tensors launch the kernel (one launch counted
    in `masked_gram.launches`); CPU tensors take the plain version."""
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
    out = _launch(list(x_num.unbind(0)), list(codes.unbind(0)), weights, n,
                  x_num.device, schema, "masked_gram")
    masked_gram.launches += 1
    return out


masked_gram.launches = 0
