"""K1 and K7: the masked Gram over per-column inputs, S = Zᵀ·diag(w)·Z.

Counterpart of `sigma_pallas_fast_cols_padded` in
`duckdb_imputation_tpu/ring/kernels/sigma_pallas.py` (which dispatches the
Pallas kernels `sigma_pallas_fast3_cols` and `sigma_pallas_fast2_cols`):
the aggregation of the MICE device loops, fed by the columnar carry
directly, so a stacked [d, n] block never exists. `masked_gram` is the
same kernels' entry point for stacked blocks (`sum_to_triple`).

Both dispatch by the sigma size P, as the JAX dispatchers fall to pack = 1
and a wider tile: P ≤ 88 takes K1 (`csrc/masked_gram.cu` over
`csrc/tc_gram.cuh`: the Gram of each value's three bf16 parts on the tensor
cores, `masked_gram_split_plain` its arithmetic in plain torch, for a
schema whose S is that kernel's one output tile, `_build.tc_fits`; any
other takes its CUDA-core route, one 4×4 tile of S a thread), P > 88 takes
K7 (`csrc/wide_gram.cu`: S's nonzero structure, the tables D, K_j and C_jk
of `_build.WidePlan`, summed over each row's nonzeros in tasks over the
grid): one launch of its whole plan up to `_build.MAX_WIDE_SIGMA_SIZE`,
above it one launch a column window of `_build.WINDOW_WIDTH`, each written
into its columns of S, up to `_build.MAX_WINDOW_SIGMA_SIZE`. CUDA
tensors launch a kernel; the plain versions (`masked_gram_cols_plain`,
`masked_gram_plain`) run only for CPU tensors. Kernels and plain versions
round the cross-chunk sum from f64 to f32 once, so one-hot counts are
exact past 2²⁴ rows, and take any row count: nothing is padded.

`masked_gram_window` is K7 over one column window S[:, lo:lo + width] of
any P (`_build.window_plan`), the counterpart of JAX's
`ring/striped.py:sigma_stripe` and, past P = 1,024, the card's only way
to what `sigma_pallas_fast_cols_padded` and `sigma_pallas_padded`
compute; `masked_gram_window_plain` computes the window from S's tables
in plain torch (f64 sums of f32 products, no dense Z), and is also the
plain version of the two entry points above P = 1,024.

`wide_tables_plain` computes K7's tables in plain torch, and
`wide_assemble` scatters tables into S through the plan's map, as the
kernel's reduction does: the CPU tests hold the plan against the plain
Gram and the JAX kernels with them.
"""
from __future__ import annotations

import functools

import torch

from ...schema import FeatureSchema
from ..sum import _stack_cols, masked_sigma
from . import _build


def masked_gram_cols_plain(x_cols, code_cols, weights, *,
                           schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `masked_gram_cols` (chunked f32 matmuls,
    summed in f64; above MAX_WIDE_SIGMA_SIZE the windows of
    `masked_gram_window_plain`, as the kernel assembles S)."""
    if schema.sigma_size > _build.MAX_WIDE_SIGMA_SIZE:
        return masked_gram_window_plain(x_cols, code_cols, weights,
                                        schema=schema, lo=0,
                                        width=schema.sigma_size)
    x, c = _stack_cols(x_cols, code_cols, schema)
    return masked_sigma(x, c, weights, schema=schema)


def masked_gram_window_plain(x_cols, code_cols, weights, *,
                             schema: FeatureSchema, lo: int, width: int
                             ) -> torch.Tensor:
    """Plain torch version of `masked_gram_window`: S[:, lo:lo + width]
    f32[P, width] from S's tables, each cut to the window and summed in
    f64 of the f32 products w·z_a (then times z_b, exact in f64): D =
    [1 ‖ x]ᵀ·diag(w)·[1 ‖ x] by one f64 product, K_j by `index_add_`, C_jk
    by `bincount`; one rounding to f32. Never builds the dense Z, so it
    takes any P at any n; its f64 scratch is at most P × WINDOW_WIDTH (the
    window is filled WINDOW_WIDTH columns at a time). x_cols d × f32[n],
    code_cols c × i32[n] (a code outside [0, size) adds nothing), weights
    f32[n] or None."""
    p = schema.sigma_size
    if not (0 <= lo and width >= 1 and lo + width <= p):
        raise ValueError(f"window [{lo}, {lo + width}) is not inside "
                         f"[0, {p})")
    x_cols, code_cols = list(x_cols), list(code_cols)
    first = (x_cols + code_cols + [weights])[0]
    n, device = first.shape[-1], first.device
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    z = torch.stack([torch.ones(n, device=device)]
                    + [x.to(torch.float32) for x in x_cols])   # [1 + d, n]
    zw = (z * w).to(torch.float64)             # w·z_a in f32, exact in f64
    out = torch.zeros((p, width), dtype=torch.float32, device=device)
    for a in range(lo, lo + width, _build.WINDOW_WIDTH):
        b = min(a + _build.WINDOW_WIDTH, lo + width)
        _window_tables(z, zw, w, code_cols, schema, a, b,
                       out[:, a - lo:b - lo])
    return out


def _window_tables(z, zw, w, code_cols, schema, lo, hi, out) -> None:
    """S[:, lo:hi] into out f32[P, hi − lo] (a zero view) from the tables
    cut to the window: `masked_gram_window_plain`'s body."""
    d = schema.num_cols
    device, f64 = z.device, torch.float64
    dense = (max(lo, 0), min(hi, 1 + d))       # window ∩ [1 ‖ x]
    if dense[1] > dense[0]:
        out[:1 + d, dense[0] - lo:dense[1] - lo] = (
            zw @ z[dense[0]:dense[1]].to(f64).T).float()
    base = [1 + d + o for o in schema.offsets]
    sizes = schema.cat_sizes
    keys = [(min(max(lo - b, 0), v), min(max(hi - b, 0), v))
            for b, v in zip(base, sizes)]
    codes = [c.long() for c in code_cols]
    valid = [(c >= 0) & (c < v) for c, v in zip(codes, sizes)]
    for j, (bj, vj) in enumerate(zip(base, sizes)):
        cj, ok = codes[j], valid[j]
        ka, kb = keys[j]
        if dense[1] > dense[0] or kb > ka:     # K_j [V_j, 1 + d]
            kt = torch.zeros((vj, 1 + d), dtype=f64, device=device)
            kt.index_add_(0, cj[ok], zw[:, ok].T)
            if kb > ka:
                cols = slice(bj + ka - lo, bj + kb - lo)
                out[:1 + d, cols] = kt[ka:kb].T.float()
                v = torch.arange(ka, kb, device=device)
                out[bj + v, bj + v - lo] = kt[ka:kb, 0].float()
            if dense[1] > dense[0]:
                out[bj:bj + vj, dense[0] - lo:dense[1] - lo] = (
                    kt[:, dense[0]:dense[1]].float())
        for k, (bk, vk) in enumerate(zip(base, sizes)):
            ka, kb = keys[k]
            if k == j or kb <= ka:
                continue                       # C_jk cut to k's window keys
            ck = codes[k]
            sel = ok & (ck >= ka) & (ck < kb)
            tab = torch.bincount(cj[sel] * (kb - ka) + ck[sel] - ka,
                                 weights=w[sel].to(f64),
                                 minlength=vj * (kb - ka))
            out[bj:bj + vj, bk + ka - lo:bk + kb - lo] = (
                tab.reshape(vj, kb - ka).float())


def split3_plain(v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """K1's split of f32 values into three bf16 parts (h, m, l), returned
    as f32: h = bf16(v), m = bf16(v − h), l = bf16(v − h − m), each
    rounded to nearest even; h + m + l == v for every v that is a multiple
    of 2⁻¹³³ (csrc/tc_gram.cuh)."""
    v = v.to(torch.float32)
    h = v.to(torch.bfloat16).float()
    m = (v - h).to(torch.bfloat16).float()
    return h, m, (v - h - m).to(torch.bfloat16).float()


def split_operands(x_cols, code_cols, weights, *, schema: FeatureSchema
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's operands (csrc/tc_gram.cuh) of n rows, in f64: left [3P, n],
    the three bf16 parts of f32(w·z_a); right [R, n], one part for the
    constant and the one-hots, three for each x (R = 1 + 3d + V). Each
    product of a left and a right value is exact in f64."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    first = (x_cols + code_cols + [weights])[0]
    n = first.shape[-1]
    w = (torch.ones(n, device=first.device) if weights is None
         else weights).to(torch.float32)
    z = [torch.ones(n, device=w.device)] + [x.to(torch.float32)
                                            for x in x_cols]
    for c, size in zip(code_cols, schema.cat_sizes):
        z += [(c == v).to(torch.float32) for v in range(size)]
    d = schema.num_cols
    left = torch.stack([part for za in z for part in split3_plain(za * w)])
    right = torch.stack([part for b, zb in enumerate(z)
                         for part in (split3_plain(zb) if 1 <= b <= d
                                      else (zb,))])
    return left.double(), right.double()


def fold_parts(parts: torch.Tensor, *, schema: FeatureSchema
               ) -> torch.Tensor:
    """The Gram of parts f64[..., 3P, R] folded over the parts into the
    upper triangle of S, f64[..., P, P] (zero below the diagonal), as the
    kernels fold S′ (tc_gram.cuh: tc_fold)."""
    p, d = schema.sigma_size, schema.num_cols
    owner = torch.tensor([b for b in range(p)
                          for _ in range(3 if 1 <= b <= d else 1)],
                         device=parts.device)
    folded = torch.zeros(parts.shape[:-1] + (p,), dtype=torch.float64,
                         device=parts.device)
    folded.index_add_(parts.dim() - 1, owner, parts)
    return folded.reshape(parts.shape[:-2] + (p, 3, p)).sum(-2).triu()


def masked_gram_split_plain(x_cols, code_cols, weights, *,
                            schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of K1's arithmetic (csrc/tc_gram.cuh), used by
    no path: the Gram of the parts of `split_operands`, in f64 (each
    product of two bf16 values is exact), is folded over the parts into S
    and rounded to f32 once."""
    left, right = split_operands(x_cols, code_cols, weights, schema=schema)
    upper = fold_parts(left @ right.T, schema=schema).float()
    return upper + upper.triu(1).T       # S[b, a] = S[a, b], as the kernel


def _launch(x_cols, code_cols, weights, n: int, device, schema,
            wrapper) -> torch.Tensor:
    """One launch of K1, or of K7 when P > 88, over per-column [n] tensors
    on `device`, checked first; shared by both entry points. Adds one to
    `wrapper.launches` (K1) or `wrapper.wide_launches` (K7) once the
    launch succeeded. No rows: no launch, a zero sigma."""
    what = wrapper.__name__
    p = schema.sigma_size
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
    if p > _build.MAX_WIDE_SIGMA_SIZE:
        _build.check_window(schema, 0, p)
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
    if n == 0:
        return torch.zeros((p, p), dtype=torch.float32, device=device)
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=device)
    lib = _build.load()
    if p > _build.MAX_WIDE_SIGMA_SIZE:       # K7 a window of S's columns
        return _gram_windows(x_cols, code_cols, weights, n, device, schema,
                             lib, wrapper, "wide_launches")
    if p > _build.MAX_SIGMA_SIZE:
        out = _launch_wide(x_cols, code_cols, weights, n, device, schema,
                           lib, what)
        wrapper.wide_launches += 1
        return out
    out = torch.empty((p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    cols = (_build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes), weights.data_ptr(), n, p)
    stream = torch.cuda.current_stream(device).cuda_stream
    if _build.tc_fits(schema.num_cols, p):    # the tensor cores
        nblocks = _build.tc_grid(n)
        partial = torch.empty(_build.TC_A ** 2 * nblocks, dtype=torch.float64,
                              device=device)
        with torch.cuda.device(device):
            rc = lib.lib.dit_masked_gram(*cols, partial.data_ptr(), nblocks,
                                         out.data_ptr(), stream)
    else:                                     # the CUDA cores
        nblocks = _build.grid_blocks(n)
        partial = torch.empty(lib.lib.dit_gram_entries(p) * nblocks,
                              dtype=torch.float64, device=device)
        with torch.cuda.device(device):
            rc = lib.lib.dit_masked_gram_cores(
                *cols, partial.data_ptr(), nblocks, out.data_ptr(), stream)
    _build.raise_on_error(lib, rc, what)
    wrapper.launches += 1
    return out


@functools.lru_cache(maxsize=32)
def _device_plan(d: int, sizes: tuple[int, ...], device, window=None):
    plan = (_build._wide_plan(d, sizes) if window is None
            else _build._window_plan(d, sizes, *window))
    return tuple(t.to(device) for t in (
        plan.slabs, plan.warp_begin, plan.task_base, plan.stage_cols,
        plan.entries))


def wide_plan_args(schema, n: int, device, groups: int = 1):
    """K7's plan as the C arguments of its entry points (the plan's device
    tensors, made once per schema and device; its shape and the row slices
    as a host array) and the f64 scratch of the (task, slice + group)
    partials; shared with K2w, and with K8 (`groups` > 1)."""
    plan = _build.wide_plan(schema)
    tensors = _device_plan(schema.num_cols, tuple(schema.cat_sizes), device)
    slices = plan.slices(n)
    partial = torch.empty(int(plan.task_base[-1]) * (slices + groups - 1),
                          dtype=torch.float64, device=device)
    args = (*(t.data_ptr() for t in tensors),
            _build.int_array(plan.shape_ints(slices)))
    return args, partial


def _launch_wide(x_cols, code_cols, weights, n, device, schema, lib, what):
    p = schema.sigma_size
    plan, partial = wide_plan_args(schema, n, device)
    out = torch.zeros((p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_wide_gram(
            _build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes), weights.data_ptr(), n, p,
            *plan, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, what)
    return out


def _gram_windows(x_cols, code_cols, weights, n, device, schema, lib,
                  wrapper, counter: str) -> torch.Tensor:
    """S f32[P, P] by one K7 launch a column window of WINDOW_WIDTH,
    adding one to `wrapper.<counter>` a launch; shared by masked_gram(_cols)
    and K2w past MAX_WIDE_SIGMA_SIZE."""
    p = schema.sigma_size
    out = torch.zeros((p, p), dtype=torch.float32, device=device)
    for lo in range(0, p, _build.WINDOW_WIDTH):
        _launch_window(x_cols, code_cols, weights, n, device, schema, lo,
                       min(_build.WINDOW_WIDTH, p - lo), out[:, lo:], lib,
                       wrapper.__name__)
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return out


def _launch_window(x_cols, code_cols, weights, n, device, schema, lo,
                   width, out, lib, what) -> None:
    """One launch of K7 over the plan of the window [lo, lo + width),
    writing S[:, lo:lo + width] into out f32[P, ld] (zeroed; its column 0
    is the window's first)."""
    plan = _build.window_plan(schema, lo, lo + width)
    tensors = _device_plan(schema.num_cols, tuple(schema.cat_sizes), device,
                           plan.window)
    slices = plan.slices(n)
    partial = torch.empty(int(plan.task_base[-1]) * slices,
                          dtype=torch.float64, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_wide_gram_window(
            _build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes), weights.data_ptr(), n,
            schema.sigma_size, lo, width, out.stride(0),
            *(t.data_ptr() for t in tensors),
            _build.int_array(plan.shape_ints(slices)), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, what)


def masked_gram_window(x_cols, code_cols, weights, *, schema: FeatureSchema,
                       lo: int, width: int) -> torch.Tensor:
    """The column window S[:, lo:lo + width] f32[P, width] of the masked
    sigma of per-column inputs (as `masked_gram_cols`'s), any P up to
    `_build.MAX_WINDOW_SIGMA_SIZE`: the function of JAX's
    `ring/striped.py:sigma_stripe`. Peak device memory beside the inputs:
    the output, the window's plan (`_build.window_plan`: its map of one
    i32[4] entry a nonzero place) and K7's f64 partial of its cells.

    CUDA tensors launch K7 over the window's plan (one launch, counted in
    `masked_gram_window.launches`); CPU tensors take
    `masked_gram_window_plain`."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    if len(x_cols) != schema.num_cols or len(code_cols) != schema.cat_cols:
        raise ValueError("column counts do not match the schema")
    tensors = x_cols + code_cols + ([] if weights is None else [weights])
    if not tensors:
        raise ValueError("need at least one column or the weights")
    if _build.on_cpu(tensors):
        return masked_gram_window_plain(x_cols, code_cols, weights,
                                        schema=schema, lo=lo, width=width)
    n = tensors[0].shape[-1]
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
    _build.check_window(schema, lo, width)
    device = _build.check_cuda(
        tensors,
        [(t, torch.float32, (n,), f"x_cols[{j}]")
         for j, t in enumerate(x_cols)]
        + [(t, torch.int32, (n,), f"code_cols[{j}]")
           for j, t in enumerate(code_cols)]
        + ([] if weights is None
           else [(weights, torch.float32, (n,), "weights")]))
    out = torch.zeros((schema.sigma_size, width), dtype=torch.float32,
                      device=device)
    if n == 0:
        return out
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=device)
    _launch_window(x_cols, code_cols, weights, n, device, schema, lo, width,
                   out, _build.load(), "masked_gram_window")
    masked_gram_window.launches += 1
    return out


masked_gram_window.launches = 0


def wide_tables_plain(x_cols, code_cols, weights, *, schema: FeatureSchema,
                      plan: _build.WidePlan | None = None) -> torch.Tensor:
    """Plain torch version of K7's tables: every cell of the plan
    (`_build.wide_plan(schema)`, or `plan`, e.g. a window's), task after
    task, f64[task_base[T]], each a sum in f64 of f32 products as the
    kernel forms them (w·x for K_j, (w·z_a)·z_b for D; bincount for
    C_jk). x_cols d × f32[n], code_cols c × i32[n] (a code outside [0,
    size) adds nothing), weights f32[n] or None."""
    plan = _build.wide_plan(schema) if plan is None else plan
    x_cols, code_cols = list(x_cols), list(code_cols)
    n = (x_cols + code_cols + [weights])[0].shape[-1]
    device = (x_cols + code_cols + [weights])[0].device
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    xw = [w] + [x * w for x in x_cols]         # w·z_a, z = [1 ‖ x]
    f64 = torch.float64
    out = torch.zeros(int(plan.task_base[-1]), dtype=f64, device=device)
    for kind, p0, p1, p2, p3, off, task, _ in plan.slabs.tolist():
        at = int(plan.task_base[task]) + off
        if kind == _build.SLAB_D:              # (a, b) for b in [p1, p2)
            cells = [xw[p0] if b == 0 else xw[p0] * x_cols[b - 1]
                     for b in range(p1, p2)]
            out[at:at + p2 - p1] = torch.stack(cells).to(f64).sum(1)
        elif kind == _build.SLAB_K:            # column p0, keys [p1, p2)
            c = code_cols[p0].long()
            ok = (c >= p1) & (c < p2)
            vals = torch.stack(xw, 1)[ok].to(f64)
            table = torch.zeros((p2 - p1, len(xw)), dtype=f64, device=device)
            table.index_add_(0, c[ok] - p1, vals)
            out[at:at + table.numel()] = table.reshape(-1)
        else:                                  # columns p0 < p1, keys [p2, p3)
            vk = schema.cat_sizes[p1]
            u, v = code_cols[p0].long(), code_cols[p1].long()
            ok = (u >= p2) & (u < p3) & (v >= 0) & (v < vk)
            cells = (p3 - p2) * vk
            out[at:at + cells] = torch.bincount(
                (u[ok] - p2) * vk + v[ok], weights=w[ok].to(f64),
                minlength=cells)
    return out


def wide_assemble(cells: torch.Tensor, *, schema: FeatureSchema,
                  plan: _build.WidePlan | None = None) -> torch.Tensor:
    """S f32[..., P, P] from the plan's cells f64[..., task_base[T]]
    (`wide_tables_plain`, or one per group): each cell rounded to f32 once
    and written to S[i, j] and S[j, i] through the plan's map, as the
    kernels' reduction does; the zero structure stays zero. A window's
    `plan` gives S[:, lo:hi] f32[..., P, hi − lo], one place an entry."""
    plan = _build.wide_plan(schema) if plan is None else plan
    p = schema.sigma_size
    lo, hi = plan.window or (0, p)
    e = plan.entries.long().to(cells.device)
    vals = cells[..., plan.task_base.to(cells.device)[e[:, 0]] + e[:, 1]]
    out = torch.zeros(cells.shape[:-1] + (p * (hi - lo),),
                      dtype=torch.float32, device=cells.device)
    out[..., e[:, 2] * (hi - lo) + e[:, 3] - lo] = vals.float()
    if plan.window is None:
        out[..., e[:, 3] * p + e[:, 2]] = vals.float()
    return out.reshape(cells.shape[:-1] + (p, hi - lo))


def masked_gram_cols(x_cols, code_cols, weights, *,
                     schema: FeatureSchema) -> torch.Tensor:
    """Masked sigma f32[P, P] of per-column inputs: x_cols d × f32[n],
    code_cols c × i32[n] (local codes; a code outside [0, size_j)
    contributes nothing), weights f32[n] or None (all ones).

    CUDA tensors launch a kernel: K1 for P ≤ 88 (one launch counted in
    `masked_gram_cols.launches`), K7 above (counted in
    `masked_gram_cols.wide_launches`: one launch up to
    MAX_WIDE_SIGMA_SIZE, one a window of WINDOW_WIDTH columns above); CPU
    tensors take the plain version."""
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
    """Plain torch version of `masked_gram`: `ring.sum.masked_sigma`
    (above MAX_WIDE_SIGMA_SIZE the windows of `masked_gram_window_plain`)."""
    if schema.sigma_size > _build.MAX_WIDE_SIGMA_SIZE:
        return masked_gram_window_plain(
            list(x_num.unbind(0)), list(codes.unbind(0)), weights,
            schema=schema, lo=0, width=schema.sigma_size)
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
    `masked_gram.launches`) or K7 above (`masked_gram.wide_launches`, one
    a window above MAX_WIDE_SIGMA_SIZE); CPU tensors take the plain
    version."""
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
