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
any P (`_build.keyed_window_plan`), the counterpart of JAX's
`ring/striped.py:sigma_stripe` and, past P = 1,024, the card's only way
to what `sigma_pallas_fast_cols_padded` and `sigma_pallas_padded`
compute; `masked_gram_window_plain` computes the window from S's tables
in plain torch (f64 sums of f32 products, no dense Z), and is also the
plain version of the two entry points above P = 1,024. Past P = 1,024,
a window's tables keyed on a column whose tables take more than one
task (`_build.keyed_columns`) run as keyed tasks, each over its key
range's rows of a copy of the columns ordered by that column's codes
(`window_order`, once a call; its counter `window_order.passes`), the
rest of the window as the residual plan over all rows;
`masked_gram_window_keyed_plain` is that arithmetic in plain torch
(`keyed_tables_plain`, `keyed_items`).

Past the crossover in d (`_build.dense_route`: 16 numeric columns and
up) D, the dense (1+d)×(1+d) block of [1 ‖ x] in S, leaves K7's plans:
the D kernel (`csrc/dense_gram.cu`, `dense_gram`; `launch_dense` from
every entry point above, counted in `dense_gram.launches`) computes it on
the tensor cores in 64 × 64 tiles of its upper triangle from K1's bf16
split, once a Gram (over all of S where `masked_gram` assembles it from
windows, over the window's tiles in `masked_gram_window`); K7 then
launches only where a plan has a task. `dense_gram_plain` and
`dense_tables_plain` are its plain versions.

`wide_tables_plain` computes K7's tables in plain torch (a plan's D
tiles after its slabs), and `wide_assemble` scatters tables into S
through the plan's map, as the kernels' reductions do: the CPU tests hold
the plan against the plain Gram and the JAX kernels with them.
"""
from __future__ import annotations

import dataclasses
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
    small = _small_cross(schema)
    if small:
        _small_cross_block(codes, valid, w, base, sizes, small, lo, hi, out)
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
            if k == j or kb <= ka or (j in small and k in small):
                continue                       # C_jk cut to k's window keys
            ck = codes[k]
            sel = ok & (ck >= ka) & (ck < kb)
            tab = torch.bincount(cj[sel] * (kb - ka) + ck[sel] - ka,
                                 weights=w[sel].to(f64),
                                 minlength=vj * (kb - ka))
            out[bj:bj + vj, bk + ka - lo:bk + kb - lo] = (
                tab.reshape(vj, kb - ka).float())


def _small_cross(schema: FeatureSchema) -> frozenset:
    """The columns whose cross tables `_window_tables` sums as one dense
    block (`_small_cross_block`): those of at most CM_SMALL levels, where
    they make more than CM_TABLES cross tables (the kernel's CM rule;
    SECOM's stream fold, 590 null flags); else none."""
    small = tuple(j for j, v in enumerate(schema.cat_sizes)
                  if 0 < v <= _build.CM_SMALL)
    sizes = tuple(schema.cat_sizes[j] for j in small)
    return frozenset(small if _build._cross_count(sizes) > _build.CM_TABLES
                     else ())


def _small_cross_block(codes, valid, w, base, sizes, small, lo, hi, out,
                       rows: int = 1 << 16) -> None:
    """The cross tables among the `small` columns, cut to the window [lo,
    hi), into out f32[P, hi − lo]: the f64 Gram Yᵀ·diag(w)·Y of their
    one-hot block Y, `rows` rows at a time (a column's own block: its
    counts on the diagonal, zeros off it)."""
    cols = sorted(small)
    pos = torch.cat([base[j] + torch.arange(sizes[j]) for j in cols]
                    ).to(w.device)
    at = torch.cat([torch.tensor([0]), torch.cumsum(torch.tensor(
        [sizes[j] for j in cols]), 0)]).tolist()
    keep = (pos >= lo) & (pos < hi)
    if not bool(keep.any()):
        return
    n, f64 = w.shape[0], torch.float64
    gram = torch.zeros((pos.shape[0], int(keep.sum())), dtype=f64,
                       device=w.device)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        y = torch.zeros((r1 - r0, pos.shape[0]), dtype=f64, device=w.device)
        for q, j in enumerate(cols):
            ok = valid[j][r0:r1]
            y[torch.nonzero(ok)[:, 0], at[q] + codes[j][r0:r1][ok]] = 1.0
        gram += (y * w[r0:r1, None].to(f64)).T @ y[:, keep]
    out[pos[:, None], (pos[keep] - lo)[None, :]] = gram.float()


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


def dense_tables_plain(x_cols, weights, tiles: torch.Tensor, d: int
                       ) -> torch.Tensor:
    """Plain torch version of the D kernel's arithmetic (csrc/dense_gram.cu)
    over the tiles (`_build.dense_tiles`): each tile's 64 × 64 cells (a, b)
    f64[T·DENSE_CELLS], tile after tile, a-major, each the f64 sum of the
    f32 products w·z_a (then times z_b, exact in f64), z = [1 ‖ x] padded
    with zero columns to whole tiles. x_cols d × f32[n], weights f32[n] or
    None."""
    x_cols = list(x_cols)
    first = (x_cols + [weights])[0]
    n, device = first.shape[-1], first.device
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    tb = _build.DENSE_TILE
    nb = int(tiles.max()) + 1
    z = torch.zeros((nb * tb, n), dtype=torch.float32, device=device)
    z[0] = 1.0
    if x_cols:
        z[1:1 + d] = torch.stack([x.to(torch.float32) for x in x_cols])
    full = (z * w).double() @ z.double().T     # f32 w·z_a, exact in f64
    return torch.cat([full[i * tb:(i + 1) * tb, j * tb:(j + 1) * tb]
                      .reshape(-1) for i, j in tiles.tolist()])


def dense_gram_plain(x_cols, weights, *, schema: FeatureSchema, lo: int = 0,
                     width: int | None = None, offsets=None) -> torch.Tensor:
    """Plain torch version of `dense_gram`: D's places of the window
    S[:, lo:lo + width] from the tiles' cells (`dense_tables_plain`), each
    rounded to f32 once and written where the kernel's reduction writes
    it, zeros elsewhere; f32[P, width], or with `offsets` (group-sorted
    rows, i64[G + 1]) f32[G, P, width], one group's rows each."""
    p, d = schema.sigma_size, schema.num_cols
    width = p - lo if width is None else width
    x_cols = list(x_cols)
    first = (x_cols + [weights])[0]
    n, device = first.shape[-1], first.device
    bounds = [0, n] if offsets is None else offsets.tolist()
    out = torch.zeros((len(bounds) - 1, p, width), dtype=torch.float32,
                      device=device)
    tiles = _build.dense_tiles(d, lo, lo + width)
    if tiles is not None:
        cell, i, j = (torch.from_numpy(v).long().to(device) for v in
                      _build.dense_map(tiles, d, (lo, lo + width)))
        for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            cells = dense_tables_plain(
                [x[a:b] for x in x_cols],
                None if weights is None else weights[a:b], tiles, d)
            out[g, i, j - lo] = cells[cell].float()
    return out[0] if offsets is None else out


def dense_gram(x_cols, weights, *, schema: FeatureSchema, lo: int = 0,
               width: int | None = None, offsets=None) -> torch.Tensor:
    """D on the tensor cores (csrc/dense_gram.cu): the places of D, the
    dense (1+d)×(1+d) block of [1 ‖ x] of the masked Gram, in the window
    S[:, lo:lo + width] (all of S by default), zeros elsewhere; f32[P,
    width], or with `offsets` (K8's group offsets of group-sorted rows,
    i64[G + 1]) one such window a group, f32[G, P, width]. What K7, K8 and
    K2w run for D past the crossover (`_build.dense_route`), here alone at
    any d. CUDA tensors launch the kernel (one launch, counted in
    `dense_gram.launches`, by every entry point that runs it); CPU tensors
    take `dense_gram_plain`."""
    x_cols = list(x_cols)
    if len(x_cols) != schema.num_cols or not x_cols:
        raise ValueError("dense_gram takes the schema's d ≥ 1 numeric "
                         "columns")
    p = schema.sigma_size
    width = p - lo if width is None else width
    tensors = x_cols + ([] if weights is None else [weights]) + (
        [] if offsets is None else [offsets])
    if _build.on_cpu(tensors):
        return dense_gram_plain(x_cols, weights, schema=schema, lo=lo,
                                width=width, offsets=offsets)
    n = x_cols[0].shape[-1]
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
    _build.check_window(schema, lo, width)
    groups = 1 if offsets is None else offsets.shape[0] - 1
    device = _build.check_cuda(
        tensors,
        [(t, torch.float32, (n,), f"x_cols[{j}]")
         for j, t in enumerate(x_cols)]
        + ([] if weights is None
           else [(weights, torch.float32, (n,), "weights")])
        + ([] if offsets is None
           else [(offsets, torch.int64, (groups + 1,), "offsets")]))
    _build.check_groups(groups)
    out = torch.zeros((groups, p, width), dtype=torch.float32, device=device)
    if n:
        if weights is None:
            weights = torch.ones(n, dtype=torch.float32, device=device)
        launch_dense(_build.load(), x_cols, weights, n, device, schema, lo,
                     width, out, width, p * width, offsets)
    return out[0] if offsets is None else out


dense_gram.launches = 0


def launch_dense(lib, x_cols, weights, n, device, schema, lo, width, out,
                 ld, gstride=0, offsets=None, far=None) -> None:
    """One launch of the D kernel and its reduction over the window [lo,
    lo + width): D's places (i, j) of group g written to out[g·gstride +
    i·ld + j − lo], out's other places untouched; K7, K8 and K2w run it
    past the crossover. offsets: group-sorted rows' i64[G + 1] (K8), else
    one group of all n rows; far: the columns' table (`_build.column_args`)
    if already made. Adds one to `dense_gram.launches`; launches nothing
    where the window holds no place of D."""
    d = schema.num_cols
    tiles = _device_tiles(d, lo, lo + width, _indexed(device))
    if tiles is None:
        return
    groups = 1 if offsets is None else offsets.shape[0] - 1
    slices = _build.dense_slices(n, d, groups)
    partial = torch.empty(groups * tiles.shape[0] * slices
                          * _build.DENSE_CELLS, dtype=torch.float64,
                          device=device)
    if far is None:
        far = _build.far_table(x_cols, [], (), device)
    with torch.cuda.device(device):
        rc = lib.lib.dit_dense_gram(
            _build.pointers(x_cols), d, far, weights.data_ptr(),
            None if offsets is None else offsets.data_ptr(), groups, n,
            schema.sigma_size, tiles.data_ptr(), tiles.shape[0], slices, lo,
            width, ld, gstride, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "dense_gram")
    dense_gram.launches += 1


def _launch(x_cols, code_cols, weights, n: int, device, schema,
            wrapper) -> torch.Tensor:
    """One launch of K1, or of K7 when P > 88, over per-column [n] tensors
    on `device`, checked first; shared by both entry points. Adds one to
    `wrapper.launches` (K1) or `wrapper.wide_launches` (K7) once the
    launch succeeded; past the crossover (`_build.dense_route`) D is the
    D kernel's (`launch_dense`), and K7 launches only where its plan has a
    task. No rows: no launch, a zero sigma."""
    what = wrapper.__name__
    p = schema.sigma_size
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
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
        out, launched = _launch_wide(x_cols, code_cols, weights, n, device,
                                     schema, lib, what)
        wrapper.wide_launches += launched
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


DEVICE_PLAN_SHARE = 0.5   # most of a device's spare memory the plans kept
                          # there (`_device_plan`) may hold: criteo_mid's 41
                          # windows (1.3e9 places, 21 GB of map) stay on an
                          # 80 GB card across the calls of one run


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """A plan's tensors on a device and the host numbers a launch reads,
    kept (`_device_plan`) without the host plan they were made from.

    tensors: the kernel's slab records (`WidePlan.device_slabs`),
      warp_begin, task_base, stage_cols, entries and, for a keyed plan,
      its task keys.
    shape: `WidePlan.shape_ints` (its slices entry unused).
    cells: task_base[T]. layer_keys: a keyed plan's (`KeyedPlan`)."""
    tensors: tuple
    shape: tuple
    cells: int
    layer_keys: tuple = ()

    @property
    def num_tasks(self) -> int:
        return self.shape[0]

    @property
    def max_task_cells(self) -> int:
        return self.shape[2]

    slices = _build.WidePlan.slices

    def shape_ints(self, slices: int) -> list[int]:
        return [*self.shape[:6], slices, self.shape[7]]


def device_plan(plan: _build.WidePlan, device,
                keyed: _build.KeyedPlan | None = None) -> DevicePlan:
    """`plan` on `device`, or with `keyed` (whose `plan` it is) that keyed
    plan with its task keys."""
    extra = (keyed.task_keys,) if keyed is not None else ()
    return DevicePlan(
        tensors=tuple(t.to(device) for t in (
            plan.device_slabs, plan.warp_begin, plan.task_base,
            plan.stage_cols, plan.entries, *extra)),
        shape=tuple(plan.shape_ints(0)), cells=int(plan.task_base[-1]),
        layer_keys=keyed.layer_keys if keyed is not None else ())


def _plan_device(plan: DevicePlan | torch.Tensor | None):
    """The device a kept plan or tile list lies on (None for none)."""
    if isinstance(plan, torch.Tensor):
        return plan.device
    return plan.tensors[0].device if plan is not None else None


def _plan_room(device, held: int) -> int:
    """The bytes the plans kept on `device` may hold: DEVICE_PLAN_SHARE of
    what is spare there beside them (free on the device, `mem_get_info`,
    or held unused by torch's allocator) and of what they hold, as a plan is kept; on the
    host, the host plans' bound."""
    if device is None or device.type != "cuda":
        return _build.PLAN_CACHE_BYTES
    free = torch.cuda.mem_get_info(device)[0]
    spare = (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return int(DEVICE_PLAN_SHARE * (free + spare + held))


_device_cache = _build.BytesCache(_plan_room, part=_plan_device)


@_device_cache
def _device_plan(d: int, sizes: tuple[int, ...], device, window=None,
                 keyed: bool = False) -> DevicePlan | None:
    """A plan on `device`: the whole plan's, or a window's residual plan's
    or (`keyed`) its keyed plan's with its task keys; None where the
    window has no such plan."""
    if window is None:
        return device_plan(_build._wide_plan(d, sizes), device)
    residual, kp = _build._keyed_window_plan(d, sizes, *window)
    if keyed:
        return kp and device_plan(kp.plan, device, kp)
    return residual and device_plan(residual, device)


@_device_cache
def _device_tiles(d: int, lo: int, hi: int, device) -> torch.Tensor | None:
    """The D tiles of the window [lo, hi) (`_build.dense_tiles`) on
    `device`, kept beside the plans; None where it holds no place of D."""
    tiles = _build.dense_tiles(d, lo, hi)
    return tiles if tiles is None else tiles.to(device)


def _indexed(device) -> torch.device:
    """`device` with its index, so that 'cuda' and a tensor's 'cuda:0'
    find one kept plan."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def window_plans(schema, lo: int, hi: int, device
                 ) -> tuple[DevicePlan | None, DevicePlan | None]:
    """The residual and keyed plans of the window [lo, hi) on `device`
    (`_build.keyed_window_plan`), either None where the window has none;
    made on the CPU once a schema and window, and kept on the device
    while it has room (`DEVICE_PLAN_SHARE`; `_device_plan.cache_clear()`
    frees them)."""
    _build.check_window(schema, lo, hi - lo)
    d, sizes, device = schema.num_cols, tuple(schema.cat_sizes), _indexed(
        device)
    return (_device_plan(d, sizes, device, (lo, hi)),
            _device_plan(d, sizes, device, (lo, hi), keyed=True))


def wide_plan_args(schema, n: int, device, groups: int = 1):
    """K7's plan as the C arguments of its entry points (the plan's device
    tensors, made once per schema and device; its shape and the row slices
    as a host array), the f64 scratch of the (task, slice + group)
    partials and the plan's task count (0 where D is all of it and on the
    tensor cores: `_build.dense_route`); shared with K2w, and with K8
    (`groups` > 1)."""
    plan = _device_plan(schema.num_cols, tuple(schema.cat_sizes),
                        _indexed(device))
    slices = plan.slices(n)
    partial = torch.empty(plan.cells * (slices + groups - 1),
                          dtype=torch.float64, device=device)
    args = (*(t.data_ptr() for t in plan.tensors),
            _build.int_array(plan.shape_ints(slices)))
    return args, partial, plan.num_tasks


def _launch_wide(x_cols, code_cols, weights, n, device, schema, lib, what):
    """S f32[P, P] by K7's one launch over its plan, where it has a task,
    and past the crossover the D kernel; (S, K7 launches)."""
    p = schema.sigma_size
    plan, partial, tasks = wide_plan_args(schema, n, device)
    out = torch.zeros((p, p), dtype=torch.float32, device=device)
    sizes = schema.cat_sizes
    cols = _build.column_args(x_cols, code_cols, sizes, device)
    if tasks:
        with torch.cuda.device(device):
            rc = lib.lib.dit_wide_gram(
                *cols, weights.data_ptr(), n, p,
                *plan, partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        _build.raise_on_error(lib, rc, what)
    if _build.dense_route(schema.num_cols):
        launch_dense(lib, x_cols, weights, n, device, schema, 0, p, out, p,
                     far=cols[-1])
    return out, int(tasks > 0)


def window_columns(schema, lows, width: int) -> tuple[int, ...]:
    """The keyed columns of the windows [lo, lo + width) for lo in
    `lows` (each cut at P): the columns one order pass sorts for them
    (`_build.window_keyed_columns`: found from the tables, no plan
    made)."""
    p, d, sizes = schema.sigma_size, schema.num_cols, tuple(schema.cat_sizes)
    cols = set()
    for lo in lows:
        cols.update(_build.window_keyed_columns(d, sizes, lo,
                                                min(lo + width, p)))
    return tuple(sorted(cols))


def _gram_windows(x_cols, code_cols, weights, n, device, schema, lib,
                  wrapper, counter: str) -> torch.Tensor:
    """S f32[P, P] by one K7 launch a column window of WINDOW_WIDTH,
    adding one to `wrapper.<counter>` a window where K7 launched, after
    one order pass (`window_order`) of the windows' keyed columns; past
    the crossover D by one launch of the D kernel over all of S first
    (each of its tiles once, where the windows would compute a tile that
    crosses two of them twice); shared by masked_gram(_cols) and K2w past
    MAX_WIDE_SIGMA_SIZE."""
    p = schema.sigma_size
    lows = range(0, p, _build.WINDOW_WIDTH)
    order = window_order(x_cols, code_cols, weights, schema=schema,
                         columns=window_columns(schema, lows,
                                                _build.WINDOW_WIDTH))
    out = torch.zeros((p, p), dtype=torch.float32, device=device)
    if _build.dense_route(schema.num_cols):
        launch_dense(lib, x_cols, weights, n, device, schema, 0, p, out, p,
                     far=_build.column_args(x_cols, code_cols,
                                            schema.cat_sizes, device)[-1])
    for lo in lows:
        if _launch_window(x_cols, code_cols, weights, n, device, schema, lo,
                          min(_build.WINDOW_WIDTH, p - lo), out[:, lo:], lib,
                          wrapper.__name__, order, dense=False):
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return out


def _launch_window(x_cols, code_cols, weights, n, device, schema, lo,
                   width, out, lib, what, order, plans=None,
                   dense: bool = True) -> bool:
    """K7 over the window [lo, lo + width) (`_build.keyed_window_plan`):
    its residual plan over all rows and its keyed tasks over `order`'s
    copies, writing S[:, lo:lo + width] into out f32[P, ld] (zeroed; its
    column 0 is the window's first), and with `dense`, past the crossover,
    D's tiles of the window (`launch_dense`). plans: (residual, keyed) on
    the device in place of the window's own (`window_plans`). Returns
    whether K7 launched (a task in either plan)."""
    residual, keyed = plans or window_plans(schema, lo, lo + width, device)
    sizes = schema.cat_sizes
    stream = torch.cuda.current_stream(device).cuda_stream
    cols = _build.column_args(x_cols, code_cols, sizes, device)
    if dense and _build.dense_route(schema.num_cols):
        launch_dense(lib, x_cols, weights, n, device, schema, lo, width, out,
                     out.stride(0), far=cols[-1])
    launched = keyed is not None
    if residual is not None and residual.num_tasks:
        launched = True
        slices = residual.slices(n)
        partial = torch.empty(residual.cells * slices,
                              dtype=torch.float64, device=device)
        with torch.cuda.device(device):
            rc = lib.lib.dit_wide_gram_window(
                *cols, weights.data_ptr(), n, schema.sigma_size, lo,
                width, out.stride(0),
                *(t.data_ptr() for t in residual.tensors),
                _build.int_array(residual.shape_ints(slices)),
                partial.data_ptr(), out.data_ptr(), stream)
        _build.raise_on_error(lib, rc, what)
    if keyed is not None:
        launch_keyed(keyed, order, n, device, schema, lo, width, out,
                     out.stride(0), 0, lib, what, cols[-1])
    return launched


def launch_keyed(keyed, order, n, device, schema, lo, width, out, ld,
                 gstride, lib, what, far) -> None:
    """One launch of the keyed tasks of the window [lo, lo + width)
    (`keyed`: its keyed plan on the device, `window_plans`) over `order`
    (`window_order`, with order.groups groups) and their reduction, each
    place (i, j) of group g written to out[g·gstride + i·ld + j − lo];
    shared by K7 and K8. far: the columns' table (`_build.column_args`),
    whose sizes the kernel reads past INLINE_COLS code columns."""
    tensors = keyed.tensors
    item_cum = keyed_items(keyed, order, n, schema, tensors[5])[0]
    items = _build.keyed_items_bound(keyed, n, order.groups)
    partial = torch.empty(items * keyed.max_task_cells,
                          dtype=torch.float64, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_wide_gram_keyed(
            _build.int_array(sizes), schema.num_cols, len(sizes), far, n,
            schema.sigma_size, lo, width, ld, gstride, order.rows.data_ptr(),
            order.rows.shape[-1], order.key_off.data_ptr(),
            order.key_chunks.data_ptr(), order.rows_of.data_ptr(),
            order.off_of.data_ptr(), tensors[5].data_ptr(),
            item_cum.data_ptr(), order.groups, _build.item_chunks(n), items,
            *(t.data_ptr() for t in tensors[:5]),
            _build.int_array(keyed.shape_ints(1)), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, what)


@dataclasses.dataclass(frozen=True)
class WindowOrder:
    """The rows in the order of each keyed column's codes
    (`window_order`): what the keyed tasks of a call's windows read.

    rows i32[Q, n, stride]: for the q-th ordered column, a row each of w,
      x (their f32 bits) and every code column, side by side
      (`_build.order_stride`), in that column's order.
    key_off i64[Σ_q (G·V_q + 1)]: for each ordered column J, its G·V_J + 1
      row offsets: the rows of group g and code u are off[g·V_J + u] ..
      off[g·V_J + u + 1] of its copy.
    key_chunks i64[as key_off]: each key's first chunk of WIDE_CHUNK rows,
      a key's chunks starting at its first row (`_build.group_chunks`).
    rows_of, off_of i64[c]: column J's first element in rows and in
      key_off (−1 for a column not ordered).
    groups: G (1 for K7; K8's groups)."""
    columns: tuple[int, ...]
    rows: torch.Tensor
    key_off: torch.Tensor
    key_chunks: torch.Tensor
    rows_of: torch.Tensor
    off_of: torch.Tensor
    groups: int


def window_order(x_cols, code_cols, weights, *, schema: FeatureSchema,
                 columns, offsets=None) -> WindowOrder | None:
    """One order of the rows for each column J of `columns` (None where
    there is none): stable by code_J, or with `offsets` (K8's group
    offsets i64[G + 1] of group-sorted rows) by g·V_J + code_J; rows with
    a code outside [0, V_J), and rows past offsets[G], come after every
    row with a key, where no task reads them. The keys' row offsets and a
    copy of w, x and every code column in that order, so that a keyed task
    reads its rows coalesced.

    CUDA tensors launch the order kernels (csrc/window_order.cu: a stable
    counting sort a keyed column, which writes each row's columns to their
    place; the rows without a key are not copied), counted in
    `window_order.launches`, one a column; CPU tensors take the plain
    version, a stable torch.sort of the keys and a gather of each column
    (the rows without a key copied last). Adds one to
    `window_order.passes` a call. Peak memory beside the inputs: the
    copies, `_build.order_stride(1 + d + c)`·n·4 bytes a column, and the
    kernels' counters (at most ORDER_CELLS of them, ~32 bytes each) or
    the sort's keys and order.
    x_cols d × f32[n], code_cols c × i32[n], weights f32[n]; ValueError
    where G·V_J ≥ 2³¹."""
    cpu = _build.on_cpu([weights] + list(x_cols) + list(code_cols))
    out = _window_order(x_cols, code_cols, weights, schema, columns, offsets,
                        _order_plain if cpu else _order_kernel)
    if out is not None:
        window_order.passes += 1
    return out


def window_order_plain(x_cols, code_cols, weights, *, schema: FeatureSchema,
                       columns, offsets=None) -> WindowOrder | None:
    """Plain torch version of `window_order` on any device (a stable
    torch.sort of each column's keys and a gather of each column), which
    its kernels equal over the rows with a key."""
    return _window_order(x_cols, code_cols, weights, schema, columns,
                         offsets, _order_plain)


def _window_order(x_cols, code_cols, weights, schema, columns, offsets,
                  order) -> WindowOrder | None:
    columns = tuple(columns)
    if not columns:
        return None
    x_cols, code_cols = list(x_cols), list(code_cols)
    n, device = weights.shape[-1], weights.device
    groups = 1 if offsets is None else offsets.shape[0] - 1
    sizes = schema.cat_sizes
    big = [j for j in columns if groups * sizes[j] >= 1 << 31]
    if big:
        raise ValueError(f"{groups} groups × {sizes[big[0]]} levels: the "
                         f"window order's keys take fewer than 2^31")
    src = ([weights.view(torch.int32)] + [x.view(torch.int32) for x in x_cols]
           + code_cols)
    stride = _build.order_stride(len(src))
    rows = torch.empty((len(columns), n, stride), dtype=torch.int32,
                       device=device)
    key_off, rows_of, off_of = [], [-1] * len(sizes), [-1] * len(sizes)
    at = 0
    for q, j in enumerate(columns):
        key_off.append(order(1 + len(x_cols) + j, sizes[j], offsets, groups,
                             src, rows[q]))
        rows_of[j], off_of[j] = q * n * stride, at
        at += groups * sizes[j] + 1
    chunks = torch.cat([_build.group_chunks(k, _build.WIDE_CHUNK)
                        for k in key_off])
    return WindowOrder(
        columns=columns, rows=rows, key_off=torch.cat(key_off),
        key_chunks=chunks,
        rows_of=torch.tensor(rows_of, dtype=torch.int64, device=device),
        off_of=torch.tensor(off_of, dtype=torch.int64, device=device),
        groups=groups)


window_order.passes = 0
window_order.launches = 0


def _order_plain(key_col, v, offsets, groups, src, out) -> torch.Tensor:
    """The plain version of one column's order: a stable torch.sort of
    the keys (g·v + code, code = src[key_col], or g·v for none), the keys'
    row offsets i64[G·v + 1] by a search of the sorted keys, the columns
    gathered into out i32[n, stride], a row's side by side (zeros past
    them)."""
    code = src[key_col]
    n = code.shape[-1]
    u = code.long()
    ok = (u >= 0) & (u < v)
    if offsets is not None:
        gid = torch.searchsorted(offsets, torch.arange(n, device=u.device),
                                 right=True) - 1
        ok &= gid < groups
        u = gid * v + u
    key = torch.where(ok, u, groups * v).to(torch.int32)
    keys, order = torch.sort(key, stable=True)
    out.zero_()
    for i, col in enumerate(src):
        out[:, i] = torch.index_select(col, 0, order)
    return torch.searchsorted(keys, torch.arange(
        groups * v + 1, dtype=torch.int32, device=u.device))


def _order_kernel(key_col, v, offsets, groups, src, out) -> torch.Tensor:
    """One column's order on the card (csrc/window_order.cu), its codes
    src[key_col]: the codes counted a segment (`_build.order_segments`),
    the counts scanned in (key, segment) order, each row with a key
    written with its columns to its row of out i32[n, stride]; returns
    the keys' row offsets i64[G·v + 1]. A row wider than two chunks of a
    warp's shared memory beside its counters is copied in pieces
    (`_build.order_piece`)."""
    piece = _build.order_piece(v, out.shape[-1])
    lib = _build.load()
    code = src[key_col]
    n, device = code.shape[-1], code.device
    segs = _build.order_segments(groups, v)
    counts = torch.empty(groups * segs * v, dtype=torch.int32, device=device)
    off = 0 if offsets is None else offsets.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.lib.dit_order_count(code.data_ptr(), v, off, groups, n,
                                     segs, counts.data_ptr(), stream)
        _build.raise_on_error(lib, rc, "window_order")
        by_key = counts.view(groups, segs, v).transpose(1, 2).reshape(-1)
        ends = torch.cumsum(by_key, 0, dtype=torch.int64)
        start = ends - by_key                 # (g, u, s) order
        key_off = torch.cat([start.view(groups * v, segs)[:, 0], ends[-1:]])
        pos = start.view(groups, v, segs).transpose(1, 2).to(
            torch.int32).contiguous()         # (g, s, u): a warp's row
        rc = lib.lib.dit_order_scatter(
            key_col, v, off, groups, n, segs, pos.data_ptr(),
            _build.pointers(src), len(src),
            _build.far_table(src, [], (), device),   # read past ORDER_INLINE
            out.shape[-1], piece, out.data_ptr(), stream)
        _build.raise_on_error(lib, rc, "window_order")
    window_order.launches += 1
    return key_off


def keyed_items(keyed: _build.KeyedPlan, order: WindowOrder, n: int,
                schema: FeatureSchema, task_keys=None):
    """The work items of a window's keyed tasks over `order`: each (task,
    group)'s chunks c0 .. c1 of its keys (each key's rows cut into chunks
    of WIDE_CHUNK from its first row: `order.key_chunks`), cut where they
    meet the blocks of m = `_build.item_chunks(n)` chunks of the column's
    copy, [b·m, (b + 1)·m): an item each, so the items that sum a key's
    chunks are the same in every task that holds the key. Its rows r0 ..
    r1 of its column's copy. Returns (item_cum i64[T·G + 1], the first
    item of each (task, group) in that order; c0, r0, r1 i64[T, G]) on the
    order's device, with no host sync: the same arithmetic the kernel's
    blocks read their items from.
    task_keys: the plan's on the device, if already there."""
    dev = order.key_off.device
    tk = (keyed.task_keys if task_keys is None else task_keys).to(dev).long()
    j, u_lo, u_hi = tk.unbind(1)
    v = torch.tensor(schema.cat_sizes, dtype=torch.int64, device=dev)[j]
    base = (order.off_of[j][:, None]
            + torch.arange(order.groups, device=dev)[None] * v[:, None])
    c0 = order.key_chunks[base + u_lo[:, None]]
    c1 = order.key_chunks[base + u_hi[:, None]]
    r0 = order.key_off[base + u_lo[:, None]]
    r1 = order.key_off[base + u_hi[:, None]]
    m = _build.item_chunks(n)
    items = torch.where(c1 > c0, (c1 + m - 1) // m - c0 // m, 0)
    return (torch.cat([items.new_zeros(1), torch.cumsum(items.reshape(-1),
                                                        0)]), c0, r0, r1)


def keyed_work(keyed: _build.KeyedPlan, order: WindowOrder, n: int,
               schema: FeatureSchema) -> dict:
    """What the keyed tasks of a window do over `order` (on the host):
    tasks, work items, the rows each layer's tasks walk in all (`rows`,
    keyed by the layer, its column and its key range), and the rows whose
    code lies in the layer's key range, which those must equal
    (`in_range`)."""
    item_cum, _, r0, r1 = keyed_items(keyed, order, n, schema)
    per_task = (r1 - r0).sum(1).tolist()
    rows, in_range = {}, {}
    for t, ly in enumerate(keyed.layer_of):
        j, a, b = keyed.layer_keys[ly]
        name = f"layer {ly}: column {j}, keys {a}-{b}"
        rows[name] = rows.get(name, 0) + per_task[t]
        if name not in in_range:
            size, base = schema.cat_sizes[j], int(order.off_of[j])
            off = order.key_off[base:base + order.groups * size + 1]
            g = torch.arange(order.groups, device=off.device) * size
            in_range[name] = int((off[g + b] - off[g + a]).sum())
    return dict(tasks=keyed.num_tasks, items=int(item_cum[-1]), rows=rows,
                in_range=in_range)


def masked_gram_window(x_cols, code_cols, weights, *, schema: FeatureSchema,
                       lo: int, width: int) -> torch.Tensor:
    """The column window S[:, lo:lo + width] f32[P, width] of the masked
    sigma of per-column inputs (as `masked_gram_cols`'s), any P up to
    `_build.MAX_WINDOW_SIGMA_SIZE`: the function of JAX's
    `ring/striped.py:sigma_stripe`. Peak device memory beside the inputs:
    the output, the window's plans (`_build.keyed_window_plan`: their map
    of one i32[4] entry a nonzero place; kept by `_device_plan`), K7's f64
    partials of their cells and, where the window keys a column, the
    order's copy of the columns (`window_order`, made by this call).

    CUDA tensors launch K7 over the window's plans (one launch, counted
    in `masked_gram_window.launches`, after an order pass where the window
    keys a column; a window of more than `_build.MAX_WINDOW_PLACES`
    places, as the whole S of criteo_c18, one launch a window of
    `_build.window_cuts`) and past the crossover the D kernel over the
    window's D tiles (`launch_dense`, counted in `dense_gram.launches`; K7
    then launches only where the window's plans have a task); CPU tensors
    take `masked_gram_window_plain`."""
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
    cuts = _build.window_cuts(schema, lo, lo + width)
    d, sizes = schema.num_cols, tuple(schema.cat_sizes)
    order = window_order(x_cols, code_cols, weights, schema=schema,
                         columns=sorted({j for a, b in cuts for j in
                                         _build.window_keyed_columns(
                                             d, sizes, a, b)}))
    for a, b in cuts:
        masked_gram_window.launches += _launch_window(
            x_cols, code_cols, weights, n, device, schema, a, b - a,
            out[:, a - lo:], _build.load(), "masked_gram_window", order)
    return out


masked_gram_window.launches = 0


def wide_tables_plain(x_cols, code_cols, weights, *, schema: FeatureSchema,
                      plan: _build.WidePlan | None = None) -> torch.Tensor:
    """Plain torch version of K7's tables: every cell of the plan
    (`_build.wide_plan(schema)`, or `plan`, e.g. a window's), task after
    task, f64[task_base[T]], each a sum in f64 of f32 products as the
    kernel forms them (w·x for K_j, (w·z_a)·z_b for D; bincount for
    C_jk); where the plan's D is the D kernel's (`plan.dense`), its tiles'
    cells follow (`dense_tables_plain`), f64[task_base[T] + tiles ·
    DENSE_CELLS]. x_cols d × f32[n], code_cols c × i32[n] (a code outside
    [0, size) adds nothing), weights f32[n] or None."""
    plan = _build.wide_plan(schema) if plan is None else plan
    x_cols, code_cols = list(x_cols), list(code_cols)
    n = (x_cols + code_cols + [weights])[0].shape[-1]
    device = (x_cols + code_cols + [weights])[0].device
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    xw = [w] + [x * w for x in x_cols]         # w·z_a, z = [1 ‖ x]
    out = torch.zeros(int(plan.task_base[-1]), dtype=torch.float64,
                      device=device)
    for slab, slot in zip(plan.slabs.tolist(), plan.slots.tolist()):
        at = int(plan.task_base[slab[6]]) + slab[5]
        cells = _slab_plain(slab, xw, x_cols, code_cols, w, schema,
                            rows=slot[2:])
        out[at:at + cells.shape[0]] = cells
    if plan.dense is not None:      # D's tiles, after the slabs' cells
        out = torch.cat([out, dense_tables_plain(x_cols, w, plan.dense,
                                                 schema.num_cols)])
    return out


def _slab_plain(slab, xw, x_cols, code_cols, w, schema,
                keys=None, rows=None) -> torch.Tensor:
    """One slab's cells f64 over the given rows (`wide_tables_plain`'s
    arithmetic); xw = [w, w·x_0, ...]; keys: the keyed task's (u_lo,
    u_hi), a CR slab's keys; rows: the slab's `WidePlan.slots` past its
    stage slots, a C or CB slab's rows (v_lo, v_hi), a K or KB slab's
    columns (a_lo, a_hi) of [1 ‖ x]."""
    kind, p0, p1, p2, p3 = slab[:5]
    f64 = torch.float64
    if kind == _build.SLAB_D:                  # (a, b) for b in [p1, p2)
        cells = [xw[p0] if b == 0 else xw[p0] * x_cols[b - 1]
                 for b in range(p1, p2)]
        return torch.stack(cells).to(f64).sum(1)
    if kind in (_build.SLAB_K, _build.SLAB_KB):   # column p0, keys [p1, p2)
        a_lo, a_hi = rows                      # columns of [1 ‖ x]
        c = code_cols[p0].long()
        ok = (c >= p1) & (c < p2)
        vals = torch.stack(xw[a_lo:a_hi], 1)[ok].to(f64)
        table = torch.zeros((p2 - p1, a_hi - a_lo), dtype=f64,
                            device=w.device)
        table.index_add_(0, c[ok] - p1, vals)
        return table.reshape(-1)
    if kind == _build.SLAB_CM:                 # key p0, rows p1 .. p2 − 1
        base = _build._bases(schema.num_cols, tuple(schema.cat_sizes))
        sizes, u = schema.cat_sizes, code_cols[p0].long()
        width = base[p2 - 1] + sizes[p2 - 1] - base[p1]
        out = torch.zeros(sizes[p0] * width, dtype=f64, device=w.device)
        for k in range(p1, p2):
            v = code_cols[k].long()
            ok = (u >= 0) & (u < sizes[p0]) & (v >= 0) & (v < sizes[k])
            out += torch.bincount(u[ok] * width + base[k] - base[p1] + v[ok],
                                  weights=w[ok].to(f64),
                                  minlength=out.shape[0])
        return out
    u, v = code_cols[p0].long(), code_cols[p1].long()
    if kind == _build.SLAB_CR:                 # keyed on p0, rows [p2, p3)
        ulo, uhi = keys
        ok = (u >= ulo) & (u < uhi) & (v >= p2) & (v < p3)
        return torch.bincount((u[ok] - ulo) * (p3 - p2) + v[ok] - p2,
                              weights=w[ok].to(f64),
                              minlength=(uhi - ulo) * (p3 - p2))
    vlo, vhi = rows                            # C, CB: keyed on p0, keys
    ok = (u >= p2) & (u < p3) & (v >= vlo) & (v < vhi)   # [p2, p3)
    return torch.bincount((u[ok] - p2) * (vhi - vlo) + v[ok] - vlo,
                          weights=w[ok].to(f64),
                          minlength=(p3 - p2) * (vhi - vlo))


def keyed_tables_plain(order: WindowOrder, keyed: _build.KeyedPlan, *,
                       schema: FeatureSchema, n: int) -> torch.Tensor:
    """Plain torch version of the keyed kernel's arithmetic over a
    window's keyed plan, used by no path: each task walks only its key
    range's rows of its column's copy in `order` (`window_order`), for
    each group, as work items of its keys' chunks cut at the blocks of
    `_build.item_chunks(n)` chunks (`keyed_items`; a key's chunks start at
    its first row); each item's cells of the task's slabs (the arithmetic
    of `wide_tables_plain`, f64 of f32 products) are added in f64, item
    after item. Returns f64[G, task_base[T]] (`wide_assemble` places them)."""
    plan = keyed.plan
    item_cum, c0, _, r1 = keyed_items(keyed, order, n, schema)
    items = (item_cum[1:] - item_cum[:-1]).reshape(c0.shape).tolist()
    c0, r1 = c0.tolist(), r1.tolist()
    m = _build.item_chunks(n)
    d, ncols = schema.num_cols, 1 + schema.num_cols + schema.cat_cols
    rows_f = order.rows.view(torch.float32)
    out = torch.zeros((order.groups, int(plan.task_base[-1])),
                      dtype=torch.float64, device=order.rows.device)
    slabs = [sl + slot[2:] for sl, slot in zip(plan.slabs.tolist(),
                                                plan.slots.tolist())]

    def first_row(j, g, chunk):
        """The first row of `chunk` of column j's keys of group g."""
        a = int(order.off_of[j]) + g * schema.cat_sizes[j]
        cum = order.key_chunks[a:a + schema.cat_sizes[j] + 1]
        u = int(torch.searchsorted(cum, torch.tensor([chunk],
                                                     device=cum.device),
                                   right=True)) - 1
        return (int(order.key_off[a + u])
                + (chunk - int(cum[u])) * _build.WIDE_CHUNK)

    for t, (j, ulo, uhi) in enumerate(keyed.task_keys.tolist()):
        q = order.columns.index(j)
        mine = [sl for sl in slabs if sl[6] == t]
        base = int(plan.task_base[t])
        for g in range(order.groups):
            for i in range(items[t][g]):       # the items, in order
                a = first_row(j, g, max(c0[t][g], (c0[t][g] // m + i) * m))
                b = (r1[t][g] if i + 1 == items[t][g]
                     else first_row(j, g, (c0[t][g] // m + i + 1) * m))
                w = rows_f[q, a:b, 0]
                xs = list(rows_f[q, a:b, 1:1 + d].T)
                cs = list(order.rows[q, a:b, 1 + d:ncols].T)
                xw = [w] + [x * w for x in xs]
                for sl in mine:
                    cells = _slab_plain(sl, xw, xs, cs, w, schema,
                                        (ulo, uhi), sl[8:])
                    out[g, base + sl[5]:base + sl[5] + cells.shape[0]] += (
                        cells)
    return out


def masked_gram_window_keyed_plain(x_cols, code_cols, weights, *,
                                   schema: FeatureSchema, lo: int,
                                   width: int, offsets=None) -> torch.Tensor:
    """Plain torch version of K7's (and with `offsets`, K8's) arithmetic
    over the window [lo, lo + width), used by no path: its residual plan's
    cells over all rows (`wide_tables_plain`, each group's rows in K8), its
    keyed tasks over the order of their columns (`window_order`,
    `keyed_tables_plain`), both placed through their maps
    (`wide_assemble`). f32[P, width], or f32[G, P, width] with `offsets`
    (group-sorted rows)."""
    x_cols, code_cols = list(x_cols), list(code_cols)
    n = (x_cols + code_cols + [weights])[0].shape[-1]
    device = (x_cols + code_cols + [weights])[0].device
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    residual, keyed = _build.keyed_window_plan(schema, lo, lo + width)
    bounds = [0, n] if offsets is None else offsets.tolist()
    groups = len(bounds) - 1
    out = torch.zeros((groups, schema.sigma_size, width),
                      dtype=torch.float32, device=device)
    if residual is not None:
        for g in range(groups):
            rows = slice(bounds[g], bounds[g + 1])
            out[g] += wide_assemble(wide_tables_plain(
                [x[rows] for x in x_cols], [c[rows] for c in code_cols],
                w[rows], schema=schema, plan=residual), schema=schema,
                plan=residual)
    if keyed is not None:
        order = window_order(x_cols, code_cols, w, schema=schema,
                             columns=keyed.columns, offsets=offsets)
        out += wide_assemble(keyed_tables_plain(order, keyed, schema=schema,
                                                n=n),
                             schema=schema, plan=keyed.plan)
    return out[0] if offsets is None else out


ASSEMBLE_ENTRIES = 1 << 22   # map entries `wide_assemble` places at a time:
                             # its int64 copy of them stays at 128 MB (a
                             # window of criteo_c18 maps 43M)


def wide_assemble(cells: torch.Tensor, *, schema: FeatureSchema,
                  plan: _build.WidePlan | None = None) -> torch.Tensor:
    """S f32[..., P, P] from the plan's cells f64[..., task_base[T]]
    (`wide_tables_plain`, or one per group): each cell rounded to f32 once
    and written to S[i, j] and S[j, i] through the plan's map, as the
    kernels' reduction does; the zero structure stays zero; a plan's D
    tiles (`plan.dense`) from the cells after its slabs'. A window's
    `plan` gives S[:, lo:hi] f32[..., P, hi − lo], one place an entry."""
    plan = _build.wide_plan(schema) if plan is None else plan
    p = schema.sigma_size
    lo, hi = plan.window or (0, p)
    base = plan.task_base.to(cells.device)
    out = torch.zeros(cells.shape[:-1] + (p * (hi - lo),),
                      dtype=torch.float32, device=cells.device)
    for a in range(0, plan.entries.shape[0], ASSEMBLE_ENTRIES):
        e = plan.entries[a:a + ASSEMBLE_ENTRIES].to(cells.device).long()
        vals = cells[..., base[e[:, 0]] + e[:, 1]].float()
        out[..., e[:, 2] * (hi - lo) + e[:, 3] - lo] = vals
        if plan.window is None:
            out[..., e[:, 3] * p + e[:, 2]] = vals
    if plan.dense is not None:      # D's tiles (`_build.dense_map`)
        cell, i, j = (torch.from_numpy(v).long().to(cells.device) for v in
                      _build.dense_map(plan.dense, schema.num_cols,
                                       plan.window))
        vals = cells[..., int(plan.task_base[-1]) + cell].float()
        out[..., i * (hi - lo) + j - lo] = vals
        if plan.window is None:
            out[..., j * p + i] = vals
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
