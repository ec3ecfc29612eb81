"""K2 and K2w: the fused impute+aggregate pass — one table pass per MICE
column step.

Counterpart of `fused_impute_aggregate` in
`duckdb_imputation_tpu/ring/kernels/sigma_fused.py` (the Pallas kernels
`_fused_impute_aggregate_v3` and `_fused_impute_aggregate_v2`). Per row:

  1. score the previous column's model: R class scores (kind 'cat') or one
     prediction (kind 'num'), from coefficients in sigma layout
     w_full f32[P, R] plus intercept f32[R], added in f32;
  2. 'cat': take the argmax, a tie going to the LOWEST class index;
     'num': optionally add std·N(0, 1) noise;
  3. write the new value where `null_imp` is set;
  4. accumulate the row's UPDATED Z, weighted by `w_agg` (the next column's
     observed mask), into the masked Gram.

Returns (new_column, sigma). The inputs are not modified.

The coefficients ride in unpacked: the JAX package's bf16 hi/lo `lhs`
operand (pack_lhs) exists only for the TPU's matrix unit.

Noise is one counter-based Philox4x32-10 draw keyed by the seed, with
counter (global row, round, column), turned into N(0, 1) by Box-Muller.
A row shard passes `row_offset`, the global id of its first row, so a
row's draw is the same for any number of shards.
`philox_normal` computes it here with int64 torch ops masked to 32 bits;
the CUDA kernel computes the same bits, so the two versions draw the same
numbers up to float rounding in log and cos. This replaces both the Pallas
PRNG and the JAX loop's integer-hash seed, and it exists for every schema.

`fused_impute_aggregate` launches the CUDA kernels
(`csrc/fused_impute_aggregate.cu`) for CUDA tensors: K2 for P ≤ 88 (on
the tensor cores, K1's kernel with an impute prologue, where S is its one
output tile, `_build.tc_fits`: `fused_impute_aggregate_split_plain` is
that route's arithmetic in plain torch; on the CUDA cores otherwise), K2w
above (an impute kernel over the null rows with W's class tiles in shared
memory, `_build.impute_plan`, whose first-max merge across tiles
`class_argmax_tiles_plain` repeats, then K7's wide Gram over the updated
columns) up to P = 1,024, and past it, up to K7's window limit, the same
impute kernel with W read from device memory (`_build.impute_global_plan`)
and then K7 once a column window of `_build.WINDOW_WIDTH`, as
`masked_gram_cols` builds S there. Past the crossover in d
(`_build.dense_route`) D of the updated columns is the D kernel's
(`sigma_pallas.launch_dense`, after the impute kernel), and K7 runs only
where its plans have a task. It takes `fused_impute_aggregate_plain`
only for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from ...schema import FeatureSchema
from ..sum import class_argmax, class_score
from . import _build
from .sigma_pallas import (_gram_windows, launch_dense,
                           masked_gram_cols_plain, masked_gram_split_plain,
                           wide_plan_args)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_KINDS = {"cat": 0, "num": 1}


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit halves of m·c for m, c < 2³², without overflowing
    int64: m is split into 16-bit halves."""
    p_lo = c * (m & 0xFFFF)
    p_hi = c * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words.
    ctr: 4 words, key: 2 ints. Returns the 4 output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_normal(seed: int, round_: int, column: int, n: int,
                  device=None, rows: torch.Tensor | None = None,
                  row_offset: int = 0) -> torch.Tensor:
    """N(0, 1) f32[n], row r drawn from Philox4x32-10 with key = seed and
    counter = (r, round, column): Box-Muller on the first two words, each
    mapped to (0, 1] as ((bits >> 8) + 1)·2⁻²⁴. rows: the global row ids
    int64[n] to key by (default row_offset + arange(n)), so a row's draw
    does not depend on where it sits in a compact sub-table or a shard."""
    if rows is None:
        rows = row_offset + torch.arange(n, dtype=torch.int64, device=device)
    c0, c1, _, _ = philox4x32_10(
        (rows & _MASK32, rows >> 32, round_ & _MASK32, column & _MASK32),
        (seed & _MASK32, (seed >> 32) & _MASK32))
    u1 = ((c0 >> 8) + 1).to(torch.float32) * 2.0 ** -24
    u2 = ((c1 >> 8) + 1).to(torch.float32) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def _check_noise(noise, kind: str, row_offset: int):
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if noise is None:
        return
    if kind != "num":
        raise ValueError("noise applies to numeric columns only")
    seed, round_, _ = noise
    if not (0 <= seed < 1 << 64 and 0 <= round_ < 1 << 32):
        raise ValueError("noise seed must lie in [0, 2^64), round in "
                         "[0, 2^32)")


def _impute_plain(x_cols, code_cols, null_imp, w_full, intercept, *,
                  schema, kind, imp_col, noise, row_offset):
    """The new column and the columns with it in place."""
    _check_noise(noise, kind, row_offset)
    x_cols, code_cols = list(x_cols), list(code_cols)
    if kind == "cat":
        pred = class_argmax(w_full, intercept, x_cols, code_cols,
                            schema=schema)
        new = torch.where(null_imp, pred, code_cols[imp_col])
        code_cols[imp_col] = new
    else:
        pred = class_score(w_full, intercept, 0, x_cols, code_cols,
                           schema=schema)
        if noise is not None:
            seed, round_, std = noise
            pred = pred + std * philox_normal(seed, round_, imp_col,
                                              pred.shape[0], pred.device,
                                              row_offset=row_offset)
        new = torch.where(null_imp, pred, x_cols[imp_col])
        x_cols[imp_col] = new
    return new, x_cols, code_cols


def fused_impute_aggregate_plain(x_cols, code_cols, null_imp, w_agg, w_full,
                                 intercept, *, schema: FeatureSchema,
                                 kind: str, imp_col: int, noise=None,
                                 row_offset: int = 0):
    """Plain torch version of `fused_impute_aggregate`."""
    new, x_cols, code_cols = _impute_plain(
        x_cols, code_cols, null_imp, w_full, intercept, schema=schema,
        kind=kind, imp_col=imp_col, noise=noise, row_offset=row_offset)
    return new, masked_gram_cols_plain(x_cols, code_cols, w_agg,
                                       schema=schema)


def fused_impute_aggregate_split_plain(x_cols, code_cols, null_imp, w_agg,
                                       w_full, intercept, *,
                                       schema: FeatureSchema, kind: str,
                                       imp_col: int, noise=None,
                                       row_offset: int = 0):
    """Plain torch version of K2's tensor-core route, used by no path:
    the column imputed as `fused_impute_aggregate_plain` imputes it (the
    kernel scores each null row in class_score's f32 order), then K1's
    Gram of three-way bf16 parts (`masked_gram_split_plain`) of the
    updated columns."""
    new, x_cols, code_cols = _impute_plain(
        x_cols, code_cols, null_imp, w_full, intercept, schema=schema,
        kind=kind, imp_col=imp_col, noise=noise, row_offset=row_offset)
    return new, masked_gram_split_plain(x_cols, code_cols, w_agg,
                                        schema=schema)


_KEY_NEG_INF = 0x007FFFFF   # score_key(-inf)


def score_key_plain(v: torch.Tensor) -> torch.Tensor:
    """K2w's order-preserving key of f32 scores (fused_impute_aggregate.cu:
    score_key), as int64: -0 taken as +0, NaN 0 (below every score), else
    the bits with the sign bit set for v ≥ 0 and all bits flipped for
    v < 0."""
    u = (v.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    u = u & _MASK32
    key = torch.where(u >= 1 << 31, _MASK32 - u, u | 1 << 31)
    return torch.where(torch.isnan(v), 0, key)


def class_argmax_tiles_plain(w_full, intercept, x_cols, code_cols, *,
                             schema: FeatureSchema, ld: int) -> torch.Tensor:
    """Plain torch version of K2w's class-tiled first max, used by no
    path: the classes in tiles of `ld`; a tile's best is its largest key
    (`score_key_plain`) and the lowest class that reaches it, and a row's
    running (key, class), from (key of -inf, 0), takes a tile's best only
    if its key is strictly larger. Equal to `class_argmax`: the first max,
    class 0 when every score is -inf or NaN. Returns i32[n]."""
    d = schema.num_cols
    ref = x_cols[0] if d else code_cols[0]
    n, r = ref.shape[-1], w_full.shape[1]
    best_key = torch.full((n,), _KEY_NEG_INF, dtype=torch.int64,
                          device=ref.device)
    best = torch.zeros(n, dtype=torch.int32, device=ref.device)
    for k0 in range(0, r, ld):
        keys = torch.stack([score_key_plain(class_score(
            w_full, intercept, k, x_cols, code_cols, schema=schema))
            for k in range(k0, min(r, k0 + ld))])
        top = keys.max(0).values
        first = k0 + (keys == top).to(torch.int8).argmax(0).to(torch.int32)
        upd = top > best_key
        best_key = torch.where(upd, top, best_key)
        best = torch.where(upd, first, best)
    return best


def fused_impute_aggregate(x_cols, code_cols, null_imp, w_agg, w_full,
                           intercept, *, schema: FeatureSchema, kind: str,
                           imp_col: int, noise=None, row_offset: int = 0):
    """One fused pass. x_cols d × f32[n], code_cols c × i32[n]; null_imp
    bool[n] (True = impute); w_agg f32[n]; w_full f32[P, R] (R = the
    label's vocab size for 'cat', 1 for 'num'); intercept f32[R];
    noise = (seed, round, std f32[1] tensor) or None, 'num' only;
    row_offset: the global id of row 0, which the noise is keyed by.

    Returns (new_column, sigma f32[P, P]): i32[n] for 'cat', f32[n] for
    'num'. CUDA tensors launch K2 for P ≤ 88, on the tensor cores where
    `_build.tc_fits`, else on the CUDA cores (counted in
    `fused_impute_aggregate.launches`), or K2w above (counted in
    `fused_impute_aggregate.wide_launches`), or past MAX_WIDE_SIGMA_SIZE
    K2w's impute kernel (`.impute_launches`) and K7 over each column window
    of the updated columns (`.window_launches`); at n = 0 they launch
    nothing and return a zero sigma. CPU tensors take the plain
    version."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'cat' or 'num', got {kind!r}")
    x_cols, code_cols = list(x_cols), list(code_cols)
    if len(x_cols) != schema.num_cols or len(code_cols) != schema.cat_cols:
        raise ValueError("column counts do not match the schema")
    _check_noise(noise, kind, row_offset)
    std = None if noise is None else torch.as_tensor(noise[2]).reshape(1)
    tensors = (x_cols + code_cols + [null_imp, w_agg, w_full, intercept]
               + ([] if std is None else [std]))
    if _build.on_cpu(tensors):
        return fused_impute_aggregate_plain(
            x_cols, code_cols, null_imp, w_agg, w_full, intercept,
            schema=schema, kind=kind, imp_col=imp_col, noise=noise,
            row_offset=row_offset)
    n = null_imp.shape[-1]
    p = schema.sigma_size
    _build.check_schema(schema, n, _build.MAX_WINDOW_SIGMA_SIZE)
    if kind == "cat":
        if not 0 <= imp_col < schema.cat_cols:
            raise ValueError(f"imp_col {imp_col} is not a categorical column")
        r = schema.cat_sizes[imp_col]
    else:
        if not 0 <= imp_col < schema.num_cols:
            raise ValueError(f"imp_col {imp_col} is not a numeric column")
        r = 1
    device = _build.check_cuda(
        tensors,
        [(t, torch.float32, (n,), f"x_cols[{j}]")
         for j, t in enumerate(x_cols)]
        + [(t, torch.int32, (n,), f"code_cols[{j}]")
           for j, t in enumerate(code_cols)]
        + [(null_imp, torch.bool, (n,), "null_imp"),
           (w_agg, torch.float32, (n,), "w_agg"),
           (w_full, torch.float32, (p, r), "w_full"),
           (intercept, torch.float32, (r,), "intercept")]
        + ([] if std is None else [(std, torch.float32, (1,), "std")]))
    new = torch.empty(n, device=device,
                      dtype=torch.int32 if kind == "cat" else torch.float32)
    if n == 0:
        return new, torch.zeros((p, p), dtype=torch.float32, device=device)
    lib = _build.load()
    seed, round_ = (0, 0) if noise is None else noise[:2]
    sizes = schema.cat_sizes
    cols = (_build.pointers(x_cols), len(x_cols), _build.pointers(code_cols),
            _build.int_array(sizes), len(sizes))
    args = (null_imp.data_ptr(),
            w_agg.data_ptr(), w_full.data_ptr(), intercept.data_ptr(), r,
            _KINDS[kind], imp_col, new.data_ptr(), int(noise is not None),
            seed & _MASK32, (seed >> 32) & _MASK32, round_, row_offset,
            None if std is None else std.data_ptr(), n, p)
    stream = torch.cuda.current_stream(device).cuda_stream
    if p > _build.MAX_WIDE_SIGMA_SIZE:
        return new, _fused_windows(
            lib, x_cols, code_cols, null_imp, w_agg, w_full, intercept, new,
            r, kind, imp_col, noise, row_offset, std, n, schema, device,
            stream)
    if p > _build.MAX_SIGMA_SIZE:   # K2w: K7's plan, then scratch
        plan, partial, _ = wide_plan_args(schema, n, device)
        imp_plan = _build.int_array(_build.impute_plan(schema, r))
        rows = torch.empty(n if kind == "cat" else 0, dtype=torch.int32,
                           device=device)
        sigma = torch.zeros((p, p), dtype=torch.float32, device=device)
        far = _build.far_table(x_cols, code_cols, sizes, device)
        if kind == "cat":           # the Gram's columns: `new` in place
            gram_cols = (x_cols, code_cols[:imp_col] + [new]
                         + code_cols[imp_col + 1:])
        else:
            gram_cols = (x_cols[:imp_col] + [new] + x_cols[imp_col + 1:],
                         code_cols)
        far_out = (_build.far_table(*gram_cols, sizes, device)
                   if far and imp_col >= _build.INLINE_COLS else far)
        with torch.cuda.device(device):
            rc = lib.lib.dit_fused_impute_aggregate_wide(
                *cols, far, far_out, *args, *plan, imp_plan,
                rows.data_ptr(), partial.data_ptr(), sigma.data_ptr(),
                stream)
        _build.raise_on_error(lib, rc, "fused_impute_aggregate")
        fused_impute_aggregate.wide_launches += 1
        if _build.dense_route(schema.num_cols):   # D of the updated columns
            launch_dense(lib, gram_cols[0], w_agg, n, device, schema, 0, p,
                         sigma, p, far=far_out)
        return new, sigma
    if _build.tc_fits(schema.num_cols, p):     # K2 on the tensor cores
        nblocks = _build.tc_grid(n)
        entries, launch = _build.TC_A ** 2, lib.lib.dit_fused_impute_aggregate
    else:                                      # K2 on the CUDA cores
        nblocks = _build.grid_blocks(n)
        entries = lib.lib.dit_gram_entries(p)
        launch = lib.lib.dit_fused_impute_aggregate_cores
    partial = torch.empty(entries * nblocks, dtype=torch.float64,
                          device=device)
    sigma = torch.empty((p, p), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = launch(*cols, *args, partial.data_ptr(), nblocks,
                    sigma.data_ptr(), stream)
    _build.raise_on_error(lib, rc, "fused_impute_aggregate")
    fused_impute_aggregate.launches += 1
    return new, sigma


def _fused_windows(lib, x_cols, code_cols, null_imp, w_agg, w_full,
                   intercept, new, r, kind, imp_col, noise, row_offset, std,
                   n, schema, device, stream):
    """K2w past MAX_WIDE_SIGMA_SIZE: the impute kernel into `new`, then K7
    over each column window of the columns with `new` in place; returns
    sigma f32[P, P]."""
    w, ldw, plan, rows = impute_wide_inputs(w_full, intercept, r, kind, n,
                                            schema, device)
    impute_wide(lib, x_cols, code_cols, null_imp, w, intercept, ldw, plan,
                rows, new, r, kind, imp_col, noise, row_offset, std, n,
                schema, device, stream)
    if kind == "cat":
        code_cols = code_cols[:imp_col] + [new] + code_cols[imp_col + 1:]
    else:
        x_cols = x_cols[:imp_col] + [new] + x_cols[imp_col + 1:]
    return _gram_windows(x_cols, code_cols, w_agg, n, device, schema, lib,
                         fused_impute_aggregate, "window_launches")


def impute_wide_inputs(w_full, intercept, r, kind, n, schema, device):
    """The inputs of K2w's impute kernel past MAX_WIDE_SIGMA_SIZE: (W, its
    row stride ldw, the lane plan, the null-row scratch). For 'cat', W is
    w_full padded to [P + 2][ldw] (W read from device memory), a row of
    zeros and the intercept after its P rows; for 'num', w_full itself."""
    p = schema.sigma_size
    if kind != "cat":
        return w_full, 1, (0, 0, 0), torch.empty(0, dtype=torch.int32,
                                                  device=device)
    plan = _build.impute_global_plan(schema, r)
    ldw = -(-r // plan[0]) * plan[0]
    w = torch.zeros((p + 2, ldw), dtype=torch.float32, device=device)
    w[:p, :r] = w_full
    w[p + 1, :r] = intercept
    return w, ldw, plan, torch.empty(n, dtype=torch.int32, device=device)


def impute_wide(lib, x_cols, code_cols, null_imp, w, intercept, ldw, plan,
                rows, new, r, kind, imp_col, noise, row_offset, std, n,
                schema, device, stream) -> None:
    """One launch of K2w's impute kernel past MAX_WIDE_SIGMA_SIZE over the
    inputs of `impute_wide_inputs`, writing the imputed column into `new`;
    adds one to `fused_impute_aggregate.impute_launches`."""
    seed, round_ = (0, 0) if noise is None else noise[:2]
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_impute_wide(
            *_build.column_args(x_cols, code_cols, sizes, device),
            null_imp.data_ptr(),
            w.data_ptr(), intercept.data_ptr(), ldw, r, _KINDS[kind],
            imp_col, new.data_ptr(), int(noise is not None), seed & _MASK32,
            (seed >> 32) & _MASK32, round_, row_offset,
            None if std is None else std.data_ptr(), n, schema.sigma_size,
            _build.int_array(plan), rows.data_ptr(), stream)
    _build.raise_on_error(lib, rc, "fused_impute_aggregate")
    fused_impute_aggregate.impute_launches += 1


fused_impute_aggregate.launches = 0
fused_impute_aggregate.wide_launches = 0
fused_impute_aggregate.impute_launches = 0
fused_impute_aggregate.window_launches = 0
