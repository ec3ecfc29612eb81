"""Cofactor aggregation (masked, grouped, NB) and the batched predictors.

Counterpart of `duckdb_imputation_tpu.ring.sum`. With the dense vocab
layout of `schema.FeatureSchema` the whole cofactor triple is one masked
Gram matrix:

    Zᵀ = [1 | X_num | onehot(X_cat)]ᵀ  ∈ f32[P, n],  P = 1 + d + V
    S  = Zᵀ · diag(w) · Z              (w = row mask / weights)

LAYOUT: features-first, x_num f32[d, n], codes i32[c, n], weights f32[n].
The predictors take the columnar carry of the MICE loops: lists of
per-column [n] tensors.

`masked_sigma` and `grouped_sigma` are the plain versions that the
hand-written Gram kernels (`ring.kernels.sigma_pallas.masked_gram_cols`,
`ring.kernels.sigma_pallas_grouped.grouped_gram`) are held against. They
form the kernels' f32 products, (z_i·w rounded to f32)·z_j, exactly, as
one f64 matmul per row chunk (and group), add the chunks in f64 and round
to f32 once: one-hot counts stay exact past 2²⁴ rows, the contract the
kernels keep, and the reference is at least as exact as the kernels it
checks (an f32 matmul's own sum over a 2¹⁷-row chunk erred by 1.1e-5 of
max|σ| at P = 492 on the H100, where the kernel erred by 3.3e-7).

The public aggregates (`sum_to_triple`, `sum_to_triple_grouped`,
`sum_to_nb_agg`, `sum_to_nb_agg_grouped`) take the kernel for tensors on a
CUDA device and the plain version on the CPU when left at 'auto'. Rows
whose group id lies outside [0, num_groups) are dropped; a code outside
[0, size) contributes nothing.
"""
from __future__ import annotations

import torch

from ..schema import FeatureSchema
from ..utils.precision import ieee_f32
from .triple import NBAgg, Triple, _map, triple_from_sigma

# Rows per chunk of the plain Gram accumulation.
ROW_CHUNK = 1 << 17


def onehot_block_t(codes: torch.Tensor, schema: FeatureSchema) -> torch.Tensor:
    """Bᵀ = concatenated per-column one-hots, f32[V, n], from codes i32[c, n].

    A code outside [0, size_j) (vocab miss, the find_in_array convention)
    yields an all-zero column for that categorical column."""
    n = codes.shape[-1]
    parts = []
    for j, size in enumerate(schema.cat_sizes):
        iota = torch.arange(size, dtype=codes.dtype, device=codes.device)
        parts.append((codes[j][None, :] == iota[:, None]).to(torch.float32))
    if not parts:
        return torch.zeros((0, n), dtype=torch.float32, device=codes.device)
    return torch.cat(parts, dim=0)


def onehot_block(codes_rowmajor: torch.Tensor,
                 schema: FeatureSchema) -> torch.Tensor:
    """B f32[n, V] from row-major codes i32[n, c] (the row-major helper of
    the predict paths and tests; the aggregates use `onehot_block_t`)."""
    return onehot_block_t(torch.as_tensor(codes_rowmajor).T, schema).T


def _zt_block(x_num: torch.Tensor, codes: torch.Tensor,
              schema: FeatureSchema) -> torch.Tensor:
    """Zᵀ f32[P, n]."""
    n = x_num.shape[-1] if x_num.shape[0] else codes.shape[-1]
    device = x_num.device if x_num.shape[0] else codes.device
    rows = [torch.ones((1, n), dtype=torch.float32, device=device)]
    if schema.num_cols:
        rows.append(x_num.to(torch.float32))
    if schema.cat_cols:
        rows.append(onehot_block_t(codes, schema))
    return torch.cat(rows, dim=0)


def _stack_cols(x_cols, code_cols, schema: FeatureSchema):
    """Lists of per-column [n] tensors -> stacked features-first blocks."""
    ref = x_cols[0] if schema.num_cols else code_cols[0]
    n = ref.shape[-1]
    x = (torch.stack(list(x_cols)) if schema.num_cols else
         torch.zeros((0, n), dtype=torch.float32, device=ref.device))
    c = (torch.stack(list(code_cols)) if schema.cat_cols else
         torch.zeros((0, n), dtype=torch.int32, device=ref.device))
    return x, c


def masked_sigma(x_num: torch.Tensor, codes: torch.Tensor,
                 weights: torch.Tensor | None, *,
                 schema: FeatureSchema) -> torch.Tensor:
    """S = Zᵀ diag(w) Z, f32[P, P], chunked over rows.

    x_num f32[d, n] features-first; codes i32[c, n]; weights f32[n] (None =
    all ones). Each chunk is one f64 matmul of (Zᵀ·w in f32) and Zᵀ;
    chunks are summed in f64 and rounded to f32 once."""
    ref = x_num if schema.num_cols else codes
    n = ref.shape[-1]
    p = schema.sigma_size
    acc = torch.zeros((p, p), dtype=torch.float64, device=ref.device)
    for lo in range(0, n, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n)
        zt = _zt_block(x_num[:, lo:hi], codes[:, lo:hi], schema)
        zw = zt if weights is None else zt * weights[lo:hi].to(torch.float32)
        acc += zw.double() @ zt.double().T
    return acc.to(torch.float32)


def _normalize_inputs(x_num, codes, weights):
    """None column blocks become empty ones on the other block's device.
    Returns (x f32[d, n], codes i32[c, n], weights f32[n] or None, n)."""
    if x_num is None and codes is None:
        raise ValueError("need x_num or codes")
    ref = x_num if x_num is not None else codes
    n, device = ref.shape[-1], ref.device
    if x_num is None:
        x_num = torch.zeros((0, n), dtype=torch.float32, device=device)
    if codes is None:
        codes = torch.zeros((0, n), dtype=torch.int32, device=device)
    if weights is not None:
        weights = weights.to(torch.float32)
    return x_num.to(torch.float32), codes.to(torch.int32), weights, n


def _on_cuda(*tensors) -> bool:
    return any(t is not None and t.device.type == "cuda" for t in tensors)


def sum_to_triple(x_num=None, codes=None, weights=None, *,
                  schema: FeatureSchema, backend: str = "auto") -> Triple:
    """The fused lift+sum aggregate `sum_to_triple_x_y(cols…)`: one masked
    sigma over x_num f32[d, n] and codes i32[c, n] (local codes), rows
    weighted by weights f32[n] (None = all ones; 0 filters a row out).

    backend: 'auto' (the kernel for CUDA tensors, plain on the CPU),
    'plain' (`masked_sigma`), or 'kernel' (K1 through its stacked entry
    point, `ring.kernels.sigma_pallas.masked_gram`)."""
    if backend not in ("auto", "plain", "kernel"):
        raise ValueError(f"backend must be 'auto', 'plain' or 'kernel', "
                         f"got {backend!r}")
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    if backend == "auto":
        backend = "kernel" if _on_cuda(x, c, w) else "plain"
    if backend == "kernel":
        from .kernels.sigma_pallas import masked_gram
        sigma = masked_gram(x, c, w, schema=schema)
    else:
        sigma = masked_sigma(x, c, w, schema=schema)
    return triple_from_sigma(sigma, schema.num_cols)


def grouped_sigma(x_num: torch.Tensor, codes: torch.Tensor,
                  weights: torch.Tensor | None, group_ids: torch.Tensor, *,
                  schema: FeatureSchema, num_groups: int) -> torch.Tensor:
    """Per-group masked sigma f32[G, P, P]: group g's sigma weights each
    row by w·[id == g], so an id outside [0, G) adds nothing. Each row
    chunk's Zᵀ is built once and multiplied once per group, as in
    `masked_sigma`: an f64 matmul of the f32 (Zᵀ·w_g) and Zᵀ; chunk sums
    are added in f64 and rounded once."""
    ref = x_num if schema.num_cols else codes
    n, p = ref.shape[-1], schema.sigma_size
    acc = torch.zeros((num_groups, p, p), dtype=torch.float64,
                      device=ref.device)
    gi = torch.arange(num_groups, device=ref.device)[:, None]
    for lo in range(0, n, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n)
        zt = _zt_block(x_num[:, lo:hi], codes[:, lo:hi], schema)
        wg = (group_ids[None, lo:hi] == gi).to(torch.float32)
        if weights is not None:
            wg = wg * weights[lo:hi].to(torch.float32)
        zt64 = zt.double()
        for g in range(num_groups):
            acc[g] += (zt * wg[g]).double() @ zt64.T
    return acc.to(torch.float32)


GROUPED_METHODS = ("auto", "masked", "sorted", "kernel")


def sum_to_triple_grouped(x_num, codes, group_ids, *, schema: FeatureSchema,
                          num_groups: int, weights=None,
                          method: str = "auto") -> Triple:
    """GROUP BY aggregation: one triple per group id in [0, num_groups);
    rows with other ids are dropped. Returns a Triple batched on [G].

    method:
      'masked' — plain: per-group weight masks over one pass of row chunks
        (`grouped_sigma`);
      'sorted' — plain: a stable sort by group id, then one masked sigma
        per contiguous segment (`grouped_gram_presorted_plain`);
      'kernel' — the grouped Gram kernels: the unsorted kernel (K4) up to
        `unsorted_group_limit(schema)` groups, a sort and the sorted-slab
        kernel (K5) above it, and above P = 88 a sort and the wide kernel
        (K8) (`sum_to_triple_grouped_kernel`);
      'auto' — 'kernel' for CUDA tensors; on the CPU 'sorted' when
        n·G ≥ 2²² and G > 2, else 'masked' (the JAX package's rule)."""
    if method not in GROUPED_METHODS:
        raise ValueError(f"method must be one of {GROUPED_METHODS}, "
                         f"got {method!r}")
    x, c, w, n = _normalize_inputs(x_num, codes, weights)
    g = group_ids.to(torch.int32)
    if method == "auto":
        if _on_cuda(x, c, w, g):
            method = "kernel"
        else:
            method = ("sorted" if n * num_groups >= (1 << 22)
                      and num_groups > 2 else "masked")
    if method == "kernel":
        from .kernels.sigma_pallas_grouped import sum_to_triple_grouped_kernel
        return sum_to_triple_grouped_kernel(x, c, g, schema=schema,
                                            num_groups=num_groups, weights=w)
    if method == "sorted":
        from .kernels.sigma_pallas_grouped import (
            grouped_gram_presorted_plain, sort_by_group)
        x_s, c_s, w_s, layout = sort_by_group(
            x, c, g, schema=schema, num_groups=num_groups, weights=w)
        sigma = grouped_gram_presorted_plain(x_s, c_s, w_s, layout,
                                             schema=schema)
    else:
        sigma = grouped_sigma(x, c, w, g, schema=schema,
                              num_groups=num_groups)
    return triple_from_sigma(sigma, schema.num_cols)


def _cat_contrib(seg: torch.Tensor, code: torch.Tensor,
                 size: int) -> torch.Tensor:
    """seg[code] for one categorical column, +0 for out-of-vocab or negative
    codes (matching one_hot's all-zero row). seg f32[size], code i32[n]."""
    padded = torch.cat([seg, seg.new_zeros(1)])
    safe = torch.where((code >= 0) & (code < size), code, size)
    return padded[safe.long()]


def linear_predict(theta: torch.Tensor, x_cols, code_cols, *,
                   schema: FeatureSchema) -> torch.Tensor:
    """θ·Z without materializing Z: ŷ[r] = θ₀ + Σⱼ θ₁₊ⱼ x[j,r] +
    Σ_c θ[offs_c + code[c,r]], added in exactly that order in f32."""
    d = schema.num_cols
    ref = x_cols[0] if d else code_cols[0]
    pred = theta[0].expand(ref.shape[-1])
    for j in range(d):
        pred = pred + theta[1 + j] * x_cols[j]
    offs = schema.offsets
    for cj, size in enumerate(schema.cat_sizes):
        seg = theta[1 + d + offs[cj]:1 + d + offs[cj + 1]]
        pred = pred + _cat_contrib(seg, code_cols[cj], size)
    return pred


def class_score(w_full: torch.Tensor, intercept: torch.Tensor, k: int,
                x_cols, code_cols, *, schema: FeatureSchema) -> torch.Tensor:
    """Score of class k, (WᵀZ + b)[k], in the summation order the fused
    kernel uses: (b_k + W₀ₖ), then each numeric term, then each categorical
    column's coefficient. The intercept is added in f32, so a -inf
    intercept (an empty LDA class) gives a -inf score, never NaN."""
    d = schema.num_cols
    ref = x_cols[0] if d else code_cols[0]
    s = (intercept[k] + w_full[0, k]).expand(ref.shape[-1])
    for j in range(d):
        s = s + w_full[1 + j, k] * x_cols[j]
    offs = schema.offsets
    for cj, size in enumerate(schema.cat_sizes):
        seg = w_full[1 + d + offs[cj]:1 + d + offs[cj + 1], k]
        s = s + _cat_contrib(seg, code_cols[cj], size)
    return s


def class_argmax(w_full: torch.Tensor, intercept: torch.Tensor, x_cols,
                 code_cols, *, schema: FeatureSchema) -> torch.Tensor:
    """argmax_k (WᵀZ + b)[k] without materializing Z or the [C, n] score
    block: classes stream with a running (best value, best index) pair and
    a strict `>`, so a tie goes to the LOWEST class index. W f32[P, C] in
    sigma layout, b f32[C]. Returns i32[n]."""
    d = schema.num_cols
    ref = x_cols[0] if d else code_cols[0]
    n = ref.shape[-1]
    best_v = torch.full((n,), -torch.inf, dtype=torch.float32,
                        device=ref.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=ref.device)
    for k in range(w_full.shape[1]):
        s = class_score(w_full, intercept, k, x_cols, code_cols,
                        schema=schema)
        upd = s > best_v
        best_v = torch.where(upd, s, best_v)
        best_i = torch.where(upd, k, best_i)
    return best_i


# ---------------------------------------------------------------------------
# Lift: per-row degree-1 aggregates
# ---------------------------------------------------------------------------

@ieee_f32()
def lift(x_num=None, codes=None, *, schema: FeatureSchema) -> Triple:
    """`to_cofactor(cols…)`: each row becomes a degree-1 triple (n = 1,
    lin = x, quad = x xᵀ, one-hot category sections). Returns a Triple
    batched on the row axis [n]."""
    x_num, codes, _, n = _normalize_inputs(x_num, codes, None)
    x = x_num.T
    b = onehot_block_t(codes, schema).T
    return Triple(n=torch.ones(n, dtype=torch.float32, device=x.device),
                  lin=x, quad=torch.einsum("ni,nj->nij", x, x), lin_cat=b,
                  num_cat=torch.einsum("ni,nv->niv", x, b),
                  cat_cat=torch.einsum("nu,nv->nuv", b, b))


def sum_triples(t: Triple, axis: int = 0) -> Triple:
    """`sum_triple(triple)`: reduce a batched triple along `axis`."""
    return _map(lambda a: a.sum(dim=axis), t)


def nb_lift(x_num=None, codes=None, *, schema: FeatureSchema) -> NBAgg:
    """`to_nb_agg(cols…)`: each row as a degree-1 NB aggregate, batched on
    the row axis [n]."""
    x_num, codes, _, n = _normalize_inputs(x_num, codes, None)
    x = x_num.T
    return NBAgg(n=torch.ones(n, dtype=torch.float32, device=x.device),
                 lin=x, quad_diag=x * x,
                 lin_cat=onehot_block_t(codes, schema).T)


def sum_nb_aggs(t: NBAgg, axis: int = 0) -> NBAgg:
    """`sum_nb_agg(agg)`: reduce a batched NB aggregate along `axis`."""
    return _map(lambda a: a.sum(dim=axis), t)


# ---------------------------------------------------------------------------
# Naive-Bayes aggregates
# ---------------------------------------------------------------------------

def _nb_feature_block(xn: torch.Tensor, cd: torch.Tensor,
                      schema: FeatureSchema) -> torch.Tensor:
    """F = [1 ‖ x ‖ x² ‖ onehot(codes)]ᵀ, f32[1+2d+V, n]: every NB section
    as one stacked feature matrix."""
    n = xn.shape[-1] if xn.shape[0] else cd.shape[-1]
    device = xn.device if xn.shape[0] else cd.device
    rows = [torch.ones((1, n), dtype=torch.float32, device=device)]
    if schema.num_cols:
        rows.append(xn)
        rows.append(xn * xn)
    if schema.cat_cols:
        rows.append(onehot_block_t(cd, schema))
    return torch.cat(rows, dim=0)


def _nb_sums(x_num: torch.Tensor, codes: torch.Tensor,
             weights: torch.Tensor | None, group_ids: torch.Tensor, *,
             schema: FeatureSchema, num_groups: int) -> torch.Tensor:
    """Per-group NB sums f32[F, G] as a segment-sum matmul F @ Wᵀ per row
    chunk, W[g, r] = w_r·[id_r == g] (an id outside [0, G) hits no
    group). The f32 features (x² rounded to f32, as the kernel forms it)
    and weights are multiplied and summed in f64, chunk sums added in f64
    and rounded once, as `masked_sigma` does: counts stay exact past 2²⁴
    rows, and x and x² sums are those of the kernel, which adds in f32
    only within its chunk of 256 rows."""
    ref = x_num if schema.num_cols else codes
    n = ref.shape[-1]
    f = 1 + 2 * schema.num_cols + schema.vocab_size
    acc = torch.zeros((f, num_groups), dtype=torch.float64,
                      device=ref.device)
    gi = torch.arange(num_groups, device=ref.device)[:, None]
    for lo in range(0, n, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n)
        feats = _nb_feature_block(x_num[:, lo:hi], codes[:, lo:hi], schema)
        wmat = (group_ids[None, lo:hi] == gi).to(torch.float32)
        if weights is not None:
            wmat = wmat * weights[lo:hi]
        acc += feats.double() @ wmat.double().T
    return acc.to(torch.float32)


def _nb_from_sums(sums: torch.Tensor, schema: FeatureSchema) -> NBAgg:
    """NBAgg batched on [G] from sums f32[F, G]."""
    d = schema.num_cols
    g = sums.T                                       # [G, F]
    return NBAgg(n=g[..., 0], lin=g[..., 1:1 + d],
                 quad_diag=g[..., 1 + d:1 + 2 * d], lin_cat=g[..., 1 + 2 * d:])


def _nb_agg(x_num, codes, group_ids, weights, *, schema: FeatureSchema,
            num_groups: int, backend: str) -> NBAgg:
    """Shared dispatch of the NB aggregates: an NBAgg batched on [G]."""
    if backend not in ("auto", "plain", "kernel"):
        raise ValueError(f"backend must be 'auto', 'plain' or 'kernel', "
                         f"got {backend!r}")
    x, c, w, _ = _normalize_inputs(x_num, codes, weights)
    g = group_ids.to(torch.int32)
    if backend == "auto":
        backend = "kernel" if _on_cuda(x, c, w, g) else "plain"
    if backend == "kernel":
        from .kernels.nb_pallas import sum_to_nb_agg_grouped_kernel
        return sum_to_nb_agg_grouped_kernel(x, c, g, schema=schema,
                                            num_groups=num_groups, weights=w)
    return _nb_from_sums(_nb_sums(x, c, w, g, schema=schema,
                                  num_groups=num_groups), schema)


def sum_to_nb_agg(x_num=None, codes=None, weights=None, *,
                  schema: FeatureSchema, backend: str = "auto") -> NBAgg:
    """The NB aggregate `sum_to_nb_agg_x_y(cols…)`: n, lin, the diagonal
    of quad and the category counts in one pass (the G = 1 case of the
    grouped sums). backend: 'auto' | 'plain' | 'kernel' (K6)."""
    ref = x_num if x_num is not None else codes
    zeros = torch.zeros(ref.shape[-1], dtype=torch.int32, device=ref.device)
    agg = _nb_agg(x_num, codes, zeros, weights, schema=schema,
                  num_groups=1, backend=backend)
    return _map(lambda a: a[0], agg)


def sum_to_nb_agg_grouped(x_num, codes, group_ids, *, schema: FeatureSchema,
                          num_groups: int, weights=None,
                          backend: str = "auto") -> NBAgg:
    """Grouped NB aggregate, one NBAgg per group id in [0, num_groups)
    (GROUP BY label) in one data pass; rows with other ids are dropped.
    backend: 'auto' (K6 through `sum_to_nb_agg_grouped_kernel` for CUDA
    tensors, plain on the CPU) | 'plain' | 'kernel'."""
    return _nb_agg(x_num, codes, group_ids, weights, schema=schema,
                   num_groups=num_groups, backend=backend)
