"""Masked cofactor aggregation and the batched predictors, in plain torch.

Counterpart of `duckdb_imputation_tpu.ring.sum` for the MICE slice. With the
dense vocab layout of `schema.FeatureSchema` the whole cofactor triple is
one masked Gram matrix:

    Zᵀ = [1 | X_num | onehot(X_cat)]ᵀ  ∈ f32[P, n],  P = 1 + d + V
    S  = Zᵀ · diag(w) · Z              (w = row mask / weights)

LAYOUT: features-first, x_num f32[d, n], codes i32[c, n], weights f32[n].
The predictors take the columnar carry of the MICE loops: lists of
per-column [n] tensors.

`masked_sigma` is the plain version that the hand-written Gram kernel
(`ring.kernels.sigma_pallas.masked_gram_cols`) is held against. Each row
chunk's Gram is one f32 matmul (TF32 must be off on the card: callers set
`torch.backends.cuda.matmul.allow_tf32 = False`); the chunk sums are added
in f64 and rounded to f32 once, so one-hot counts stay exact past 2²⁴
rows, the same contract the kernel keeps.
"""
from __future__ import annotations

import torch

from ..schema import FeatureSchema

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
    all ones). Each chunk is one f32 matmul; chunks are summed in f64."""
    ref = x_num if schema.num_cols else codes
    n = ref.shape[-1]
    p = schema.sigma_size
    acc = torch.zeros((p, p), dtype=torch.float64, device=ref.device)
    for lo in range(0, n, ROW_CHUNK):
        hi = min(lo + ROW_CHUNK, n)
        zt = _zt_block(x_num[:, lo:hi], codes[:, lo:hi], schema)
        zw = zt if weights is None else zt * weights[lo:hi].to(torch.float32)
        acc += (zw @ zt.T).double()
    return acc.to(torch.float32)


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
