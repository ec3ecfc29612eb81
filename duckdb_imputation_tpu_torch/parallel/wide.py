"""Wide-V training: the MICE column steps solved against a sigma whose
COLUMNS are split over the grid's 'model' ranks; no rank holds all of it.

Counterpart of `duckdb_imputation_tpu.parallel.wide` (`sigma_wide`,
`cg_solve_wide`, `linreg_train_wide`, `predict_wide`,
`mice_column_step_wide`, `lda_solve_wide`, `lda_predict_wide`,
`mice_cat_step_wide`, `run_mice_wide`). At wide V the dense quad_cat
section is V×V (V = 64k ⇒ 16 GB f32), so sigma stays split through the
SOLVE, not only through the aggregation:

  * aggregation: each rank's block S[:, cols_m] of its data rank's rows,
    summed over 'data' (`parallel.sharded2d._sigma_2d`: one launch of K7
    over the column window on the card), P × cols_per a rank;
  * solve: preconditioned conjugate gradient on the ridge normal equations
      (Σ_keep/N + λ·D) w = Σ[keep, label]/N
    (the system `models.device.linreg_solve_device` solves densely), whose
    matvec y = Σ_m S[:, cols_m] @ v[cols_m] is one product of the rank's
    block, widened to f64 a slab of rows at a time (`_matvec`: JAX leaves
    it to XLA in f32, outside any Pallas kernel), and one all-reduce of a
    P-vector over 'model'. The label row and column are masked inside the
    operator; the LDA step's f32 rank-C correction runs under
    `utils.precision.ieee_f32`;
  * predict: θ is a small P-vector every rank holds the same; ŷ = θ·z over
    each row's codes (`ring.sum.linear_predict`), and the LDA classes by
    `ring.sum.class_argmax`, on the rank's rows. The JAX package builds a
    dense Zᵀ for each row shard here; the port never does.

The CG loops run on the device in f32. Every rank computes the same
iterates from all-reduced numbers, so the stop test (the residual norm
against tol·‖b‖) agrees; the loop masks its updates on the device once
the test fails, as JAX's while_loop stops, and reads the test on the host
every `CG_CHECK` steps only, after an all-reduce (max) of it over
'model', so no rank can leave the loop while the others wait in a
collective.

λ > 0 is required: full one-hot blocks make Σ exactly singular (each
column's one-hots sum to the intercept column); the dense trainer absorbs
that with a min-norm pseudo-inverse, CG needs the ridge to pin the
solution.

Divergences from the JAX package: inputs and results are the rank's rows
(`row_shard(n, data_rank, n_data)`; `shard_rows=True` cuts them out of
whole arrays), with no row padding and no `row_chunk`; a rank's block is
its own f32[P, cols_per], not a global array; prediction runs over each
row's codes; the init means are accumulated in f64 (the JAX package sums
in f32).
"""
from __future__ import annotations

import torch

from ..ring.sum import _normalize_inputs, class_argmax, linear_predict
from ..schema import FeatureSchema
from ..utils.precision import ieee_f32
from .mesh import all_reduce
from .sharded2d import Mesh2D, _rows, _sigma_2d

CG_CHECK = 32   # CG steps between two host reads of the stop test


def sigma_wide(x_num, codes, weights, *, schema: FeatureSchema,
               mesh: Mesh2D, shard_rows: bool = False) -> torch.Tensor:
    """The rank's block of the column-sharded sigma, f32[P, cols_per]
    (columns [m·cols_per, (m + 1)·cols_per), zero past P), summed over
    every data rank's rows: the entry point of the wide-V flows."""
    return _sigma_2d(x_num, codes, weights, schema=schema, mesh=mesh,
                     shard_rows=shard_rows)


def _own_cols(s_loc: torch.Tensor, mesh: Mesh2D) -> tuple[int, int]:
    """[lo, hi) of sigma's columns the rank's block holds (hi ≤ P)."""
    cols_per = s_loc.shape[1]
    lo = mesh.model.rank * cols_per
    return lo, max(lo, min(lo + cols_per, s_loc.shape[0]))


def _local_parts(s_loc: torch.Tensor, mesh: Mesh2D,
                 cols: list[int]) -> tuple[torch.Tensor, ...]:
    """From the ranks' blocks, with one all-reduce over 'model': N =
    sigma[0, 0] (at least 1), the columns `cols` of sigma f32[P,
    len(cols)] and sigma's diagonal f32[P]."""
    p = s_loc.shape[0]
    lo, hi = _own_cols(s_loc, mesh)
    k = len(cols)
    buf = torch.zeros(1 + p * (k + 1), dtype=torch.float32,
                      device=s_loc.device)
    if lo == 0:
        buf[0] = s_loc[0, 0]
    sel = buf[1:1 + p * k].view(p, k)
    for q, c in enumerate(cols):
        if lo <= c < hi:
            sel[:, q] = s_loc[:, c - lo]
    rows = torch.arange(lo, hi, device=s_loc.device)
    diag = buf[1 + p * k:]
    diag[rows] = s_loc[rows, rows - lo]
    all_reduce(buf, mesh.model)
    return buf[0].clamp(min=1.0), sel, diag


MATVEC_ROWS = 1024  # rows of the block widened to f64 at a time


def _matvec(s_loc: torch.Tensor, v: torch.Tensor,
            mesh: Mesh2D) -> torch.Tensor:
    """Σ @ v for v f32[P] or f32[P, C]: the rank's block times its slice
    of v, accumulated in f64 (MATVEC_ROWS rows of the block widened at a
    time), all-reduced over 'model' in f64 and rounded to f32 once, so the
    product does not depend on how sigma's columns are split."""
    lo, hi = _own_cols(s_loc, mesh)
    v64 = v[lo:hi].double()
    y = torch.zeros((s_loc.shape[0],) + v.shape[1:], dtype=torch.float64,
                    device=v.device)
    if hi > lo:
        for r in range(0, s_loc.shape[0], MATVEC_ROWS):
            y[r:r + MATVEC_ROWS] = (s_loc[r:r + MATVEC_ROWS, :hi - lo]
                                    .double() @ v64)
    return all_reduce(y, mesh.model).float()


def _pcg(op, b: torch.Tensor, pinv: torch.Tensor, *, mesh: Mesh2D,
         iters: int, tol: float) -> torch.Tensor:
    """Jacobi-preconditioned CG for op(x) = b, b f32[P] or f32[P, C] (C
    systems at once, each with its own step sizes; one stop test on
    the norm of the whole residual). Stops when ‖r‖ ≤ tol·‖b‖ or after
    `iters` steps. Adds the steps it runs (whole checks of CG_CHECK, the
    last ones masked) to `_pcg.steps`."""
    thr = tol * max(float(torch.linalg.vector_norm(b)), 1e-30)
    x = torch.zeros_like(b)
    r = b.clone()
    z = r * pinv
    pv = z.clone()
    rz = (r * z).sum(0)
    k = 0
    while k < iters:
        _pcg.steps += min(CG_CHECK, iters - k)
        for _ in range(min(CG_CHECK, iters - k)):
            go = torch.linalg.vector_norm(r) > thr
            ap = op(pv)
            alpha = rz / (pv * ap).sum(0).clamp(min=1e-30)
            x = torch.where(go, x + alpha * pv, x)
            r_new = r - alpha * ap
            z = r_new * pinv
            rz_new = (r_new * z).sum(0)
            beta = rz_new / rz.clamp(min=1e-30)
            pv = torch.where(go, z + beta * pv, pv)
            r = torch.where(go, r_new, r)
            rz = torch.where(go, rz_new, rz)
        k += min(CG_CHECK, iters - k)
        go = (torch.linalg.vector_norm(r) > thr).to(torch.int32).reshape(1)
        if not int(all_reduce(go, mesh.model, "max")):
            break
    return x


_pcg.steps = 0


def cg_solve_wide(sigma_cols: torch.Tensor, *, mesh: Mesh2D, label: int,
                  p: int, ridge: float = 1e-3, iters: int = 500,
                  tol: float = 1e-7) -> torch.Tensor:
    """Ridge normal-equations solve against the column-sharded sigma.

    sigma_cols: the rank's block f32[P, cols_per] from `sigma_wide`.
    Returns coeff f32[P], the same on every rank, coeff[label] = −1: the
    contract of `linreg_solve_device`. The ridge applies to every active
    feature except the intercept (index 0), as the dense trainer's
    diag(0, 1, …)."""
    s_loc = sigma_cols
    idx = torch.arange(p, device=s_loc.device)
    active = (idx != label).to(torch.float32)
    ridge_m = active * (idx != 0).to(torch.float32)
    n_rows, col, diag = _local_parts(s_loc, mesh, [label])
    b = active * col[:, 0] / n_rows

    def op(v):
        return (active * _matvec(s_loc, active * v, mesh) / n_rows
                + ridge * ridge_m * v + (1.0 - active) * v)

    op_diag = active * (diag / n_rows + ridge * ridge_m) + (1.0 - active)
    pinv = torch.where(op_diag > 1e-30, 1.0 / op_diag,
                       torch.ones_like(op_diag))
    coeff = _pcg(op, b, pinv, mesh=mesh, iters=iters, tol=tol)
    coeff[label] = -1.0
    return coeff


def linreg_train_wide(x_num, codes, weights, *, schema: FeatureSchema,
                      mesh: Mesh2D, label: int, ridge: float = 1e-3,
                      iters: int = 500, tol: float = 1e-7,
                      shard_rows: bool = False) -> torch.Tensor:
    """Wide-V ridge linear regression: aggregation and solve both sharded,
    a rank's sigma P × cols_per. `label` indexes the numeric columns;
    returns coeff f32[P] with coeff[1 + label] = −1."""
    sigma_cols = sigma_wide(x_num, codes, weights, schema=schema, mesh=mesh,
                            shard_rows=shard_rows)
    return cg_solve_wide(sigma_cols, mesh=mesh, label=1 + label,
                         p=schema.sigma_size, ridge=ridge, iters=iters,
                         tol=tol)


def _cols(x_num, codes, mesh: Mesh2D, shard_rows: bool):
    """The rank's rows as lists of per-column tensors."""
    x, c, _, _ = _normalize_inputs(x_num, codes, None)
    x, c = _rows((x, c), mesh, shard_rows)
    return list(x.unbind(0)), list(c.unbind(0))


def predict_wide(x_num, codes, coeff, *, schema: FeatureSchema,
                 mesh: Mesh2D, label: int,
                 shard_rows: bool = False) -> torch.Tensor:
    """ŷ = Σ_{i ≠ 1 + label} θ_i z_i on the rank's rows, f32[n_r], over
    each row's codes (coeff the same on every rank)."""
    theta = coeff.clone()
    theta[1 + label] = 0.0
    xs, cs = _cols(x_num, codes, mesh, shard_rows)
    return linear_predict(theta, xs, cs, schema=schema)


def mice_column_step_wide(x_num, codes, null_mask, *,
                          schema: FeatureSchema, mesh: Mesh2D, label: int,
                          ridge: float = 1e-3, iters: int = 500,
                          tol: float = 1e-7,
                          shard_rows: bool = False) -> torch.Tensor:
    """One numeric MICE column step at wide V: the masked aggregate
    (weights = ¬null), the CG train, the prediction of the null rows and
    their write-back. Returns the rank's x_num f32[d, n_r], a new
    tensor."""
    x, c, _, _ = _normalize_inputs(x_num, codes, None)
    x, c, null = _rows((x, c, torch.as_tensor(null_mask, device=x.device)
                        .bool()), mesh, shard_rows)
    weights = (~null).to(torch.float32)
    coeff = linreg_train_wide(x, c, weights, schema=schema, mesh=mesh,
                              label=label, ridge=ridge, iters=iters,
                              tol=tol)
    preds = predict_wide(x, c, coeff, schema=schema, mesh=mesh, label=label)
    out = x.clone()
    out[label] = torch.where(null, preds, x[label])
    return out


@ieee_f32()
def lda_solve_wide(sigma_cols: torch.Tensor, *, mesh: Mesh2D,
                   schema: FeatureSchema, label: int,
                   shrinkage: float = 1e-3, iters: int = 500,
                   tol: float = 1e-7) -> tuple[torch.Tensor, torch.Tensor]:
    """LDA train against the column-sharded FULL sigma (label included).

    The pooled within-class scatter is never a matrix, only its action
    S_w v = Σ′v − Σ_c s_c (s_cᵀ v)/N_c, Σ′ the label-excluded sigma (a
    mask) and s_c the label block's columns of sigma (C small P-vectors,
    gathered once); the shrinkage solve cov·W = M is a Jacobi-
    preconditioned CG on that operator, the C classes at once. `label`
    indexes the categorical columns. Returns (w f32[P, C], zero on the
    intercept row and the label block, and intercept f32[C]), the same on
    every rank."""
    s_loc = sigma_cols
    p = schema.sigma_size
    d, offs = schema.num_cols, schema.offsets
    lab_lo = 1 + d + offs[label]
    n_classes = offs[label + 1] - offs[label]
    idx = torch.arange(p, device=s_loc.device)
    in_label = (idx >= lab_lo) & (idx < lab_lo + n_classes)
    active = ((idx >= 1) & ~in_label).to(torch.float32)
    m_eff = active.sum()

    n_total, s_full, diag = _local_parts(
        s_loc, mesh, list(range(lab_lo, lab_lo + n_classes)))
    counts = s_full[0]                                 # [C] class counts
    cnt = counts.clamp(min=1.0)
    sc = s_full * active[:, None]                      # masked s_c
    low_diag = (sc * sc / cnt[None]).sum(1)           # Σ_c s²/N_c
    mu = ((active * diag).sum() - (active * low_diag).sum()) / m_eff

    def cov_mat(v):
        sv = _matvec(s_loc, v, mesh) * active[:, None]
        low = sc @ ((sc.T @ v) / cnt[:, None])         # rank-C correction
        return ((1.0 - shrinkage) * (sv - low)
                + shrinkage * mu * v) / n_total

    def op(v):
        return cov_mat(v * active[:, None]) * active[:, None]

    rhs = sc / cnt[None]                               # class means [P, C]
    cov_diag = ((1.0 - shrinkage) * (diag - low_diag)
                + shrinkage * mu) / n_total
    pinv = torch.where(active * cov_diag > 1e-30, 1.0 / cov_diag,
                       torch.ones_like(cov_diag))
    pinv = active * pinv + (1.0 - active)
    w = _pcg(op, rhs, pinv[:, None], mesh=mesh, iters=iters,
             tol=tol) * active[:, None]
    log_prior = torch.where(counts > 0, torch.log(cnt / n_total),
                            torch.full_like(cnt, -torch.inf))
    intercept = -0.5 * (rhs * w).sum(0) + log_prior
    return w, intercept


def lda_predict_wide(x_num, codes, w, intercept, *, schema: FeatureSchema,
                     mesh: Mesh2D, shard_rows: bool = False) -> torch.Tensor:
    """The LDA classes of the rank's rows, i32[n_r] (0-based; a tie goes to
    the lowest class), over each row's codes. `w` is zero on the label
    block, so the label column's current values never score their own
    prediction."""
    xs, cs = _cols(x_num, codes, mesh, shard_rows)
    return class_argmax(w, intercept, xs, cs, schema=schema)


def mice_cat_step_wide(x_num, codes, null_mask, *, schema: FeatureSchema,
                       mesh: Mesh2D, label: int, shrinkage: float = 1e-3,
                       iters: int = 500, tol: float = 1e-7,
                       shard_rows: bool = False) -> torch.Tensor:
    """One categorical MICE column step at wide V: the masked full-schema
    aggregate, the sharded LDA train, the argmax of the rank's rows and
    the write-back of the null codes. Returns the rank's codes i32[c,
    n_r], a new tensor."""
    x, c, _, _ = _normalize_inputs(x_num, codes, None)
    x, c, null = _rows((x, c, torch.as_tensor(null_mask, device=x.device)
                        .bool()), mesh, shard_rows)
    weights = (~null).to(torch.float32)
    sigma_cols = sigma_wide(x, c, weights, schema=schema, mesh=mesh)
    w, intercept = lda_solve_wide(sigma_cols, mesh=mesh, schema=schema,
                                  label=label, shrinkage=shrinkage,
                                  iters=iters, tol=tol)
    pred = lda_predict_wide(x, c, w, intercept, schema=schema, mesh=mesh)
    out = c.clone()
    out[label] = torch.where(null, pred, c[label])
    return out


def _fill(x, c, num_null, cat_null, num_cols, cat_cols, schema, mesh):
    """Observed mean (f64 sums) and mode (a tie to the lowest code) of the
    columns to impute over every data rank's rows, written into their
    null cells; one all-reduce over 'data'."""
    dev = x.device
    sizes = [schema.cat_sizes[j] for j in cat_cols]
    stats = torch.zeros(2 * len(num_cols) + sum(sizes), dtype=torch.float64,
                        device=dev)
    for q, j in enumerate(num_cols):
        obs = ~num_null[j]
        stats[2 * q] = torch.where(obs, x[j].double(), 0.0).sum()
        stats[2 * q + 1] = obs.sum()
    at = 2 * len(num_cols)
    for j, size in zip(cat_cols, sizes):
        code = c[j][~cat_null[j]].long()
        code = code[(code >= 0) & (code < size)]
        stats[at:at + size] = torch.bincount(code, minlength=size).double()
        at += size
    all_reduce(stats, mesh.data)
    x, c = x.clone(), c.clone()
    for q, j in enumerate(num_cols):
        mean = (stats[2 * q] / stats[2 * q + 1].clamp(min=1.0)).float()
        x[j] = torch.where(num_null[j], mean, x[j])
    at = 2 * len(num_cols)
    for j, size in zip(cat_cols, sizes):
        mode = stats[at:at + size].argmax().to(c.dtype)
        c[j] = torch.where(cat_null[j], mode, c[j])
        at += size
    return x, c


def run_mice_wide(x_num, codes, num_null, cat_null, *,
                  schema: FeatureSchema, mesh: Mesh2D, iters: int = 5,
                  num_cols_to_impute=None, cat_cols_to_impute=None,
                  ridge: float = 1e-3, shrinkage: float = 1e-3,
                  cg_iters: int = 500, tol: float = 1e-7,
                  shard_rows: bool = False):
    """MICE over a mixed table at wide V: every aggregate and solve stays
    sharded (rows over 'data', sigma's columns over 'model'); a rank's
    sigma is P × cols_per throughout.

    The wide-V analogue of run_MICE_baseline (imputation_base.cpp:6-146):
    mean/mode init, then each round the categorical columns first (sharded
    LDA), the numeric columns second (sharded ridge CG). The columns to
    impute default to those with a null on any data rank. Returns the
    rank's (x_num f32[d, n_r], codes i32[c, n_r]) imputed."""
    x, c, _, _ = _normalize_inputs(x_num, codes, None)
    x, c, nn, cn = _rows((x, c, torch.as_tensor(num_null, device=x.device)
                          .bool().reshape(x.shape),
                          torch.as_tensor(cat_null, device=x.device)
                          .bool().reshape(c.shape)), mesh, shard_rows)
    if num_cols_to_impute is None or cat_cols_to_impute is None:
        has = all_reduce(torch.cat([nn.any(1), cn.any(1)]).to(torch.int32),
                         mesh.data, "max").tolist()
        if num_cols_to_impute is None:
            num_cols_to_impute = tuple(
                j for j in range(schema.num_cols) if has[j])
        if cat_cols_to_impute is None:
            cat_cols_to_impute = tuple(
                j for j in range(schema.cat_cols) if has[schema.num_cols + j])
    x, c = _fill(x, c, nn, cn, num_cols_to_impute, cat_cols_to_impute,
                 schema, mesh)
    for _ in range(iters):
        for j in cat_cols_to_impute:
            c = mice_cat_step_wide(x, c, cn[j], schema=schema, mesh=mesh,
                                   label=j, shrinkage=shrinkage,
                                   iters=cg_iters, tol=tol)
        for j in num_cols_to_impute:
            x = mice_column_step_wide(x, c, nn[j], schema=schema, mesh=mesh,
                                      label=j, ridge=ridge, iters=cg_iters,
                                      tol=tol)
    return x, c
