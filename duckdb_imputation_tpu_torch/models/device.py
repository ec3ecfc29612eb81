"""Device-side trainers and batched predictors.

Counterpart of `duckdb_imputation_tpu.models.device`: the direct
least-squares trainer that keeps a whole MICE column step (aggregate →
train → predict → write-back) on the device, and the classifier path's
QDA and naive-Bayes trainers and one-pass predictors. The GD trainer
(`linreg_train_device`) is not ported yet.

Three divergences from the JAX package, each a fix (ROADMAP Queue 3):
`qda_train_device` takes the per-class SVD in f64 (JAX: f32 with the f64
trainer's absolute 1e-9 cutoff, which keeps f32 rounding noise of a
singular covariance and blows −quad up); `nb_train_device` trains in f64
and clamps the variance at 0 (JAX: f32 Σx²/n − mean², which cancels to a
negative variance and a NaN score); and `qda_predict_device` scores the
quadratic form as it is, over each row's nonzero pairs (JAX: a Cholesky
of −quad + 1e-12·I, NaN for the singular PSD −quad of a full one-hot
schema). Scoring needs no factor: `qda_tables` and `nb_tables` pack each
class's form into the cells of the schema's plan.
"""
from __future__ import annotations

import torch


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares, x = pinv(a) @ b, through an SVD.

    The MICE systems are EXACTLY singular (the intercept and a full one-hot
    block are collinear), and `torch.linalg.lstsq` on CUDA offers only
    'gels', which assumes full rank. This solves them the way
    `jnp.linalg.lstsq` does, on CPU and CUDA alike: singular values below
    eps·max(m, n)·s_max are dropped. a f32[m, k], b f32[m] or f32[m, r]."""
    m, k = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(a.dtype).eps * max(m, k) * s[0]
    keep = s >= cut
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    ub = u.T @ b
    ub = s_inv * ub if b.dim() == 1 else s_inv[:, None] * ub
    return vh.T @ ub


def linreg_solve_device(sigma: torch.Tensor, *,
                        label: int) -> torch.Tensor:
    """Direct least-squares trainer: the normal equations of the Gram
    objective solved in one SVD-backed min-norm solve.

    minimize θᵀΣθ/N s.t. θ[label] = −1  ⇒  (Σ_keep/N) w = Σ[keep, label]/N.

    Returns coeff f32[P] with coeff[label] = −1."""
    p = sigma.shape[0]
    keep = torch.tensor([i for i in range(p) if i != label],
                        device=sigma.device)
    n = sigma[0, 0].clamp(min=1.0)
    a = sigma[keep][:, keep] / n
    b = sigma[keep, label] / n
    coeff = torch.zeros(p, dtype=sigma.dtype, device=sigma.device)
    coeff[keep] = lstsq_min_norm(a, b)
    coeff[label] = -1.0
    return coeff


def qda_train_device(sigmas: torch.Tensor, tot, drop_d: int = 1):
    """QDA from per-class sigmas f32[C, P, P], batched over classes.
    Returns (quad f32[C, m, m], lin f32[C, m], intercept f32[C]) with the
    reference's parameterization: −½cov⁻¹, cov⁻¹μ and −½μᵀcov⁻¹μ −
    ½log pdet + log(N_c/N), m = P − drop_d.

    The covariance, SVD pseudo-inverse (singular values ≤ 1e-9 cut) and
    log-pseudo-determinant are taken in f64, the host trainer's arithmetic
    (models/qda.py); a zero-count class gets μ = 0, cov = 0 and a −inf
    intercept."""
    sig = sigmas.to(torch.float64)
    tot = torch.as_tensor(tot, dtype=torch.float64, device=sig.device)
    n_c = sig[:, 0, 0]
    n_safe = n_c.clamp(min=1.0)[:, None]
    s = sig[:, drop_d:, drop_d:]
    sv = sig[:, 0, drop_d:]
    cov = (s - sv[:, :, None] * sv[:, None, :] / n_safe[..., None]) \
        / n_safe[..., None]
    u, svals, vt = torch.linalg.svd(cov)
    keep = svals > 1e-9
    inv_s = torch.where(keep, 1.0 / torch.where(keep, svals, 1.0), svals)
    inva = (vt.transpose(-1, -2) * inv_s[:, None, :]) @ u.transpose(-1, -2)
    logdet = torch.where(keep, torch.log(torch.where(keep, svals, 1.0)),
                         0.0).sum(-1)
    mu = sv / n_safe
    lin = (inva @ mu[..., None])[..., 0]
    intercept = (-0.5 * (mu * lin).sum(-1) - 0.5 * logdet
                 + torch.log(n_c / tot))
    return ((-0.5 * inva).to(torch.float32), lin.to(torch.float32),
            intercept.to(torch.float32))


def nb_train_device(n, lin, quad_diag, lin_cat):
    """NB from batched NBAgg sections ([C], [C, d], [C, d], [C, V]):
    returns (priors [C], mean [C, d], var [C, d], freqs [C, V]), f32.

    Trained in f64 from the f32 sections, as the JAX host trainer
    (models/naive_bayes.py) does, and var clamped at 0: Σx²/n − mean² of
    a constant column cancels to a small negative number even from exact
    sums rounded to f32 once (ROADMAP Queue 3)."""
    f64 = torch.float64
    n = n.to(f64)
    n_safe = n.clamp(min=1.0)[:, None]  # zero-count class guard
    mean = lin.to(f64) / n_safe
    var = (quad_diag.to(f64) / n_safe - mean * mean).clamp(min=0.0)
    freqs = lin_cat.to(f64) / n_safe
    return tuple(t.to(torch.float32)
                 for t in (n / n.sum(), mean, var, freqs))


PREDICT_METHODS = ("auto", "plain", "kernel")


def _predict(tables, plan, x_num, codes, *, schema, method):
    """Score through the tables with the method asked for."""
    from ..ring.kernels.qda_pallas import qda_predict_kernel, qda_predict_plain

    if method not in PREDICT_METHODS:
        raise ValueError(f"method must be one of {PREDICT_METHODS}, "
                         f"got {method!r}")
    if method == "auto":
        method = "kernel" if x_num.device.type == "cuda" else "plain"
    predict = qda_predict_kernel if method == "kernel" else qda_predict_plain
    return predict(tables, plan, x_num, codes, schema=schema)


def qda_predict_device(quad, lin, intercept, x_num, codes, *, schema,
                       method: str = "auto") -> torch.Tensor:
    """Batched QDA scoring and argmax over every row, features z = [x_num ‖
    onehot(codes)] of width m = P − 1: the class INDEX i32[n] of the first
    maximum of zᵀ·quad_c·z + lin_c·z + b_c.

    The scorer packs each class's quadratic form into the cells of the
    schema's plan (`qda_tables`) and sums over each row's nonzero pairs.
    method: 'auto' (the kernel, K3 or K3w by the plan's tasks, for CUDA
    tensors; plain on the CPU), 'plain' (`qda_predict_plain`) or 'kernel'
    (`qda_predict_kernel`)."""
    from ..ring.kernels.qda_pallas import qda_tables

    tables, plan = qda_tables(quad, lin, intercept, schema=schema)
    return _predict(tables, plan, x_num, codes, schema=schema, method=method)


def nb_predict_device(priors, mean, var, freqs, x_num, codes, *, schema,
                      method: str = "auto") -> torch.Tensor:
    """Batched NB scoring and argmax: naive Bayes is QDA with a diagonal
    quadratic form, so in log space

        s_c = log prior_c + Σ_num [−(x−μ)²/2σ² − ½log(2πσ²)]
                          + Σ_cat log freq_c[code]

    and scores through QDA's predictors with tables of that form
    (`nb_tables`: no cross tables). var is clamped at 0 and gets the
    reference's +1e-9, in f64; a zero training frequency scores −1e30, and
    a predict-time category outside the vocab contributes nothing. Returns
    the class index i32[n]."""
    from ..ring.kernels.qda_pallas import nb_tables

    f64 = torch.float64
    var = var.to(f64).clamp(min=0.0) + 1e-9
    freqs = freqs.to(f64)
    log_freq = torch.where(freqs > 0.0, torch.log(freqs.clamp(min=1e-38)),
                           -1e30)
    tables, plan = nb_tables(torch.log(priors.to(f64).clamp(min=1e-38)),
                             mean, var, log_freq, schema=schema)
    return _predict(tables, plan, x_num, codes, schema=schema, method=method)
