"""Device-side trainers on the P×P sigma.

Counterpart of `duckdb_imputation_tpu.models.device` for the MICE slice:
the direct least-squares trainer that keeps a whole MICE column step
(aggregate → train → predict → write-back) on the device. The GD trainer
(`linreg_train_device`) is not ported yet.
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
