"""Ridge / stochastic linear regression trained from a cofactor triple.

Counterpart of `duckdb_imputation_tpu.models.linear_regression`. Train
follows ML::ridge_linear_regression (regression.cpp:108-354)
iteration for iteration: batch gradient descent on the Gram matrix
(grad = Σθ/N, compute_gradient :29-46), backtracking line search (halve the
step until the Armijo-like condition holds, ≤ 500 halvings, :205-223),
Barzilai–Borwein step size (:79-105), and the same stopping rules
(dparam_norm < 1e-20 or relative grad norm < 1e-8, :226-231). The label's
coefficient is pinned to −1 (:163, 199). The loop is f64 numpy on the host
over the P×P sigma, the reference's `double`; the triple reaches the host
in one copy.

The flat float32 parameter vector reproduces the reference layout
(:313-353):

  [ n_cat_cols,
    (cat_vars_idxs[0..n_cat] — n_cat+1 values, cat_values… — V values,)?   # if cats
    intercept, num coefs (label excluded), cat coefs (V),
    (means: num cols then cats, label & intercept excluded,)?              # if normalize
    (std = sqrt(variance))? ]                                              # if compute_variance

Predict (ML::linreg_impute, :397-509) is batched on the device of the
features: one matvec over all rows plus one coefficient gather per
categorical column. The stochastic noise (Box–Muller from /dev/urandom,
:493-504) becomes `std · N(0, 1)` from an explicit `torch.Generator`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ring.triple import Triple
from ..schema import FeatureSchema
from ..utils.precision import ieee_f32
from .sigma import build_sigma, standardize_sigma


def _gd_train(sigma: np.ndarray, label: int, step_size: float, lam: float,
              max_iters: int) -> np.ndarray:
    """The reference GD loop (regression.cpp:157-238) in f64 numpy.
    `label` is the sigma index (0 = intercept, so num-col l -> l+1)."""
    p = sigma.shape[0]
    n = sigma[0, 0]
    coeff = np.zeros(p)
    prev_coeff = np.zeros(p)
    coeff[label] = -1.0
    prev_coeff[label] = -1.0

    def gradient(theta):
        if n == 0.0:
            return np.zeros(p)
        g = sigma @ theta / n
        g[label] = 0.0
        return g

    def error(theta):
        if n == 0.0:
            return 0.0
        e = theta @ sigma @ theta / n
        pn = float(theta[1:] @ theta[1:]) - 1.0  # label coef (-1)^2 removed
        return (e + lam * pn) / 2.0

    grad = gradient(coeff)
    prev_grad = grad.copy()

    gnorm = grad[0] ** 2
    upd0 = grad[1:] + lam * coeff[1:]
    gnorm += float(upd0 @ upd0) - lam * lam
    first_gnorm = math.sqrt(max(gnorm, 0.0))
    prev_error = error(coeff)

    num_iterations = 1
    while num_iterations < max_iters:
        update = grad + lam * coeff
        update[0] = grad[0]
        prev_coeff[:] = coeff
        prev_grad[:] = grad
        coeff = coeff - step_size * update
        coeff[label] = -1.0
        gradient_norm = float(update @ update) - lam * lam
        dparam_norm = step_size * math.sqrt(float(update @ update))

        err = error(coeff)
        backtracking = 0
        while (err > prev_error - (step_size / 2) * gradient_norm
               and backtracking < 500):
            step_size /= 2
            newp = prev_coeff - step_size * update
            dp = coeff - newp
            coeff = newp
            dparam_norm = math.sqrt(float(dp @ dp))
            coeff[label] = -1.0
            err = error(coeff)
            backtracking += 1

        gradient_norm = math.sqrt(max(gradient_norm, 0.0))
        if (dparam_norm < 1e-20
                or gradient_norm / (first_gnorm + 0.001) < 1e-8):
            break
        grad = gradient(coeff)

        # Barzilai–Borwein step (compute_step_size, regression.cpp:79-105)
        dtheta = coeff - prev_coeff
        dgrad = grad - prev_grad
        dss = float(dtheta @ dtheta)
        gss = float(dgrad @ dgrad)
        dgs = float(dtheta @ dgrad)
        if dgs != 0.0 and gss != 0.0:
            ts, tm = dss / dgs, dgs / gss
            if tm >= 0.0 and ts >= 0.0:
                step_size = tm if tm / ts > 0.5 else ts - 0.5 * tm
        prev_error = err
        num_iterations += 1
    return coeff


def linreg_train(t: Triple, schema: FeatureSchema, label: int,
                 step_size: float = 0.001, lam: float = 0.0,
                 max_iters: int = 10000, compute_variance: bool = False,
                 normalize: bool = False) -> np.ndarray:
    """`linreg_train(triple, label, step_size, lambda, max_iters,
    compute_variance, normalize)`: label indexes the NUMERIC columns from 0
    (regression.cpp:114,161). Returns the flat float32 parameter vector."""
    sigma, _ = build_sigma(t, schema)
    p = sigma.shape[0]
    n = sigma[0, 0]
    means = std = None
    if normalize:
        means, std = standardize_sigma(sigma)

    sig_label = label + 1
    coeff = _gd_train(sigma, sig_label, step_size, lam, max_iters)

    variance = 0.0
    if compute_variance:
        theta = coeff.copy()
        theta[sig_label] = -1.0
        variance = float(theta @ sigma @ theta) / float(n)

    if normalize:
        # rescale for the standardized fit (regression.cpp:265-270)
        coeff = coeff.copy()
        coeff[1:] = coeff[1:] / std[1:] * std[sig_label]
        coeff[0] = coeff[0] * std[sig_label] + means[sig_label]

    out: list[float] = [float(schema.cat_cols)]
    if schema.cat_cols > 0:
        out.extend(float(x) for x in schema.offsets)
        out.extend(float(k) for k in schema.keys_flat())
    keep = [i for i in range(p) if i != sig_label]
    out.extend(float(coeff[i]) for i in keep)
    if normalize:
        out.extend(float(means[i]) for i in keep[1:])
    if compute_variance:
        out.append(math.sqrt(max(variance, 0.0)))
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True)
class LinregParams:
    """Decoded view of the flat parameter vector (the predict-side parser,
    regression.cpp:428-435)."""
    n_cat: int
    offsets: np.ndarray    # i64[n_cat+1]
    cat_keys: np.ndarray   # i64[V]
    intercept: float
    num_coef: np.ndarray   # f64[dn]  (label excluded)
    cat_coef: np.ndarray   # f64[V]
    num_means: np.ndarray | None
    cat_means: np.ndarray | None
    noise_std: float

    @staticmethod
    def decode(params: np.ndarray, num_cols: int, normalize: bool,
               has_variance: bool) -> "LinregParams":
        params = np.asarray(params, np.float64)
        n_cat = int(params[0])
        i = 1
        if n_cat > 0:
            offsets = params[i:i + n_cat + 1].astype(np.int64)
            i += n_cat + 1
            v = int(offsets[-1])
            cat_keys = params[i:i + v].astype(np.int64)
            i += v
        else:
            offsets = np.zeros(1, np.int64)
            cat_keys = np.zeros(0, np.int64)
            v = 0
        intercept = float(params[i]); i += 1
        num_coef = params[i:i + num_cols]; i += num_cols
        cat_coef = params[i:i + v]; i += v
        num_means = cat_means = None
        if normalize:
            num_means = params[i:i + num_cols]; i += num_cols
            cat_means = params[i:i + v]; i += v
        noise_std = float(params[i]) if has_variance else 0.0
        return LinregParams(n_cat, offsets, cat_keys, intercept, num_coef,
                            cat_coef, num_means, cat_means, noise_std)


@ieee_f32()
def linreg_predict(params: np.ndarray, x_num: torch.Tensor, codes=None, *,
                   add_noise: bool = False, normalize: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Batched `linreg_predict(params, add_noise, normalize, cols…)` on the
    device of x_num.

    x_num: f32[dn, n] numeric feature columns FEATURES-FIRST (label column
    excluded, same order as training). codes: i32[c, n] LOCAL per-column
    category codes against the training vocab (FeatureSchema.encode order).
    Unseen categories (code == column size) contribute 0 (the reference's
    linear scan reads one slot past the block there, regression.cpp:462-491,
    an out-of-bounds artifact not reproduced). add_noise draws N(0, 1) per
    row from `generator` (on x_num's device; a generator seeded 0 when
    None). Returns f32[n]."""
    x_num = torch.as_tensor(x_num, dtype=torch.float32)
    dev = x_num.device
    dn, n = x_num.shape
    p = LinregParams.decode(params, dn, normalize, add_noise)
    w_num = torch.tensor(p.num_coef, dtype=torch.float32, device=dev)
    pred = torch.full((n,), p.intercept, dtype=torch.float32, device=dev)
    pred = pred + w_num @ x_num
    if normalize:
        pred = pred - float(np.float32(np.dot(p.num_means, p.num_coef)))
    if p.n_cat > 0 and codes is not None:
        codes = torch.as_tensor(codes, device=dev)
        # one zero slot past the table takes every miss
        coef_pad = torch.tensor(np.append(p.cat_coef, 0.0), dtype=torch.float32,
                                device=dev)
        for j in range(p.n_cat):
            start, end = int(p.offsets[j]), int(p.offsets[j + 1])
            pos = torch.where(codes[j] < end - start, codes[j] + start,
                              len(p.cat_coef))
            pred = pred + coef_pad[pos.long()]
        if normalize:
            # subtract Σ_v mean_v * coef_v for every categorical slot
            # (the (onehot - mean)·w expansion, regression.cpp:469-485)
            pred = pred - float(np.float32(np.dot(p.cat_means, p.cat_coef)))
    if add_noise:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        pred = pred + p.noise_std * torch.randn(
            n, generator=generator, device=dev)
    return pred
