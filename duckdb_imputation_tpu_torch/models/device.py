"""Device-side trainers and batched predictors.

Counterpart of `duckdb_imputation_tpu.models.device`: the trainers that
keep a whole MICE column step (aggregate → train → predict → write-back)
on the device, the direct least-squares solve and the reference's GD loop
in f32 (`linreg_train_device`), and the classifier path's QDA and
naive-Bayes trainers and one-pass predictors.

The GD loop is the JAX package's two `while_loop`s: an outer loop of GD
steps that stops on `done`, and inside each step a backtracking loop of up
to 500 halvings. Here a step is a fixed sequence of tensor ops with no
host read: the backtracking evaluates every candidate step/2^j, j ≤ 500,
in one batched product [501, P] @ Σ and takes the first that meets the
Armijo test (halving is exact, so each candidate is the value the
sequential loop reaches). The outer loop runs in chunks of `GD_CHUNK`
steps; a step whose state is done returns it unchanged, so one read of
`done` a chunk stops the loop where the while loop stops.

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

import dataclasses

import torch

from ..utils.precision import ieee_f32

# The reference's cap on backtracking halvings (regression.cpp:205-223).
GD_HALVINGS = 500
# Outer GD steps between two host reads of `done`.
GD_CHUNK = 32


@ieee_f32()
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


@dataclasses.dataclass(frozen=True)
class _GDState:
    it: torch.Tensor          # i64[], the reference's num_iterations
    step: torch.Tensor        # f32[]
    coeff: torch.Tensor       # f32[P]
    grad: torch.Tensor        # f32[P]
    prev_error: torch.Tensor  # f32[]
    done: torch.Tensor        # bool[]


def _gd_error(sigma, cand, n, lam):
    """The reference's error of each row of cand f32[J, P]:
    (θᵀΣθ/N + λ(‖θ₁:‖² − 1)) / 2, as f32[J]."""
    e = ((cand @ sigma) * cand).sum(-1) / n
    pn = (cand[:, 1:] * cand[:, 1:]).sum(-1) - 1.0
    return (e + lam * pn) / 2.0


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, read on the device (no host sync)."""
    return x.index_select(0, i.reshape(1))[0]


def _gd_step(s: _GDState, sigma, n, lam, keep, pin, is_intercept,
             halvings, first_gnorm) -> _GDState:
    """One outer GD step (regression.cpp:179-238) with its backtracking,
    all on the device; a state that is done comes back unchanged."""
    update = torch.where(is_intercept, s.grad, s.grad + lam * s.coeff)
    uu = update @ update
    gnorm2 = uu - lam * lam
    # every backtracking candidate at once: steps[j] = step / 2^j exactly
    # (an f32 times a power of two in f64, rounded once to f32)
    steps = (s.step.double() * halvings).float()              # [J]
    raw = s.coeff - steps[:, None] * update                   # [J, P]
    cand = raw * keep - pin
    err = _gd_error(sigma, cand, n, lam)
    # the while loop halves while err > prev_error − (step/2)·gnorm2 and
    # fewer than 500 halvings were taken: the first candidate that fails
    # that test is taken, the last one in any case
    stop = ~(err > s.prev_error - (steps / 2) * gnorm2)
    stop[-1] = True
    a = torch.argmax(stop.to(torch.int32))
    dparam = torch.where(
        a == 0, s.step * torch.sqrt(uu),
        _at(torch.sqrt(((cand[:-1] - raw[1:]) ** 2).sum(-1)),
            (a - 1).clamp(min=0)))
    step, coeff = _at(steps, a), _at(cand, a)
    gnorm = torch.sqrt(gnorm2.clamp(min=0.0))
    done = (dparam < 1e-20) | (gnorm / (first_gnorm + 0.001) < 1e-8)
    grad = sigma @ coeff / n * keep

    # Barzilai–Borwein step (compute_step_size, regression.cpp:79-105)
    dtheta = coeff - s.coeff
    dgrad = grad - s.grad
    dss, gss, dgs = dtheta @ dtheta, dgrad @ dgrad, dtheta @ dgrad
    ts = dss / torch.where(dgs == 0, 1.0, dgs)
    tm = dgs / torch.where(gss == 0, 1.0, gss)
    bb = torch.where(tm / ts > 0.5, tm, ts - 0.5 * tm)
    new_step = torch.where((dgs == 0) | (gss == 0) | (tm < 0) | (ts < 0),
                           step, bb)
    new = _GDState(s.it + 1, new_step, coeff, grad, _at(err, a), done)
    return _GDState(*(torch.where(s.done, getattr(s, f.name),
                                  getattr(new, f.name))
                      for f in dataclasses.fields(_GDState)))


@ieee_f32()
def linreg_train_device(sigma: torch.Tensor, *, label: int,
                        step_size: float = 0.001, lam: float = 0.0,
                        max_iters: int = 1000) -> torch.Tensor:
    """GD ridge regression on the Gram matrix, on sigma's device, in f32:
    the reference's loop (regression.cpp:157-238) with BB steps and nested
    backtracking, as the JAX package's `linreg_train_device` runs it.

    sigma: f32[P, P] (from sigma_from_triple). label: sigma row index of the
    target (numeric col l -> l+1). Returns coeff f32[P] with coeff[label]
    pinned to −1; the usual prediction uses all entries except label.

    The loop reads `done` from the device once every `GD_CHUNK` steps
    (counted in `linreg_train_device.host_reads`); the result does not
    depend on `GD_CHUNK`."""
    p = sigma.shape[0]
    dev = sigma.device
    f32 = torch.float32
    sigma = sigma.to(f32)
    n = sigma[0, 0].clamp(min=1.0)
    lam_t = torch.tensor(lam, dtype=f32, device=dev)
    pin = torch.zeros(p, dtype=f32, device=dev)
    pin[label] = 1.0
    keep = 1.0 - pin
    is_intercept = torch.zeros(p, dtype=torch.bool, device=dev)
    is_intercept[0] = True
    halvings = torch.pow(0.5, torch.arange(GD_HALVINGS + 1,
                                           dtype=torch.float64, device=dev))

    coeff0 = -pin
    grad0 = sigma @ coeff0 / n * keep
    upd0 = grad0 + lam_t * coeff0 * (~is_intercept).to(f32)
    first_gnorm = torch.sqrt((upd0 @ upd0 - lam_t * lam_t).clamp(min=0.0))
    s = _GDState(torch.ones((), dtype=torch.int64, device=dev),
                 torch.tensor(step_size, dtype=f32, device=dev), coeff0,
                 grad0, _gd_error(sigma, coeff0[None], n, lam_t)[0],
                 torch.zeros((), dtype=torch.bool, device=dev))
    taken = 0
    while taken < max_iters - 1:
        for _ in range(min(GD_CHUNK, max_iters - 1 - taken)):
            s = _gd_step(s, sigma, n, lam_t, keep, pin, is_intercept,
                         halvings, first_gnorm)
            taken += 1
        if taken < max_iters - 1:
            linreg_train_device.host_reads += 1
            if bool(s.done):
                break
    return s.coeff


linreg_train_device.host_reads = 0


@ieee_f32()
def linreg_predict_device(coeff: torch.Tensor, zt: torch.Tensor,
                          label: int) -> torch.Tensor:
    """Prediction from the device coeff vector over the features-first
    feature matrix Zᵀ = [1 | x_num | onehot]ᵀ f32[P, n] (the sigma's
    layout): the model solves θ·z ≈ 0 with θ[label] = −1, so
    ŷ = Σ_{i≠label} θ_i z_i. Returns f32[n]."""
    theta = coeff.clone()
    theta[label] = 0.0
    return theta @ zt


def mice_column_step_device(x_num, codes, null_mask, *, schema, label: int,
                            max_iters: int = 200):
    """One on-device MICE continuous-column step: masked aggregate (K1, or
    K7 for P > 88, on a CUDA table) → GD train → batched predict → masked
    write-back. x_num f32[d, n] features-first, codes i32[c, n], null_mask
    bool[n]. Returns (new x_num, coeff); the inputs stay unchanged."""
    from ..ring.kernels.sigma_pallas import masked_gram_cols
    from ..ring.sum import linear_predict

    x_cols = list(x_num.contiguous().unbind(0))
    code_cols = list(codes.contiguous().unbind(0))
    sigma = masked_gram_cols(x_cols, code_cols, (~null_mask).to(torch.float32),
                             schema=schema)
    coeff = linreg_train_device(sigma, label=label + 1, max_iters=max_iters)
    theta = coeff.clone()
    theta[label + 1] = 0.0
    pred = linear_predict(theta, x_cols, code_cols, schema=schema)
    out = x_num.clone()
    out[label] = torch.where(null_mask, pred, x_num[label])
    return out, coeff


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


def _predict(tables, plan, x_num, codes, *, schema, method, shift=None):
    """Score through the tables with the method asked for."""
    from ..ring.kernels.qda_pallas import qda_predict_kernel, qda_predict_plain

    if method not in PREDICT_METHODS:
        raise ValueError(f"method must be one of {PREDICT_METHODS}, "
                         f"got {method!r}")
    if method == "auto":
        method = "kernel" if x_num.device.type == "cuda" else "plain"
    predict = qda_predict_kernel if method == "kernel" else qda_predict_plain
    return predict(tables, plan, x_num, codes, schema=schema, shift=shift)


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
    (`nb_tables`: no cross tables), built around the prior-weighted mean
    of the class means (`nb_center`), which the scorer subtracts from x as
    it loads it. var is clamped at 0 and gets the reference's +1e-9, in
    f64; a zero training frequency scores −1e30, and a predict-time
    category outside the vocab contributes nothing. Returns the class
    index i32[n]."""
    from ..ring.kernels.qda_pallas import nb_center, nb_tables

    f64 = torch.float64
    var = var.to(f64).clamp(min=0.0) + 1e-9
    freqs = freqs.to(f64)
    log_freq = torch.where(freqs > 0.0, torch.log(freqs.clamp(min=1e-38)),
                           -1e30)
    log_prior = torch.log(priors.to(f64).clamp(min=1e-38))
    center = nb_center(log_prior, mean)
    tables, plan = nb_tables(log_prior, mean, var, log_freq, schema=schema,
                             center=center)
    return _predict(tables, plan, x_num, codes, schema=schema, method=method,
                    shift=center.to(x_num.device))
