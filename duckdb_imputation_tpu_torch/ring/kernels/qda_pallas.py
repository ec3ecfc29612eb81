"""K3 and K3w: batched QDA scoring in one table pass, all classes per row.

Counterpart of `duckdb_imputation_tpu/ring/kernels/qda_pallas.py`
(`qda_predict_pallas`, the Pallas kernel `_qda_predict_pallas`). With
z = [x ‖ onehot(codes)] (m = P − 1 features) and the factored form
quad_c = −L_c·L_cᵀ, every class scores as

    s_c(z) = (b_c + lin_c·z) − ‖L_cᵀz‖²

and the prediction is the first argmax (a tie goes to the lowest class;
a NaN score never wins). `qda_scorers` builds L_c from a symmetric
eigendecomposition of −quad_c in f64, negative eigenvalues clamped to 0:
L_c = V·diag(√λ₊). It holds for the singular PSD matrices that every full
one-hot schema gives, where the JAX package's Cholesky of −quad + 1e-12·I
fails (see ROADMAP Queue 3). Where the whole factors pass K3's shared
memory, eigenvalues at f64 rounding noise are clamped too and the zero
columns dropped (they add exactly +0 to ‖L_cᵀz‖²), so L is f32[C, m, r]
with r ≤ m rounded up to `_build.QDA_RANK_ALIGN`; `nb_scorers` builds
naive Bayes's diagonal factor directly, of rank d.

`qda_predict_kernel` launches a hand-written CUDA kernel
(`csrc/qda_predict.cu`) for CUDA tensors: K3, factors in shared memory,
when they fit (`_build.qda_route`), else K3w, factors read from device
memory; it takes its plain version, `qda_predict_plain`, only for CPU
tensors. All three add their f32 terms in the same order, so their scores
round alike.
"""
from __future__ import annotations

import torch

from ...schema import FeatureSchema
from ..sum import _cat_contrib
from . import _build


def _truncated(factor: torch.Tensor, rank: int) -> torch.Tensor:
    """The last `rank` columns of factor f64[C, m, m] rounded up to
    QDA_RANK_ALIGN (zero columns in front where that passes m), as a
    contiguous f32[C, m, r]."""
    m = factor.shape[-1]
    r = -(-rank // _build.QDA_RANK_ALIGN) * _build.QDA_RANK_ALIGN
    if r > m:
        factor = torch.cat([factor.new_zeros(factor.shape[:-1] + (r - m,)),
                            factor], dim=-1)
    return factor[..., factor.shape[-1] - r:].to(torch.float32).contiguous()


def qda_scorers(quad: torch.Tensor, lin: torch.Tensor,
                intercept: torch.Tensor):
    """(quad f32[C, m, m] with −quad PSD, lin [C, m], intercept [C]) →
    (L f32[C, m, r] with L_c·L_cᵀ = −quad_c, lin f32, intercept f32), all
    contiguous. Row k of L_c is what feature z_k contributes to y = L_cᵀz.

    Where the whole factors (r = m) fit K3's shared memory they are kept
    whole, negative eigenvalues clamped to 0. Past it, eigenvalues at most
    m·eps·max|λ_c| (f64 rounding noise of an exactly singular −quad_c) are
    clamped to 0 too; eigh returns them ascending, so each class's zero
    columns come first, and the factor keeps the last r columns, r the
    largest count of positive eigenvalues over the classes rounded up to
    QDA_RANK_ALIGN (a read of r on the host). The columns dropped are zero,
    so no score changes."""
    a = -quad.to(torch.float64)
    a = (a + a.transpose(-1, -2)) / 2
    lam, v = torch.linalg.eigh(a)
    num_classes, m = a.shape[0], a.shape[-1]
    lin = lin.to(torch.float32).contiguous()
    intercept = intercept.to(torch.float32).contiguous()
    if _build.qda_smem_bytes(m, num_classes, m) <= _build.MAX_QDA_SMEM:
        factor = v * lam.clamp(min=0.0).sqrt()[..., None, :]
        return factor.to(torch.float32).contiguous(), lin, intercept
    noise = m * torch.finfo(torch.float64).eps * lam.abs().amax(
        -1, keepdim=True)
    lam = torch.where(lam > noise, lam, 0.0)
    factor = v * lam.sqrt()[..., None, :]
    rank = int((lam > 0).sum(-1).max())
    return _truncated(factor, rank), lin, intercept


def nb_scorers(quad_diag: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """Naive Bayes's factor: quad_c = diag(quad_diag_c) over the d numeric
    slots of m features, so L_c[j, j] = √max(−quad_diag_c[j], 0) (in f64,
    rounded to f32) for j < d and every other entry 0, as `qda_scorers`
    would factor that quad; f32[C, m, r], r = d rounded up to
    QDA_RANK_ALIGN."""
    r = -(-d // _build.QDA_RANK_ALIGN) * _build.QDA_RANK_ALIGN
    factor = torch.zeros((quad_diag.shape[0], m, r), dtype=torch.float32,
                         device=quad_diag.device)
    di = torch.arange(d, device=quad_diag.device)
    factor[:, di, di] = (-quad_diag.to(torch.float64)).clamp(min=0.0).sqrt() \
        .to(torch.float32)
    return factor


def qda_predict_plain(factor, lin, intercept, x_num, codes, *,
                      schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `qda_predict_kernel`: classes stream with a
    running (best value, best index) pair and a strict `>`, as the JAX
    package's `_qda_predict_xla` does. Returns i32[n]."""
    d = schema.num_cols
    offs = schema.offsets
    ref = x_num if d else codes
    n, device = ref.shape[-1], ref.device
    factor = factor.to(torch.float32)
    best_v = torch.full((n,), -torch.inf, dtype=torch.float32, device=device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=device)
    for cc in range(factor.shape[0]):
        lc = factor[cc]
        q = torch.zeros(n, dtype=torch.float32, device=device)
        for i in range(lc.shape[1]):
            y = torch.zeros(n, dtype=torch.float32, device=device)
            for j in range(d):
                y = y + x_num[j] * lc[j, i]
            for j, size in enumerate(schema.cat_sizes):
                y = y + _cat_contrib(lc[d + offs[j]:d + offs[j + 1], i],
                                     codes[j], size)
            q = q + y * y
        t = intercept[cc].expand(n)
        for j in range(d):
            t = t + lin[cc, j] * x_num[j]
        for j, size in enumerate(schema.cat_sizes):
            t = t + _cat_contrib(lin[cc, d + offs[j]:d + offs[j + 1]],
                                 codes[j], size)
        s = t - q
        upd = s > best_v
        best_v = torch.where(upd, s, best_v)
        best_i = torch.where(upd, cc, best_i)
    return best_i


def qda_predict_kernel(factor, lin, intercept, x_num, codes, *,
                       schema: FeatureSchema) -> torch.Tensor:
    """First-argmax class index i32[n] of the factored QDA scores over
    x_num f32[d, n] and codes i32[c, n]; factor f32[C, m, r], lin,
    intercept as `qda_scorers` returns them.

    CUDA tensors launch a kernel: K3 when the factors fit its shared
    memory (one launch counted in `qda_predict_kernel.launches`), else K3w
    (counted in `qda_predict_kernel.wide_launches`); CPU tensors take the
    plain version."""
    tensors = [factor, lin, intercept, x_num, codes]
    if _build.on_cpu(tensors):
        return qda_predict_plain(factor, lin, intercept, x_num, codes,
                                 schema=schema)
    num_classes, m, rank = factor.shape
    route = _build.qda_route(schema, num_classes, rank)
    if route == "K3w" and rank % _build.QDA_RANK_ALIGN:
        raise ValueError(f"factor rank {rank}: the wide QDA kernel takes a "
                         f"multiple of {_build.QDA_RANK_ALIGN}")
    n = x_num.shape[-1] if schema.num_cols else codes.shape[-1]
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the QDA kernel takes fewer than 2^31")
    device = _build.check_cuda(
        tensors,
        [(factor, torch.float32, (num_classes, schema.sigma_size - 1, rank),
          "factor"),
         (lin, torch.float32, (num_classes, m), "lin"),
         (intercept, torch.float32, (num_classes,), "intercept"),
         (x_num, torch.float32, (schema.num_cols, n), "x_num"),
         (codes, torch.int32, (schema.cat_cols, n), "codes")])
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=device)
    sizes = schema.cat_sizes
    entry = (lib.lib.dit_qda_predict if route == "K3"
             else lib.lib.dit_qda_predict_wide)
    with torch.cuda.device(device):
        rc = entry(
            _build.pointers(list(x_num)), schema.num_cols,
            _build.pointers(list(codes)), _build.int_array(sizes),
            len(sizes), factor.data_ptr(), lin.data_ptr(),
            intercept.data_ptr(), num_classes, m, rank, n, out.data_ptr(),
            _build.grid_blocks(n),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "qda_predict_kernel")
    if route == "K3":
        qda_predict_kernel.launches += 1
    else:
        qda_predict_kernel.wide_launches += 1
    return out


qda_predict_kernel.launches = 0
qda_predict_kernel.wide_launches = 0
