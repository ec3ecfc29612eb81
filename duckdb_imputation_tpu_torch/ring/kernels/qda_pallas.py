"""K3: batched QDA scoring in one table pass, all classes per row.

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
fails (see ROADMAP Queue 3).

`qda_predict_kernel` launches the hand-written CUDA kernel
(`csrc/qda_predict.cu`) for CUDA tensors and takes its plain version,
`qda_predict_plain`, only for CPU tensors. Both add their f32 terms in the
same order, so their scores round alike.
"""
from __future__ import annotations

import torch

from ...schema import FeatureSchema
from ..sum import _cat_contrib
from . import _build


def qda_scorers(quad: torch.Tensor, lin: torch.Tensor,
                intercept: torch.Tensor):
    """(quad f32[C, m, m] with −quad PSD, lin [C, m], intercept [C]) →
    (L f32[C, m, m] with L_c·L_cᵀ = −quad_c, lin f32, intercept f32), all
    contiguous. Row k of L_c is what feature z_k contributes to y = L_cᵀz."""
    a = -quad.to(torch.float64)
    a = (a + a.transpose(-1, -2)) / 2
    lam, v = torch.linalg.eigh(a)
    factor = v * lam.clamp(min=0.0).sqrt()[..., None, :]
    return (factor.to(torch.float32).contiguous(),
            lin.to(torch.float32).contiguous(),
            intercept.to(torch.float32).contiguous())


def qda_predict_plain(factor, lin, intercept, x_num, codes, *,
                      schema: FeatureSchema) -> torch.Tensor:
    """Plain torch version of `qda_predict_kernel`: classes stream with a
    running (best value, best index) pair and a strict `>`, as the JAX
    package's `_qda_predict_xla` does. Returns i32[n]."""
    d = schema.num_cols
    offs = schema.offsets
    ref = x_num if d else codes
    n, device = ref.shape[-1], ref.device
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
    x_num f32[d, n] and codes i32[c, n]; factor, lin, intercept as
    `qda_scorers` returns them.

    CUDA tensors launch the kernel (one launch counted in
    `qda_predict_kernel.launches`); CPU tensors take the plain version."""
    tensors = [factor, lin, intercept, x_num, codes]
    if _build.on_cpu(tensors):
        return qda_predict_plain(factor, lin, intercept, x_num, codes,
                                 schema=schema)
    num_classes, m = factor.shape[0], schema.sigma_size - 1
    _build.check_qda(schema, num_classes)
    n = x_num.shape[-1] if schema.num_cols else codes.shape[-1]
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the QDA kernel takes fewer than 2^31")
    device = _build.check_cuda(
        tensors,
        [(factor, torch.float32, (num_classes, m, m), "factor"),
         (lin, torch.float32, (num_classes, m), "lin"),
         (intercept, torch.float32, (num_classes,), "intercept"),
         (x_num, torch.float32, (schema.num_cols, n), "x_num"),
         (codes, torch.int32, (schema.cat_cols, n), "codes")])
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=device)
    sizes = schema.cat_sizes
    with torch.cuda.device(device):
        rc = lib.lib.dit_qda_predict(
            _build.pointers(list(x_num)), schema.num_cols,
            _build.pointers(list(codes)), _build.int_array(sizes),
            len(sizes), factor.data_ptr(), lin.data_ptr(),
            intercept.data_ptr(), num_classes, m, n, out.data_ptr(),
            _build.grid_blocks(n),
            torch.cuda.current_stream(device).cuda_stream)
    _build.raise_on_error(lib, rc, "qda_predict_kernel")
    qda_predict_kernel.launches += 1
    return out


qda_predict_kernel.launches = 0
