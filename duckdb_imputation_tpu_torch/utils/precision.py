"""IEEE f32 matrix products, whatever the caller set.

torch lets a program turn on reduced precision for every f32 matrix
product: `torch.set_float32_matmul_precision("high")` (a common line in
training scripts), `torch.backends.cuda.matmul.allow_tf32 = True` or
`torch.backends.cuda.matmul.fp32_precision = "tf32"` make cuBLAS round
the operands of an f32 product to TF32 (10 bits of mantissa), and on the
CPU "high" and "medium" make oneDNN take TF32 or bf16 where the processor
has them. The JAX package pins `Precision.HIGHEST` on its f32 products
(ring/sum.py, parallel/wide.py, models/qda.py); the port promises the
same f32 arithmetic, so every function of the port that takes an f32
product on the device runs it under `ieee_f32`.

`ieee_f32()` is a context manager and a decorator: it reads the matmul
precision of cuBLAS and of oneDNN through torch's `fp32_precision`
settings (one API, which reads back whatever way the caller set it and
never raises on a mix of the old and the new ways), sets both to "ieee",
and restores what it read when the block ends, by an exception too. The
settings are the process's: a guard that nests restores the outer one's.
"""
from __future__ import annotations

import contextlib

import torch

# the backends whose f32 matrix products a caller can make reduced
_MATMUL = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def ieee_f32():
    """Run the block (or the decorated function) with IEEE f32 matrix
    products on the card and the CPU; the caller's settings come back
    after it, as they were."""
    saved = [m.fp32_precision for m in _MATMUL]
    try:
        for m in _MATMUL:
            m.fp32_precision = "ieee"
        yield
    finally:
        for m, value in zip(_MATMUL, saved):
            m.fp32_precision = value
