"""The port's global knobs, in one place.

Counterpart of `duckdb_imputation_tpu.config`, whose two functions set
XLA's compilation cache and JAX's platform; neither has a meaning here.
What the port builds at run time goes under `build/` at the root of the
checkout (gitignored): the CUDA kernels (`ring/kernels/_build.py`) and
the native CSV library (`table/native.py`), each from the repo's own
sources. The entry points put their tensors on `DEFAULT_DEVICE` unless
the caller names another device.
"""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD_ROOT = ROOT / "build"
KERNEL_BUILD_DIR = BUILD_ROOT / "kernels"
NATIVE_BUILD_DIR = BUILD_ROOT / "native"
# the C++ source the JAX package's binding builds with make; the port
# compiles it itself into NATIVE_BUILD_DIR and never touches native/
NATIVE_SOURCE = ROOT / "native" / "columnar.cpp"
DEFAULT_DEVICE = "cuda"
