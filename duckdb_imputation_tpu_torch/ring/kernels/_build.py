"""Build the package's CUDA kernels and bind them to torch through ctypes.

The sources under `duckdb_imputation_tpu_torch/csrc/` are compiled by
`nvcc` for sm_90a into one shared library with a plain C interface, at
first use (never at import), into `build/kernels/` at the root of the
checkout. The library's name carries a hash of the sources and flags, so
an edit rebuilds and an unchanged tree loads the library already built.

The helpers below are what every kernel wrapper does around a launch:
check the tensors, pass their pointers, size the grid, launch on torch's
current stream, and raise on a nonzero cudaError_t.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("masked_gram.cu", "fused_impute_aggregate.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest grid of the Gram kernels: about 8 resident 256-thread blocks on
# each of an H100's 132 SMs. A function of n only, so a result does not
# depend on the card it ran on.
MAX_BLOCKS = 1024
CHUNK_ROWS = 256  # rows a block stages per step (kChunk in gram_common.cuh)
MAX_SIGMA_SIZE = 88  # kMaxP: every thread of a block owns one 4x4 tile
MAX_COLS = 64        # kMaxCols, numeric and categorical each


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when the library was already built
    log: str               # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "duckdb_imputation_tpu_torch need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint32)
    lib.dit_masked_gram.argtypes = [p, i, p, p, i, p, i64, i, p, i, p, p]
    lib.dit_masked_gram.restype = i
    lib.dit_fused_impute_aggregate.argtypes = [
        p, i, p, p, i, p, p, p, p, i, i, i, p, i, u32, u32, u32, p, i64, i,
        p, i, p, p]
    lib.dit_fused_impute_aggregate.restype = i
    lib.dit_gram_entries.argtypes = [i]
    lib.dit_gram_entries.restype = i
    lib.dit_error_string.argtypes = [i]
    lib.dit_error_string.restype = ctypes.c_char_p


@functools.cache
def load() -> Library:
    """Build (if needed) and load the kernel library; raises on failure."""
    nvcc = _nvcc()
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    digest.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libdit_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return Library(lib=lib, path=path, build_seconds=seconds, log=log)


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers then take their
    plain version. Any CUDA tensor sends the call to the kernel."""
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(tensors, checks) -> torch.device:
    """Every tensor on one CUDA device, contiguous; checks = [(tensor,
    dtype, shape, name)]. Raises ValueError on anything the kernels do not
    take. Returns the device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel inputs must all lie on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    for t, dtype, shape, name in checks:
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    return next(iter(devices))


def check_schema(schema, n: int) -> None:
    """Raise ValueError for a schema or row count the kernels do not take."""
    if schema.sigma_size > MAX_SIGMA_SIZE:
        raise ValueError(f"sigma size {schema.sigma_size} > {MAX_SIGMA_SIZE}"
                         f" is not supported by the Gram kernels yet")
    if schema.num_cols > MAX_COLS or schema.cat_cols > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} numeric or categorical "
                         f"columns is not supported by the Gram kernels")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the Gram kernels take fewer than 2^31")


def pointers(tensors):
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def int_array(values):
    """A C array of ints."""
    return (ctypes.c_int * len(values))(*values)


def grid_blocks(n: int) -> int:
    return max(1, min(-(-n // CHUNK_ROWS), MAX_BLOCKS))


def raise_on_error(lib: Library, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.dit_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
