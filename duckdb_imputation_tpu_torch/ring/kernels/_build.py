"""Build the package's CUDA kernels and bind them to torch through ctypes.

The sources under `duckdb_imputation_tpu_torch/csrc/` are compiled by
`nvcc` for sm_90a, one process per source, all started together, and
linked into one shared library with a plain C interface, at first use
(never at import), into `build/kernels/` at the root of the checkout. The
library's name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree loads the library already built.

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
SOURCES = ("masked_gram.cu", "fused_impute_aggregate.cu", "grouped_gram.cu",
           "nb_grouped_sums.cu", "qda_predict.cu", "wide_gram.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Largest grid of the Gram kernels: about 8 resident 256-thread blocks on
# each of an H100's 132 SMs. A function of n only, so a result does not
# depend on the card it ran on.
MAX_BLOCKS = 1024
# The kernels' limits. The sources under csrc/ fix each one as the C++
# constant named beside it, and each value here must equal that constant:
# the checks below raise ValueError before a launch the kernel would refuse.
CHUNK_ROWS = 256     # kChunk (gram_common.cuh): rows a block stages a step
MAX_SIGMA_SIZE = 88  # kMaxP (gram_common.cuh): one 4x4 tile a thread
MAX_WIDE_SIGMA_SIZE = 1024  # kMaxWideP (wide_gram.cuh): K7 and K2w
WIDE_TILE = 64       # kWideTile (wide_gram.cuh): side of a region of S
WIDE_CHUNK = 128     # kWideChunk (wide_gram.cuh): rows a block stages a step
MAX_COLS = 64        # kMaxCols (gram_common.cuh), numeric and categorical
MAX_UNSORTED_GROUPS = 8  # kMaxUnsortedGroups (grouped_gram.cu): K4's tiles
MAX_NB_GROUPS = 32       # kMaxNbGroups (nb_grouped_sums.cu): K6 per launch
MAX_NB_FEATURES = 256    # kThreads (gram_common.cuh): K6, F = 1 + 2d + V
MAX_QDA_COLS = 32        # kMaxQdaCols (qda_predict.cu): K3, d and c each
MAX_QDA_SMEM = 227 * 1024  # kMaxQdaSmem (qda_predict.cu): K3's factors


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
    lib.dit_grouped_gram.argtypes = [p, i, p, p, i, p, p, i, i64, i, p, i,
                                     p, p]
    lib.dit_grouped_gram.restype = i
    lib.dit_presorted_gram.argtypes = [p, i, p, p, i, p, p, p, i, i64, i, p,
                                       i, p, p]
    lib.dit_presorted_gram.restype = i
    lib.dit_nb_grouped_sums.argtypes = [p, i, p, p, i, p, p, i, i, i64, p, i,
                                        p, p]
    lib.dit_nb_grouped_sums.restype = i
    lib.dit_qda_predict.argtypes = [p, i, p, p, i, p, p, p, i, i, i64, p, i,
                                    p]
    lib.dit_qda_predict.restype = i
    lib.dit_wide_gram.argtypes = [p, i, p, p, i, p, i64, i, p, i, i, p, p, p]
    lib.dit_wide_gram.restype = i
    lib.dit_fused_impute_aggregate_wide.argtypes = [
        p, i, p, p, i, p, p, p, p, i, i, i, p, i, u32, u32, u32, p, i64, i,
        p, i, i, p, p, p]
    lib.dit_fused_impute_aggregate_wide.restype = i
    lib.dit_wide_region_entries.argtypes = []
    lib.dit_wide_region_entries.restype = i
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
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(srcs, objs)]
            outs = [proc.communicate()[0] for proc in procs]
            log = "".join(outs)
            failed = [src.name for src, proc in zip(srcs, procs)
                      if proc.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            lib_tmp = Path(tmp) / "lib.so"
            proc = subprocess.run(
                [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)],
                capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):"
                                   f"\n{log}")
            os.replace(lib_tmp, path)
        seconds = time.perf_counter() - t0
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


def check_schema(schema, n: int, max_sigma: int = MAX_SIGMA_SIZE) -> None:
    """Raise ValueError for a schema or row count the kernels do not take.
    max_sigma: MAX_SIGMA_SIZE for the grouped Grams (K4, K5),
    MAX_WIDE_SIGMA_SIZE for the masked Gram and the fused pass (K1/K7,
    K2/K2w), which switch to their wide kernels above MAX_SIGMA_SIZE."""
    if schema.sigma_size > max_sigma:
        raise ValueError(f"sigma size {schema.sigma_size} > {max_sigma}"
                         f" is not supported by this kernel")
    if schema.num_cols > MAX_COLS or schema.cat_cols > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} numeric or categorical "
                         f"columns is not supported by the Gram kernels")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the Gram kernels take fewer than 2^31")


def check_groups(num_groups: int, limit: int | None = None) -> None:
    """Raise ValueError for a group count a grouped kernel does not take."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be at least 1, got {num_groups}")
    if limit is not None and num_groups > limit:
        raise ValueError(f"{num_groups} groups > {limit}, the unsorted "
                         f"grouped Gram kernel's limit (register tiles per "
                         f"thread); sort by group and use the sorted one")
    if num_groups >= 1 << 31:
        raise ValueError(f"{num_groups} groups: fewer than 2^31 are taken")


def check_nb(schema, n: int) -> None:
    """Raise ValueError for an NB schema or row count K6 does not take."""
    f = 1 + 2 * schema.num_cols + schema.vocab_size
    if f > MAX_NB_FEATURES:
        raise ValueError(f"{f} NB features (1 + 2d + V) > {MAX_NB_FEATURES}"
                         f" are not supported by the NB kernel")
    if schema.num_cols > MAX_COLS or schema.cat_cols > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} numeric or categorical "
                         f"columns is not supported by the NB kernel")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the NB kernel takes fewer than 2^31")


def check_qda(schema, num_classes: int) -> None:
    """Raise ValueError for a schema or class count K3 does not take."""
    m = schema.sigma_size - 1
    if schema.num_cols > MAX_QDA_COLS or schema.cat_cols > MAX_QDA_COLS:
        raise ValueError(f"more than {MAX_QDA_COLS} numeric or categorical "
                         f"columns is not supported by the QDA kernel")
    smem = 4 * num_classes * (m * m + m + 1)
    if num_classes < 1 or smem > MAX_QDA_SMEM:
        raise ValueError(f"{num_classes} classes of {m} features need "
                         f"{smem} bytes of factors in shared memory; the "
                         f"QDA kernel holds at most {MAX_QDA_SMEM}")


def pointers(tensors):
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def int_array(values):
    """A C array of ints."""
    return (ctypes.c_int * len(values))(*values)


def grid_blocks(n: int) -> int:
    return max(1, min(-(-n // CHUNK_ROWS), MAX_BLOCKS))


def wide_regions(schema) -> list[tuple[int, int]]:
    """K7's plan: the (lo_i, lo_j) of each 64×64 region of S's upper
    triangle that can be nonzero. A region off the diagonal whose two ranges
    both lie inside the one-hot block of one categorical column is dropped:
    a row sets at most one code of a column, so no row has a nonzero in
    both ranges, and S is zero there."""
    p, d = schema.sigma_size, schema.num_cols
    offs = schema.offsets
    blocks = [(1 + d + offs[j], 1 + d + offs[j + 1])
              for j in range(schema.cat_cols)]
    starts = range(0, p, WIDE_TILE)
    return [(i, j) for i in starts for j in starts if i <= j
            and (i == j or not any(lo <= i and min(j + WIDE_TILE, p) <= hi
                                   for lo, hi in blocks))]


def wide_slices(n: int, nregions: int) -> int:
    """Row slices of K7's grid (blockIdx.y): about MAX_BLOCKS blocks in
    all, never more slices than chunks. A function of n and the schema
    only, so a result does not depend on the card it ran on."""
    return max(1, min(-(-n // WIDE_CHUNK), -(-MAX_BLOCKS // nregions)))


def raise_on_error(lib: Library, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.dit_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
