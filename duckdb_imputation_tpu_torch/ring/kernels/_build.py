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
           "nb_grouped_sums.cu", "qda_predict.cu", "wide_gram.cu",
           "grouped_wide_gram.cu")
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
MAX_WIDE_SIGMA_SIZE = 1024  # kMaxWideP (wide_gram.cuh): K7, K2w and K8
WIDE_TILE = 64       # kWideTile (wide_gram.cuh): side of a region of S
WIDE_CHUNK = 128     # kWideChunk (wide_gram.cuh): rows a block stages a step
MAX_COLS = 64        # kMaxCols (gram_common.cuh), numeric and categorical
MAX_UNSORTED_GROUPS = 8  # kMaxUnsortedGroups (grouped_gram.cu): K4's tiles
MAX_NB_GROUPS = 32       # kMaxNbGroups (nb_grouped_sums.cu): K6 per launch
MAX_NB_FEATURES = 256    # kThreads (gram_common.cuh): K6's F = 1 + 2d + V;
                         # K6w sums wider F in ranges of this many features
MAX_NB_RANGES = 65535    # kMaxNbRanges (nb_grouped_sums.cu): K6w's gridDim.y
MAX_QDA_COLS = 32        # kMaxQdaCols (qda_predict.cu): K3 and K3w, d and c
MAX_QDA_SMEM = 227 * 1024  # kMaxQdaSmem (qda_predict.cu): K3's factors;
                           # K3w reads larger ones from device memory
QDA_RANK_ALIGN = 4       # kQdaRankAlign (qda_predict.cu): the factor's
                         # columns come in float4s


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
    for qda in (lib.dit_qda_predict, lib.dit_qda_predict_wide):
        qda.argtypes = [p, i, p, p, i, p, p, p, i, i, i, i64, p, i, p]
        qda.restype = i
    lib.dit_grouped_wide_gram.argtypes = [p, i, p, p, i, p, p, p, i, i64, i,
                                          p, i, i, p, p, p]
    lib.dit_grouped_wide_gram.restype = i
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
    max_sigma: MAX_SIGMA_SIZE for the narrow kernels alone (K1, K2, K4,
    K5), MAX_WIDE_SIGMA_SIZE for the wrappers that switch to their wide
    kernels above MAX_SIGMA_SIZE (K7, K2w, K8)."""
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


def nb_features(schema) -> int:
    """F = 1 + 2d + V, the NB sums of one group."""
    return 1 + 2 * schema.num_cols + schema.vocab_size


def nb_ranges(schema) -> int:
    """Feature ranges of the NB kernel's grid (blockIdx.y): 1 is K6 (F ≤
    256, one feature a thread and several row groups), more is K6w (a
    range of 256 features a block, the table read once per range)."""
    return -(-nb_features(schema) // MAX_NB_FEATURES)


def check_nb(schema, n: int) -> None:
    """Raise ValueError for an NB schema or row count K6/K6w do not take."""
    if nb_ranges(schema) > MAX_NB_RANGES:
        raise ValueError(f"{nb_features(schema)} NB features (1 + 2d + V) "
                         f"are more than the NB kernel's grid holds")
    if schema.num_cols > MAX_COLS or schema.cat_cols > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} numeric or categorical "
                         f"columns is not supported by the NB kernel")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the NB kernel takes fewer than 2^31")


def qda_smem_bytes(m: int, num_classes: int, rank: int) -> int:
    """Shared memory K3 stages: the factors f32[C, m, r], lin f32[C, m]
    and the intercepts f32[C]."""
    return 4 * num_classes * (m * rank + m + 1)


def qda_route(schema, num_classes: int, rank: int) -> str:
    """'K3' when the factors f32[C, m, rank] fit K3's shared memory, else
    'K3w' (factors read from device memory); raises ValueError for a
    schema or class count neither takes."""
    if schema.num_cols > MAX_QDA_COLS or schema.cat_cols > MAX_QDA_COLS:
        raise ValueError(f"more than {MAX_QDA_COLS} numeric or categorical "
                         f"columns is not supported by the QDA kernels")
    if num_classes < 1:
        raise ValueError(f"{num_classes} classes: at least 1 is needed")
    m = schema.sigma_size - 1
    return ("K3" if qda_smem_bytes(m, num_classes, rank) <= MAX_QDA_SMEM
            else "K3w")


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


def group_chunks(offsets: torch.Tensor, rows: int) -> torch.Tensor:
    """Group-aligned chunks of rows sorted by group (`sort_by_group`'s
    offsets i64[G + 1]): cum i64[G + 1], cum[g] the first chunk of group g,
    cum[G] the chunk count. A chunk of `rows` rows never crosses a group
    boundary, so the row slices of K5 and K8, runs of whole chunks, meet
    the groups in order. On the offsets' device, with no host sync."""
    chunks = (offsets[1:] - offsets[:-1] + rows - 1) // rows
    return torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)])


def wide_slices(n: int, nregions: int) -> int:
    """Row slices of K7's and K8's grid (blockIdx.y): about MAX_BLOCKS
    blocks in all, never more slices than chunks. A function of n and the
    schema only, so a result does not depend on the card it ran on (K8's
    slices are runs of group-aligned chunks, `group_chunks`)."""
    return max(1, min(-(-n // WIDE_CHUNK), -(-MAX_BLOCKS // nregions)))


def raise_on_error(lib: Library, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.dit_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
