"""Build the package's CUDA kernels and bind them to torch through ctypes.

The sources under `duckdb_imputation_tpu_torch/csrc/` are compiled by
`nvcc` for sm_90a, one process per source, all started together, and
linked into one shared library with a plain C interface, at first use
(never at import), into `build/kernels/` at the root of the checkout
(`config.KERNEL_BUILD_DIR`). The
library's name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree loads the library already built.

The helpers below are what every kernel wrapper does around a launch:
check the tensors, pass their pointers, size the grid, launch on torch's
current stream, and raise on a nonzero cudaError_t.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import heapq
import itertools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ... import config

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = config.KERNEL_BUILD_DIR
SOURCES = ("masked_gram.cu", "fused_impute_aggregate.cu", "grouped_gram.cu",
           "nb_grouped_sums.cu", "qda_predict.cu", "wide_gram.cu",
           "grouped_wide_gram.cu", "window_order.cu", "dense_gram.cu")
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
MAX_SIGMA_SIZE = 88  # kMaxP (gram_common.cuh): the narrow kernels' P
TC_ROWS = 128        # kTcRows (tc_gram.cuh): rows a K1 block stages a step
TC_A = 21            # kTcA (tc_gram.cuh): K1's most P on the tensor cores
TC_RIGHT = 32        # kTcRight (tc_gram.cuh): right features of K1's tile
# K1's largest grid: one wave of 5 resident 128-thread blocks on each of an
# H100's 132 SMs (tools/k1_variants.py: 0.389 ms at config 5 against 0.438
# at 1,024 blocks); a constant, so a result does not depend on the card it
# ran on
TC_MAX_BLOCKS = 660
MAX_WIDE_SIGMA_SIZE = 1024  # kMaxWideP (wide_gram.cuh): K7's whole plan,
                            # K2w's fused entry and K8's whole plan; past
                            # it K2w (its impute kernel, dit_impute_wide,
                            # then K7's windows) and K8 run a launch a
                            # column window, and K3/K3w take any P up to
                            # MAX_SCORER_SIGMA_SIZE
# kMaxWindowP (wide_gram.cuh): K7, K8 and K2w over column windows. The
# width that sets it is the int count of a window's map entries
# (WidePlanArgs::nentries, `WidePlan.shape_ints`): a window of
# WINDOW_WIDTH columns maps at most P·WINDOW_WIDTH places (a wider one
# past MAX_WINDOW_PLACES runs as such windows, `window_cuts`), so P ≤
# (2³¹ − 1) // WINDOW_WIDTH. Every index of S (an entry's i, j, a
# column's offset) is an int below P, every position into S an int64.
# The dense f32 S and the allocator bound what fits well before it (S of
# 47,412² is 9.0 GB; S alone fills an 80 GB card near P = 141,000), and
# past that torch's out-of-memory error is the answer
MAX_WINDOW_SIGMA_SIZE = 2097151
# kMaxScorerP (qda_predict.cu): K3/K3w score a class's whole quadratic
# form over one plan of S (no windows), P² cells a class counted in int
# places (`qda_plan`'s map), and the trainers hand it f64[C, P, P] forms
# (18 GB a class at P = 47,412): past 46,340 (P² ≥ 2³¹) out of reach in
# either package
MAX_SCORER_SIGMA_SIZE = 46340
WINDOW_WIDTH = 1024  # the windows masked_gram(_cols) assemble S from above
                     # MAX_WIDE_SIGMA_SIZE: the width K7 was tuned at
MAX_WINDOW_PLACES = 1 << 28  # most places of one window's plans (4 GB of
                             # map); a wider window runs as windows of
                             # WINDOW_WIDTH (`window_cuts`): criteo_mid's
                             # whole S has 1.3e9
WIDE_CHUNK = 32      # kWideChunk (wide_gram.cuh): rows a warp takes a step,
                     # one a lane; also the most cells of a D slab
WIDE_WARPS = 8       # kWideWarps (wide_gram.cuh): warps of a K7/K8 block
WIDE_TASK_BYTES = 64 * 1024  # kWideTaskBytes (wide_gram.cuh): the f64
                             # tables of one task in shared memory
WIDE_SLAB_INTS = 8   # kWideSlabInts (wide_gram.cuh): ints of a slab record
WIDE_MAX_SLABS = 256  # kWideMaxSlabs (wide_gram.cuh): slabs of one task
WIDE_STAGE_ROWS = 256  # kThreads (gram_common.cuh): most rows a block
                       # stages a step, one a thread
WIDE_SMEM = 227 * 1024  # kWideSmem (wide_gram.cuh): a block's shared memory
WIDE_PLAN_INTS = 8   # kWidePlanInts (wide_gram.cuh): WidePlan.shape_ints
KEYED_TASK_INTS = 3  # kKeyedTaskInts (wide_gram.cuh): KeyedPlan.task_keys
ITEM_MIN_CHUNKS = 8  # fewest chunks of the blocks keyed work items are
                     # cut at (`item_chunks`): a block's stage
ORDER_WARPS = 2048   # warps of an order pass (window_order.cu), about: a
                     # segment of a group's rows each
ORDER_CELLS = 1 << 23  # most (key, segment) counters of an order pass
INLINE_COLS = 88     # kInlineCols (gram_common.cuh): columns of each kind
                     # the kernels' parameter holds; past them a wide
                     # kernel reads the columns' device table (`far_table`),
                     # and a narrow kernel (P ≤ 88) never needs it
ORDER_INLINE = 1 + 2 * INLINE_COLS  # kOrderInline (window_order.cu)
MAX_UNSORTED_GROUPS = 8  # kMaxUnsortedGroups (grouped_gram.cu): K4's G
ORDER_BLOCKS = 1024      # kOrderBlocks (grouped_gram.cu): most blocks of
                         # K4's group order
ORDER_MIN_CHUNKS = 8     # kOrderMinChunks (grouped_gram.cu): fewest chunks
                         # of CHUNK_ROWS rows an order block takes
NB_PLAN_INTS = 9         # kNbPlanInts (nb_grouped_sums.cu): NbPlan.shape_ints
NB_SLAB_CODES = 3        # kNbSlabCodes (nb_grouped_sums.cu): the NB plan's
                         # slab of a code range of one group's row of K_j
IMP_THREADS = 1024       # kImpThreads (fused_impute_aggregate.cu): threads
                         # of a K2w 'cat' impute block
IMP_MAX_M = 4            # kImpMaxM (fused_impute_aggregate.cu): most
                         # classes a lane scores a tile
IMP_FILL_ROWS = 8        # kFillRows (fused_impute_aggregate.cu): rows a
                         # thread a compaction step
IMP_BATCH = 2048         # most null rows of a batch past W's class tiles
IMP_TILED_BATCH = 1024   # fewest a batch where W is streamed in tiles: W is
                         # read again from L2 for each batch
IMP_WHOLE_BATCH = 1024   # a batch where W lies whole in shared memory, read
                         # once a launch: a row a thread
QDA_THREADS = 1024       # kQdaThreads (qda_predict.cu): most threads of a
                         # K3/K3w block
QDA_TASK_CELLS = 4096    # the f32 cells of a K3/K3w task (`qda_plan`):
                         # a row tile of 1,024 × 4 beside two classes'
                         # tables (tools/qda_variants.py --schedules:
                         # 15.67 / 1.354 ms at favorita_classify's family /
                         # onpromotion, 16.08 / 1.633 at K7's 8,192)
QDA_SHORT_LEVELS = 32768  # kQdaShortLevels (qda_predict.cu): most levels
                          # of a column whose codes K3/K3w stage as i16;
                          # past them every code is staged as i32
QDA_MAX_GROUP = 4        # kQdaMaxGroup (qda_predict.cu): most classes a
                         # K3/K3w step stages
QDA_MAX_SUMS = 8         # kQdaMaxSums (qda_predict.cu): f64 sums a thread
                         # keeps in registers, rows · classes a step; the
                         # most rows a thread scores
QDA_LOCAL_ZEROS = 128    # kQdaLocalZeros (qda_predict.cu): the zero cells
                         # after a table of a local plan (`qda_local`),
                         # which a missed KB cell reads
QDA_LOCAL_TILE = 64      # columns of D's tiles and of a KB slab in a local
                         # plan: a task of 4,096 cells holds 64 × 64 of D
QDA_LOCAL_X = 128        # most numeric columns a task of a local plan
                         # stages (x in f64 for each row of the tile)


PLAN_CACHE_BYTES = 4 << 30   # most bytes of the plans kept on the host
                             # (`plan_cache`): every plan of the schemas
                             # before criteo_mid, a few of its windows


def tensor_bytes(obj) -> int:
    """Bytes of the tensors in obj: a tensor, a dataclass (a plan), or a
    tuple or list of them."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(map(tensor_bytes, obj))
    return 0


class BytesCache:
    """The results of the functions it wraps, least recently used first,
    kept while the bytes of their tensors (`tensor_bytes`) that lie in
    one part (`part` of a result, e.g. its device; one part by default)
    sum to at most `max_bytes`: an int, or a function of the part and the
    bytes it holds, called as a result is kept. A result larger than that
    is not kept. One store for every function wrapped by one instance."""

    def __init__(self, max_bytes, part=None):
        self.max_bytes = max_bytes
        self.part = part or (lambda out: None)
        self.store: collections.OrderedDict = collections.OrderedDict()
        self.held: collections.Counter = collections.Counter()

    def __call__(self, fn):
        @functools.wraps(fn)
        def cached(*args, **kwargs):
            key = (fn.__qualname__, args, tuple(sorted(kwargs.items())))
            if key in self.store:
                self.store.move_to_end(key)
                return self.store[key][0]
            out = fn(*args, **kwargs)
            self._keep(key, out)
            return out
        cached.cache_clear = self.clear
        return cached

    def _keep(self, key, out) -> None:
        size, part = tensor_bytes(out), self.part(out)
        cap = (self.max_bytes(part, self.held[part])
               if callable(self.max_bytes) else self.max_bytes)
        if size > cap:
            return
        for k in [k for k, v in self.store.items() if v[2] == part]:
            if self.held[part] + size <= cap:
                break
            self.held[part] -= self.store.pop(k)[1]
        self.store[key] = (out, size, part)
        self.held[part] += size

    def clear(self) -> None:
        self.store.clear()
        self.held.clear()


plan_cache = BytesCache(PLAN_CACHE_BYTES)


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
    lib.dit_masked_gram_cores.argtypes = [p, i, p, p, i, p, i64, i, p, i, p,
                                          p]
    lib.dit_masked_gram_cores.restype = i
    lib.dit_fused_impute_aggregate.argtypes = [
        p, i, p, p, i, p, p, p, p, i, i, i, p, i, u32, u32, u32, i64, p,
        i64, i, p, i, p, p]
    lib.dit_fused_impute_aggregate.restype = i
    lib.dit_fused_impute_aggregate_cores.argtypes = (
        lib.dit_fused_impute_aggregate.argtypes)
    lib.dit_fused_impute_aggregate_cores.restype = i
    lib.dit_grouped_gram.argtypes = [p, i, p, p, i, p, p, i, i64, i, p, p,
                                     p, p, i, p, p]
    lib.dit_grouped_gram.restype = i
    lib.dit_presorted_gram.argtypes = [p, i, p, p, i, p, p, p, i, i64, i, p,
                                       i, p, p]
    lib.dit_presorted_gram.restype = i
    lib.dit_nb_grouped_sums.argtypes = [p, i, p, p, i, p, p, p, i64, p, p,
                                        p, p, p, p, p, p, p]
    lib.dit_nb_grouped_sums.restype = i
    lib.dit_qda_predict.argtypes = [p, i, p, p, i, p, p, p, p, p, i, i, i,
                                    i64, i64, i, i, i, i, i, p, p, i, i, p,
                                    p]
    lib.dit_qda_predict.restype = i
    plan = [p] * 6   # WidePlan's tensors and its shape_ints
    lib.dit_grouped_wide_gram.argtypes = [p, i, p, p, i, p, p, p, p, i, i64,
                                          i, *plan, p, p, p]
    lib.dit_grouped_wide_gram.restype = i
    lib.dit_grouped_wide_gram_window.argtypes = [
        p, i, p, p, i, p, p, p, p, i, i64, i, i, i, i64, i64, *plan, p, p, p]
    lib.dit_grouped_wide_gram_window.restype = i
    lib.dit_wide_gram.argtypes = [p, i, p, p, i, p, p, i64, i, *plan, p, p,
                                  p]
    lib.dit_wide_gram.restype = i
    lib.dit_wide_gram_window.argtypes = [p, i, p, p, i, p, p, i64, i, i, i,
                                         i64, *plan, p, p, p]
    lib.dit_wide_gram_window.restype = i
    lib.dit_wide_gram_keyed.argtypes = [p, i, i, p, i64, i, i, i, i64, i64,
                                        p, i, p, p, p, p, p, p, i, i, i64,
                                        *plan, p, p, p]
    lib.dit_wide_gram_keyed.restype = i
    lib.dit_order_count.argtypes = [p, i, p, i, i64, i, p, p]
    lib.dit_order_count.restype = i
    lib.dit_order_scatter.argtypes = [i, i, p, i, i64, i, p, p, i, p, i, i,
                                      p, p]
    lib.dit_order_scatter.restype = i
    lib.dit_fused_impute_aggregate_wide.argtypes = [
        p, i, p, p, i, p, p, p, p, p, p, i, i, i, p, i, u32, u32, u32, i64, p,
        i64, i, *plan, p, p, p, p, p]
    lib.dit_fused_impute_aggregate_wide.restype = i
    lib.dit_impute_wide.argtypes = [
        p, i, p, p, i, p, p, p, p, i, i, i, i, p, i, u32, u32, u32, i64, p,
        i64, i, p, p, p]
    lib.dit_impute_wide.restype = i
    lib.dit_dense_gram.argtypes = [p, i, p, p, p, i, i64, i, p, i, i, i, i,
                                   i64, i64, p, p, p]
    lib.dit_dense_gram.restype = i
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
    kernels above MAX_SIGMA_SIZE (K7, K2w, K8). Any number of columns:
    P bounds them."""
    if schema.sigma_size > max_sigma:
        raise ValueError(f"sigma size {schema.sigma_size} > {max_sigma}"
                         f" is not supported by this kernel")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the Gram kernels take fewer than 2^31")


def check_groups(num_groups: int, limit: int | None = None) -> None:
    """Raise ValueError for a group count a grouped kernel does not take."""
    if num_groups < 1:
        raise ValueError(f"num_groups must be at least 1, got {num_groups}")
    if limit is not None and num_groups > limit:
        raise ValueError(f"{num_groups} groups > {limit}, the unsorted "
                         f"grouped Gram kernel's limit; sort by group and "
                         f"use the sorted one")
    if num_groups >= 1 << 31:
        raise ValueError(f"{num_groups} groups: fewer than 2^31 are taken")


def nb_features(schema) -> int:
    """F = 1 + 2d + V, the NB sums of one group."""
    return 1 + 2 * schema.num_cols + schema.vocab_size


def check_nb(schema, n: int) -> None:
    """Raise ValueError for an NB schema or row count K6/K6w do not take:
    any number of columns and groups (the plan, `nb_plan`, raises where a
    task cannot stage its columns in shared memory)."""
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the NB kernel takes fewer than 2^31")


def qda_code_bytes(schema) -> int:
    """Bytes of a staged code in K3/K3w (qda_predict.cu: the Code type):
    2 (i16) where every column has at most QDA_SHORT_LEVELS levels, else 4
    (i32)."""
    return 2 if max(schema.cat_sizes, default=0) <= QDA_SHORT_LEVELS else 4


def qda_smem_bytes(max_cells: int, schema, tile: int, group: int = 1,
                   local_x: int | None = None) -> int:
    """Shared memory of a K3/K3w block (qda_predict.cu: qda_smem_bytes):
    two buffers of `group` f32 tables of the plan's largest task (a
    multiple of 4 cells), each followed by 1 + d zero cells rounded up to
    a 16-byte word, and a tile of `tile` rows of x (in f64) and codes
    (`qda_code_bytes` each). local_x: a local plan's (`qda_local`) most
    numeric columns of a task, which its tile stages in place of all d,
    its tables followed by QDA_LOCAL_ZEROS zero cells."""
    d = schema.num_cols
    zeros = (1 + d + 3) // 4 * 4 if local_x is None else QDA_LOCAL_ZEROS
    return (4 * 2 * group * (max_cells + zeros)
            + tile * (8 * (d if local_x is None else local_x)
                      + qda_code_bytes(schema) * schema.cat_cols))


def qda_tile(schema, plan: "WidePlan", num_classes: int
             ) -> tuple[int, int, int]:
    """(threads, rows a thread, classes a step) of a K3/K3w block, with
    rows · classes = QDA_MAX_SUMS and classes ≤ `num_classes`. A plan of
    several tasks: QDA_THREADS threads and the largest row tile first (2
    classes a step, then 4), as its tables are copied again for every
    tile; a plan of one task (small tables): 256 threads, so that several
    blocks share an SM, and the most classes a step first (4, then 2), as
    a row's cells found once a step serve them all. Past shared memory:
    one class a step and fewer rows, then fewer threads. A local plan
    (`qda_local`): one row a thread and one class a step, the most threads
    whose tile of x fits."""
    if plan.num_tasks == 1:
        threads, groups = 256, (4, 2)
    else:
        threads, groups = QDA_THREADS, (2, 4)
    local_x = plan.max_stage_x if plan.local else None

    def fits(threads, rows, group):
        return qda_smem_bytes(plan.max_task_cells, schema, threads * rows,
                              group, local_x) <= WIDE_SMEM

    if plan.local:      # x of a task's columns a step: a row a thread,
        while threads > 32 and not fits(threads, 1, 1):   # a class a step
            threads //= 2
        return threads, 1, 1
    # tools/qda_variants.py --schedules, ms: at favorita_classify's family
    # (4,096 cells a task) 1024 × 4 × 2 15.67, 1024 × 2 × 4 16.06; at
    # config 4 256 × 2 × 4 0.746, 256 × 4 × 2 0.803, 256 × 8 × 1 1.174
    for group in groups:
        rows = QDA_MAX_SUMS // group
        if group <= min(num_classes, QDA_MAX_GROUP) and fits(threads, rows,
                                                            group):
            return threads, rows, group
    rows = QDA_MAX_SUMS
    while rows > 1 and not fits(threads, rows, 1):
        rows //= 2
    while threads > 32 and not fits(threads, rows, 1):
        threads //= 2
    return threads, rows, 1


def check_qda(schema, num_classes: int, n: int, cross: bool = True
              ) -> None:
    """Raise ValueError for a schema, class count or row count K3/K3w do
    not take: P ≤ MAX_SCORER_SIGMA_SIZE (a class's whole P² form), any
    levels a column (a cross table whose rows pass a task is cut by row
    code too, `qda_plan`; codes past QDA_SHORT_LEVELS are staged as i32),
    any numeric columns (past a tile of 32 rows of x in f64 beside a
    task's tables, the plan is local, `qda_local`: a task stages its own
    columns)."""
    if num_classes < 1:
        raise ValueError(f"{num_classes} classes: at least 1 is needed")
    if schema.sigma_size > MAX_SCORER_SIGMA_SIZE:
        raise ValueError(
            f"sigma size {schema.sigma_size} > {MAX_SCORER_SIGMA_SIZE}: "
            f"K3/K3w score each class's whole P² quadratic form, whose "
            f"plan and f64 per-class tables are out of reach past it in "
            f"either package")
    check_schema(schema, n, MAX_SCORER_SIGMA_SIZE)


def qda_local(schema, cross: bool = True) -> bool:
    """Whether the scorer's plan is local: a tile of 32 rows of every
    numeric column in f64 and the codes does not fit shared memory beside
    two buffers of a task's tables (d > 756 with no categorical column),
    so each task reads few numeric columns and the kernel stages a task's
    columns a step (`_wide_plan`'s `local`)."""
    cells = (qda_task_cells(tuple(schema.cat_sizes)) if cross
             else QDA_TASK_CELLS)
    return qda_smem_bytes(cells, schema, 32) > WIDE_SMEM


def pointers(tensors):
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


_FAR_TABLES: dict = {}
_FAR_KEEP = 64


def far_table(x_cols, code_cols, sizes, device) -> int:
    """The device address of the columns' table (gram_common.cuh: Cols),
    or 0 where every kind has at most INLINE_COLS columns (the kernel
    parameter holds them all): int64 [x pointers (d) | code pointers (c) |
    sizes (c) | sigma offsets (c)] on `device`, copied once for a set of
    column addresses and kept (the last _FAR_KEEP sets; an address names
    the column a caller passes now, so a kept table never goes stale),
    one for each stream: its copy is ordered before the launches on the
    current stream."""
    d, c = len(x_cols), len(code_cols)
    if d <= INLINE_COLS and c <= INLINE_COLS:
        return 0
    ptrs = [t.data_ptr() for t in x_cols] + [t.data_ptr() for t in code_cols]
    key = (str(device), torch.cuda.current_stream(device).cuda_stream,
           tuple(ptrs), tuple(sizes))
    table = _FAR_TABLES.pop(key, None)
    if table is None:
        offs, o = [], 1 + d
        for v in sizes:
            offs.append(o)
            o += v
        table = torch.tensor(ptrs + list(sizes) + offs, dtype=torch.int64
                             ).to(device, non_blocking=True)
        while len(_FAR_TABLES) >= _FAR_KEEP:
            _FAR_TABLES.pop(next(iter(_FAR_TABLES)))
    _FAR_TABLES[key] = table
    return table.data_ptr()


def column_args(x_cols, code_cols, sizes, device) -> tuple:
    """The columns as the C entry points take them: (x pointers, d, code
    pointers, sizes, c, the columns' table or 0: `far_table`)."""
    return (pointers(x_cols), len(x_cols), pointers(code_cols),
            int_array(sizes), len(sizes),
            far_table(x_cols, code_cols, sizes, device))


def int_array(values):
    """A C array of ints."""
    return (ctypes.c_int * len(values))(*values)


def impute_smem_bytes(schema, ld: int, batch: int,
                      x_terms: bool | None = None) -> int:
    """Shared memory of a K2w 'cat' impute block (fused_impute_aggregate.cu:
    impute_smem_bytes): a class tile f32[P + 2, ld] (rounded up to 16
    bytes; none at ld = 0, W read from device memory), and per batch row
    its terms (x, then the codes' W-row offsets, each part padded to 4
    words), key, class and row index, and a compaction step's counts (one
    a warp and a row of a thread) and total. x_terms False: the batch
    rows keep no x, which the kernel reads from device memory; None: as
    the kernel decides (`impute_x_terms`)."""
    if x_terms is None:
        x_terms = impute_x_terms(schema, ld, batch)
    p, d, c = schema.sigma_size, schema.num_cols, schema.cat_cols
    r4 = lambda v: (v + 3) // 4 * 4   # noqa: E731
    return 4 * (r4((p + 2) * ld)
                + batch * (3 + (r4(d) if x_terms else 0) + r4(c))
                + IMP_FILL_ROWS * IMP_THREADS // 32 + 1)


def impute_x_terms(schema, ld: int, batch: int) -> bool:
    """Whether K2w's 'cat' impute kernel keeps a batch row's x in shared
    memory (fused_impute_aggregate.cu: impute_x_terms): where the plan
    fits with it; else each x is read from device memory as the row is
    scored, in the same order."""
    return impute_smem_bytes(schema, ld, batch, True) <= WIDE_SMEM


def _impute_batch(schema, ld: int, cap: int, x_terms: bool) -> int:
    """The most null rows a batch, in whole warps, up to `cap`, beside a
    class tile of ld classes (0: W in device memory)."""
    fixed = impute_smem_bytes(schema, ld, 0, x_terms)
    per_row = impute_smem_bytes(schema, ld, 1, x_terms) - fixed
    return min(cap, (WIDE_SMEM - fixed) // per_row // 32 * 32)


def impute_plan(schema, r: int) -> tuple[int, int, int]:
    """(ld, M, batch) of K2w's 'cat' impute kernel for R = r classes: W's
    class tiles of ld classes ([P + 2][ld] f32 in shared memory, one
    buffer, M = ceil(ld / 32) classes a lane), null rows a batch. W whole
    (ld = R, loaded once a launch) where R ≤ 32·IMP_MAX_M and it fits
    beside IMP_WHOLE_BATCH rows; else the widest tile that fits beside
    IMP_TILED_BATCH rows (tools/k2_times.py --plans: at favorita_wide,
    R = 337, 64 classes a tile beat 32); else 32 classes. The batch is the
    most rows that fit, up to IMP_BATCH (IMP_WHOLE_BATCH for W whole), in
    whole warps. Where none fits with each batch row's x in shared memory
    (d ≥ 881 at R = 33), the same choice with x read from device memory
    (`impute_x_terms`)."""
    cands = []
    if r <= 32 * IMP_MAX_M:
        cands.append((r, IMP_WHOLE_BATCH, 32))
    cands += [(32 * m, IMP_BATCH, IMP_TILED_BATCH) for m in (IMP_MAX_M, 2)]
    cands.append((32, IMP_BATCH, 32))
    for x_terms in (True, False):
        for ld, cap, least in cands:
            batch = _impute_batch(schema, ld, cap, x_terms)
            if batch >= least:
                return ld, -(-ld // 32), batch
    raise ValueError(f"K2w: no impute plan fits shared memory at P = "
                     f"{schema.sigma_size}")


def impute_global_plan(schema, r: int) -> tuple[int, int, int]:
    """(ld, M, batch) of K2w's 'cat' impute kernel past
    MAX_WIDE_SIGMA_SIZE, W read from device memory (`dit_impute_wide`):
    tiles of ld = 32·M classes, M = ceil(R / 32) up to IMP_MAX_M, and
    IMP_BATCH null rows a batch, or the most whole warps shared memory
    holds beside no class tile; where not 32 rows of x fit (d ≥ 1,801),
    x is read from device memory (`impute_x_terms`). ValueError where W
    padded to [P + 2][ldw] (ldw: R rounded up to a tile) reaches 2³¹
    cells: the kernel reads it through int offsets (R past about 2³¹ / P
    classes: 45,184 at P = 47,412)."""
    m = min(IMP_MAX_M, -(-r // 32))
    ldw = -(-r // (32 * m)) * 32 * m
    if (schema.sigma_size + 2) * ldw >= 1 << 31:
        raise ValueError(
            f"K2w: W of [{schema.sigma_size} + 2][{ldw}] cells reaches "
            f"2^31, past the impute kernel's int offsets into it")
    batch = _impute_batch(schema, 0, IMP_BATCH, True)
    if batch < 32:
        batch = _impute_batch(schema, 0, IMP_BATCH, False)
    if batch < 32:
        raise ValueError(f"K2w: no impute plan fits shared memory at P = "
                         f"{schema.sigma_size}")
    return 32 * m, m, batch


def grid_blocks(n: int) -> int:
    return max(1, min(-(-n // CHUNK_ROWS), MAX_BLOCKS))


def tc_fits(d: int, p: int) -> bool:
    """Whether K1 takes S f32[P, P] of d numerics on the tensor cores
    (tc_gram.cuh: tc_fits): S is its one output tile, the three bf16 parts
    of each a (3P ≤ 63 left features) by 1 + 3d + V ≤ TC_RIGHT right
    features (3 parts of each x, 1 for the constant and each one-hot).
    BASELINE config 5 (d = 4, P = 21) fits; any other P ≤ 88 takes K1's
    CUDA-core route, which reads the rows once (tiled over several
    tensor-core tiles, each staging the rows again, it was slower at every
    schema measured: PERF.md §6)."""
    return p <= TC_A and p + 2 * d <= TC_RIGHT


DENSE_TILE = 64          # kDgTile (dense_gram.cu): columns of [1 ‖ x] a side
                         # of a D tile
DENSE_CELLS = DENSE_TILE * DENSE_TILE
DENSE_BLOCKS = 1056      # the D kernel's grid, about: four waves of its two
                         # resident blocks on each of an H100's 132 SMs
DENSE_SLICE_ROWS = 2048  # fewest rows a row slice of the D kernel takes
# The crossover: K7's, K8's and K2w's D leaves the slab plans for the tile
# kernel on the tensor cores (dense_gram.cu) at d numeric columns and up
# (`dense_route`). Chosen by tools/dense_crossover.py (H100 80GB HBM3,
# 700.00 W, 10M rows): K7 with D on the slabs / on the tiles, ms, at d = 3
# (favorita_wide) 6.87 / 9.62, d = 16 6.48 / 4.79, d = 32 23.9 / 7.44,
# d = 64 114.7 / 25.4, d = 104 (Home Credit) 328.4 / 99.5, d = 128 449.8
# / 89.4 (PERF.md §6): the smallest d measured where the tiles win
DENSE_MIN_D = 16


def dense_route(d: int) -> bool:
    """Whether D, the dense (1+d)×(1+d) block of [1 ‖ x] in S, is the tile
    kernel's (dense_gram.cu, on the tensor cores) in K7, K8 and K2w: d ≥
    DENSE_MIN_D. Their plans then hold no D slab (`wide_plan`,
    `window_plan`, `keyed_window_plan`); the scorer's plans keep theirs."""
    return d >= DENSE_MIN_D


def dense_blocks(d: int) -> int:
    """Tiles of DENSE_TILE columns on a side of D (1 + d columns)."""
    return -(-(1 + d) // DENSE_TILE)


@functools.lru_cache(maxsize=4096)
def dense_tiles(d: int, lo: int, hi: int) -> torch.Tensor | None:
    """The D tiles of the window S[:, lo:hi]: (I, J) i32[T, 2], I ≤ J, the
    tiles of D's upper triangle (cells (a, b), a ≤ b, of rows [64I, 64I +
    64) and columns [64J, 64J + 64) of [1 ‖ x]) with a place in the window:
    D[a, b] where lo ≤ b < hi, D[b, a] where lo ≤ a < hi. None where the
    window holds no place of D. Made once a (d, lo, hi); read only."""
    tb, m = DENSE_TILE, 1 + d

    def meets(i):
        return max(i * tb, lo) < min(i * tb + tb, m, hi)
    tiles = [(i, j) for i in range(dense_blocks(d))
             for j in range(i, dense_blocks(d)) if meets(i) or meets(j)]
    return torch.tensor(tiles, dtype=torch.int32) if tiles else None


def dense_slices(n: int, d: int, groups: int = 1) -> int:
    """Row slices of each group in the D kernel's grid (tiles × slices ×
    groups, one dimension): about DENSE_BLOCKS blocks over the whole D's
    tiles, each slice
    at least DENSE_SLICE_ROWS rows where n allows. A function of n, d and
    G only, the same in every window, so a cell two windows hold (D[a, b]
    in one, D[b, a] in another) is the same sum, and a result does not
    depend on the card it ran on."""
    nb = dense_blocks(d)
    tiles = nb * (nb + 1) // 2
    return max(1, min(-(-n // (groups * DENSE_SLICE_ROWS)),
                      -(-DENSE_BLOCKS // (tiles * groups))))


def dense_map(tiles: torch.Tensor, d: int,
              window: tuple[int, int] | None = None) -> np.ndarray:
    """The places of the D tiles' cells, as a plan's map lists its cells':
    i32[3, M] of (cell, i, j), cell = t·DENSE_CELLS + (a − 64I)·64 + b −
    64J the cell (a, b) of tile t, a ≤ b < 1 + d; without `window`, once a
    cell at (a, b) (S[b, a] the same value); with a window (lo, hi), each
    place S[i, j] with lo ≤ j < hi."""
    t = tiles.numpy().astype(np.int64)
    r = np.arange(DENSE_TILE, dtype=np.int64)
    a = np.broadcast_to(t[:, 0, None, None] * DENSE_TILE + r[None, :, None],
                        (len(t), DENSE_TILE, DENSE_TILE))
    b = np.broadcast_to(t[:, 1, None, None] * DENSE_TILE + r[None, None, :],
                        (len(t), DENSE_TILE, DENSE_TILE))
    cell = np.arange(len(t) * DENSE_CELLS, dtype=np.int64).reshape(a.shape)
    keep = (a <= b) & (b < 1 + d)
    cell, a, b = (v[keep].astype(np.int32) for v in (cell, a, b))
    if window is None:
        return np.stack([cell, a, b])
    return _places(*window, cell, a, b)


def tc_grid(n: int) -> int:
    """K1's tensor-core blocks: a step of TC_ROWS rows each at most, at most
    TC_MAX_BLOCKS; a function of n only."""
    return max(1, min(-(-n // TC_ROWS), TC_MAX_BLOCKS))


def presorted_grid(d: int, p: int, n: int) -> tuple[int, int]:
    """(blocks, rows a step) of K5 (and of K4 after its group order): the
    tensor cores' grid and steps where `tc_fits`, else the CUDA cores'.
    Its partial holds a slot for each (block, group) a block may meet:
    blocks + G."""
    if tc_fits(d, p):
        return tc_grid(n), TC_ROWS
    return grid_blocks(n), CHUNK_ROWS


def order_geometry(n: int) -> tuple[int, int]:
    """(B, rows a block) of K4's group order (grouped_gram.cu:
    order_geometry): B contiguous slices of the rows, each a multiple of
    CHUNK_ROWS, at most ORDER_BLOCKS, each at least ORDER_MIN_CHUNKS chunks
    where n allows; a function of n only."""
    chunks = -(-n // CHUNK_ROWS)
    b = min(max(-(-chunks // ORDER_MIN_CHUNKS), 1), ORDER_BLOCKS)
    per = max(-(-chunks // b) * CHUNK_ROWS, CHUNK_ROWS)
    return max(-(-n // per), 1), per


def group_chunks(offsets: torch.Tensor, rows: int) -> torch.Tensor:
    """Group-aligned chunks of rows sorted by group (`sort_by_group`'s
    offsets i64[G + 1]): cum i64[G + 1], cum[g] the first chunk of group g,
    cum[G] the chunk count. A chunk of `rows` rows never crosses a group
    boundary, so the row slices of K5 and K8, runs of whole chunks, meet
    the groups in order. On the offsets' device, with no host sync."""
    chunks = (offsets[1:] - offsets[:-1] + rows - 1) // rows
    return torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)])


# Slab kinds of the wide plan, kSlabD, kSlabK, kSlabC, kSlabCR, kSlabCM,
# kSlabCB and kSlabKB (wide_gram.cuh; CR only in a window's keyed tasks, CM
# only where a schema has more than CM_TABLES cross tables, CB only where
# both columns of a cross table have more levels than a task's cells, KB
# only where a task staging every numeric column beside a code column passes
# shared memory, `_k_cols`)
SLAB_D, SLAB_K, SLAB_C, SLAB_CR, SLAB_CM, SLAB_CB, SLAB_KB = range(7)
KB_COLS = 128        # most columns of [1 ‖ x] a KB slab holds: the width of
                     # D's tiles in `_pack_local`, whose columns it reads
CM_TABLES = 4096     # cross tables past which the small ones of one key
                     # column merge into CM slabs (`_cross_runs`): SECOM's
                     # stream fold has 173,755 of one cell (590 null flags)
CM_SMALL = 64        # most cells of a cross table a CM slab takes
CM_MAX_COLS = 128    # most row columns of a CM slab


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """K7's and K8's plan: S's nonzero structure cut into tables, the
    tables into slabs, the slabs into tasks that fit a block's shared
    memory, and the map from each task's cells to entries of S.

    With Z = [1 ‖ x ‖ onehot(c_1) … onehot(c_c)] a row has 1 + d + c
    nonzeros, and S's upper triangle is made of
      D     the (1+d)×(1+d) block of [1 ‖ x], as slabs (D, a, b_lo, b_hi)
            of row a's cells (a, b), b in [b_lo, b_hi), at most WIDE_CHUNK;
      K_j   per categorical column j, the keyed sums Σ_{c_j=v} w·[1, x]:
            slabs (K, j, v_lo, v_hi), cell (v − v_lo)·(1+d) + a (a·(v_hi −
            v_lo) + v − v_lo in the scorer's plan, `scorer`); row a = 0
            holds the code counts, also the diagonal of j's one-hot block;
      C_jk  per pair j < k, Σ_{c_j=u, c_k=v} w: slabs (C, j, k, u_lo,
            u_hi), cell (u − u_lo)·V_k + v; where a schema has more than
            CM_TABLES of them, the small tables of one key column j whose
            row columns k_lo .. k_hi − 1 follow each other are one slab
            (CM, j, k_lo, k_hi), cell u·W + off_k − off_{k_lo} + v (W =
            Σ V_k, off_k the sigma index of k's code 0);
    everything else is zero by construction (two codes of one column in
    one row). A table larger than WIDE_TASK_BYTES of f64 is split by its
    leading key into slabs of equal key ranges; where even one key's row
    (V_k cells) passes a task, by row code too, into slabs (CB, j, k,
    u_lo, u_hi) of rows [v_lo, v_hi), cell (u − u_lo)·(v_hi − v_lo) + v −
    v_lo (`_row_cut`). Where a task staging every numeric column beside a
    code column passes shared memory (`_k_cols`: d ≥ 835), K_j is cut by
    column range of [1 ‖ x] too, into slabs (KB, j, v_lo, v_hi, a_lo,
    a_hi) of columns [a_lo, a_hi), cell (v − v_lo)·(a_hi − a_lo) + a − a_lo
    ((a − a_lo)·(v_hi − v_lo) + v − v_lo in the scorer's plan), so that its
    task stages only those columns.

    slabs i32[S, WIDE_SLAB_INTS]: (kind, p0, p1, p2, p3, off, task, warp),
      sorted by (task, warp); off is the slab's first cell in its task's
      table, and a warp's slabs lie next to each other.
    slots i32[S, 4]: the stage slots a slab reads (0: w, 1 .. nx: the task's
      numeric columns, then its code columns): D (a, b_lo, b_hi) x_a's
      slot (0 for a = 0) and s with x_b at slot s + b; K and KB j's codes
      and s with x_a at slot s + a (K's 0: a task with a K slab stages
      every numeric column), then their columns a_lo, a_hi of [1 ‖ x] (a
      K slab's 0, 1 + d);
      C, CB and CR the key's and the row column's; CM the key's and k_lo's
      (k's at that + k − k_lo); then a C or CB slab's rows v_lo, v_hi (a
      C slab's 0, V_k). The kernel's records carry the slots in place of
      (task, warp), a C or CB slab's v_lo, v_hi in place of its two
      columns, whose codes its slots name, and a KB slab's a_hi in place
      of j (`device_slabs`): the kernel reads a C slab as the CB slab of
      every row.
    warp_begin i32[T·WIDE_WARPS + 1]: warp w of task t owns the slabs
      warp_begin[t·W + w] .. warp_begin[t·W + w + 1].
    task_base i64[T + 1]: task t's cells are task_base[t] ..
      task_base[t + 1] of the flat list of every task's cells.
    entries i32[M, 4]: (task, cell, i, j), i ≤ j: S[i, j] = S[j, i] = that
      cell; every structurally nonzero (i, j) of the upper triangle once,
      sorted by (task, cell). A window's plan (`window_plan`): S[i, j] =
      that cell for one place (i, j) with j in the window; every
      structurally nonzero place of the window once.
    stage_cols i32[T, 2 + L]: (nx, nc, the numeric columns task t's slabs
      read, then its code columns, ascending each, −1 past them): what its
      blocks stage after w. L = max_stage_cols − 1.
    shape: the sizes the kernel's shared memory is cut by (`shape_ints`).
    """
    slabs: torch.Tensor
    warp_begin: torch.Tensor
    task_base: torch.Tensor
    entries: torch.Tensor
    stage_cols: torch.Tensor
    slots: torch.Tensor
    max_stage_cols: int    # columns a block stages: w, its x and codes
    max_slabs: int         # slab records a block keeps in shared memory
    stage_rows: int        # rows a block stages a step (a multiple of 32)
    cross: bool = True     # whether it has the C_jk tables
    task_cells: int = WIDE_TASK_BYTES // 8  # the budget of a task, cells
    scorer: bool = False   # K3/K3w's tables: K_j's cell (v, a) at a·(v_hi −
                           # v_lo) + v − v_lo, and each task's cells padded
                           # to a multiple of 4 (whole 16-byte f32 words)
    window: tuple[int, int] | None = None  # [lo, hi): a window's plan
                           # (`window_plan`), whose map lists one place
                           # (i, j), lo ≤ j < hi, an entry
    local: bool = False    # a scorer's plan whose tasks each read few
                           # numeric columns (`qda_local`): K3/K3w stage a
                           # task's columns a step (`stage_cols`)
    dense: torch.Tensor | None = None  # D's tiles on the tensor cores
                           # (`dense_tiles`, `dense_route`), which then has
                           # no D slab; the kernels' cells of them follow
                           # the slabs' in `wide_tables_plain` (`dense_map`)

    @property
    def num_tasks(self) -> int:
        return self.task_base.shape[0] - 1

    @property
    def max_task_cells(self) -> int:
        if not self.num_tasks:     # D on the tensor cores and nothing else
            return 0
        return int((self.task_base[1:] - self.task_base[:-1]).max())

    @property
    def device_slabs(self) -> torch.Tensor:
        """The slab records the kernel reads: (kind, p0 .. p3, off, and
        the two stage slots of `slots` in place of task and warp), a C or
        CB slab's p0, p1 its rows v_lo, v_hi (a C slab's 0, V_k), a KB
        slab's p0 its end column a_hi."""
        out = torch.cat([self.slabs[:, :6], self.slots[:, :2]], 1)
        c = (out[:, 0] == SLAB_C) | (out[:, 0] == SLAB_CB)
        out[c, 1:3] = self.slots[c, 2:4]
        kb = out[:, 0] == SLAB_KB
        out[kb, 1] = self.slots[kb, 3]
        return out.contiguous()

    @property
    def max_stage_x(self) -> int:
        """The most numeric columns a task stages."""
        return int(self.stage_cols[:, 0].max())

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory (`wide_smem_bytes`)."""
        return wide_smem_bytes(self.max_task_cells, self.max_stage_cols,
                               self.max_slabs, self.stage_rows,
                               self.stage_cols.shape[1])

    def shape_ints(self, slices: int) -> list[int]:
        """The kernel's sizes (kWidePlanInts, wide_gram.cuh: make_plan):
        tasks, map entries, the most cells, staged columns and slabs of a
        task, rows a stage, slices, the stage list's width."""
        return [self.num_tasks, self.entries.shape[0], self.max_task_cells,
                self.max_stage_cols, self.max_slabs, self.stage_rows, slices,
                self.stage_cols.shape[1]]

    def slices(self, n: int) -> int:
        """Row slices of the grid (blockIdx.y): about MAX_BLOCKS blocks in
        all, never more slices than steps of WIDE_CHUNK rows. A function
        of n and the schema only, so a result does not depend on the card
        it ran on (K8's slices are runs of group-aligned chunks,
        `group_chunks`)."""
        if not self.num_tasks:
            return 1
        return max(1, min(-(-n // WIDE_CHUNK),
                          -(-MAX_BLOCKS // self.num_tasks)))


class _Grid(tuple):
    """The map of a slab of `keys` keys of `row` cells each whose cells
    fill one place each: cell c = du·row + dv at S[u, v] (`key_first`) or
    S[v, u], u = u0 + du, v = v0 + dv; written straight into the plan's
    map (`_plan_of`). (keys, row, u0, v0, key_first)."""

    @property
    def shape(self) -> tuple[int, int]:
        return 3, self[0] * self[1]


@functools.lru_cache(maxsize=256)
def _grid_cells(keys: int, row: int) -> tuple[np.ndarray, ...]:
    """(cell, du, dv) i32 of a `_Grid` of that shape, in cell order (read
    only: shared by every slab of the shape)."""
    cell = _ar(0, keys * row)
    out = (cell, cell // row, cell % row)
    for a in out:
        a.setflags(write=False)
    return out


def _write_map(out: np.ndarray, a: int, t: int, off: int, local) -> None:
    """A slab's map entries into out i32[4, M] at columns a ..: its task
    t, cells from `off` and places; `local` a `_Grid` or (cell, i, j)
    sorted by cell."""
    b = a + local.shape[1]
    out[0, a:b] = t
    if isinstance(local, _Grid):
        keys, row, u0, v0, key_first = local
        cell, du, dv = _grid_cells(keys, row)
        np.add(cell, off, out=out[1, a:b])
        np.add(du, u0, out=out[2 if key_first else 3, a:b])
        np.add(dv, v0, out=out[3 if key_first else 2, a:b])
    else:
        np.add(local[0], off, out=out[1, a:b])
        out[2:, a:b] = local[1:]


def _ar(lo: int, hi: int) -> np.ndarray:
    """i32 [lo, hi): the plan's map is built in numpy i32 (every cell of
    a task, and every index of S, is below 2³¹)."""
    return np.arange(lo, hi, dtype=np.int32)


def _by_cell(local: np.ndarray) -> np.ndarray:
    """A slab's map entries (cell, i, j) stably sorted by cell."""
    cell = local[0]
    if cell.shape[0] > 1 and bool((cell[1:] < cell[:-1]).any()):
        return local[:, np.argsort(cell, kind="stable")]
    return local


def _split(rows: int, row_cells: int, cap: int) -> list[tuple[int, int]]:
    """Key ranges [lo, hi) of `rows` keys of `row_cells` cells each, as
    even as the task budget of `cap` cells allows."""
    pieces = -(-rows * row_cells // cap)
    step = min(-(-rows // pieces), cap // row_cells)
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def _slab_cost(kind: int, cells: int, d: int) -> int:
    """A slab's instructions per warp step, roughly: what balances a
    task's warps."""
    if kind == SLAB_D:
        per = WIDE_CHUNK // cells            # lanes a cell: row parts
        return 12 + 5 * -(-WIDE_CHUNK // per)
    return 16 + 4 * (1 + d) if kind == SLAB_K else 20


def _piece_cost(piece, d: int) -> int:
    """`_slab_cost` of a piece; a CM slab costs a C slab a row column, a
    KB slab a K slab of its columns."""
    if piece[0] == SLAB_CM:
        return 20 * (piece[1][2] - piece[1][1])
    if piece[0] == SLAB_KB:
        return 16 + 4 * (piece[1][4] - piece[1][3])
    return _slab_cost(piece[0], piece[2], d)


def _pack_tasks(cells: list[int], cap: int) -> list[list[int]]:
    """Slabs of `cells` cells each into tasks of at most `cap` cells and
    WIDE_MAX_SLABS slabs."""
    # tasks: as few as the budget allows; the largest slab first, each to
    # the task with room that holds the fewest slabs, then the fewest
    # cells, then the lowest index (a block takes as long as its busiest
    # warp): a heap of (slabs, cells, task), the tasks without room for a
    # slab set aside while it is placed (a full one for good)
    order = sorted(range(len(cells)), key=lambda i: -cells[i])
    # no two slabs of more than half the budget share a task: each of them
    # (they come first) takes the next empty task, as the rule below would
    big = sum(2 * c > cap for c in cells)
    count = max(-(-sum(cells) // cap), big)
    while True:
        tasks: list[list[int]] = [[] for _ in range(count)]
        used = [0] * count
        for t, i in enumerate(order[:big]):
            tasks[t].append(i)
            used[t] = cells[i]
        heap = [(len(tasks[t]), used[t], t) for t in range(count)]
        heapq.heapify(heap)
        for i in order[big:]:
            aside = []
            while heap:
                slabs, cells_t, t = heapq.heappop(heap)
                if cells_t + cells[i] <= cap:
                    break
                if cells_t < cap:
                    aside.append((slabs, cells_t, t))
            else:
                break
            tasks[t].append(i)
            used[t] += cells[i]
            if slabs + 1 < WIDE_MAX_SLABS:
                heapq.heappush(heap, (slabs + 1, used[t], t))
            for e in aside:
                heapq.heappush(heap, e)
        else:
            return tasks
        count += 1


def _k_room(d: int) -> int:
    """The cells a task has room for where it stages, at WIDE_CHUNK rows a
    stage, w, the d numerics and a code column: what a K slab reads."""
    cols = 2 + d
    return (WIDE_SMEM - 4 * (2 * cols * WIDE_CHUNK + WIDE_SLAB_INTS
                             * WIDE_MAX_SLABS + cols + 1
                             + 2 * WIDE_STAGE_ROWS // WIDE_CHUNK)) // 8


def _column_cap(d: int, sizes: tuple[int, ...], cap: int) -> int:
    """The cells of a task where a K slab stages every numeric column: as
    many as leave room at WIDE_CHUNK rows a stage for w, the d numerics
    and a code column beside them (`cap` up to d ≈ 600); `cap` itself
    where not one key's row of K_j, 1 + d cells, fits (d ≥ 835): K_j is
    then cut by column range into KB slabs (`_k_cols`), whose tasks stage
    few columns."""
    if not sizes or _k_room(d) < 1 + d:
        return cap
    return min(cap, _k_room(d))


def _k_cols(d: int, cap: int) -> int:
    """Columns of [1 ‖ x] a slab of K_j holds in K7's and K8's plans: all
    1 + d (K slabs) where a key's row beside every staged numeric column
    fits a task (`_column_cap`); else min(KB_COLS, cap), KB slabs of
    `_k_ranges`."""
    return 1 + d if _k_room(d) >= 1 + d else min(KB_COLS, cap)


def _k_ranges(d: int, width: int) -> list[tuple[int, int]]:
    """[a_lo, a_hi) of K_j's slabs: the columns of [1 ‖ x] cut at the
    multiples of `width`."""
    return [(a, min(a + width, 1 + d)) for a in range(0, 1 + d, width)]


def _k_piece(j: int, lo: int, hi: int, a_lo: int, a_hi: int, base: int,
             scorer: bool, whole: bool, places=None):
    """The slab of K_j over keys [lo, hi) and columns [a_lo, a_hi): K
    where it holds every column (`whole`), else KB; each cell (v, a) at
    S[a, base + v] and, at a = 0, the one-hot diagonal S[base + v, base +
    v]. places: a window's (lo, hi), whose places alone are mapped."""
    w = a_hi - a_lo
    v = np.repeat(_ar(lo, hi), w)
    a = np.tile(_ar(a_lo, a_hi), hi - lo)
    cell = ((a - a_lo) * (hi - lo) + v - lo if scorer
            else (v - lo) * w + a - a_lo)
    diag = base + (_ar(lo, hi) if a_lo == 0 else _ar(0, 0))
    dcell = cell[a == 0]
    if places is None:
        local = np.concatenate([np.stack([cell, a, base + v]),
                                np.stack([dcell, diag, diag])], 1)
    else:
        on = (diag >= places[0]) & (diag < places[1])
        local = np.concatenate([_places(*places, cell, a, base + v),
                                np.stack([dcell, diag, diag])[:, on]], 1)
    if whole:
        return (SLAB_K, (j, lo, hi, 0), (hi - lo) * w, local)
    return (SLAB_KB, (j, lo, hi, a_lo, a_hi), (hi - lo) * w, local)


@functools.lru_cache(maxsize=32)
def _bases(d: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    """The sigma index of each categorical column's code 0."""
    return tuple(itertools.accumulate(sizes[:-1], initial=1 + d))[
        :len(sizes)]


def _cross_count(sizes: tuple[int, ...]) -> int:
    """The cross tables C_jk of a schema: pairs of columns with levels."""
    m = sum(v > 0 for v in sizes)
    return m * (m - 1) // 2


def _cm_run(sizes: tuple[int, ...], j: int, run: list[int], k: int,
            cap: int) -> bool:
    """Whether row column k extends the CM run of key column j (`run`: its
    row columns, then their cells a key, W): it follows the run's last
    column, and the slab stays within `cap` cells and CM_MAX_COLS row
    columns. Extends `run` where it does."""
    if run and not (k == run[-2] + 1 and len(run) <= CM_MAX_COLS
                    and sizes[j] * (run[-1] + sizes[k]) <= cap):
        return False
    width = run.pop() if run else 0
    run += [k, width + sizes[k]]
    return True


def _cm_piece(sizes: tuple[int, ...], base: list[int], j: int, k_lo: int,
              k_hi: int, lo: int | None = None, hi: int | None = None):
    """The CM slab of key column j over row columns k_lo .. k_hi − 1: every
    C_jk of them side by side (cell u·W + q − base[k_lo], q the sigma
    index of (k, v)), each cell placed at (base[j] + u, q) and, in a
    window [lo, hi), at both of its places there."""
    q0 = base[k_lo]
    width = base[k_hi - 1] + sizes[k_hi - 1] - q0
    u = np.repeat(_ar(0, sizes[j]), width)
    q = np.tile(_ar(q0, q0 + width), sizes[j])
    cell = u * width + q - q0
    local = (np.stack([cell, base[j] + u, q]) if lo is None
             else _places(lo, hi, cell, base[j] + u, q))
    return (SLAB_CM, (j, k_lo, k_hi, 0), sizes[j] * width, local)


def _dense_cuts(d: int, a: int, aligned: bool) -> list[int]:
    """Where row a of D, columns a .. d of [1 ‖ x], is cut into slabs of at
    most WIDE_CHUNK cells: every WIDE_CHUNK from a, or (`aligned`) at the
    multiples of WIDE_CHUNK, so that a tile of D's columns holds whole
    slabs (the scorer's local plan)."""
    if not aligned:
        return list(range(a, 1 + d, WIDE_CHUNK)) + [1 + d]
    return ([a] + list(range((a // WIDE_CHUNK + 1) * WIDE_CHUNK, 1 + d,
                             WIDE_CHUNK)) + [1 + d])


@plan_cache
def _wide_plan(d: int, sizes: tuple[int, ...], cross: bool = True,
               scorer: bool = False, cap: int = WIDE_TASK_BYTES // 8,
               local: bool = False) -> WidePlan:
    """local: the scorer's plan where x of a tile of rows does not fit
    beside its tables (`qda_local`): D's slabs aligned to WIDE_CHUNK
    columns and K_j cut into KB slabs of QDA_LOCAL_TILE columns, packed
    into tasks of QDA_LOCAL_X numeric columns at most (`_pack_local`);
    without C_jk (naive Bayes), of D only row 0 and the diagonal, of K_j
    only the counts (what the scorer reads of NB's tables). Past the
    crossover (`dense_route`) K7's, K8's and K2w's plans (not the
    scorer's) hold no D slab: the plan's `dense` is D's tiles."""
    tiles = dense_route(d) and not scorer
    if not scorer:
        cap = _column_cap(d, sizes, cap)
        kw = _k_cols(d, cap)
    else:
        kw = 1 + d if not local else QDA_LOCAL_TILE if cross else 1
    base = _bases(d, sizes)
    pieces = []                 # (kind, params, cells, local entries)
    nb_local = local and not cross
    for a in range(0 if tiles else 1 + d):
        cuts = (_dense_cuts(d, a, local) if not nb_local or a == 0
                else [a, a + 1])
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            b = _ar(lo, hi)
            pieces.append((SLAB_D, (a, lo, hi, 0), hi - lo,
                           np.stack([b - lo, np.full_like(b, a), b])))
    for j, size in enumerate(sizes):
        for a_lo, a_hi in _k_ranges(d, kw)[:1 if nb_local else None]:
            for lo, hi in _split(size, a_hi - a_lo, cap):
                pieces.append(_k_piece(j, lo, hi, a_lo, a_hi, base[j],
                                       scorer, kw == 1 + d))
    merge = cross and not scorer and _cross_count(sizes) > CM_TABLES
    for j in range(len(sizes) if cross else 0):
        run: list[int] = []
        for k in range(j + 1, len(sizes) + 1):
            small = (k < len(sizes) and merge
                     and 0 < sizes[j] * sizes[k] <= CM_SMALL)
            if small and _cm_run(sizes, j, run, k, cap):
                continue
            if len(run) > 2:
                pieces.append(_cm_piece(sizes, base, j, run[0], run[-2] + 1))
            elif run:               # a run of one: its C table
                pieces += _cross_pieces(sizes, base, j, run[0], cap)
            run = []
            if small:
                _cm_run(sizes, j, run, k, cap)
            elif k < len(sizes):
                pieces += _cross_pieces(sizes, base, j, k, cap)
    if local:
        return _plan_of(pieces, d, cross, scorer, cap, local_plan=True,
                        tasks=_pack_local(pieces, d, cap, QDA_LOCAL_TILE,
                                          lambda nx, nc: nx <= QDA_LOCAL_X))
    return _plan_of(pieces, d, cross, scorer, cap,
                    dense=dense_tiles(d, 0, 1 + d) if tiles else None)


def _cross_pieces(sizes: tuple[int, ...], base: list[int], j: int, k: int,
                  cap: int) -> list:
    """The C slabs of C_jk (j < k) in the whole plan: its key column's
    ranges (`_cross_keys`), each entry (cell, i, j) of S's upper triangle;
    where a row passes `cap` cells, CB slabs of the row ranges of
    `_row_ranges`, each cut by key range."""
    if sizes[j] == 0 or sizes[k] == 0:
        return []
    key, row = _cross_keys(sizes, j, k, cap)
    pieces = []
    for v_lo, v_hi in _row_ranges(sizes[row], cap):
        vr = v_hi - v_lo
        for lo, hi in _split(sizes[key], vr, cap):
            # S's upper triangle: the key's index first where it is lower
            local = _Grid((hi - lo, vr, base[key] + lo, base[row] + v_lo,
                           key < row))
            pieces.append(
                (SLAB_C, (key, row, lo, hi), (hi - lo) * vr, local)
                if vr == sizes[row] else
                (SLAB_CB, (key, row, lo, hi, v_lo, v_hi), (hi - lo) * vr,
                 local))
    return pieces


def _row_ranges(levels: int, cap: int) -> list[tuple[int, int]]:
    """[v_lo, v_hi) of a cross table's row column: the whole row where it
    fits a task of `cap` cells, else even ranges of at most `cap` codes."""
    return _split(levels, 1, cap)


def _cross_keys(sizes: tuple[int, ...], j: int, k: int, cap: int
                ) -> tuple[int, int]:
    """(key column, row column) of C_jk, j < k: keyed on j's codes, a row
    of V_k cells, as long as a row fits a task of `cap` cells; else keyed on
    the column of more levels, so that a row holds the narrower column's
    levels (favorita_items: item_nbr's 4,100 against a 4,096-cell task)."""
    if sizes[k] <= cap:
        return j, k
    return (k, j) if sizes[k] >= sizes[j] else (j, k)


def qda_task_cells(sizes: tuple[int, ...]) -> int:
    """The task budget of the scorer's plan: QDA_TASK_CELLS, or, where of
    two categorical columns the narrower has more levels (its row of a
    cross table lies in one task), that many rounded up to whole 16-byte
    words, up to K7's WIDE_TASK_BYTES // 8; past it K7's budget, the cross
    table cut by row code too (`_cross_pieces`)."""
    ordered = sorted(sizes)
    narrow = ordered[-2] if len(ordered) > 1 else 0
    return min(max(QDA_TASK_CELLS, -(-narrow // 4) * 4),
               WIDE_TASK_BYTES // 8)


def _piece_columns(piece, d: int) -> tuple[range | set, set]:
    """(numeric, code) columns a slab reads: D's x_a and x_b (Z index a is
    x column a − 1), K_j every numeric column and j's codes, KB its
    columns' and j's codes, C and CR their two columns, CM its key and row
    columns."""
    kind, p = piece[0], piece[1]
    if kind == SLAB_D:
        return ({p[0] - 1} if p[0] else set()) | set(
            range(max(p[1], 1) - 1, p[2] - 1)), set()
    if kind == SLAB_K:
        return range(d), {p[0]}
    if kind == SLAB_KB:
        return set(range(max(p[3], 1) - 1, p[4] - 1)), {p[0]}
    if kind == SLAB_CM:
        return set(), {p[0], *range(p[1], p[2])}
    return set(), {p[0], p[1]}


def _task_stage(pieces: list, members: list[int], d: int
                ) -> tuple[list[int], list[int]]:
    """The numeric and the code columns a task stages, ascending: those
    its slabs read (every numeric column where it has a K slab)."""
    xs, cs = set(), set()
    for i in members:
        x, c = _piece_columns(pieces[i], d)
        if isinstance(x, range):
            xs = set(x)
        elif len(xs) < d:
            xs |= x
        cs |= c
    return sorted(xs), sorted(cs)


def _piece_slots(piece, xslot: dict, cslot: dict, d: int
                 ) -> tuple[int, int, int, int]:
    """The two stage slots of a slab, then a C or CB slab's rows v_lo,
    v_hi (a C slab's 0, V_k), a K or KB slab's columns a_lo, a_hi (a K
    slab's 0, 1 + d; `WidePlan.slots`)."""
    kind, p = piece[0], piece[1]
    if kind == SLAB_D:
        b0 = max(p[1], 1)
        return (xslot[p[0] - 1] if p[0] else 0,
                xslot[b0 - 1] - b0 if b0 < p[2] else 0, 0, 0)
    if kind == SLAB_K:
        return cslot[p[0]], 0, 0, 1 + d
    if kind == SLAB_KB:
        a0 = max(p[3], 1)
        return (cslot[p[0]], xslot[a0 - 1] - a0 if a0 < p[4] else 0, p[3],
                p[4])
    if kind == SLAB_CB:
        return cslot[p[0]], cslot[p[1]], p[4], p[5]
    levels = piece[2] // (p[3] - p[2]) if kind == SLAB_C else 0
    return cslot[p[0]], cslot[p[1]], 0, levels


def _stage_rows(cells: int, cols: int, slabs: int, width: int) -> int:
    """The most rows a stage (256, 128, 64 or 32) that leave a block's
    shared memory room for a plan of these sizes, 0 where none does."""
    return next((r for r in (256, 128, 64, 32) if wide_smem_bytes(
        cells, cols, slabs, r, width) <= WIDE_SMEM), 0)


def _layout_rows(pieces: list, tasks: list[list[int]], d: int,
                 cap: int) -> int:
    """`_stage_rows` of a packing: its largest task's cells, staged
    columns and slabs."""
    cols = max(1 + sum(map(len, _task_stage(pieces, m, d))) for m in tasks)
    cells = max(sum(pieces[i][2] for i in m) for m in tasks)
    return _stage_rows(cells, cols, max(map(len, tasks)), cols + 1)


def _pack_local(pieces: list, d: int, cap: int, width: int = KB_COLS,
                fits=None) -> list[list[int]]:
    """Slabs into tasks that each stage few columns, for a schema whose
    tasks of `_pack_tasks` (which spreads a table's slabs over its tasks)
    would stage more than shared memory holds: D's slabs in tiles of
    `width` of its columns by its rows, each tile's KB slabs after them,
    the other slabs in the order they were made (a table's key ranges,
    then the next table), each task filled in that order up to `cap`
    cells, WIDE_MAX_SLABS slabs and the columns that `fits(numeric, code)`
    takes (by default, those that leave room for K7's stages of WIDE_CHUNK
    rows)."""
    if fits is None:
        def fits(nx, nc):
            cols = 1 + nx + nc
            return _stage_rows(cap, cols, WIDE_MAX_SLABS, cols + 1) > 0

    def tile(i):
        kind, p = pieces[i][0], pieces[i][1]
        if kind == SLAB_D:
            return (0, p[1] // width, p[0], p[1])
        return (0, p[3] // width, 1 + d, i) if kind == SLAB_KB else (1, i)
    order = sorted(range(len(pieces)), key=tile)
    tasks: list[list[int]] = []
    members: list[int] = []
    xs: set = set()
    cs: set = set()
    cells = 0
    for i in order:
        x, c = _piece_columns(pieces[i], d)
        x2 = set(range(d)) if isinstance(x, range) or len(xs) == d \
            else xs | x
        c2 = cs | c
        room = (cells + pieces[i][2] <= cap
                and len(members) < WIDE_MAX_SLABS and fits(len(x2), len(c2)))
        if members and not room:
            tasks.append(members)
            members, xs, cs, cells = [], set(), set(), 0
            x, c = _piece_columns(pieces[i], d)
            x2 = set(range(d)) if isinstance(x, range) else set(x)
            c2 = set(c)
        members.append(i)
        xs, cs, cells = x2, c2, cells + pieces[i][2]
    if members:
        tasks.append(members)
    return tasks


def _plan_of(pieces: list, d: int, cross: bool, scorer: bool, cap: int,
             window: tuple[int, int] | None = None,
             tasks: list[list[int]] | None = None,
             local_plan: bool = False,
             dense: torch.Tensor | None = None) -> WidePlan:
    """The plan of `pieces` (kind, params, cells, local entries: i32[3,
    m] of (cell, i, j), or a `_Grid`): the slabs packed into tasks (or the given `tasks`, lists
    of the pieces' indices), each task's slabs to its warps, the map
    sorted by (task, cell). The packing of `_pack_tasks`, which balances
    the tasks' slab counts, where its stages take 64 rows or more; else
    the one of `_pack_local` where its stages take more rows (a schema of
    hundreds of numeric or code columns); ValueError where no stage of
    WIDE_CHUNK rows fits. dense: D's tiles, where the tile kernel takes D
    (`dense_tiles`); with no pieces, a plan of no task and those tiles."""
    if not pieces:
        def none(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype)
        return WidePlan(
            slabs=none(0, WIDE_SLAB_INTS), warp_begin=none(1),
            task_base=none(1, dtype=torch.int64), entries=none(0, 4),
            stage_cols=none(0, 2), slots=none(0, 4), max_stage_cols=1,
            max_slabs=0, stage_rows=WIDE_CHUNK, cross=cross, scorer=scorer,
            task_cells=cap, window=window, local=local_plan, dense=dense)
    if tasks is None:
        tasks = _pack_tasks([p[2] for p in pieces], cap)
        if not scorer and _layout_rows(pieces, tasks, d, cap) < 64:
            local = _pack_local(pieces, d, cap)
            if (_layout_rows(pieces, local, d, cap)
                    > _layout_rows(pieces, tasks, d, cap)):
                tasks = local
    slabs, slots, warp_begin, task_base, stage_cols = [], [], [0], [0], []
    locals_, at = [], []     # each slab's map (cells sorted) and (task, off)
    cost = [_piece_cost(p, d) for p in pieces]
    for t, members in enumerate(tasks):
        xs, cs = _task_stage(pieces, members, d)
        stage_cols.append([len(xs), len(cs)] + xs + cs)
        xslot = {x: 1 + q for q, x in enumerate(xs)}
        cslot = {c: 1 + len(xs) + q for q, c in enumerate(cs)}
        # warps: the costliest slab first, to the least loaded warp (the
        # first of equals); a warp's slabs in the order of `members`
        load = [0] * WIDE_WARPS
        warp_of = {}
        for i in sorted(members, key=lambda i: -cost[i]):
            w = load.index(min(load))
            warp_of[i] = w
            load[w] += cost[i]
        by_warp: list[list[int]] = [[] for _ in range(WIDE_WARPS)]
        for i in members:
            by_warp[warp_of[i]].append(i)
        off = 0
        for w in range(WIDE_WARPS):
            for i in by_warp[w]:
                kind, params, cells, local = pieces[i]
                slabs.append((kind, *params[:4], off, t, w))
                slots.append(_piece_slots(pieces[i], xslot, cslot, d))
                locals_.append(local if isinstance(local, _Grid)
                               else _by_cell(local))
                at.append((t, off))
                off += cells
            warp_begin.append(len(slabs))
        if scorer:
            off = -(-off // 4) * 4
        task_base.append(task_base[-1] + off)
    # the map, sorted by (task, cell): a task's slabs lie in order of their
    # first cell, and each slab's entries are sorted by cell (stably)
    ent = np.empty((4, sum(local.shape[1] for local in locals_)),
                   dtype=np.int32)
    a = 0
    for (t, off), local in zip(at, locals_):
        _write_map(ent, a, t, off, local)
        a += local.shape[1]
    ent = torch.from_numpy(np.ascontiguousarray(ent.T))
    width = 2 + max(len(r) - 2 for r in stage_cols)
    max_cols, max_slabs = width - 1, max(map(len, tasks))
    max_cells = max(b - a for a, b in zip(task_base, task_base[1:]))
    rows = _stage_rows(max_cells, max_cols, max_slabs, width)
    if not rows:
        if not scorer:
            raise ValueError(f"K7/K8: a task stages {max_cols} columns "
                             f"beside {max_cells} cells, more than a "
                             f"block's shared memory holds")
        rows = WIDE_CHUNK       # the scorer stages no rows
    return WidePlan(
        slabs=torch.tensor(slabs, dtype=torch.int32).reshape(
            -1, WIDE_SLAB_INTS),
        warp_begin=torch.tensor(warp_begin, dtype=torch.int32),
        task_base=torch.tensor(task_base, dtype=torch.int64),
        entries=ent,
        stage_cols=torch.tensor([r + [-1] * (width - len(r))
                                 for r in stage_cols], dtype=torch.int32),
        slots=torch.tensor(slots, dtype=torch.int32).reshape(-1, 4),
        max_stage_cols=max_cols, max_slabs=max_slabs, stage_rows=rows,
        cross=cross, scorer=scorer, task_cells=cap, window=window,
        local=local_plan, dense=dense)


def _window_tables(d: int, sizes: tuple[int, ...], lo: int, hi: int,
                   keyed: tuple[int, ...] = (), with_dense: bool = True,
                   cap: int = WIDE_TASK_BYTES // 8) -> tuple[list, list]:
    """The cells of S[:, lo:hi] before any cut: (D's pieces (none where
    not `with_dense`), the keyed tables). Every cell whose row or column
    lies in the window, with one map entry (cell, i, j) for each place
    S[i, j], lo ≤ j < hi, that the cell's value fills.

    D: a slab where one of its places lies in the window. K_j: every key
    where a column of [1 ‖ x] lies in the window (its row of the table is
    a row of S), else the keys whose one-hot columns do; cut into KB
    tables of column ranges (`_k_cols`), the ranges with a place in the
    window. C_jk (j < k),
    with A and B the window's keys of j and of k: the whole table when
    |A|·V_k + |B|·V_j ≥ V_j·V_k, keyed on the column of more levels (rows
    of the fewer pack the tasks fuller), each cell to its places in the
    window; else a table (C, j, k) over A, placed in j's columns, and one
    (C, k, j) over B (keyed on k's codes, cell (v − v_lo)·V_j + u),
    placed in k's columns, so a place of A × B is written once.

    Where j or k is in `keyed`, every table of C_jk is keyed on one owner
    in every window, the keyed column (of both, the one of more levels,
    else j): the whole table as above, or (C, o, r) over A_o and, for the
    other column's keys B_r, a table (CR, o, r) over all of o's keys with
    rows B_r (cell (u − u_lo)·|B_r| + v − v_lo), placed in r's columns.
    So both places of a cell, S[i, j] in one window and S[j, i] in
    another, are summed over the same rows of o's order, and S stays
    exactly symmetric.

    Where the schema has more than CM_TABLES cross tables, the whole small
    tables of a column j with neither column keyed whose row columns k
    follow each other are one CM table (`_cm_run`), over all of j's keys.

    A C or CR table whose cells a key pass a task of `cap` cells (the
    budget of K7's tasks, `_column_cap`) is cut by row code into tables
    of at most `cap` cells a key (`_row_cut`), each keeping its key column,
    so a keyed pair keeps its owner in every window.

    A table is (kind, key column, row column (−1 for K_j; CM: the first),
    first key, end key, cells a key, whether its cells fill places on both
    sides, first row code (CR and a C table cut by row code; CM: its end
    row column; KB: its first column; else 0))."""
    base = _bases(d, sizes)
    merge = _cross_count(sizes) > CM_TABLES
    cap = _column_cap(d, sizes, cap)

    def keys(j):
        """[a, b) of column j's codes whose one-hot columns lie in the
        window."""
        return (min(max(lo - base[j], 0), sizes[j]),
                min(max(hi - base[j], 0), sizes[j]))

    dense = []
    for a in range(1 + d if with_dense else 0):
        for blo in range(a, 1 + d, WIDE_CHUNK):
            bhi = min(blo + WIDE_CHUNK, 1 + d)
            b = _ar(blo, bhi)
            local = _places(lo, hi, b - blo, np.full_like(b, a), b)
            if local.shape[1]:
                dense.append((SLAB_D, (a, blo, bhi, 0), bhi - blo, local))
    tables = []
    kw = _k_cols(d, cap)
    for j, size in enumerate(sizes):
        klo, khi = (0, size) if lo < 1 + d else keys(j)
        if khi > klo and kw == 1 + d:
            tables.append((SLAB_K, j, -1, klo, khi, 1 + d, True, 0))
        elif khi > klo:     # KB: the column ranges with a place here
            on = keys(j)[1] > keys(j)[0]
            tables += [(SLAB_KB, j, -1, klo, khi, a_hi - a_lo, True, a_lo)
                       for a_lo, a_hi in _k_ranges(d, kw)
                       if on or max(a_lo, lo) < min(a_hi, hi)]
    win = [keys(j) for j in range(len(sizes))]
    for j in range(len(sizes)):
        run: list[int] = []
        for k in range(j + 1, len(sizes) + 1):
            small = k < len(sizes) and merge and _cm_pair(
                sizes, keyed, j, k, win[j], win[k])
            if small and _cm_run(sizes, j, run, k, cap):
                continue
            if len(run) > 2:
                tables.append((SLAB_CM, j, run[0], 0, sizes[j], run[-1], True,
                               run[-2] + 1))
            elif run:               # a run of one: its C table
                tables += _pair_tables(sizes, keyed, j, run[0], win[j],
                                       win[run[0]])
            run = []
            if small:
                _cm_run(sizes, j, run, k, cap)
            elif k < len(sizes):
                tables += _pair_tables(sizes, keyed, j, k, win[j], win[k])
    return dense, [cut for tb in tables for cut in _row_cut(tb, cap)]


def _row_cut(table, cap: int) -> list:
    """A window's C or CR table (`_window_tables`) whose cells a key pass
    `cap`, as tables of the row ranges of `_row_ranges`; any other table
    as it is."""
    kind, key, row, klo, khi, row_cells, both, v_lo = table
    if kind not in (SLAB_C, SLAB_CR) or row_cells <= cap:
        return [table]
    return [(kind, key, row, klo, khi, b - a, both, v_lo + a)
            for a, b in _row_ranges(row_cells, cap)]


def _cm_pair(sizes: tuple[int, ...], keyed: tuple[int, ...], j: int, k: int,
             wj: tuple[int, int], wk: tuple[int, int]) -> bool:
    """Whether C_jk may join a CM table in a window where j's and k's
    window keys are wj and wk: neither column keyed, at most CM_SMALL
    cells, and whole there (`_window_tables`)."""
    vj, vk = sizes[j], sizes[k]
    (ua, ub), (va, vb) = wj, wk
    return (j not in keyed and k not in keyed and 0 < vj * vk <= CM_SMALL
            and (ua < ub or va < vb)
            and (ub - ua) * vk + (vb - va) * vj >= vj * vk)


def _pair_tables(sizes: tuple[int, ...], keyed: tuple[int, ...], j: int,
                 k: int, wj: tuple[int, int], wk: tuple[int, int]) -> list:
    """The tables of C_jk (j < k) in a window where j's and k's window keys
    are wj and wk (`_window_tables`)."""
    vj, vk = sizes[j], sizes[k]
    win = {j: wj, k: wk}
    (ua, ub), (va, vb) = wj, wk
    if vj == 0 or vk == 0 or (ua == ub and va == vb):
        return []
    whole = (ub - ua) * vk + (vb - va) * vj >= vj * vk
    if j in keyed or k in keyed:
        o = k if k in keyed and (j not in keyed or vk > vj) else j
        r = j + k - o
        (oa, ob), (ra, rb) = win[o], win[r]
        if whole:
            return [(SLAB_C, o, r, 0, sizes[o], sizes[r], True, 0)]
        tables = []
        if ob > oa:
            tables.append((SLAB_C, o, r, oa, ob, sizes[r], False, 0))
        if rb > ra:
            tables.append((SLAB_CR, o, r, 0, sizes[o], rb - ra, False, ra))
        return tables
    if whole:
        # (key column, row column): the rows the shorter
        key, row = (j, k) if vj >= vk else (k, j)
        return [(SLAB_C, key, row, 0, sizes[key], sizes[row], True, 0)]
    return [(SLAB_C, key, row, klo, khi, sizes[row], False, 0)
            for key, row, klo, khi in ((j, k, ua, ub), (k, j, va, vb))
            if khi > klo]


def _places(lo: int, hi: int, cell, i, j) -> np.ndarray:
    """(cell, i, j) for S[i, j] and (cell, j, i) for S[j, i] (i ≠ j), each
    where its column lies in the window [lo, hi)."""
    fwd = (j >= lo) & (j < hi)
    rev = (i >= lo) & (i < hi) & (i != j)
    return np.concatenate([np.stack([cell, i, j])[:, fwd],
                           np.stack([cell, j, i])[:, rev]], 1)


def _table_piece(table, d: int, sizes: tuple[int, ...], lo: int, hi: int,
                 u_lo: int, u_hi: int):
    """The slab of a window's table (`_window_tables`) over its keys [u_lo,
    u_hi): (kind, params, cells, local map entries (cell, i, j)); a C
    table cut by row code is a CB slab of its rows."""
    kind, key, row, _, _, row_cells, both, v_lo = table
    b_key = _bases(d, sizes)[key]
    if kind == SLAB_CM:     # all of the key's levels (`_cm_run`)
        assert (u_lo, u_hi) == (0, sizes[key])
        return _cm_piece(sizes, _bases(d, sizes), key, row, v_lo, lo, hi)
    if kind in (SLAB_K, SLAB_KB):
        return _k_piece(key, u_lo, u_hi, v_lo, v_lo + row_cells, b_key,
                        False, kind == SLAB_K, (lo, hi))
    b_row = _bases(d, sizes)[row]
    grid = _Grid((u_hi - u_lo, row_cells, b_key + u_lo, b_row + v_lo,
                  kind == SLAB_CR))
    if kind == SLAB_CR:     # keys [u_lo, u_hi): the keyed task's own
        return (SLAB_CR, (key, row, v_lo, v_lo + row_cells),
                (u_hi - u_lo) * row_cells, grid)
    if both:
        u = np.repeat(_ar(u_lo, u_hi), row_cells)
        v = np.tile(_ar(v_lo, v_lo + row_cells), u_hi - u_lo)
        local = _places(lo, hi, (u - u_lo) * row_cells + v - v_lo,
                        b_key + u, b_row + v)
    else:
        local = grid
    if (v_lo, row_cells) != (0, sizes[row]):
        return (SLAB_CB, (key, row, u_lo, u_hi, v_lo, v_lo + row_cells),
                (u_hi - u_lo) * row_cells, local)
    return (SLAB_C, (key, row, u_lo, u_hi), (u_hi - u_lo) * row_cells,
            local)


def _key_ranges(a: int, b: int, row_cells: int, cap: int
                ) -> list[tuple[int, int]]:
    """Key ranges of [a, b) as `_split` cuts them."""
    return ([(a + r0, a + r1) for r0, r1 in _split(b - a, row_cells, cap)]
            if b > a else [])


def _window_pieces(d: int, sizes: tuple[int, ...], lo: int, hi: int,
                   cap: int, with_dense: bool = True) -> list:
    """The slabs of S[:, lo:hi] (`_window_tables`), each table cut by key
    range into slabs of at most `cap` cells: the unkeyed cut, whose tasks
    each walk all n rows, so a table of V_j·V_k cells costs ~V_j·V_k / cap
    reads of every row. `keyed_window_plan` keeps it for the residual and
    cuts the tables of a keyed column by its key ranges instead, each task
    walking only its range's rows in that column's order: a row read once
    a layer, whatever V_j·V_k is."""
    dense, tables = _window_tables(d, sizes, lo, hi, with_dense=with_dense,
                                   cap=cap)
    return dense + [_table_piece(tb, d, sizes, lo, hi, u_lo, u_hi)
                    for tb in tables
                    for u_lo, u_hi in _key_ranges(tb[3], tb[4], tb[5], cap)]


def window_places(d: int, sizes: tuple[int, ...], lo: int, hi: int) -> int:
    """The structurally nonzero places of S[:, lo:hi] (what a window's
    plans map): P in each column of [1 ‖ x]; in a one-hot column of column
    j, 1 + d, its diagonal and every other column's levels."""
    p = 1 + d + sum(sizes)
    out = p * max(0, min(hi, 1 + d) - max(lo, 0))
    for b, v in zip(_bases(d, sizes), sizes):
        out += (2 + d + p - 1 - d - v) * max(0, min(hi, b + v) - max(lo, b))
    return out


def window_cuts(schema, lo: int, hi: int) -> list[tuple[int, int]]:
    """The windows K7 runs S[:, lo:hi] as: the window itself, or where its
    plans would map more than MAX_WINDOW_PLACES places, its columns cut at
    the multiples of WINDOW_WIDTH (the windows masked_gram(_cols) run,
    whose plans it shares)."""
    d, sizes = schema.num_cols, tuple(schema.cat_sizes)
    if window_places(d, sizes, lo, hi) <= MAX_WINDOW_PLACES:
        return [(lo, hi)]
    cuts = [lo] + list(range((lo // WINDOW_WIDTH + 1) * WINDOW_WIDTH, hi,
                             WINDOW_WIDTH)) + [hi]
    return list(zip(cuts[:-1], cuts[1:]))


def check_window(schema, lo: int, width: int) -> None:
    """Raise ValueError for a window K7 does not take: [lo, lo + width)
    outside [0, P). A column takes any levels: a cross table whose rows
    pass a task is cut by row code too (`_row_cut`)."""
    p = schema.sigma_size
    if not (0 <= lo and width >= 1 and lo + width <= p):
        raise ValueError(f"window [{lo}, {lo + width}) is not inside "
                         f"[0, {p})")


@plan_cache
def _window_plan(d: int, sizes: tuple[int, ...], lo: int, hi: int,
                 cap: int = WIDE_TASK_BYTES // 8) -> WidePlan:
    tiles = dense_route(d)
    cap = _column_cap(d, sizes, cap)
    return _plan_of(_window_pieces(d, sizes, lo, hi, cap, not tiles), d,
                    True, False, cap, (lo, hi),
                    dense=dense_tiles(d, lo, hi) if tiles else None)


def window_plan(schema, lo: int, hi: int) -> WidePlan:
    """The unkeyed plan of the column window S[:, lo:hi] (every table cut
    by key range, each task over all rows), on the CPU; made once per
    schema and window. Its map lists each structurally nonzero place of
    the window once, (task, cell, i, j) with lo ≤ j < hi. The kernels run
    `keyed_window_plan`, which takes from it the tables of its keyed
    columns. Past the crossover (`dense_route`) it holds no D slab and
    D's tiles of the window (`dense_tiles`) are its `dense`."""
    check_window(schema, lo, hi - lo)
    d = schema.num_cols
    return _window_plan(d, tuple(schema.cat_sizes), lo, hi)


@dataclasses.dataclass(frozen=True)
class KeyedPlan:
    """The keyed part of a window's plan (`keyed_window_plan`): the tables
    of each keyed column J (K_J, and every C_Jk keyed on J's codes) cut
    into tasks of one key range of J each, so that a task walks only the
    rows whose code_J lies in its range, in J's order (`window_order`).

    A column's tables are packed by their cells a key into layers of at
    most `task_cells` cells a key (first fit, widest first); each layer's
    keys are cut as `_split` cuts a table, a task holding the layer's
    slabs over its key range. The tasks of one layer have disjoint key
    ranges, so a layer walks each row at most once (once a group in K8).

    plan: the tasks' `WidePlan` (slabs, warps, cells, stage columns, map
      of the window's places); its `slices` are unused: the kernel cuts
      each task's rows into work items (`keyed_items`).
    task_keys i32[T, KEYED_TASK_INTS]: (J, u_lo, u_hi) of each task.
    columns: the keyed columns, ascending. layers: the layers of all of
    them (what bounds the rows the tasks walk: n · layers), each task's
    layer and each layer's column and key range (for counting rows)."""
    plan: WidePlan
    task_keys: torch.Tensor
    columns: tuple[int, ...]
    layers: int
    layer_of: tuple[int, ...]   # each task's layer, 0 .. layers − 1
    layer_keys: tuple[tuple[int, int, int], ...]   # each layer's (J, first
                                                   # key, end key)

    @property
    def num_tasks(self) -> int:
        return self.plan.num_tasks


@functools.lru_cache(maxsize=32)
def keyed_columns(d: int, sizes: tuple[int, ...],
                  cap: int = WIDE_TASK_BYTES // 8,
                  past: int = MAX_WIDE_SIGMA_SIZE) -> tuple[int, ...]:
    """The categorical columns every window keys: none up to P = `past`
    (MAX_WIDE_SIGMA_SIZE: K7's one-launch plan covers S there, and a window
    of such a schema keeps the unkeyed cut), else those whose tables
    keyed on them (K_j and every C_jk keyed on j's codes) take more than
    one task in one of the windows `masked_gram` assembles S from (of
    WINDOW_WIDTH columns) or in the whole of S: a table that one task
    holds is walked once a window either way. The tables are first those
    of the unkeyed cut; a keyed column owns its C_jk (`_window_tables`),
    so a column left with one task's tables is dropped, until none is.
    One rule for all windows, so that a cell two windows compute (S[i, j]
    in one, S[j, i] in another) is summed the same way in both: over its
    key's rows of one column's order, in chunks from the key's first
    row. `cap`: the budget of a task, cells (lowered by the tests)."""
    p = 1 + d + sum(sizes)
    if p <= past:
        return ()
    windows = [(0, p)] + [(lo, min(lo + WINDOW_WIDTH, p))
                          for lo in range(0, p, WINDOW_WIDTH)]

    def fill(keyed):
        """Columns whose tables take more than one task in a window."""
        most: dict[int, int] = {}
        for lo, hi in windows:
            for j, t in _key_cells(_window_tables(d, sizes, lo, hi,
                                                  keyed, False, cap)[1],
                                   _column_cap(d, sizes, cap)).items():
                most[j] = max(most.get(j, 0), t)
        return {j for j, t in most.items() if t > 1}

    keyed = fill(())
    while (kept := keyed & fill(tuple(sorted(keyed)))) != keyed:
        keyed = kept
    return tuple(sorted(keyed))


def _key_cells(tables: list, cap: int) -> dict[int, int]:
    """Tasks each column's tables fill at the fewest (cells over `cap`)."""
    cells: dict[int, int] = {}
    for _, key, _, klo, khi, row_cells, *_ in tables:
        cells[key] = cells.get(key, 0) + (khi - klo) * row_cells
    return {key: -(-c // cap) for key, c in cells.items()}


@functools.lru_cache(maxsize=4096)
def window_keyed_columns(d: int, sizes: tuple[int, ...], lo: int, hi: int,
                         cap: int = WIDE_TASK_BYTES // 8,
                         past: int = MAX_WIDE_SIGMA_SIZE
                         ) -> tuple[int, ...]:
    """The keyed columns that own a table of the window [lo, hi): its
    keyed plan's `columns` (`_keyed_window_plan`), found from the tables
    alone, with no plan made; kept, as a pass asks for them again."""
    columns = keyed_columns(d, sizes, cap, past)
    if not columns:
        return ()
    tables = _window_tables(d, sizes, lo, hi, columns, False, cap)[1]
    return tuple(sorted({tb[1] for tb in tables} & set(columns)))


@plan_cache
def _keyed_window_plan(d: int, sizes: tuple[int, ...], lo: int, hi: int,
                       cap: int = WIDE_TASK_BYTES // 8,
                       past: int = MAX_WIDE_SIGMA_SIZE
                       ) -> tuple[WidePlan | None, KeyedPlan | None]:
    tiles = dense_route(d)
    columns = keyed_columns(d, sizes, cap, past)
    cap = _column_cap(d, sizes, cap)
    dense, tables = _window_tables(d, sizes, lo, hi, columns, not tiles,
                                   cap)
    keyed = sorted({tb[1] for tb in tables} & set(columns))
    rest = dense + [_table_piece(tb, d, sizes, lo, hi, u_lo, u_hi)
                    for tb in tables if tb[1] not in keyed
                    for u_lo, u_hi in _key_ranges(tb[3], tb[4], tb[5], cap)]
    dt = dense_tiles(d, lo, hi) if tiles else None
    residual = (_plan_of(rest, d, True, False, cap, (lo, hi), dense=dt)
                if rest or dt is not None else None)
    if not keyed:
        return residual, None
    pieces, tasks, task_keys, layer_of, layer_keys = [], [], [], [], []
    for j in keyed:
        mine = sorted((tb for tb in tables if tb[1] == j),
                      key=lambda tb: -tb[5])
        packed: list[list] = []
        for tb in mine:                 # first fit, the widest first; a KB
            room = [ly for ly in packed  # table a layer of its own
                    if sum(t[5] for t in ly) + tb[5] <= cap
                    and SLAB_KB not in (tb[0], ly[0][0])]
            if room:
                room[0].append(tb)
            else:
                packed.append([tb])
        for ly in packed:
            width = sum(t[5] for t in ly)
            k_lo, k_hi = min(t[3] for t in ly), max(t[4] for t in ly)
            layer_keys.append((j, k_lo, k_hi))
            for u_lo, u_hi in _key_ranges(k_lo, k_hi, width, cap):
                members = []
                for tb in ly:
                    a, b = max(tb[3], u_lo), min(tb[4], u_hi)
                    # a CR slab's keys are its task's (wide_gram.cuh)
                    assert tb[0] != SLAB_CR or (a, b) == (u_lo, u_hi)
                    if b > a:
                        members.append(len(pieces))
                        pieces.append(_table_piece(tb, d, sizes, lo, hi, a,
                                                   b))
                if members:
                    tasks.append(members)
                    task_keys.append((j, u_lo, u_hi))
                    layer_of.append(len(layer_keys) - 1)
    plan = _plan_of(pieces, d, True, False, cap, (lo, hi), tasks)
    return residual, KeyedPlan(
        plan=plan, task_keys=torch.tensor(task_keys, dtype=torch.int32),
        columns=tuple(keyed), layers=len(layer_keys),
        layer_of=tuple(layer_of), layer_keys=tuple(layer_keys))


def keyed_window_plan(schema, lo: int, hi: int
                      ) -> tuple[WidePlan | None, KeyedPlan | None]:
    """The plans K7 and K8 run over the column window S[:, lo:hi], on the
    CPU; made once per schema and window: (residual, keyed). Past P =
    MAX_WIDE_SIGMA_SIZE, a categorical column is keyed where its tables
    (K_J and every C_Jk keyed on J, `_window_tables`) take more than one
    task in one of masked_gram's windows (`keyed_columns`: the same
    columns in every window); its tables in the window, and every table
    of a C_Jk it owns, are cut into tasks (`KeyedPlan`) that walk only
    their key range's rows in J's order. The residual, the window's other
    cells (D, the K_j of the other columns and the C_jk between them), is
    the unkeyed cut of `window_plan`, each task over all rows; at P ≤
    MAX_WIDE_SIGMA_SIZE it is the whole window. Past the crossover
    (`dense_route`) the residual holds no D slab: its `dense` is D's tiles
    of the window, and it is a plan of no task where the window has no
    other residual cell. Either may be None; between them (and the
    tiles) every structurally nonzero place of the window is mapped
    once."""
    check_window(schema, lo, hi - lo)
    d = schema.num_cols
    return _keyed_window_plan(d, tuple(schema.cat_sizes), lo, hi)


def item_chunks(n: int) -> int:
    """Chunks of WIDE_CHUNK rows in the blocks of an ordered copy that
    keyed work items are cut at (`keyed_items`; an item holds at most
    that many): about MAX_BLOCKS blocks over n rows, so that a hot key's
    rows spread over many blocks, and at least ITEM_MIN_CHUNKS (a block's
    stage); a function of n only."""
    return max(ITEM_MIN_CHUNKS, -(-(-(-n // WIDE_CHUNK)) // MAX_BLOCKS))


def check_order_stride(levels: int, stride: int) -> None:
    """Raise ValueError where an order pass (window_order.cu) cannot stage
    its rows: a warp keeps `levels` counters and two chunks of 32 rows of
    a piece of the row (`order_piece`, each row padded by 4) in a block's
    shared memory, so a row of any width is copied in pieces; only a
    column of so many levels that its counters and a piece of 8 ints do
    not fit is refused."""
    if 4 * order_warp_ints(levels, 8) > WIDE_SMEM:
        raise ValueError(
            f"the window order keeps {levels} counters beside its rows: "
            f"a warp's shared memory does not hold them")


def order_warp_ints(levels: int, piece: int) -> int:
    """Ints of shared memory an order warp keeps (window_order.cu:
    order_warp_ints) for rows staged a piece of `piece` ints at a time."""
    return (levels + 3) // 4 * 4 + 32 + 64 * (piece + 4)


def order_piece(levels: int, stride: int) -> int:
    """Ints of a row an order warp stages and writes at a time
    (window_order.cu): the whole row of `stride` ints where two chunks of
    32 of them fit beside the column's `levels` counters, else the most
    whole 32-byte sectors that do (a row of 1 + d + c past about 880 −
    V/64 ints, copied in pieces)."""
    check_order_stride(levels, stride)
    if 4 * order_warp_ints(levels, stride) <= WIDE_SMEM:
        return stride
    return ((WIDE_SMEM // 4 - (levels + 3) // 4 * 4 - 32) // 64 - 4) // 8 * 8


def order_stride(cols: int) -> int:
    """Ints of a row of the order's copies (window_order.cu): the row's
    `cols` columns rounded up to whole 32-byte sectors, so the scatter
    writes whole sectors."""
    return -(-cols // 8) * 8


def order_segments(groups: int, levels: int) -> int:
    """Segments of each group's rows in an order pass of a column of
    `levels` levels (window_order.cu, a warp each, its V counters in
    shared memory): about ORDER_WARPS in all, and at most ORDER_CELLS
    counters (key, segment) over the G·V keys; at least one. A function of
    G and V only, so the order does not depend on the card."""
    return max(1, min(-(-ORDER_WARPS // groups),
                      ORDER_CELLS // (groups * levels)))


def keyed_items_bound(keyed: KeyedPlan, n: int, groups: int = 1) -> int:
    """Most work items the keyed tasks can make over n rows and `groups`
    groups: each (task, group)'s chunks c0 .. c1 meet at most (c1 − c0) /
    item_chunks(n) + 2 of the blocks of item_chunks(n) chunks that items
    are cut at (`keyed_items`), a key's chunks start at its first row,
    and a layer's tasks walk at most n rows and its keys in all (so at
    most n / WIDE_CHUNK + G·keys chunks). The grid of the keyed kernel
    (blocks past the real count exit) and its partial's slots."""
    tg = keyed.num_tasks * groups
    chunks = sum(-(-n // WIDE_CHUNK) + groups * (hi - lo)
                 for _, lo, hi in keyed.layer_keys)
    return 2 * tg + -(-chunks // item_chunks(n))


def wide_smem_bytes(cells: int, cols: int, slabs: int, rows: int,
                    width: int | None = None) -> int:
    """Shared memory of a K7/K8 block (wide_gram.cuh: wide_smem_bytes):
    the f64 tables, two stages of `rows` rows of `cols` columns, the slab
    records, the task's stage list (`width` ints, cols + 1 by default) and
    two stages' group ids."""
    width = cols + 1 if width is None else width
    return (8 * cells + 4 * (2 * cols * rows + WIDE_SLAB_INTS * slabs
                             + width + 2 * WIDE_STAGE_ROWS // WIDE_CHUNK))


def wide_plan(schema) -> WidePlan:
    """The plan of K7 and K8 (and K2w's Gram) for `schema`, on the CPU;
    made once per schema. Past the crossover (`dense_route`) it holds no
    D slab, its `dense` all of D's tiles; with no categorical column it
    then has no task."""
    d = schema.num_cols
    return _wide_plan(d, tuple(schema.cat_sizes))


def qda_plan(schema, cross: bool = True) -> WidePlan:
    """The plan of K3/K3w's tables for `schema`: K7's cells, cut into
    tasks of at most QDA_TASK_CELLS f32 cells, with each K_j laid out
    a-major, so that a warp's lookups at its rows' codes spread over the
    banks of shared memory (tools/qda_variants.py), and each task padded
    with zero cells to a multiple of 4, so that a table copies in 16-byte
    words. cross=False is naive Bayes's plan: no
    C_jk tables, and the scorer reads of D only row 0 and the diagonal and
    of K_j only row 0 (the rest of its cells are zero in NB's tables).
    A cross table whose rows would pass a task is keyed on its column of
    more levels (`_cross_keys`); where even the narrower column passes
    QDA_TASK_CELLS the tasks grow to it (`qda_task_cells`). Where x of a
    tile of rows does not fit beside the tables (`qda_local`), the plan is
    local: its tasks read QDA_LOCAL_X numeric columns at most."""
    sizes = tuple(schema.cat_sizes)
    return _wide_plan(schema.num_cols, sizes, cross, True,
                      qda_task_cells(sizes) if cross else QDA_TASK_CELLS,
                      qda_local(schema, cross))


@dataclasses.dataclass(frozen=True)
class NbPlan:
    """The NB kernel's plan (nb_grouped_sums.cu): a row adds w·[1, x, x²]
    under its group g and w under (g, code_j) for each categorical column
    j, so the sums are the f64 tables D, G × (1 + 2d), and K_j, G × V_j,
    cut by group range into slabs and the slabs into tasks of at most
    `task_cells` cells, as `WidePlan` cuts K7's tables.

    slabs i32[S, WIDE_SLAB_INTS]: (SLAB_D, v_lo, g_lo, g_hi, v_hi, off,
      task, warp), the terms v_lo .. v_hi (at most d_terms) of D, cell
      (g − g_lo)·(v_hi − v_lo) + v − v_lo; (SLAB_K, j, g_lo, g_hi, 0, off,
      task, warp), cell (g − g_lo)·V_j + u; or, where one group's row of
      K_j is longer than a task, (NB_SLAB_CODES, j, g, u_lo, u_hi, off,
      task, warp), its codes u_lo .. u_hi, cell u − u_lo; sorted by (task,
      warp).
    warp_begin, task_base, stage_cols: as `WidePlan`'s (a task stages w,
      the group ids, the numeric columns of its D slabs' terms, and its
      code columns).
    slots i32[S, 2]: the stage slot a slab reads (0: w, 1: the group ids,
      then the task's numeric and code columns): a D slab's x_a at slot
      s + a (s = 2 where its task stages every numeric column, as it does
      outside `_nb_pack_local`'s packing), a K or codes slab's column j
      at s; then a K slab's V_j. The kernel's records carry them in place
      of (task, warp) (`device_slabs`).
    out_index i32[cells]: each flat cell's place in out f32[G, F], F = 1 +
      2d + V: D's (g, v) at g·F + v, K_j's (g, u) at g·F + 1 + 2d +
      offset_j + u; every place once.
    """
    slabs: torch.Tensor
    warp_begin: torch.Tensor
    task_base: torch.Tensor
    stage_cols: torch.Tensor
    slots: torch.Tensor
    out_index: torch.Tensor
    groups: int
    max_stage_cols: int
    max_slabs: int
    stage_rows: int
    task_cells: int
    d_terms: int           # terms of D a slab, at most

    num_tasks = WidePlan.num_tasks
    max_task_cells = WidePlan.max_task_cells
    slices = WidePlan.slices

    @property
    def device_slabs(self) -> torch.Tensor:
        """The slab records the kernel reads: `slots` in place of the
        task and the warp."""
        return torch.cat([self.slabs[:, :6], self.slots], 1).contiguous()

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory (nb_grouped_sums.cu: nb_smem_bytes)."""
        return wide_smem_bytes(self.max_task_cells, self.max_stage_cols,
                               self.max_slabs, self.stage_rows,
                               self.stage_cols.shape[1])

    def shape_ints(self, slices: int) -> list[int]:
        """The kernel's sizes (kNbPlanInts, nb_grouped_sums.cu): tasks,
        cells, the most cells, staged columns and slabs of a task, rows a
        stage, slices, groups, the stage list's width."""
        return [self.num_tasks, int(self.task_base[-1]), self.max_task_cells,
                self.max_stage_cols, self.max_slabs, self.stage_rows, slices,
                self.groups, self.stage_cols.shape[1]]


def _nb_pieces(d: int, sizes: tuple[int, ...], groups: int, cap: int,
               terms: int, split: bool = False) -> list:
    """The NB plan's slabs before packing: (kind, params, cells, out
    places); D cut into runs of `terms` terms (`split`: and at x², so a
    slab's columns follow each other) and by group range, K_j by group
    range or, where one group's row is longer than `cap`, by code range for
    each group."""
    f = 1 + 2 * d + sum(sizes)
    g_all = torch.arange(groups)
    pieces = []
    runs = ([(a, min(a + terms, 1 + 2 * d)) for a in range(0, 1 + 2 * d,
                                                             terms)]
            if not split else
            [(a, min(a + terms, e))
             for b, e in ((0, 1 + d), (1 + d, 1 + 2 * d))
             for a in range(b, e, terms)])
    for v_lo, v_hi in runs:
        for lo, hi in _split(groups, v_hi - v_lo, cap):
            pieces.append((SLAB_D, (v_lo, lo, hi, v_hi),
                           (hi - lo) * (v_hi - v_lo),
                           (g_all[lo:hi, None] * f
                            + torch.arange(v_lo, v_hi)).reshape(-1)))
    base = 1 + 2 * d
    for j, size in enumerate(sizes):
        if size > cap:
            for g in range(groups):
                for lo, hi in _split(size, 1, cap):
                    pieces.append((NB_SLAB_CODES, (j, g, lo, hi), hi - lo,
                                   g * f + base + torch.arange(lo, hi)))
        else:
            for lo, hi in _split(groups, size, cap) if size else ():
                pieces.append((SLAB_K, (j, lo, hi, 0), (hi - lo) * size,
                               (g_all[lo:hi, None] * f + base
                                + torch.arange(size)).reshape(-1)))
        base += size
    return pieces


def _nb_layout(pieces: list, cap: int, tasks: list | None = None):
    """Tasks of the pieces (`_pack_tasks`'s, or `tasks`) and, per task,
    each member's warp: the costliest slab first, to the least loaded warp.
    Returns (tasks, warp_of, cost), cost the sum over tasks of its busiest
    warp's load: a slab costs the key match and its lane list (6 shuffle
    steps) and 5 a summed term (one for K_j), what each chunk of 32 rows
    waits on (tools/nb_variants.py)."""
    if tasks is None:
        tasks = _pack_tasks([p[2] for p in pieces], cap)
    cost = [6 + 5 * (p[1][3] - p[1][0] if p[0] == SLAB_D else 1)
            for p in pieces]
    warp_of, total = {}, 0
    for members in tasks:
        load = [0] * WIDE_WARPS
        for i in sorted(members, key=lambda i: -cost[i]):
            w = min(range(WIDE_WARPS), key=lambda w: load[w])
            warp_of[i] = w
            load[w] += cost[i]
        total += max(load)
    return tasks, warp_of, total


NB_TERMS_SEARCH = 129   # most terms 1 + 2d for which every slab width is
                        # tried; past them (1, 2, 4, 8, 16, 32)


def _nb_columns(piece, d: int) -> tuple[set, set, bool]:
    """(numeric, code) columns an NB slab reads, and whether its terms pass
    from x to x² (their columns then do not follow each other)."""
    kind, p = piece[0], piece[1]
    if kind != SLAB_D:
        return set(), {p[0]}, False
    v_lo, v_hi = max(p[0], 1), p[3]
    wraps = v_lo <= d < v_hi - 1
    return {(v - 1) % d for v in range(v_lo, v_hi)}, set(), wraps


def _nb_stage(pieces: list, members: list[int], d: int, local: bool = False
              ) -> tuple[list[int], list[int]]:
    """The numeric and code columns an NB task stages, ascending: every
    numeric column where it has a D slab, or with `local` (the packing of
    `_nb_pack_local`, whose slabs' terms never wrap) those they read."""
    xs, cs = set(), set()
    for i in members:
        x, c, wraps = _nb_columns(pieces[i], d)
        xs = set(range(d)) if (wraps or not local) and x else xs | x
        cs |= c
    return sorted(xs), sorted(cs)


def _nb_rows(pieces: list, tasks: list[list[int]], d: int,
             local: bool = False) -> int:
    """`_stage_rows` of an NB packing (w and the group ids staged too)."""
    cols = max(2 + sum(map(len, _nb_stage(pieces, m, d, local)))
               for m in tasks)
    cells = max(sum(pieces[i][2] for i in m) for m in tasks)
    return _stage_rows(cells, cols, max(map(len, tasks)), cols)


def _nb_pack_local(pieces: list, d: int, cap: int) -> list[list[int]]:
    """NB slabs into tasks in the order they were made (D's terms in turn,
    then each K_j), each filled up to `cap` cells, WIDE_MAX_SLABS slabs and
    the columns that leave room for stages of WIDE_CHUNK rows: a task then
    stages the columns of a run of terms (`_nb_stage`'s `local`)."""
    tasks, members, cols, cells = [], [], set(), 0
    for i, piece in enumerate(pieces):
        x, c, _ = _nb_columns(piece, d)
        new = cols | {("x", q) for q in x} | {("c", q) for q in c}
        fits = (cells + piece[2] <= cap and len(members) < WIDE_MAX_SLABS
                and _stage_rows(cap, 2 + len(new), WIDE_MAX_SLABS,
                                2 + len(new)) > 0)
        if members and not fits:
            tasks.append(members)
            members, cells = [], 0
            new = {("x", q) for q in x} | {("c", q) for q in c}
        members.append(i)
        cols, cells = new, cells + piece[2]
    return tasks + [members]


@functools.lru_cache(maxsize=32)
def _nb_plan(d: int, sizes: tuple[int, ...], groups: int,
             cap: int = WIDE_TASK_BYTES // 8, d_terms: int = 0) -> NbPlan:
    """d_terms: terms of D a slab, 0 for the count `_nb_layout` costs
    least (the most terms among equals: fewer slabs). The packing of
    `_pack_tasks` where its stages take 64 rows or more; else
    `_nb_pack_local`'s (D cut at x² too) where its stages take more;
    ValueError where no stage of WIDE_CHUNK rows fits."""
    f = 1 + 2 * d + sum(sizes)
    tried = (range(1, 2 + 2 * d) if 1 + 2 * d <= NB_TERMS_SEARCH
             else (1, 2, 4, 8, 16, 32))
    terms = d_terms or min(tried, key=lambda t: (_nb_layout(
        _nb_pieces(d, sizes, groups, cap, t), cap)[2], -t))
    pieces = _nb_pieces(d, sizes, groups, cap, terms)
    tasks, warp_of, _ = _nb_layout(pieces, cap)
    local = False
    if _nb_rows(pieces, tasks, d) < 64:
        split = _nb_pieces(d, sizes, groups, cap, terms, split=True)
        packed = _nb_pack_local(split, d, cap)
        if _nb_rows(split, packed, d, True) > _nb_rows(pieces, tasks, d):
            pieces, tasks, local = split, packed, True
            warp_of = _nb_layout(pieces, cap, tasks)[1]
    slabs, slots, warp_begin, task_base, places, stage_cols = (
        [], [], [0], [0], [], [])
    for t, members in enumerate(tasks):
        xs, cs = _nb_stage(pieces, members, d, local)
        stage_cols.append([len(xs), len(cs)] + xs + cs)
        xslot = {x: 2 + q for q, x in enumerate(xs)}
        cslot = {c: 2 + len(xs) + q for q, c in enumerate(cs)}
        off = 0
        for w in range(WIDE_WARPS):
            for i in (i for i in members if warp_of[i] == w):
                kind, params, cells, out = pieces[i]
                slabs.append((kind, *params, off, t, w))
                if kind == SLAB_D:
                    x = sorted(_nb_columns(pieces[i], d)[0])
                    slots.append((xslot[x[0]] - x[0] if x else 2, 0))
                else:
                    slots.append((cslot[params[0]], sizes[params[0]]))
                places.append(out)
                off += cells
            warp_begin.append(len(slabs))
        task_base.append(task_base[-1] + off)
    assert task_base[-1] == groups * f
    width = max(map(len, stage_cols))
    max_slabs = max(map(len, tasks))
    max_cells = max(b - a for a, b in zip(task_base, task_base[1:]))
    rows = _stage_rows(max_cells, width, max_slabs, width)
    if not rows:
        raise ValueError(f"the NB kernel: a task stages {width} columns "
                         f"beside {max_cells} cells, more than a block's "
                         f"shared memory holds")
    return NbPlan(
        slabs=torch.tensor(slabs, dtype=torch.int32).reshape(
            -1, WIDE_SLAB_INTS),
        warp_begin=torch.tensor(warp_begin, dtype=torch.int32),
        task_base=torch.tensor(task_base, dtype=torch.int64),
        stage_cols=torch.tensor([r + [-1] * (width - len(r))
                                 for r in stage_cols], dtype=torch.int32),
        slots=torch.tensor(slots, dtype=torch.int32).reshape(-1, 2),
        out_index=torch.cat(places).to(torch.int32),
        groups=groups, max_stage_cols=width, max_slabs=max_slabs,
        stage_rows=rows, task_cells=cap, d_terms=terms)


def nb_plan(schema, num_groups: int) -> NbPlan:
    """The NB kernel's plan for `schema` and `num_groups`, on the CPU; made
    once per schema and group count."""
    return _nb_plan(schema.num_cols, tuple(schema.cat_sizes), num_groups)


def raise_on_error(lib: Library, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.dit_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
