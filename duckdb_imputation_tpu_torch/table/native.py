"""ctypes binding of the native columnar store and CSV reader.

Counterpart of `duckdb_imputation_tpu.table.native`, over the same C++
source, `native/columnar.cpp`: the multithreaded CSV parse, the
dictionary encoding of string columns, the chunked reader of the
out-of-core path and the CSV formatter of its write pass run on CPU
threads, and hand features-first numpy buffers to `from_numpy`.

The library is built here, not by the JAX package's `make`: `g++` is
called directly with the Makefile's flags (the card's machine has a host
compiler, since nvcc needs one, but may have no `make`) into
`config.NATIVE_BUILD_DIR`, under a name keyed by a hash of the source,
the flags and the compiler's predefined macros for this host (its version
and, through -march=native, the CPU's features), so a checkout copied to
another machine builds its own. It is linked to a temporary file and
moved into place with `os.replace`: concurrent processes never load a
half-written file, and a rebuild gets a new inode (glibc's dlopen caches
by inode). `native/libdbi_native.so`, the JAX binding's library, is never
loaded, rebuilt or removed here.
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

import numpy as np

from .. import config
from ..schema import FeatureSchema
from .table import Table, from_numpy

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
             "-march=native", "-shared")
ABI_VERSION = 3
# integers are formatted exactly up to 2^53, the f64 cell's exact range
MAX_EXACT_INT = float(1 << 53)


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native CSV library of "
                           "duckdb_imputation_tpu_torch needs a C++ compiler")
    return cxx


def library_path() -> str:
    """Where this host's build of the native library lies (built or not):
    its name carries a hash of the source, the flags and the compiler's
    predefined macros under -march=native."""
    cxx = _compiler()
    macros = subprocess.run(
        [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, check=True).stdout
    digest = hashlib.sha256()
    digest.update(config.NATIVE_SOURCE.read_bytes())
    digest.update(" ".join((cxx,) + CXX_FLAGS).encode())
    digest.update(macros.encode())
    return str(config.NATIVE_BUILD_DIR
               / f"libdbi_native_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        proc = subprocess.run(
            [_compiler(), *CXX_FLAGS, "-o", tmp, str(config.NATIVE_SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {config.NATIVE_SOURCE} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises RuntimeError
    when it cannot be built or its ABI is older than this binding's."""
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    try:
        lib.dbi_version.restype = ctypes.c_int64
        version = lib.dbi_version()
    except AttributeError:
        version = 0
    if version < ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {version}, this binding "
                           f"needs {ABI_VERSION}")
    _declare(lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "dbi_load_csv": (p, [ctypes.c_char_p, i, i]),
        "dbi_free": (None, [p]),
        "dbi_error": (ctypes.c_char_p, [p]),
        "dbi_n_rows": (i64, [p]),
        "dbi_n_cols": (i64, [p]),
        "dbi_col_is_numeric": (i, [p, i64]),
        "dbi_col_is_string": (i, [p, i64]),
        "dbi_col_labels_bytes": (i64, [p, i64]),
        "dbi_col_labels_fill": (None, [p, i64, ctypes.c_char_p]),
        "dbi_col_name": (ctypes.c_char_p, [p, i64]),
        "dbi_col_f32": (ctypes.POINTER(ctypes.c_float), [p, i64]),
        "dbi_col_i64": (ctypes.POINTER(ctypes.c_int64), [p, i64]),
        "dbi_col_null_mask": (ctypes.POINTER(ctypes.c_uint8), [p, i64]),
        "dbi_col_vocab_size": (i64, [p, i64]),
        "dbi_col_vocab": (ctypes.POINTER(ctypes.c_int64), [p, i64]),
        "dbi_col_codes": (ctypes.POINTER(ctypes.c_int32), [p, i64]),
        "dbi_swap_col_f32": (None, [p, i64, ctypes.POINTER(ctypes.c_float)]),
        "dbi_csv_open": (p, [ctypes.c_char_p, i, i]),
        "dbi_csv_stream_error": (ctypes.c_char_p, [p]),
        "dbi_csv_stream_ncols": (i64, [p]),
        "dbi_csv_stream_col_name": (ctypes.c_char_p, [p, i64]),
        "dbi_csv_next_chunk": (p, [p, i64]),
        "dbi_csv_close": (None, [p]),
        "dbi_format_csv": (i64, [
            ctypes.POINTER(ctypes.c_double), i64, i64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, i64, i]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def format_csv_block(cols, is_int, n_threads: int = 0,
                     names=None) -> memoryview:
    """CSV text of a block of columns, formatted natively on CPU threads:
    the write pass of the out-of-core path. cols: k arrays of m values;
    is_int[c] formats column c as an integer (exact to 2^53), else as the
    shortest repr of its f32 value (bit-exact through reload for the
    pipeline's f32 tables, lossy for genuine f64 input). NaN is an empty
    field, the loader's null. Returns a memoryview of the bytes.

    Raises ValueError, naming the column (`names[c]`, else its index),
    on an integer cell that is ±inf or beyond 2^53, which the C
    formatter's llround cannot represent."""
    lib = load_library()
    k = len(cols)
    m = len(cols[0]) if k else 0
    data = np.ascontiguousarray(np.stack(
        [np.asarray(c, np.float64) for c in cols])) if k else \
        np.zeros((0, 0), np.float64)
    flags = np.asarray(is_int, np.uint8)
    for c in np.nonzero(flags)[0]:
        bad = ~(np.abs(data[c]) <= MAX_EXACT_INT) & ~np.isnan(data[c])
        if bad.any():
            name = names[c] if names is not None else int(c)
            raise ValueError(
                f"column {name!r}: integer cell {float(data[c][bad][0])} is "
                f"±inf or beyond 2^53 and cannot be written exactly")
    cap = int(m * (27 * k + 2))
    # a numpy buffer and a memoryview slice of it: create_string_buffer
    # zeroes and .raw copies, several times the formatting's own cost
    buf = np.empty(cap, np.uint8)
    nb = lib.dbi_format_csv(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k, m,
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.ctypes.data_as(ctypes.c_char_p), cap, n_threads)
    if nb < 0:
        raise RuntimeError("dbi_format_csv: buffer too small")
    return memoryview(buf)[:nb]


class NativeTable:
    """The native table handle and numpy views of its column buffers
    (valid while the handle is open; `close` frees it)."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        err = lib.dbi_error(handle)
        if err:
            self.close()
            raise RuntimeError(err.decode())

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dbi_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @property
    def n_rows(self) -> int:
        return self._lib.dbi_n_rows(self._h)

    @property
    def n_cols(self) -> int:
        return self._lib.dbi_n_cols(self._h)

    def col_name(self, c: int) -> str:
        return self._lib.dbi_col_name(self._h, c).decode()

    def is_numeric(self, c: int) -> bool:
        return bool(self._lib.dbi_col_is_numeric(self._h, c))

    def is_string(self, c: int) -> bool:
        return bool(self._lib.dbi_col_is_string(self._h, c))

    def col_labels(self, c: int) -> tuple[str, ...]:
        """Sorted label dictionary of a string column; raw value v decodes
        to labels[v]."""
        nbytes = self._lib.dbi_col_labels_bytes(self._h, c)
        if nbytes == 0:
            return ()
        buf = ctypes.create_string_buffer(int(nbytes))
        self._lib.dbi_col_labels_fill(self._h, c, buf)
        return tuple(buf.raw.decode().split("\n")[:-1])

    def col_f32(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_f32(self._h, c),
                                     shape=(self.n_rows,))

    def col_i64(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_i64(self._h, c),
                                     shape=(self.n_rows,))

    def col_null(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(
            self._lib.dbi_col_null_mask(self._h, c),
            shape=(self.n_rows,)).astype(bool)

    def col_vocab(self, c: int) -> np.ndarray:
        v = self._lib.dbi_col_vocab_size(self._h, c)
        if v == 0:
            return np.zeros((0,), np.int64)
        return np.ctypeslib.as_array(self._lib.dbi_col_vocab(self._h, c),
                                     shape=(v,))

    def col_codes(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_codes(self._h, c),
                                     shape=(self.n_rows,))

    def swap_col_f32(self, c: int, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float32)
        self._lib.dbi_swap_col_f32(
            self._h, c, values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def columns(self):
        """(num f32[d, m], cat i64[c, m], num_null bool[d, m],
        cat_null bool[c, m]), copies of the buffers: numeric columns,
        then categorical ones, each kind in file order."""
        num_idx = [c for c in range(self.n_cols) if self.is_numeric(c)]
        cat_idx = [c for c in range(self.n_cols) if not self.is_numeric(c)]
        m = self.n_rows
        num = np.empty((len(num_idx), m), np.float32)
        num_null = np.empty((len(num_idx), m), bool)
        for j, c in enumerate(num_idx):
            num[j] = self.col_f32(c)
            num_null[j] = self.col_null(c)
        cat = np.empty((len(cat_idx), m), np.int64)
        cat_null = np.empty((len(cat_idx), m), bool)
        for j, c in enumerate(cat_idx):
            cat[j] = self.col_i64(c)
            cat_null[j] = self.col_null(c)
        return num, cat, num_null, cat_null

    def to_table(self, device=config.DEFAULT_DEVICE) -> Table:
        """The Table on `device` (the card unless asked otherwise): the
        columns, null masks, schema (each vocabulary the column's observed
        values), names and string labels."""
        num_idx = [c for c in range(self.n_cols) if self.is_numeric(c)]
        cat_idx = [c for c in range(self.n_cols) if not self.is_numeric(c)]
        num, cat, num_null, cat_null = self.columns()
        keys = tuple(tuple(int(v) for v in self.col_vocab(c))
                     for c in cat_idx)
        labels = tuple(self.col_labels(c) if self.is_string(c) else None
                       for c in cat_idx)
        t = from_numpy(
            num, cat, num_null, cat_null,
            num_names=tuple(self.col_name(c) for c in num_idx),
            cat_names=tuple(self.col_name(c) for c in cat_idx),
            schema=FeatureSchema(num_cols=len(num_idx), cat_keys=keys),
            rows_first=False, device=device)
        if any(lb is not None for lb in labels):
            t = dataclasses.replace(t, cat_labels=labels)
        return t


def load_csv(path: str, has_header: bool = True,
             n_threads: int = 0) -> NativeTable:
    """Parse a whole CSV on CPU threads (n_threads 0: one a core)."""
    lib = load_library()
    h = lib.dbi_load_csv(os.fsencode(path), 1 if has_header else 0,
                         n_threads)
    return NativeTable(h, lib)


def read_csv(path: str, has_header: bool = True,
             device=config.DEFAULT_DEVICE) -> Table:
    """CSV → Table on `device` (the card unless asked otherwise), in one
    call: the port's data-loading front door."""
    nt = load_csv(path, has_header)
    try:
        return nt.to_table(device)
    finally:
        nt.close()


class CsvStream:
    """Chunked native CSV reader of the out-of-core path: each
    `next_chunk` parses about `block_bytes` on CPU threads and returns a
    NativeTable of its own. Column types are fixed from the first block,
    so two streams of one file agree only with one `block_bytes`. Columns
    split as in `NativeTable.to_table`, so streamed and resident schemas
    line up. String columns are refused (their codes are per block)."""

    def __init__(self, path: str, has_header: bool = True,
                 block_bytes: int = 64 << 20, n_threads: int = 0):
        self._lib = load_library()
        self._h = self._lib.dbi_csv_open(os.fsencode(path),
                                         1 if has_header else 0, n_threads)
        self.block_bytes = block_bytes
        err = self._lib.dbi_csv_stream_error(self._h)
        if err:
            self.close()
            raise RuntimeError(err.decode())

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dbi_csv_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @property
    def col_names(self) -> tuple[str, ...]:
        n = self._lib.dbi_csv_stream_ncols(self._h)
        return tuple(self._lib.dbi_csv_stream_col_name(self._h, c).decode()
                     for c in range(n))

    def next_chunk(self) -> NativeTable | None:
        h = self._lib.dbi_csv_next_chunk(self._h, self.block_bytes)
        if not h:
            err = self._lib.dbi_csv_stream_error(self._h)
            if err:
                raise RuntimeError(err.decode())
            return None
        return NativeTable(h, self._lib)


def csv_chunk_source(path: str, has_header: bool = True,
                     block_bytes: int = 64 << 20, n_threads: int = 0):
    """Chunk source over a CSV for `ring.streaming` / `mice.streaming`: a
    callable returning an iterator of (num, cat, num_null, cat_null)
    features-first numpy chunks. Each call opens the file anew (the
    aggregation reads it twice and the write pass once more); the arrays
    are copies, so each block's native table is freed at once."""

    def source():
        stream = CsvStream(path, has_header, block_bytes, n_threads)
        try:
            while True:
                nt = stream.next_chunk()
                if nt is None:
                    return
                try:
                    yield nt.columns()
                finally:
                    nt.close()
        finally:
            stream.close()
    return source
