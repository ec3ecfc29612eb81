"""Out-of-core streaming cofactor aggregation.

Counterpart of `duckdb_imputation_tpu.ring.streaming`: tables that never
fit in device memory (or host memory) stream through it chunk by chunk
and fold into one resident Gram matrix.

MICE's init fill (`mice.partition.init_fill`: numeric nulls take the
column MEAN, categorical nulls the column MODE, partition.cpp:42-57 and
init_baseline :671-719) needs global statistics that are unknown until
the whole stream has been seen. Instead of a second pass over the filled
data, one extended Gram is folded over

    A = [ Z₀ | M ]  ∈ [m, P+K]

where Z₀ is the feature block with nulls contributing nothing (numeric
null cells zeroed, categorical null cells out of vocabulary, so their
one-hot row is zero) and M the 0/1 null flags of the K nullable columns.
With U ∈ [P, K] placing each nullable column's fill at its sigma row, the
filled block is Z₀ + M·Uᵀ, so with G = AᵀA in blocks G_zz, G_zm, G_mm

    S_filled = G_zz + G_zm·Uᵀ + U·G_zmᵀ + U·G_mm·Uᵀ,

the full triple over the mean/mode-filled table from one pass. The fills
come out of G too: observed sums and counts are row 0 of G_zz, null
counts the diagonal of G_mm.

The fold (`scan_gram`) is the port's own: A is exactly Z of the EXTENDED
schema, the schema with the K flags appended as K categorical columns of
one level each (code 0 where the cell is null, 1, out of vocabulary,
where it is observed), already in [Z₀ | M] order. So each chunk is one
call of the masked-Gram kernels (`ring.kernels.sigma_pallas.masked_gram`:
K1 at P + K ≤ 88, K7 above: one launch, or past P + K = 1,024 one a
column window), with no row padding, and the chunks' f32
results are summed in f64 on the device: counts stay exact past 2²⁴ rows,
where the JAX package's f32 sum of chunks does not. The kernels take
any column count and P + K ≤ `_build.MAX_WINDOW_SIGMA_SIZE` (K7's
windows); past it a CUDA fold raises before it reads the stream. Null cells are zeroed and codes
encoded on the host; chunks are copied to the device as they are (plain
copies, no packing). With a mesh (`parallel.Mesh`), each rank folds its
`row_shard` of every chunk and one all-reduce of the f64 Gram ends the
pass (the JAX package's GSPMD sums every chunk; the sum is the same).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .. import config
from ..parallel.mesh import all_reduce, row_shard
from ..schema import FeatureSchema
from .kernels import _build
from .triple import Triple, triple_from_sigma

# Rows of a re-blocked chunk of the fold.
DEFAULT_STREAM_CHUNK = 1 << 20


class Chunk(NamedTuple):
    """One host chunk of a streamed table, features-first.

    num: f32[d, m] numeric columns (NaN ⇒ missing when num_null is None).
    cat: i64[c, m] RAW categorical values (negative ⇒ missing when
      cat_null is None); they are encoded against the global schema
      inside the fold, once the vocabularies are known.
    """
    num: np.ndarray | None
    cat: np.ndarray | None
    num_null: np.ndarray | None = None
    cat_null: np.ndarray | None = None


def _normalize_chunk(ch) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    if not isinstance(ch, Chunk):
        ch = Chunk(*ch)  # a plain (num, cat[, num_null, cat_null])
    num, cat = ch.num, ch.cat
    if num is None and cat is None:
        raise ValueError("chunk needs num or cat columns")
    m = num.shape[-1] if num is not None else cat.shape[-1]
    num = (np.zeros((0, m), np.float32) if num is None
           else np.asarray(num, np.float32))
    cat = (np.zeros((0, m), np.int64) if cat is None
           else np.asarray(cat, np.int64))
    num_null = (np.isnan(num) if ch.num_null is None
                else np.asarray(ch.num_null, bool))
    cat_null = (cat < 0 if ch.cat_null is None
                else np.asarray(ch.cat_null, bool))
    return num, cat, num_null, cat_null


def _rows(num: np.ndarray, cat: np.ndarray) -> int:
    return num.shape[-1] if num.shape[0] else cat.shape[-1]


def chunks_from_arrays(num, cat, num_null=None, cat_null=None,
                       chunk_rows: int = DEFAULT_STREAM_CHUNK):
    """Chunk source over in-memory features-first arrays: a callable
    returning an iterator of `Chunk`s of `chunk_rows` rows (views)."""
    ch = _normalize_chunk(Chunk(num, cat, num_null, cat_null))

    def source() -> Iterator[Chunk]:
        n = _rows(ch[0], ch[1])
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            yield Chunk(*(a[:, lo:hi] for a in ch))
    return source


@dataclasses.dataclass(frozen=True)
class StreamSchema:
    """The global schema and the nullable columns found by pass 0."""
    schema: FeatureSchema
    nullable_num: tuple[int, ...]   # numeric columns with a null
    nullable_cat: tuple[int, ...]
    n_rows: int

    @property
    def k(self) -> int:
        return len(self.nullable_num) + len(self.nullable_cat)


def extended_schema(ss: StreamSchema) -> FeatureSchema:
    """The schema whose Z is the fold's A = [Z₀ | M]: the K null flags as
    K categorical columns of one level (code 0 = null, 1 = observed, out
    of vocabulary)."""
    return FeatureSchema(num_cols=ss.schema.num_cols,
                         cat_keys=ss.schema.cat_keys + ((0,),) * ss.k)


@dataclasses.dataclass
class DirtyCache:
    """Host cache of the rows with at least one null, the only rows MICE
    rewrites: the whole working set after the stream pass, O(dirty)."""
    idx: np.ndarray        # i64[nd] global row ids, ascending
    num: np.ndarray        # f32[d, nd] raw values (null cells garbage)
    cat: np.ndarray        # i64[c, nd] raw values
    num_null: np.ndarray   # bool[d, nd]
    cat_null: np.ndarray   # bool[c, nd]


class DirtySpill:
    """Disk-backed dirty-row store for high missing rates.

    Past `dirty_budget_rows` dirty rows the cache spills to files in a
    temporary directory, and every consumer (the delta aggregation, the
    predict write-back, the output substitution) reads them through
    bounded windows: peak host memory is O(chunk + window + (P+K)²),
    whatever n and the missing rate. Arrays are ROWS-FIRST on disk, so an
    append is contiguous; `window(lo, hi)` returns features-first copies;
    writes go straight into the memmaps (the imputed values live on disk
    between rounds). `cleanup` removes the directory."""

    def __init__(self, d: int, c: int, dir: str | None = None):
        self._dir = tempfile.mkdtemp(prefix="dbi_spill_", dir=dir)
        self.d, self.c = d, c
        names = ("idx", "num", "cat", "num_null", "cat_null")
        self._paths = {nm: os.path.join(self._dir, nm + ".bin")
                       for nm in names}
        self._handles = {nm: open(p, "wb") for nm, p in self._paths.items()}
        self.n = 0

    def append(self, idx, num, cat, num_null, cat_null) -> None:
        """Append a features-first dirty slice (written rows-first)."""
        for name, a, dtype in (("idx", idx, np.int64),
                               ("num", num.T, np.float32),
                               ("cat", cat.T, np.int64),
                               ("num_null", num_null.T, bool),
                               ("cat_null", cat_null.T, bool)):
            self._handles[name].write(
                np.ascontiguousarray(a, dtype).tobytes())
        self.n += len(idx)

    def finalize(self) -> None:
        for h in self._handles.values():
            h.close()
        self._handles = {}

        def mm(nm, dtype, shape):
            return (np.memmap(self._paths[nm], dtype=dtype, mode="r+",
                              shape=shape) if self.n
                    else np.zeros(shape, dtype))
        self.idx = mm("idx", np.int64, (self.n,))
        self.num = mm("num", np.float32, (self.n, self.d))
        self.cat = mm("cat", np.int64, (self.n, self.c))
        self.num_null = mm("num_null", bool, (self.n, self.d))
        self.cat_null = mm("cat_null", bool, (self.n, self.c))

    def window(self, lo: int, hi: int):
        """Features-first copies of rows [lo, hi): (num f32[d, m],
        cat i64[c, m], num_null bool[d, m], cat_null bool[c, m])."""
        return (np.ascontiguousarray(self.num[lo:hi].T),
                np.ascontiguousarray(self.cat[lo:hi].T),
                np.ascontiguousarray(self.num_null[lo:hi].T),
                np.ascontiguousarray(self.cat_null[lo:hi].T))

    def write_num(self, col: int, lo: int, values, mask) -> None:
        """Masked write of imputed numeric values into rows
        [lo, lo + len(mask))."""
        block = self.num[lo:lo + len(mask), col]
        block[mask] = np.asarray(values, np.float32)[mask]

    def write_cat(self, col: int, lo: int, raw_values, mask) -> None:
        block = self.cat[lo:lo + len(mask), col]
        block[mask] = np.asarray(raw_values, np.int64)[mask]

    def cleanup(self) -> None:
        for h in self._handles.values():
            h.close()
        self._handles = {}
        shutil.rmtree(self._dir, ignore_errors=True)


def scan_schema(chunk_source, *, collect_dirty: bool = True,
                dirty_budget_rows: int | None = None, spill_dir=None
                ) -> tuple[StreamSchema, "DirtyCache | DirtySpill | None"]:
    """Pass 0, on the host: each categorical column's vocabulary over its
    OBSERVED values (the streaming `build_list_of_uniq_categoricals`,
    partition.cpp:722-747), the nullable columns, and the dirty-row cache.
    Past `dirty_budget_rows` dirty rows the cache becomes a disk-backed
    `DirtySpill`, and host memory stays bounded."""
    vocabs: list[set] | None = None
    d_num = None
    n_rows = 0
    any_num_null = any_cat_null = None
    dirty: list[tuple] = []
    dirty_count = 0
    spill: DirtySpill | None = None
    for raw in chunk_source():
        num, cat, num_null, cat_null = _normalize_chunk(raw)
        m = _rows(num, cat)
        if vocabs is None:
            d_num = num.shape[0]
            vocabs = [set() for _ in range(cat.shape[0])]
            any_num_null = np.zeros(num.shape[0], bool)
            any_cat_null = np.zeros(cat.shape[0], bool)
        for j in range(cat.shape[0]):
            vocabs[j].update(np.unique(cat[j, ~cat_null[j]]).tolist())
        any_num_null |= num_null.any(axis=1)
        any_cat_null |= cat_null.any(axis=1)
        if collect_dirty:
            rows = num_null.any(axis=0) | cat_null.any(axis=0)
            if rows.any():
                (r,) = np.nonzero(rows)
                part = (r + n_rows, num[:, r], cat[:, r],
                        num_null[:, r], cat_null[:, r])
                dirty_count += len(r)
                if (spill is None and dirty_budget_rows is not None
                        and dirty_count > dirty_budget_rows):
                    spill = DirtySpill(d_num, cat.shape[0], dir=spill_dir)
                    for dpart in dirty:
                        spill.append(*dpart)
                    dirty = []
                if spill is not None:
                    spill.append(*part)
                else:
                    dirty.append(part)
        n_rows += m
    if vocabs is None:
        raise ValueError("empty stream")
    schema = FeatureSchema(
        num_cols=d_num, cat_keys=tuple(tuple(sorted(v)) for v in vocabs))
    ss = StreamSchema(
        schema=schema,
        nullable_num=tuple(int(j) for j in np.nonzero(any_num_null)[0]),
        nullable_cat=tuple(int(j) for j in np.nonzero(any_cat_null)[0]),
        n_rows=n_rows)
    if not collect_dirty:
        return ss, None
    if spill is not None:
        spill.finalize()
        return ss, spill
    if dirty:
        return ss, DirtyCache(*(np.concatenate([d[i] for d in dirty],
                                               axis=-1) for i in range(5)))
    return ss, DirtyCache(
        idx=np.zeros((0,), np.int64),
        num=np.zeros((schema.num_cols, 0), np.float32),
        cat=np.zeros((schema.cat_cols, 0), np.int64),
        num_null=np.zeros((schema.num_cols, 0), bool),
        cat_null=np.zeros((schema.cat_cols, 0), bool))


def encode_chunk(num, cat, num_null, cat_null, ss: StreamSchema
                 ) -> tuple[np.ndarray, np.ndarray]:
    """A chunk as the fold's inputs over `extended_schema(ss)`: (x f32[d,
    m] with null cells zeroed, codes i32[c + K, m]: the local codes with
    null cells out of vocabulary, then the K flags)."""
    schema = ss.schema
    m = _rows(num, cat)
    x = np.where(num_null, np.float32(0), num).astype(np.float32)
    codes = np.empty((schema.cat_cols + ss.k, m), np.int32)
    if schema.cat_cols:
        sizes = np.asarray(schema.cat_sizes, np.int32)[:, None]
        codes[:schema.cat_cols] = np.where(cat_null, sizes,
                                           schema.encode(cat.T).T)
    flags = ([num_null[j] for j in ss.nullable_num]
             + [cat_null[j] for j in ss.nullable_cat])
    for k, null in enumerate(flags):
        codes[schema.cat_cols + k] = ~null
    return x, codes


def check_fold(ss: StreamSchema, rows: int) -> None:
    """Raise ValueError when the kernels cannot fold this stream's
    extended schema: any number of columns of any levels, the K flags
    among them, up to P + K = K7's window limit."""
    ext = extended_schema(ss)
    _build.check_schema(ext, rows, _build.MAX_WINDOW_SIGMA_SIZE)


def _reblocked(chunk_source, chunk_rows: int):
    """The source's chunks cut and joined into chunks of `chunk_rows` rows
    (the last one ragged)."""
    buf = None
    for raw in chunk_source():
        parts = _normalize_chunk(raw)
        buf = parts if buf is None else tuple(
            np.concatenate([b, p], axis=1) for b, p in zip(buf, parts))
        while _rows(buf[0], buf[1]) >= chunk_rows:
            yield tuple(a[:, :chunk_rows] for a in buf)
            buf = tuple(a[:, chunk_rows:] for a in buf)
    if buf is not None and _rows(buf[0], buf[1]):
        yield buf


def scan_gram(chunk_source, ss: StreamSchema, *,
              chunk_rows: int = DEFAULT_STREAM_CHUNK, mesh=None,
              device=config.DEFAULT_DEVICE, timer=None) -> torch.Tensor:
    """Pass 1: the extended Gram G = AᵀA, f64[P+K, P+K] on `device` (the
    card unless asked otherwise; a mesh's own device with `mesh`).

    The source is re-blocked into chunks of `chunk_rows` rows, each
    encoded on the host (`encode_chunk`), copied to the device and folded
    by one `masked_gram` call over the extended schema (K1 or K7 on a CUDA
    device, the plain Gram on the CPU); the f32 results are summed in f64.
    With `mesh`, each rank folds its `row_shard` of every chunk and the
    ranks' Grams are all-reduced once at the end. `timer` (a PhaseTimer),
    if given, times the host encoding ('encode') and the copies and
    launches ('fold')."""
    from .kernels.sigma_pallas import masked_gram

    if mesh is not None:
        device = mesh.device
    device = torch.device(device)
    ext = extended_schema(ss)
    if device.type == "cuda":
        check_fold(ss, chunk_rows)
    p = ext.sigma_size
    gram = torch.zeros((p, p), dtype=torch.float64, device=device)
    for parts in _reblocked(chunk_source, chunk_rows):
        m = _rows(parts[0], parts[1])
        lo, hi = (0, m) if mesh is None else row_shard(m, mesh.rank,
                                                       mesh.world)
        if hi == lo:
            continue
        parts = tuple(a[:, lo:hi] for a in parts)
        with _phase(timer, "encode"):
            x, codes = encode_chunk(*parts, ss)
        with _phase(timer, "fold"):
            xt = torch.from_numpy(x).to(device)
            ct = torch.from_numpy(codes).to(device)
            gram += masked_gram(xt, ct, None, schema=ext).double()
    if mesh is not None:
        gram = all_reduce(gram, mesh)
    return gram


def _phase(timer, name: str):
    return contextlib.nullcontext() if timer is None else timer.phase(name)


@dataclasses.dataclass(frozen=True)
class StreamFills:
    """The init fills recovered from the extended Gram (init_baseline's
    AVG/MODE, partition.cpp:42-57) and the null counts."""
    num_means: tuple[float, ...]        # per NUMERIC col (0.0 if not nullable)
    cat_modes: tuple[int, ...]          # per CAT col, LOCAL mode code
    num_null_counts: tuple[int, ...]
    cat_null_counts: tuple[int, ...]


def assemble_filled_triple(gram, ss: StreamSchema) -> tuple[Triple,
                                                            StreamFills]:
    """The extended Gram's blocks → the full triple over the mean/mode
    FILLED table (the U algebra of the module docstring), in f64 on the
    host, rounded to f32 once; the Triple lies on the Gram's device (a
    numpy Gram: the CPU)."""
    device = gram.device if isinstance(gram, torch.Tensor) else "cpu"
    g = (gram.detach().cpu().numpy() if isinstance(gram, torch.Tensor)
         else np.asarray(gram)).astype(np.float64)
    schema = ss.schema
    p, d = schema.sigma_size, schema.num_cols
    gzz, gzm, gmm = g[:p, :p], g[:p, p:], g[p:, p:]
    n = gzz[0, 0]
    nullc = np.diag(gmm)
    offs = schema.offsets
    means = [0.0] * d
    modes = [0] * schema.cat_cols
    num_nc = [0] * d
    cat_nc = [0] * schema.cat_cols
    u = np.zeros((p, ss.k), np.float64)
    for k, j in enumerate(ss.nullable_num):
        cnt = n - nullc[k]
        means[j] = float(gzz[0, 1 + j] / cnt) if cnt > 0 else 0.0
        num_nc[j] = int(round(nullc[k]))
        u[1 + j, k] = means[j]
    for k2, j in enumerate(ss.nullable_cat):
        k = len(ss.nullable_num) + k2
        counts = gzz[0, 1 + d + offs[j]:1 + d + offs[j + 1]]
        modes[j] = int(np.argmax(counts)) if counts.size else 0
        cat_nc[j] = int(round(nullc[k]))
        u[1 + d + offs[j] + modes[j], k] = 1.0
    sigma = gzz + gzm @ u.T + u @ gzm.T + u @ gmm @ u.T
    fills = StreamFills(num_means=tuple(means), cat_modes=tuple(modes),
                        num_null_counts=tuple(num_nc),
                        cat_null_counts=tuple(cat_nc))
    sigma = torch.tensor(sigma, dtype=torch.float32, device=device)
    return triple_from_sigma(sigma, d), fills


def aggregate_stream(chunk_source, *, chunk_rows: int = DEFAULT_STREAM_CHUNK,
                     collect_dirty: bool = True, mesh=None,
                     dirty_budget_rows: int | None = None, spill_dir=None,
                     device=config.DEFAULT_DEVICE):
    """Both passes: the vocabulary and dirty scan on the host, then the
    fold on `device`. Returns (filled full Triple, StreamFills,
    StreamSchema, DirtyCache | DirtySpill | None): a DirtySpill when the
    dirty count passed `dirty_budget_rows`."""
    ss, cache = scan_schema(chunk_source, collect_dirty=collect_dirty,
                            dirty_budget_rows=dirty_budget_rows,
                            spill_dir=spill_dir)
    gram = scan_gram(chunk_source, ss, chunk_rows=chunk_rows, mesh=mesh,
                     device=device)
    full, fills = assemble_filled_triple(gram, ss)
    return full, fills, ss, cache
