"""Checkpoint and resume of tables and MICE runs.

Counterpart of `duckdb_imputation_tpu.utils.checkpoint` (`save_table`,
`load_table`, `load_table_arrays`, `MiceCheckpointer`). The reference has
none (SURVEY.md §5). A checkpoint is the JAX package's npz layout: the
four table arrays (`num_data`, `cat_codes`, `num_null`, `cat_null`),
further arrays under `x_<name>` keys, and a JSON `meta` (schema, column
names, and `extra`), so a file either package writes loads in the other.
Files are written to a temporary name and moved into place with
`os.replace`: a reader sees the old file or the new one, never half of
one. They are not compressed (the JAX package's are; `np.load` reads
both): a sharded loop writes one every round or few, and compressing
the table costs more than the rounds (PERF.md, the [checkpoint] phase).

Unlike the JAX package, a run's checkpoint carries a fingerprint of the
run (`run_fingerprint`: the schema, the global row count, a checksum of
the null masks and observed values computed on the device, the loop's
settings and the world size); resuming against a file whose fingerprint
differs raises ValueError naming the field, instead of continuing another
run's table. `StreamCheckpointer` is the out-of-core loop's
(`mice.streaming`): the dirty rows, the full sigma and the stream's
schema and fills, with the same fingerprint; the JAX package's stream
file (which has none) is refused.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..parallel.mesh import all_reduce
from ..schema import FeatureSchema
from ..table.table import Table


def save_table(path: str, t: Table, extra: dict | None = None,
               arrays: dict | None = None) -> None:
    """Atomic npz snapshot of a Table (its tensors copied to the host).
    `extra` rides as JSON metadata; `arrays` (numpy arrays or tensors) are
    stored under `x_<name>` keys, which `load_table_arrays` returns."""
    meta = {
        "num_cols": t.schema.num_cols,
        "cat_keys": [list(k) for k in t.schema.cat_keys],
        "num_names": list(t.num_names),
        "cat_names": list(t.cat_names),
        "extra": extra or {},
    }
    if any(labels is not None for labels in t.cat_labels):
        meta["cat_labels"] = [None if labels is None else list(labels)
                              for labels in t.cat_labels]

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    tmp = path + ".tmp"
    np.savez(
        tmp, num_data=host(t.num_data), cat_codes=host(t.cat_codes),
        num_null=host(t.num_null), cat_null=host(t.cat_null),
        meta=json.dumps(meta),
        **{f"x_{k}": host(v) for k, v in (arrays or {}).items()})
    os.replace(tmp + ".npz", path)


def load_table(path: str, device="cuda") -> tuple[Table, dict]:
    """(Table on `device`, extra) of a `save_table` file; the card unless
    the caller asks for the CPU."""
    t, extra, _ = load_table_arrays(path, device)
    return t, extra


def load_table_arrays(path: str, device="cuda") -> tuple[Table, dict, dict]:
    """(Table on `device`, extra, arrays) of a `save_table` file; arrays
    stay numpy."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        schema = FeatureSchema(
            num_cols=int(meta["num_cols"]),
            cat_keys=tuple(tuple(int(v) for v in k)
                           for k in meta["cat_keys"]))

        def tensor(name, dtype):
            return torch.tensor(np.asarray(z[name], dtype), device=device)

        labels = meta.get("cat_labels")
        t = Table(num_data=tensor("num_data", np.float32),
                  cat_codes=tensor("cat_codes", np.int32),
                  num_null=tensor("num_null", bool),
                  cat_null=tensor("cat_null", bool), schema=schema,
                  num_names=tuple(meta["num_names"]),
                  cat_names=tuple(meta["cat_names"]),
                  cat_labels=() if labels is None else tuple(
                      None if lab is None else tuple(lab) for lab in labels))
        arrays = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return t, meta.get("extra", {}), arrays


_P = 2_147_483_629   # a prime below 2^31: every product below stays < 2^62


def _column_checksum(values: torch.Tensor, null: torch.Tensor, col: int,
                     row_offset: int) -> torch.Tensor:
    """Σ_i (u_i mod P)·w_i mod P over a column, as an int64 scalar on its
    device: u_i = the value's 32 bits + 1 where observed, 0 where null;
    w_i = (global row · 40503 + col · 69069 + 1) mod P. Integer sums do
    not depend on their order, so shards sum to the whole table's."""
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(null, 0, bits + 1) % _P
    rows = row_offset + torch.arange(values.shape[-1], dtype=torch.int64,
                                     device=values.device)
    w = (rows * 40503 + col * 69069 + 1) % _P
    return ((u * w) % _P).sum() % _P


def table_checksum(t: Table, row_offset: int = 0, mesh=None) -> int:
    """A checksum of the table's null masks and observed values (numeric
    bits and categorical codes; the filler under a null does not count),
    computed on the table's device; with a mesh of row shards (`t` the
    rank's rows from global row `row_offset`), the whole table's, the same
    for any number of shards."""
    total = torch.zeros(1, dtype=torch.int64, device=t.device)
    for j in range(t.num_data.shape[0]):
        total += _column_checksum(t.num_data[j], t.num_null[j], j, row_offset)
    d = t.num_data.shape[0]
    for j in range(t.cat_codes.shape[0]):
        total += _column_checksum(t.cat_codes[j].to(torch.int32),
                                  t.cat_null[j], d + j, row_offset)
    if mesh is not None:
        total = all_reduce(total, mesh)
    return int(total) % _P


def run_fingerprint(t: Table, *, n_rows: int, world_size: int = 1,
                    row_offset: int = 0, mesh=None, **settings) -> dict:
    """The fingerprint a checkpoint of a MICE run carries: the schema, the
    global row count, `table_checksum`, the world size and the run's
    settings (seed, noise, trainer, kernel, lda_shrinkage, gd_iters, the
    columns imputed, ...), as JSON values."""
    fp = {"num_cols": t.schema.num_cols,
          "cat_keys": [list(k) for k in t.schema.cat_keys],
          "n_rows": int(n_rows),
          "checksum": table_checksum(t, row_offset, mesh),
          "world_size": int(world_size)}
    for k, v in settings.items():
        fp[k] = list(v) if isinstance(v, tuple) else v
    return json.loads(json.dumps(fp))


def fingerprint_mismatch(saved: dict | None, current: dict) -> str | None:
    """None when `saved` equals `current`, else a message naming the first
    field that differs."""
    if saved is None:
        return "the file has no run fingerprint"
    for k in sorted(set(saved) | set(current)):
        if saved.get(k) != current.get(k):
            return (f"field {k!r} is {saved.get(k)!r} in the file and "
                    f"{current.get(k)!r} in this run")
    return None


def check_resume(path: str, extra: dict, fingerprint: dict | None,
                 iters: int | None) -> int:
    """The completed rounds of a loaded checkpoint's `extra`; raises
    ValueError when its fingerprint does not match `fingerprint` (if one
    is given) or it completed more rounds than the `iters` asked for."""
    if fingerprint is not None:
        why = fingerprint_mismatch(extra.get("fingerprint"), fingerprint)
        if why is not None:
            raise ValueError(f"checkpoint {path}: it is not of this run: "
                             f"{why}")
    done = int(extra.get("completed_iters", 0))
    if iters is not None and done > iters:
        raise ValueError(f"checkpoint {path}: it completed {done} rounds, "
                         f"more than the {iters} asked for")
    return done


@dataclasses.dataclass
class MiceCheckpointer:
    """on_iteration callback of the host MICE drivers: persist the table
    after every round (with the run's `fingerprint`, if given) and report
    the round to resume from."""
    path: str
    fingerprint: dict | None = None

    def __call__(self, t: Table, iteration: int) -> None:
        extra = {"completed_iters": iteration + 1}
        if self.fingerprint is not None:
            extra["fingerprint"] = self.fingerprint
        save_table(self.path, t, extra=extra)

    def resume(self, iters: int | None = None, device="cuda"
               ) -> tuple[Table, int] | None:
        """(table on `device`, completed rounds), or None without a file.
        Raises ValueError on a fingerprint that does not match this
        checkpointer's, or more completed rounds than `iters`."""
        if not os.path.exists(self.path):
            return None
        t, extra = load_table(self.path, device)
        return t, check_resume(self.path, extra, self.fingerprint, iters)


@dataclasses.dataclass
class StreamCheckpointer:
    """Checkpoint and resume of out-of-core MICE (`mice.streaming`): after
    each round, everything `run_mice_stream` needs to go on without the
    fold: the dirty-row table, their global ids `idx`, the current full
    sigma f32[P, P] (the loop's own, so a resumed run is bit-identical to
    one never stopped), the stream's fills and schema, the completed
    rounds and the run's `fingerprint`. O(dirty + P²), never O(n)."""
    path: str
    fingerprint: dict | None = None

    def save(self, t: Table, full_sigma: torch.Tensor, idx, fills, ss,
             completed_iters: int) -> None:
        extra = {
            "completed_iters": completed_iters,
            "fills": {k: list(v) for k, v in
                      dataclasses.asdict(fills).items()},
            "ss": {"nullable_num": list(ss.nullable_num),
                   "nullable_cat": list(ss.nullable_cat),
                   "n_rows": int(ss.n_rows)},
        }
        if self.fingerprint is not None:
            extra["fingerprint"] = self.fingerprint
        save_table(self.path, t, extra, arrays={
            "idx": np.asarray(idx, np.int64), "full_sigma": full_sigma})

    def resume(self, iters: int | None = None, device="cuda"):
        """(dirty table on `device`, full sigma on `device`, idx, fills,
        StreamSchema, completed rounds), or None without a file. Raises
        ValueError on a fingerprint that does not match this
        checkpointer's (a file without one, such as the JAX package's, is
        refused) or more completed rounds than `iters`."""
        if not os.path.exists(self.path):
            return None
        from ..ring.streaming import StreamFills, StreamSchema

        t, extra, arr = load_table_arrays(self.path, device)
        done = check_resume(self.path, extra, self.fingerprint, iters)
        fills = StreamFills(**{k: tuple(v)
                               for k, v in extra["fills"].items()})
        s = extra["ss"]
        ss = StreamSchema(schema=t.schema,
                          nullable_num=tuple(s["nullable_num"]),
                          nullable_cat=tuple(s["nullable_cat"]),
                          n_rows=int(s["n_rows"]))
        sigma = torch.tensor(arr["full_sigma"], dtype=torch.float32,
                             device=device)
        return t, sigma, np.asarray(arr["idx"]), fills, ss, done
