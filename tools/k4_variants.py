"""Time the candidates for K4, the unsorted grouped Gram, on one GPU.

K4 as built (`grouped_gram`: a stable group order of the ids, then K5's
tensor-core kernel over the rows through the order's index list) beside
the candidates of `tools/k4_variants.cu`, which this script compiles with
`nvcc` (the package's kernels included whole) into `build/k4_variants/`:

- `order`: the group order alone (count, scan, scatter of the indices);
- `packed`: the order writing a group-ordered packed copy of the rows
  (w, x, codes) instead of their indices, then K5 over the copy in place;
- `onepass`: one pass with no order first: each step's 128 rows bucketed
  by group in shared memory, each group's run padded to a k16 boundary,
  the fragments folded into the group's f64 sums at the end of its run;
- `k5_sorted`: K5 (`grouped_gram_presorted`) over the same rows sorted
  by `sort_by_group`, read in place: K4's Gram without the gather;
- `k5_gather`: K4's second half alone, K5 through the order's index list
  over the unsorted rows; `k5_identity`: K5 through an index list that
  is the identity over the sorted rows (the indirection without the
  scattered reads);
- `grid_<B>`: K4 as built on a grid of B blocks instead of
  `_build.tc_grid(n)` (at most 660, one wave of 5 an SM): shorter runs
  of steps, taken by the SMs as they free up.

Last, a `torch.profiler` trace of one K4 call at each table gives each
of its kernels' device time.

Tables: BASELINE config 4 (P = 21, 8 classes, 90% in class 0) and the
same schema with 8 uniform classes, 10M rows, binary weights (the
tables of `chip_smoke.py`). Each candidate is held against the plain
version (counts exact, within 1e-5 of max|σ| per group) before it is
timed. Times: CUDA events, ms per call, mean of 10 after a warm-up.

    python3 tools/k4_variants.py

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, ptxas's registers and spills of the
candidates' kernels, then one JSON line per table.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def compile_lib():
    """tools/k4_variants.cu compiled against the package's sources;
    returns (library, nvcc's log)."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    out = ROOT / "build" / "k4_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk4v.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), "-o", str(lib),
         str(ROOT / "tools" / "k4_variants.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def build():
    so, log = compile_lib()
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if re.search(r"onepass_kernel|packed_scatter_kernel",
                     line):
            print(" ".join(l.strip() for l in lines[i:i + 3]), flush=True)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    so.k4v_order.argtypes = [p, i, i64, i, p, p, p, p]
    so.k4v_packed.argtypes = [p, i, p, p, i, p, p, i, i64, i, p, p, p, p, i,
                              p, p]
    so.k4v_onepass.argtypes = [p, i, p, p, i, p, p, i, i64, i, p, i, p, p]
    so.k4v_k5_through.argtypes = [p, i, p, p, i, p, p, p, i, i64, i, p, i, p,
                                  p]
    return so


GRIDS = (1320, 2640, 5280)


def kernel_times(fn) -> dict:
    """Device ms of each kernel of one call of fn (torch.profiler), by
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t > 0 and "Memcpy" not in ev.key:
            name = re.sub(r"^.*?(\w+_kernel|\w+_reduce)\b.*$", r"\1", ev.key)
            out[name] = out.get(name, 0.0) + t / 1e3
    return out


def main() -> int:
    import chip_smoke as cs
    import torch
    from k1_variants import card

    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_plain, grouped_gram_presorted,
        sort_by_group)

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    so = build()
    dev = cs.DEVICE
    classes = cs.CLASSES
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, hot in (("config4", 0.9), ("uniform8", None)):
        x, codes, y, schema = cs.make_classify_table(cs.N, 0, hot=hot)
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        w = (torch.rand(cs.N, generator=gen, device=dev) >= 0.2).float()
        n, p, d = cs.N, schema.sigma_size, schema.num_cols
        kw = dict(schema=schema, num_groups=classes)
        want = grouped_gram_plain(x, codes, w, y, **kw)
        counts = torch.empty(classes * _build.ORDER_BLOCKS, dtype=torch.int64,
                             device=dev)
        off_cum = torch.empty(2 * (classes + 1), dtype=torch.int64,
                              device=dev)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        packed = torch.empty((1 + d + schema.cat_cols) * n, device=dev)
        nblocks = _build.tc_grid(n)
        partial = torch.empty(_build.TC_A ** 2 * (nblocks + classes),
                              dtype=torch.float64, device=dev)
        partial1 = torch.empty(classes * _build.TC_A ** 2 * nblocks,
                               dtype=torch.float64, device=dev)
        cols = (_build.pointers(list(x)), d, _build.pointers(list(codes)),
                _build.int_array(schema.cat_sizes), schema.cat_cols,
                w.data_ptr(), y.data_ptr(), classes, n, p)

        def packed_call():
            out = torch.empty((classes, p, p), device=dev)
            rc = so.k4v_packed(*cols, counts.data_ptr(), off_cum.data_ptr(),
                               packed.data_ptr(), partial.data_ptr(), nblocks,
                               out.data_ptr(), stream())
            cs.check(rc == 0, f"k4v_packed: CUDA error {rc}")
            return out

        def onepass_call():
            out = torch.empty((classes, p, p), device=dev)
            rc = so.k4v_onepass(*cols, partial1.data_ptr(), nblocks,
                                out.data_ptr(), stream())
            cs.check(rc == 0, f"k4v_onepass: CUDA error {rc}")
            return out

        def order_call():
            rc = so.k4v_order(y.data_ptr(), classes, n, _build.TC_ROWS,
                              counts.data_ptr(), off_cum.data_ptr(),
                              idx.data_ptr(), stream())
            cs.check(rc == 0, f"k4v_order: CUDA error {rc}")

        row = {"table": name, "n": n}
        for label, fn in (("as_built", lambda: grouped_gram(x, codes, w, y,
                                                            **kw)),
                          ("packed", packed_call), ("onepass", onepass_call)):
            got, again = fn(), fn()
            torch.cuda.synchronize()
            row[f"{label}_rel_err"] = cs.check_grouped(
                f"{name} {label}", got, again, want, schema, binary=True)
            row[f"{label}_ms"] = cs.cuda_ms(fn)
        row["order_ms"] = cs.cuda_ms(order_call)
        lib = _build.load().lib
        for blocks in GRIDS:
            key = f"grid_{blocks}"
            part = torch.empty(_build.TC_A ** 2 * (blocks + classes),
                               dtype=torch.float64, device=dev)

            def k4_call():
                out = torch.empty((classes, p, p), device=dev)
                rc = lib.dit_grouped_gram(
                    *cols, counts.data_ptr(), off_cum.data_ptr(),
                    idx.data_ptr(), part.data_ptr(), blocks, out.data_ptr(),
                    stream())
                cs.check(rc == 0, f"{key}: CUDA error {rc}")
                return out
            cs.check_grouped(f"{name} {key}", k4_call(), k4_call(), want,
                             schema, binary=True)
            row[f"{key}_ms"] = cs.cuda_ms(k4_call)
            del part
        xs, cs_, ws, layout = sort_by_group(x, codes, y, weights=w, **kw)
        row["k5_sorted_ms"] = cs.cuda_ms(
            lambda: grouped_gram_presorted(xs, cs_, ws, layout,
                                           schema=schema))

        def through(cols_, w_, order):
            def call():
                out = torch.empty((classes, p, p), device=dev)
                rc = so.k4v_k5_through(
                    *cols_, w_.data_ptr(), off_cum.data_ptr(),
                    order.data_ptr(), classes, n, p, partial.data_ptr(),
                    nblocks, out.data_ptr(), stream())
                cs.check(rc == 0, f"k4v_k5_through: CUDA error {rc}")
                return out
            return call

        order_call()        # off_cum and idx of the unsorted rows
        gather = through(cols[:5], w, idx)
        cs.check_grouped(f"{name} k5_gather", gather(), gather(), want,
                         schema, binary=True)
        row["k5_gather_ms"] = cs.cuda_ms(gather)
        ident = torch.arange(n, dtype=torch.int32, device=dev)
        sorted_cols = (_build.pointers(list(xs)), d,
                       _build.pointers(list(cs_)), cols[3], cols[4])
        identity = through(sorted_cols, ws, ident)
        cs.check_grouped(f"{name} k5_identity", identity(), identity(), want,
                         schema, binary=True)
        row["k5_identity_ms"] = cs.cuda_ms(identity)
        row["k4_kernels_ms"] = kernel_times(
            lambda: grouped_gram(x, codes, w, y, **kw))
        print(json.dumps(row), flush=True)
        del x, codes, y, w, packed, idx, xs, cs_, ws, ident
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
