"""D on the tensor cores (csrc/dense_gram.cu) against D on the slabs, on one
GPU: the checks of the D kernel, the crossover in d that sets
`_build.DENSE_MIN_D`, and the D kernel alone at the schemas of many
numeric columns beside its bounds and one cuBLAS product.

    python3 tools/dense_crossover.py [--check] [--times] [--alone]
                                     [--oracle] [--dram] [--rows N]
                                     [--seed S]

- `--check`: the D kernel (`sigma_pallas.dense_gram`) against its plain
  version (`dense_gram_plain`) at d = 300 and 2,000 over columns of a
  block whose rows do not start on 16-byte boundaries: all of S, a window
  across tiles (bit-identical to the same columns of S), three groups over
  group-sorted rows; a rerun bit-identical, S exactly symmetric, D[0, 0]
  = Σw exactly, within 1e-5 of max|σ|.
- `--oracle`: the D kernel at Home Credit's 104 numeric columns
  (chip_smoke.py's table) at `--rows` rows (default 10M) against the f64
  oracle of tests/reference_oracle.py (`_exact_triple_dict`: N, lin_agg
  and quad_agg, exact f64 sums over the rows of w ≠ 0, here one f64
  product on the card), binary weights: the largest error relative to
  max|D|, and D[0, 0] = Σw exactly.
- `--times`: K7 (`masked_gram_cols`) at `--rows` rows (default 10M) of
  schemas of d = 3 (favorita_wide), 16, 32, 64, 104 (Home Credit) and 128
  numeric columns, with D on the slabs (`DENSE_MIN_D` past d) and on the
  tensor cores (`DENSE_MIN_D` = 0), in turns (slabs, tiles, tiles, slabs),
  and the parts of the tile route: K7 over its plan without D slabs, and
  the D kernel alone.
- `--alone`: the D kernel alone at Epsilon (d = 2,000, 400k rows), SECOM
  (590, 1M), d900_r33's 900 columns (1M) and Home Credit (104, 10M):
  ms, the f32 bound of chip_smoke.py (the upper triangle's multiply-adds
  at 67 TFLOP/s, or the bytes at 3.35 TB/s), the tensor-core bound of
  nine bf16 products of it (989 TFLOP/s), one cuBLAS f32 product (Zᵀ·w)
  @ Z of [1 ‖ x] (TF32 off), and the kernels' device ms by
  torch.profiler; with `--dram` the profiler is also asked for the D
  kernel's DRAM bytes read (CUPTI's dram__bytes_read.sum), which it may
  not give.

Timings by CUDA events (the mean of 3 calls after one). Prints the card
and its power limit first, one line a measurement, and last one JSON
object of all of them. Default: all three.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

FAVORITA_VOCABS = (54, 33, 337, 2, 2, 22, 16, 5, 17)
HC_VOCABS = (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2)
CROSSOVER = {"favorita_wide": (3, FAVORITA_VOCABS), "d16": (16, (54, 33)),
             "d32": (32, (54, 33)), "d64": (64, (54, 33)),
             "home_credit": (104, HC_VOCABS), "d128": (128, (54, 33))}
ALONE = {"epsilon": (2000, 400_000), "secom": (590, 1_000_000),
         "d900_r33": (900, 1_000_000), "home_credit": (104, 10_000_000)}
PEAK_BF16 = 989e12


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--alone", action="store_true")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--dram", action="store_true")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (args.check or args.times or args.alone or args.oracle
            or args.dram):
        args.check = args.times = args.alone = True
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("dense_crossover: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels import _build, sigma_pallas
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, dense_gram_plain, masked_gram_cols)

    torch.backends.cuda.matmul.fp32_precision = "ieee"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    lib = _build.load()
    lines = lib.log.splitlines()
    for i, line in enumerate(lines):     # the D kernel's ptxas report
        if "Compiling entry function" in line and "dense_gram" in line:
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt:
                    print(f"[build] {line.split()[-3]} {nxt.strip()}",
                          flush=True)
    dev, out = torch.device("cuda"), {}
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    def record(name, **vals):
        out[name] = vals
        print(f"{name}: {vals}", flush=True)

    if args.check:
        for d, n in ((300, 20_003), (2000, 6_001)):
            schema = FeatureSchema(num_cols=d)
            # rows of a [d, n + 1] block from column 1: no column's first
            # row lies on a 16-byte boundary where n is odd
            block = torch.randn(d, n + 1, generator=g, device=dev)
            xs = list(block[:, 1:])
            w = (torch.rand(n, generator=g, device=dev) >= 0.3).float()
            before = dense_gram.launches
            got, again = (dense_gram(xs, w, schema=schema) for _ in range(2))
            torch.cuda.synchronize()
            cs.check(dense_gram.launches == before + 2, "launches")
            cs.check(torch.equal(got, again), f"d={d}: rerun differs")
            cs.check(torch.equal(got, got.T), f"d={d}: not symmetric")
            want = dense_gram_plain(xs, w, schema=schema)
            cs.check(float(got[0, 0]) == float(want[0, 0])
                     == float(w.double().sum()), f"d={d}: count")
            err = float((got - want).abs().max() / want.abs().max())
            cs.check(err <= 1e-5, f"d={d}: rel err {err}")
            lo, width = 100, d - 150
            win = dense_gram(xs, w, schema=schema, lo=lo, width=width)
            cs.check(torch.equal(win, got[:, lo:lo + width]),
                     f"d={d}: window differs from S's columns")
            off = torch.tensor([0, n // 3, n // 3 + 17, n], device=dev)
            gg = dense_gram(xs, w, schema=schema, offsets=off)
            gw = dense_gram_plain(xs, w, schema=schema, offsets=off)
            gerr = 0.0
            for k in range(3):
                cs.check(torch.equal(gg[k], gg[k].T), f"group {k} symmetric")
                cs.check(float(gg[k, 0, 0]) == float(gw[k, 0, 0]),
                         f"group {k} count")
                gerr = max(gerr, float((gg[k] - gw[k]).abs().max()
                                       / gw[k].abs().max()))
            cs.check(gerr <= 1e-5, f"d={d}: groups rel err {gerr}")
            record(f"check d={d} n={n}", rel_err=err, groups_rel_err=gerr)
            del block, xs, got, again, want, win, gg, gw
            torch.cuda.empty_cache()

    if args.oracle:
        n = args.rows
        t, x, _, _ = cs.make_home_credit(n, args.seed + 1)
        del t
        d = x.shape[0]
        schema = FeatureSchema(num_cols=d)
        w = (torch.rand(n, generator=g, device=dev) >= 0.2).float()
        got = dense_gram(list(x), w, schema=schema).double()
        z = torch.cat([torch.ones((1, n), device=dev), x]).double()
        z = z[:, w != 0]
        oracle = z @ z.T
        del z
        err = float((got - oracle).abs().max() / oracle.abs().max())
        cs.check(float(got[0, 0]) == float(oracle[0, 0]), "the count")
        cs.check(err <= 1e-5, f"oracle rel err {err}")
        record(f"oracle home_credit d={d} n={n}", rel_err=err,
               max_abs_oracle=float(oracle.abs().max()))
        del x, w, got, oracle
        torch.cuda.empty_cache()

    def set_min_d(min_d):
        # the plans are kept by (d, sizes), not by the route: drop them
        _build.DENSE_MIN_D = min_d
        _build.plan_cache.clear()
        sigma_pallas._device_plan.cache_clear()

    def k7_ms(xs, cs_, w, schema, min_d):
        set_min_d(min_d)
        return cs.cuda_ms(lambda: masked_gram_cols(xs, cs_, w,
                                                   schema=schema),
                          reps=3, warmup=1)

    if args.times:
        n, keep = args.rows, _build.DENSE_MIN_D
        for name, (d, vocabs) in CROSSOVER.items():
            schema = FeatureSchema(num_cols=d, cat_keys=tuple(
                tuple(range(v)) for v in vocabs))
            x = torch.randn(d, n, generator=g, device=dev)
            codes = torch.stack([torch.randint(0, v, (n,), generator=g,
                                               device=dev, dtype=torch.int32)
                                 for v in vocabs])
            w = (torch.rand(n, generator=g, device=dev) >= 0.2).float()
            xs, cl = list(x), list(codes)
            off, on = 1 << 30, 0
            times = [k7_ms(xs, cl, w, schema, m) for m in (off, on, on, off)]
            set_min_d(on)
            dense = cs.cuda_ms(lambda: dense_gram(xs, w, schema=schema),
                               reps=3, warmup=1)
            # K7 over its plan without D slabs: the route's K7 less D
            slabs_only = times[1] - dense
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                masked_gram_cols(xs, cl, w, schema=schema)
                torch.cuda.synchronize()
            by_kernel = {e.key: e.device_time_total / 1e3
                         for e in prof.key_averages()
                         if e.device_time_total > 0}
            record(f"crossover {name} d={d} P={schema.sigma_size} n={n}",
                   slabs_ms=[times[0], times[3]],
                   tiles_ms=[times[1], times[2]], dense_alone_ms=dense,
                   k7_without_d_ms_by_difference=slabs_only,
                   profiler_ms=by_kernel)
            del x, codes, w, xs, cl
            torch.cuda.empty_cache()
        set_min_d(keep)

    if args.alone or args.dram:
        for name, (d, n) in ALONE.items():
            schema = FeatureSchema(num_cols=d)
            x = torch.randn(d, n, generator=g, device=dev)
            w = (torch.rand(n, generator=g, device=dev) >= 0.2).float()
            xs = list(x)
            ms = cs.cuda_ms(lambda: dense_gram(xs, w, schema=schema),
                            reps=3, warmup=1)
            m = 1 + d
            fma = int(w.count_nonzero()) * m * (m + 1) // 2
            f32 = cs.bound(n * 4 * (d + 1) + m * m * 4, 2 * fma)
            tc = 9 * 2 * fma / PEAK_BF16 * 1e3
            zt = torch.cat([torch.ones(1, n, device=dev), x])
            zw = zt * w
            lib_ms = cs.cuda_ms(lambda: torch.mm(zw, zt.T), reps=3, warmup=1)
            del zt, zw
            kw = {}
            if args.dram:
                from torch._C._profiler import _ExperimentalConfig
                kw["experimental_config"] = _ExperimentalConfig(
                    profiler_metrics=["dram__bytes_read.sum"],
                    profiler_measure_per_kernel=True)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA], **kw) as prof:
                dense_gram(xs, w, schema=schema)
                torch.cuda.synchronize()
            prof_ms = {e.key: e.device_time_total / 1e3
                       for e in prof.key_averages()
                       if e.device_time_total > 0}
            dram = ([{k: getattr(e, k) for k in dir(e) if "metric" in k}
                     for e in prof.events()
                     if "dense_gram_kernel" in e.name][:1]
                    if args.dram else None)
            record(f"alone {name} d={d} n={n}", ms=ms,
                   f32_bound_ms=f32["bound_ms"], f32_bound_by=f32["bound_by"],
                   tensor_core_bound_ms=tc, library_ms=lib_ms,
                   slices=_build.dense_slices(n, d),
                   tiles=int(_build.dense_tiles(d, 0, m).shape[0]),
                   profiler_ms=prof_ms, dram=str(dram))
            del x, w, xs
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
