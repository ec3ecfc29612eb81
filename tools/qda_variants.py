"""Time design variants and block shapes of the pair-form QDA scorer (K3,
K3w) on one GPU.

Cases: the tables of `chip_smoke.py`, QDA trained on favorita_classify,
labels family (C = 33, 12 tasks) and onpromotion (C = 2, 16 tasks), and on
BASELINE config 4 (C = 8, one task), 10M rows. Times are CUDA events,
mean of 5 calls after a warm-up.

- Block shapes (`--schedules`): the f32 cells of a task
  (`_build.QDA_TASK_CELLS`, which cuts the scorer's plan), threads a
  block, rows a thread and classes a step, so a tile of threads·rows rows
  that a block stages once and scores against every (class group, task)
  table it streams through shared memory. Each shape that fits a block's
  shared memory replaces `_build.qda_tile` in this process and must give
  the plain version's argmax on the first 1M rows.
- Code variants (the default): each a copy of `duckdb_imputation_tpu_torch/`
  with one change to the kernel, made under `build/qda_variants/<name>/`
  and timed in a process of its own (each copy builds its own kernels).
  `as_built`; `x_f32`: x staged in f32 and converted at each use;
  `stage4`: the tables copied in 4-byte words (as first built);
  `stage16_l1`: 16-byte words through L1 (`cp.async.ca`). The
  variants named `skip_*` leave out one kind of slab (D, K_j or C_jk),
  `no_stage` the copies of the tables into shared memory, and `no_f2f`
  the f32 → f64 conversion of the K and C cells (their bits moved into
  a double instead), `skip_all` every slab, `bare` every slab and the
  copies: they compute no scorer, and time what the rest costs (no
  check).

    python3 tools/qda_variants.py [--schedules] [--rounds 1]
        [--variants as_built,x_f32]

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, then one JSON line per variant (or case)
and round.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "duckdb_imputation_tpu_torch"
CU = "csrc/qda_predict.cu"
TASK_CELLS = (8192, 4096, 2048)
SCHEDULES = [(1024, 8, 1), (1024, 4, 2), (1024, 2, 4), (512, 8, 1),
             (512, 4, 2), (512, 2, 4), (256, 8, 1), (256, 4, 2), (256, 2, 4)]

X_F32 = (
    ("         size_t(tile) * (sizeof(double) * d + sizeof(int16_t) * c);",
     "         size_t(tile) * (sizeof(float) * d + sizeof(int16_t) * c);"),
    ("  extern __shared__ __align__(16) double qda_smem[];",
     "  extern __shared__ __align__(16) float qda_smem[];"),
    ("  double* xs = qda_smem;", "  float* xs = qda_smem;"),
    ("        xs[j * tile + e] = valid ? static_cast<double>(cols.x[j][row]) : 0.0;",
     "        xs[j * tile + e] = valid ? cols.x[j][row] : 0.0f;"),
    ("          const double* xa = xs", "          const float* xa = xs"),
    ("            const double* xb = xs", "            const float* xb = xs"),
    ("            const double* xr = xs", "            const float* xr = xs"),
)
SKIP = "        if (kind == kSlabD) {          // cells (p0, b), b in [p1, p2)"
STAGE4 = (("for (int e = 4 * tid; e < nc; e += 4 * nt) stage16(dst + e, src + e);",
           "for (int e = tid; e < nc; e += nt) stage4(dst + e, src + e, true, 0.0f);"),)
STAGE16_L1 = (("cp.async.cg.shared.global [%0], [%1], 16;",
               "cp.async.ca.shared.global [%0], [%1], 16;"),)
NO_STAGE = (("stage16(dst + e, src + e);", ";"),)
NO_F2F = (
    ("static_cast<double>(tb[i * stride + base[k]])",
     "__hiloint2double(__float_as_int(tb[i * stride + base[k]]), 0)"),
    ("__dmul_rn(tb[i * stride + base[k] + a * step[k]], x)",
     "__dmul_rn(__hiloint2double(__float_as_int("
     "tb[i * stride + base[k] + a * step[k]]), 0), x)"),
    ("static_cast<double>(tb[i * stride + cell])",
     "__hiloint2double(__float_as_int(tb[i * stride + cell]), 0)"),
)

CASES = r'''
import chip_smoke as cs
from duckdb_imputation_tpu_torch.models.device import qda_train_device
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import qda_tables
from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple_grouped
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple


def cases(seed):
    """(name, x, codes, schema, QDA's (quad, lin, intercept)) of each
    case."""
    for label in ("family", "onpromotion"):
        x, codes, y, schema, classes = cs.make_favorita_classify(
            cs.N, seed + 24, label)
        sig = sigma_from_triple(sum_to_triple_grouped(
            x, codes, y, schema=schema, num_groups=classes))
        yield label, x, codes, schema, qda_train_device(sig, float(cs.N))
    x, codes, y, schema = cs.make_classify_table(cs.N, seed)
    sig = sigma_from_triple(sum_to_triple_grouped(
        x, codes, y, schema=schema, num_groups=cs.CLASSES))
    yield "config4", x, codes, schema, qda_train_device(sig, float(cs.N))
'''

TIMER = r'''
import json, sys, torch
sys.path.insert(0, ".")
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
    qda_predict_kernel, qda_predict_plain)
''' + CASES + r'''
torch.backends.cuda.matmul.allow_tf32 = False
name, check = sys.argv[1], sys.argv[2] == "check"
ms = {}
for case, x, codes, schema, params in cases(0):
    tables, plan = qda_tables(*params, schema=schema)
    got = qda_predict_kernel(tables, plan, x, codes, schema=schema)
    if check:
        m = 1_000_000
        xs, cs_ = x[:, :m].contiguous(), codes[:, :m].contiguous()
        want = qda_predict_plain(tables, plan, xs, cs_, schema=schema)
        cs.check(torch.equal(got[:m], want), f"{name} {case}: argmax differs")
    ms[case] = cs.cuda_ms(lambda: qda_predict_kernel(
        tables, plan, x, codes, schema=schema), reps=5, warmup=1)
print(json.dumps({"variant": name, "checked": check, "ms": ms}))
'''


def patched(text: str, *pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"the source no longer holds the text a variant "
                             f"replaces: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants() -> dict[str, tuple[str, bool]]:
    """name → (kernel source, whether it computes the scorer)."""
    cu = (ROOT / PKG / CU).read_text()
    skip = {kind: patched(cu, (SKIP, f"        if (kind == {kind}) continue;\n"
                                     + SKIP))
            for kind in ("kSlabD", "kSlabK", "kSlabC")}
    return {"as_built": (cu, True), "x_f32": (patched(cu, *X_F32), True),
            "stage4": (patched(cu, *STAGE4), True),
            "stage16_l1": (patched(cu, *STAGE16_L1), True),
            "skip_dense": (skip["kSlabD"], False),
            "skip_keyed": (skip["kSlabK"], False),
            "skip_cross": (skip["kSlabC"], False),
            "no_stage": (patched(cu, *NO_STAGE), False),
            "skip_all": (patched(cu, (SKIP, "        continue;\n" + SKIP)),
                         False),
            "bare": (patched(cu, (SKIP, "        continue;\n" + SKIP),
                             *NO_STAGE), False),
            "no_f2f": (patched(cu, *NO_F2F), False)}


def schedules(rounds: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain, qda_tables)

    scope = {}
    exec(CASES, scope)
    as_built, cells_as_built = _build.qda_tile, _build.QDA_TASK_CELLS
    m = 1_000_000
    for name, x, codes, schema, params in scope["cases"](0):
        for rnd in range(rounds):
            for cap in TASK_CELLS:
                _build.QDA_TASK_CELLS = cap
                try:
                    tables, plan = qda_tables(*params, schema=schema)
                finally:
                    _build.QDA_TASK_CELLS = cells_as_built
                base = as_built(schema, plan, tables.shape[0])
                want = qda_predict_plain(tables, plan, x[:, :m].contiguous(),
                                         codes[:, :m].contiguous(),
                                         schema=schema)
                ms = {}
                for shape in SCHEDULES:
                    if _build.qda_smem_bytes(plan.max_task_cells, schema,
                                             shape[0] * shape[1], shape[2]
                                             ) > _build.WIDE_SMEM:
                        continue
                    _build.qda_tile = lambda *_, shape=shape: shape
                    try:
                        got = qda_predict_kernel(tables, plan, x, codes,
                                                 schema=schema)
                        cs.check(torch.equal(got[:m], want),
                                 f"{name} {cap} {shape}: argmax differs")
                        ms["x".join(map(str, shape))] = cs.cuda_ms(
                            lambda: qda_predict_kernel(tables, plan, x, codes,
                                                       schema=schema),
                            reps=5, warmup=1)
                    finally:
                        _build.qda_tile = as_built
                print(json.dumps({"case": name, "round": rnd,
                                  "task_cells": cap,
                                  "tasks": plan.num_tasks,
                                  "classes": tables.shape[0],
                                  "cells": tables.shape[1],
                                  "as_built": "x".join(map(str, base)),
                                  "ms": ms}), flush=True)
        del x, codes
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--schedules", action="store_true",
                    help="time block shapes instead of code variants")
    ap.add_argument("--variants", default="",
                    help="comma-separated names to run (default: all)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        print("qda_variants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.schedules:
        schedules(args.rounds)
        return 0
    dirs = {}
    pick = set(filter(None, args.variants.split(",")))
    for name, (cu, scorer) in variants().items():
        if pick and name not in pick:
            continue
        d = ROOT / "build" / "qda_variants" / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(ROOT / PKG, d / PKG,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", d)
        (d / PKG / CU).write_text(cu)
        dirs[name] = (d, scorer)
    failed = False
    for _ in range(args.rounds):
        for name, (d, scorer) in dirs.items():
            run = subprocess.run(
                [sys.executable, "-c", TIMER, name,
                 "check" if scorer else "time"], cwd=d, capture_output=True,
                text=True)
            if run.returncode != 0:
                failed = True
                print(json.dumps({"variant": name,
                                  "error": run.stderr[-2000:]}), flush=True)
            else:
                print(run.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
