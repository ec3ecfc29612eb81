"""Time design variants of the wide masked Gram (K7, K8) on one GPU.

Each variant is a copy of `duckdb_imputation_tpu_torch/` with one change
to the kernel or its plan, made under `build/wide_gram_variants/<name>/`
and timed in a process of its own (each copy builds its own kernels):

- `as_built`: the kernels of the checkout;
- `one_chunk`: a warp takes one chunk of 32 rows at a time, not two;
- `serial_sum`: the lowest lane of a cell sums the cell's rows one after
  another, in place of the sums by pointer jumping;
- `first_fit`: the plan packs slabs into tasks first fit, largest first,
  in place of to the task with room that holds the fewest slabs.

Times (CUDA events, mean of 5 calls after a warm-up): K7
(`masked_gram_cols`) at favorita_wide (P = 492) and K8
(`grouped_gram_presorted`) at favorita_classify, label family (33 groups,
P = 459), 10M rows, binary weights, the tables of `chip_smoke.py`.

    python3 tools/wide_gram_variants.py [--rounds 1]

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, then one JSON line per variant and round.
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
CUH = "csrc/wide_gram.cuh"
BUILD = "ring/kernels/_build.py"

SERIAL_SUM = (
    "  float s0 = l0.suffix_sum(w0), s1 = l1.suffix_sum(w1);\n",
    "  float s0 = 0.0f, s1 = 0.0f;\n"
    "  if (lead0) for (unsigned m = p0; m; m &= m - 1) s0 += rows0[__ffs(m) - 1];\n"
    "  if (lead1) for (unsigned m = p1; m; m &= m - 1) s1 += rows1[__ffs(m) - 1];\n")
SERIAL_SUM_K = (
    "    s0 = l0.suffix_sum(rows0[a * R + lane] * w0);\n"
    "    s1 = l1.suffix_sum(rows1[a * R + lane] * w1);\n",
    "    s0 = 0.0f;\n    s1 = 0.0f;\n"
    "    if (lead0) for (unsigned m = p0; m; m &= m - 1) {\n"
    "      const int r = __ffs(m) - 1; s0 += rows0[a * R + r] * rows0[r]; }\n"
    "    if (lead1) for (unsigned m = p1; m; m &= m - 1) {\n"
    "      const int r = __ffs(m) - 1; s1 += rows1[a * R + r] * rows1[r]; }\n")
ONE_CHUNK = (
    "      const bool pair = k + 1 < nsub && (!Grouped || gsub[k + 1] == cur);",
    "      const bool pair = false;")
FIRST_FIT_START = "    # tasks: as few as the budget allows"
FIRST_FIT_END = "    slabs, warp_begin, task_base, entries = [], [0], [0], []"
FIRST_FIT = """    # tasks: first fit, largest slab first
    cap = WIDE_TASK_BYTES // 8
    tasks: list[list[int]] = []
    used: list[int] = []
    for i in sorted(range(len(pieces)), key=lambda i: -pieces[i][2]):
        t = next((t for t, u in enumerate(used) if u + pieces[i][2] <= cap
                  and len(tasks[t]) < WIDE_MAX_SLABS), None)
        if t is None:
            tasks.append([])
            used.append(0)
            t = len(tasks) - 1
        tasks[t].append(i)
        used[t] += pieces[i][2]
"""

TIMER = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    grouped_gram_presorted, sort_by_group)
torch.backends.cuda.matmul.allow_tf32 = False
_build.load()
t, _ = cs.make_favorita(cs.N, 11)
xs, c = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
gen = torch.Generator(device="cuda")
gen.manual_seed(12)
w = (torch.rand(cs.N, generator=gen, device="cuda") >= 0.2).float()
k7 = cs.cuda_ms(lambda: masked_gram_cols(xs, c, w, schema=t.schema), reps=5,
                warmup=1)
x8, c8, y, schema, classes = cs.make_favorita_classify(cs.N, 20, "family")
args = sort_by_group(x8, c8, y, schema=schema, num_groups=classes, weights=w)
k8 = cs.cuda_ms(lambda: grouped_gram_presorted(*args, schema=schema),
                reps=5, warmup=1)
print(json.dumps({"variant": sys.argv[1], "k7_ms": k7, "k8_family_ms": k8,
                  "k7_tasks": _build.wide_plan(t.schema).num_tasks,
                  "k8_tasks": _build.wide_plan(schema).num_tasks}))
'''


def patched(text: str, *pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"the source no longer holds the text a variant "
                             f"replaces: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants() -> dict[str, tuple[str, str]]:
    cuh = (ROOT / PKG / CUH).read_text()
    build = (ROOT / PKG / BUILD).read_text()
    start, end = build.index(FIRST_FIT_START), build.index(FIRST_FIT_END)
    return {
        "as_built": (cuh, build),
        "one_chunk": (patched(cuh, ONE_CHUNK), build),
        "serial_sum": (patched(cuh, SERIAL_SUM, SERIAL_SUM_K), build),
        "first_fit": (cuh, build[:start] + FIRST_FIT + build[end:]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    dirs = {}
    for name, (cuh, build) in variants().items():
        d = ROOT / "build" / "wide_gram_variants" / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(ROOT / PKG, d / PKG,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", d)
        (d / PKG / CUH).write_text(cuh)
        (d / PKG / BUILD).write_text(build)
        dirs[name] = d
    failed = False
    for _ in range(args.rounds):
        for name, d in dirs.items():
            run = subprocess.run([sys.executable, "-c", TIMER, name], cwd=d,
                                 capture_output=True, text=True)
            if run.returncode != 0:
                failed = True
                print(json.dumps({"variant": name,
                                  "error": run.stderr[-2000:]}), flush=True)
            else:
                print(run.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
