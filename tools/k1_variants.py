"""Time design variants of the narrow masked Gram K1 on one GPU.

Each variant is a copy of `duckdb_imputation_tpu_torch/` with one change,
made under `build/k1_variants/<name>/` and timed in a process of its own
(each copy builds its own kernels):

- `as_built`: the kernels of the checkout (tensor cores, csrc/tc_gram.cuh);
- `k7`: K7, the wide kernel over each row's nonzeros (csrc/wide_gram.cuh),
  at P = 21: the wrapper's dispatch sends every P there;
- `flush_1`, `flush_2`, `flush_8`, `flush_32`, `flush_end`: the f32
  fragments flushed to f64 every 1, 2, 8, 32 steps or only after the
  last one, against every 4 as built (16 products of k16, 256 rows,
  summed in f32 into a value a flush: two sets of fragments, 4 k16 steps
  each a step);
- `stages_2`, `stages_6`: raw buffers for 1 or 5 steps ahead, against 4
  (3 ahead);
- `min_blocks_6`, `min_blocks_8`: `__launch_bounds__` asks for 6 or 8
  resident blocks an SM (fewer registers a thread);
- `grid_528`, `grid_1024`, `grid_2048`: so many blocks, against 660;
- `no_mma`: the products skipped (wrong sums): what staging alone costs,
  and so the most that keeping six part products of nine could save;
- `no_build`: the operand tiles never written (wrong sums): what the loads
  and products cost without the staging of the parts.

Times (CUDA events, mean of 10 calls after a warm-up): `masked_gram_cols`
at BASELINE config 5 (P = 21), 10M rows, binary and general weights, the
table of `chip_smoke.py`; the max error of each, relative to max|σ|,
against the plain version (f64 sums) at 10M rows and, with `--deploy`, at
100M rows (binary weights).

    python3 tools/k1_variants.py [--variants a,b] [--deploy]

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, then one JSON line per variant.
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
CUH = "csrc/tc_gram.cuh"
PY = "ring/kernels/sigma_pallas.py"
BUILD = "ring/kernels/_build.py"

K7 = ("    if p > _build.MAX_SIGMA_SIZE:\n"
      "        out, launched = _launch_wide(",
      "    if True:\n        out, launched = _launch_wide(")
NO_MMA = ("        mma_bf16(acc[(k0 >> 4) & 1][ni], af, bf[ni][0], bf[ni][1]);",
          "        if (s < 0) mma_bf16(acc[(k0 >> 4) & 1][ni], af, bf[ni][0],"
          " bf[ni][1]);")
NO_BUILD = ("    build_row(raw + (s % kTcStages)",
            "    if (s < 0) build_row(raw + (s % kTcStages)")


def flush(steps: str):
    return ("constexpr int kTcFlushSteps = 4;",
            f"constexpr int kTcFlushSteps = {steps};")


def stages(k: int):
    return ("constexpr int kTcStages = 4;", f"constexpr int kTcStages = {k};")


def min_blocks(k: int):
    return ("__global__ void __launch_bounds__(kTcThreads)\ntc_gram_kernel",
            f"__global__ void __launch_bounds__(kTcThreads, {k})\n"
            f"tc_gram_kernel")


def grid(blocks: int):
    return ("    return max(1, min(-(-n // TC_ROWS), TC_MAX_BLOCKS))",
            f"    return max(1, min(-(-n // TC_ROWS), {blocks}))")


TIMER = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols, masked_gram_cols_plain)
torch.backends.cuda.matmul.allow_tf32 = False
log = _build.load().log.splitlines()
at = next(i for i, line in enumerate(log) if "tc_gram_kernel" in line)
out = {"variant": sys.argv[1], "ptxas": " ".join(log[at + 1:at + 4])}
sizes = (cs.N, cs.N_DEPLOY) if sys.argv[2] == "1" else (cs.N,)
for n in sizes:
    t, _ = cs.make_table(n, 0)
    xs, c = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    w_gen = torch.rand(n, generator=gen, device="cuda")
    for name, w in (("binary", (w_gen >= 0.2).float()), ("general", w_gen)):
        if n > cs.N and name == "general":
            continue
        got = masked_gram_cols(xs, c, w, schema=t.schema)
        want = masked_gram_cols_plain(xs, c, w, schema=t.schema)
        out[f"err_{name}_{n}"] = cs.rel_err(got, want)
        if n == cs.N:
            out[f"ms_{name}"] = cs.cuda_ms(
                lambda: masked_gram_cols(xs, c, w, schema=t.schema))
    del t, xs, c
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def patched(text: str, *pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"the source no longer holds the text a variant "
                             f"replaces: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants() -> dict[str, dict[str, str]]:
    """name → {file under the package: its text}."""
    cuh = (ROOT / PKG / CUH).read_text()
    py = (ROOT / PKG / PY).read_text()
    build = (ROOT / PKG / BUILD).read_text()
    return {
        "as_built": {},
        "k7": {PY: patched(py, K7)},
        "flush_1": {CUH: patched(cuh, flush("1"))},
        "flush_2": {CUH: patched(cuh, flush("2"))},
        "flush_8": {CUH: patched(cuh, flush("8"))},
        "flush_32": {CUH: patched(cuh, flush("32"))},
        "flush_end": {CUH: patched(cuh, flush("1 << 30"))},
        "stages_2": {CUH: patched(cuh, stages(2))},
        "stages_6": {CUH: patched(cuh, stages(6))},
        "min_blocks_6": {CUH: patched(cuh, min_blocks(6))},
        "min_blocks_8": {CUH: patched(cuh, min_blocks(8))},
        "grid_528": {BUILD: patched(build, grid(528))},
        "grid_1024": {BUILD: patched(build, grid(1024))},
        "grid_2048": {BUILD: patched(build, grid(2048))},
        "no_mma": {CUH: patched(cuh, NO_MMA)},
        "no_build": {CUH: patched(cuh, NO_BUILD)},
    }


def run(names, texts_of, timer, args) -> int:
    """Copies the package per variant, runs `timer` in each; shared with
    tools/nb_variants.py."""
    dirs = {}
    for name in names:
        d = ROOT / "build" / Path(sys.argv[0]).stem / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(ROOT / PKG, d / PKG,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", d)
        for rel, text in texts_of[name].items():
            (d / PKG / rel).write_text(text)
        dirs[name] = d
    failed = False
    for name, d in dirs.items():
        proc = subprocess.run([sys.executable, "-c", timer, name, *args],
                              cwd=d, capture_output=True, text=True)
        if proc.returncode != 0:
            failed = True
            print(json.dumps({"variant": name,
                              "error": proc.stderr[-2000:]}), flush=True)
        else:
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else "nvidia-smi failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="")
    ap.add_argument("--deploy", action="store_true",
                    help="also the error at 100M rows")
    args = ap.parse_args()
    texts = variants()
    names = args.variants.split(",") if args.variants else list(texts)
    print(card(), flush=True)
    return run(names, texts, TIMER, ["1" if args.deploy else "0"])


if __name__ == "__main__":
    sys.exit(main())
