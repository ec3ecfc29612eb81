"""Drive the port's command line on one GPU and time each command.

    python3 tools/cli_times.py [--rows N] [--seed S]

Writes BASELINE config 5 (4 numeric columns, two categorical columns of 8;
x1 = 3·x0 + x2, c0 from x0) at N rows (default 2,000,000) with 1% nulls
in x1 and c0 as a CSV under build/cli/, then runs, each as its own
`python -m duckdb_imputation_tpu_torch.cli` process on the card:

- `impute --mode stream --engine device` and `--engine host`, `--mode
  delta`, `--mode fused` and `--mode low` (2 rounds, no noise);
- `train --model lda --label c1` and `predict` with the bundle;
- `bench --config all`.

Checks each exit code, the output's row count and the imputed x1's RMSE
(< 0.05, the config-5 gate), and prints one line a command with its wall
seconds (the process's whole life: its start, the kernels' and the
native library's load, the CSV parse, the work and the write), then the
bench's JSON, the card's name and power limit. The files are removed
at the end. Exits nonzero on any failure or without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "cli")
sys.path.insert(0, ROOT)


def write_csv(path: str, n: int, seed: int) -> tuple:
    """Config 5 as CSV through the port's formatter; (x1, its null mask)."""
    from duckdb_imputation_tpu_torch.table.native import format_csv_block

    rng = np.random.default_rng(seed)
    z0, z1 = rng.normal(size=n), rng.normal(size=n)
    x = np.stack([z0, 2 * z0 + z1, z1 - z0,
                  rng.normal(size=n)]).astype(np.float32)
    c = np.stack([np.clip(z0 + 4, 0, 7).astype(int), rng.integers(0, 8, n)])
    nx, nc = rng.random(n) < 0.01, rng.random(n) < 0.01
    cols = [x[0], np.where(nx, np.nan, x[1]), x[2], x[3],
            np.where(nc, np.nan, c[0].astype(float)), c[1].astype(float)]
    with open(path, "wb") as f:
        f.write(b"x0,x1,x2,x3,c0,c1\n")
        f.write(format_csv_block(cols, [0, 0, 0, 0, 1, 1]))
    return x[1], nx


def run(args: list[str]) -> tuple[float, str]:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "duckdb_imputation_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"cli {' '.join(args)} failed "
                         f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return wall, proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    from duckdb_imputation_tpu_torch.table.native import read_csv
    if not torch.cuda.is_available():
        print("cli_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "config5.csv")
    try:
        truth, null = write_csv(src, args.rows, args.seed)
        walls = {}
        common = ["--iters", "2", "--no-noise"]
        for name, extra in (("stream_device", ["--mode", "stream",
                                               "--engine", "device"]),
                            ("stream_host", ["--mode", "stream",
                                             "--engine", "host"]),
                            ("delta", ["--mode", "delta"]),
                            ("fused", ["--mode", "fused"]),
                            ("low", ["--mode", "low"])):
            out = os.path.join(OUT, f"{name}.csv")
            walls[name], _ = run(["impute", src, "--out", out, *extra,
                                  *common])
            got = read_csv(out, device="cpu").num_data.numpy()
            if got.shape[1] != args.rows:
                raise SystemExit(f"{name}: {got.shape[1]} rows")
            rmse = float(np.sqrt(np.mean((got[1, null] - truth[null]) ** 2)))
            if not rmse < 0.05:
                raise SystemExit(f"{name}: x1 RMSE {rmse}")
            print(f"[cli] impute {' '.join(extra)}: {walls[name]:.3f} s, "
                  f"x1 RMSE {rmse:.3g}", flush=True)
        bundle = os.path.join(OUT, "lda.npz")
        walls["train_lda"], _ = run(["train", src, "--model", "lda",
                                     "--label", "c1", "--out", bundle])
        walls["predict_lda"], _ = run(["predict", src, "--params", bundle,
                                       "--out", os.path.join(OUT, "p.csv")])
        print(f"[cli] train lda {walls['train_lda']:.3f} s, predict "
              f"{walls['predict_lda']:.3f} s", flush=True)
        walls["bench"], bench = run(["bench", "--config", "all"])
        print(f"[cli] bench {walls['bench']:.3f} s", flush=True)
        print(json.dumps({"rows": args.rows, "wall_s": walls,
                          "bench": json.loads(bench)}))
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
