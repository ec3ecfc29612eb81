"""Time the kernels whose shared code the column passing of every kernel
changed, at schemas of at most 64 + 64 columns, in checkouts on one GPU:
K1 at BASELINE config 5 (`masked_gram_cols`, P = 21, on the tensor
cores), K7 at favorita_wide (P = 492, one launch) and a pass of K7's
windows over favorita_items (P = 4,592: its order pass and five windows),
10M rows each, binary weights (20% zeros); K3 at config 4 (8 classes)
and K3w at favorita_classify's family (33 classes) on seeded QDA tables,
and K6 at config 3 (8 numeric, 4 categorical columns of 8, 5 groups).

    python3 tools/cols_times.py [--roots DIR [DIR ...]] [--reps N]
    python3 tools/cols_times.py --root DIR [--reps N]

With `--roots` (default: this checkout twice) it times each root in turn,
one process each, in the order given (e.g. `build/parent . . build/parent`
for a parent unpacked with `git archive`: two turns each, so run-to-run
noise shows beside the difference), and prints one JSON line per root and
a last line with every run. A root is the root of a checkout whose
`duckdb_imputation_tpu_torch` is timed; its kernels build under its own
`build/`. The tables are those of this checkout's `chip_smoke.py`. Times
are CUDA events, ms per call, mean of `--reps` (default 20) after two
warm-up calls. Prints the card and its power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROWS = 10_000_000


def time_root(root: str, reps: int) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    card = cs.phase_device()
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(5)
    w = (torch.rand(ROWS, generator=gen, device=cs.DEVICE) >= 0.2).float()
    out = {"card": card}
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel)

    t = cs.make_table(ROWS, 4)[0]
    for name, (x, codes, schema, classes) in (
            ("k3_config4", (t.num_data, t.cat_codes, t.schema, 8)),
            ("k3w_family", cs.make_favorita_classify(ROWS, 6, "family")[:2]
             + cs.make_favorita_classify(ROWS, 6, "family")[3:])):
        tables, plan, _ = cs.seeded_scorer("qda", schema, classes, 7)
        out[name] = cs.cuda_ms(lambda: qda_predict_kernel(
            tables, plan, x, codes, schema=schema), reps=reps, warmup=2)
    del t, x, codes
    c3 = FeatureSchema(num_cols=8, cat_keys=(tuple(range(8)),) * 4)
    x = torch.randn(8, ROWS, generator=gen, device=cs.DEVICE)
    codes = torch.randint(0, 8, (4, ROWS), generator=gen, device=cs.DEVICE,
                          dtype=torch.int32)
    ids = torch.randint(0, 5, (ROWS,), generator=gen, device=cs.DEVICE,
                        dtype=torch.int32)
    out["k6_config3"] = cs.cuda_ms(lambda: nb_grouped_sums(
        x, codes, w, ids, schema=c3, num_groups=5), reps=reps, warmup=2)
    del x, codes, ids
    torch.cuda.empty_cache()
    for name, make in (("k1_config5", lambda: cs.make_table(ROWS, 1)[0]),
                       ("k7_favorita_wide",
                        lambda: cs.make_favorita(ROWS, 2)[0]),
                       ("k7_items_pass",
                        lambda: cs.make_favorita_items(ROWS, 3)[0])):
        t = make()
        xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
        out[name] = cs.cuda_ms(lambda: masked_gram_cols(
            xs, cs_, w, schema=t.schema), reps=reps, warmup=2)
        del t, xs, cs_
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.root:
        import torch

        if not torch.cuda.is_available():
            print("cols_times: no CUDA device", file=sys.stderr)
            return 1
        res = time_root(args.root, args.reps)
        print(json.dumps({"root": args.root, **res}), flush=True)
        return 0
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--root", root, "--reps",
             str(args.reps)], capture_output=True, text=True,
            timeout=args.timeout)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
