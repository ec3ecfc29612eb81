"""Time K7 and K8 over column windows past P = 1,024 of checkouts on one
GPU, for a comparison of two commits in one call (parent, change, change,
parent).

    python3 tools/window_times.py [--roots DIR [DIR ...]] [--timeout S]
    python3 tools/window_times.py --root DIR [--tag NAME]

With `--roots` (default: this checkout twice) it times each root in turn,
one process each, in the order given (e.g. `build/parent . . build/parent`
for a parent unpacked with `git archive`), and prints one JSON line per
root and a last line with every run; with `--root` it times that one
checkout. A root is the root of a checkout whose
`duckdb_imputation_tpu_torch` is timed; its kernels build under its own
`build/`. The tables are those of this checkout's `chip_smoke.py`, 10M
rows, binary weights (20% zeros):

- favorita_items (P = 4,592): a pass over S (`masked_gram_cols`, one
  launch a window of 1,024), each of its five windows alone
  (`masked_gram_window`), K2w's 'cat' step imputing family (R = 33;
  `fused_impute_aggregate`: its impute kernel, then the windows);
- wide16k (P = 16,387): its first window, the one across the two one-hot
  blocks and its last, alone, and beside each the plain version
  (`masked_gram_window_plain`, whose pair-key bincount is the yardstick);
- K8 past 1,024 (`grouped_gram_presorted` after `sort_by_group`) at
  favorita_items' labels onpromotion (G = 2) and family (G = 33);
- favorita_wide (P = 492): its four stripes of 123 columns, as
  `parallel/overlap.py` cuts S on one card, and its windows of 128
  columns, each set of `masked_gram_window` calls timed as one; no column
  is keyed at P ≤ 1,024, so these keep the unkeyed plan.

Where the checkout has the keyed windows (`window_order`), it also times
the order pass alone: of favorita_items' pass (its keyed columns) and of
each wide16k window, and of K8's two calls.

Times are CUDA events, ms per call, mean of 3 after a warm-up (1 for the
wide16k pass and the plain versions). Prints the card and its power limit
first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def time_root(root: str, tag: str) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables and timer
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels import sigma_pallas as sp
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram_presorted, sort_by_group)

    keyed = hasattr(sp, "window_order")
    print(cs.phase_device(), flush=True)
    out = {"tag": tag, "root": str(Path(root).resolve().name)}
    n, dev, width = cs.N, cs.DEVICE, _build.WINDOW_WIDTH

    def weights(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return (torch.rand(n, generator=gen, device=dev) >= 0.2).float()

    def order_ms(xs, cs_, w, lows, wd, offsets=None):
        cols = sp.window_columns(schema, lows, wd)
        if not cols:
            return 0.0
        return cs.cuda_ms(lambda: sp.window_order(
            xs, cs_, w, schema=schema, columns=cols, offsets=offsets),
            reps=3, warmup=1)

    # favorita_items: the pass, each window, K2w 'cat'
    t = init_fill(cs.make_favorita_items(n, 61)[0])
    schema = t.schema
    p = schema.sigma_size
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w = weights(62)
    lows = list(range(0, p, width))
    for lo in lows:                         # the plans, before any timing
        sp.masked_gram_window(xs, cs_, w, schema=schema, lo=lo,
                              width=min(width, p - lo))
    out["items_pass"] = cs.cuda_ms(
        lambda: sp.masked_gram_cols(xs, cs_, w, schema=schema), reps=3,
        warmup=1)
    out["items_windows"] = [cs.cuda_ms(lambda: sp.masked_gram_window(
        xs, cs_, w, schema=schema, lo=lo, width=min(width, p - lo)),
        reps=3, warmup=1) for lo in lows]
    if keyed:
        out["items_order"] = order_ms(xs, cs_, w, lows, width)
        out["items_window_orders"] = [order_ms(xs, cs_, w, [lo],
                                               min(width, p - lo))
                                      for lo in lows]
    sig = sp.masked_gram_cols(xs, cs_, w, schema=schema)
    wl, icpt, keep = _lda_device(sig, schema, 1, 0.001)
    del sig
    args = (xs, cs_, t.cat_null[1], (~t.num_null[1]).float(),
            _w_full(wl, keep, schema), icpt)
    out["k2w_cat"] = cs.cuda_ms(lambda: fused_impute_aggregate(
        *args, schema=schema, kind="cat", imp_col=1), reps=3, warmup=1)
    del args
    del t, xs, cs_, w
    torch.cuda.empty_cache()

    # wide16k: three windows alone, beside their plain versions
    schema, xs, cs_, w = cs.make_wide16k(n, 64)
    p = schema.sigma_size
    wide = []
    for lo in (0, 3 + schema.cat_sizes[0] - width // 2, p - p % width):
        wd = min(width, p - lo)
        row = dict(lo=lo, width=wd, ms=cs.cuda_ms(
            lambda: sp.masked_gram_window(xs, cs_, w, schema=schema, lo=lo,
                                          width=wd), reps=3, warmup=1))
        row["plain_ms"] = cs.cuda_ms(lambda: sp.masked_gram_window_plain(
            xs, cs_, w, schema=schema, lo=lo, width=wd), reps=1, warmup=0)
        if keyed:
            row["order_ms"] = order_ms(xs, cs_, w, [lo], wd)
        wide.append(row)
    out["wide16k_windows"] = wide
    del xs, cs_, w
    torch.cuda.empty_cache()

    # favorita_wide: the overlap's four stripes and windows of 128
    t, _ = cs.make_favorita(n, 60)
    schema = t.schema
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w = weights(65)
    p = schema.sigma_size
    for name, wd in (("favorita_wide_stripes_of_4", -(-p // 4)),
                     ("favorita_wide_windows_of_128", 128)):
        def windows(wd=wd):
            for lo in range(0, p, wd):
                sp.masked_gram_window(xs, cs_, w, schema=schema, lo=lo,
                                      width=min(wd, p - lo))
        out[name] = cs.cuda_ms(windows, reps=3, warmup=1)
    del t, xs, cs_, w
    torch.cuda.empty_cache()

    # K8 at G = 2 and 33
    for label in ("onpromotion", "family"):
        x, codes, y, schema, classes = cs.items_classify(n, 71, label)
        w = weights(72)
        args = sort_by_group(x, codes, y, schema=schema, num_groups=classes,
                             weights=w)
        del x, codes, y
        out[f"k8_{label}"] = cs.cuda_ms(lambda: grouped_gram_presorted(
            *args, schema=schema), reps=3, warmup=1)
        if keyed:
            p = schema.sigma_size
            out[f"k8_{label}_order"] = order_ms(
                list(args[0]), list(args[1]), args[2], range(0, p, width),
                width, args[3].offsets)
        del args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(time_root(args.root, args.tag)), flush=True)
        return 0
    runs = []
    for i, root in enumerate(args.roots):
        proc = subprocess.run(
            [sys.executable, __file__, "--root", root, "--tag", str(i)],
            capture_output=True, text=True, timeout=args.timeout)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"timing {root} failed ({proc.returncode})")
        if i == 0:                               # the card and its limit
            print("\n".join(lines[:-1]), flush=True)
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
