"""Time the grouped Grams (K4, K5) and the pipelines over them of checkouts
on one GPU, for a comparison of two commits in one call (parent, change,
change, parent).

    python3 tools/k4k5_times.py [--roots DIR [DIR ...]] [--timeout S]
    python3 tools/k4k5_times.py --root DIR [--tag NAME]

With `--roots` (default: this checkout twice) it times each root in turn,
one process each, in the order given, and prints one JSON line per root
and a last line with every run; with `--root` it times that one checkout.
A root is the root of a checkout whose `duckdb_imputation_tpu_torch` is
timed; its kernels build under its own `build/`. The tables are those of
this checkout's `chip_smoke.py`, 10M rows, binary weights:

- K4 (`grouped_gram`) at BASELINE config 4 (P = 21, 8 classes, 90% in
  class 0), at 8 uniform classes, and at P = 88 (24 numeric and three
  categorical columns of 21, 8 uniform classes);
- K5 (`grouped_gram_presorted`, after `sort_by_group`) at config 4's 8
  classes and at 1,000 uniform groups;
- the QDA pipelines of `[classify]` (GROUP BY label, f64 training,
  scoring): config 4's 8 classes (K4) and 16 uniform classes (a sort and
  K5), and the NB pipeline at config 4 (which launches neither);
- K1 (`masked_gram_cols`) and K2 (`fused_impute_aggregate`, 'cat' and
  'num') at BASELINE config 5, whose tensor-core body K4 and K5 share,
  and K2 and the fused MICE round (`mice_loop_device_fused`, slope of 1
  against 4 rounds) at 10M and 100M rows, which launch that body.

Times are CUDA events, ms per call, mean of 10 (3 at P = 88 and for the
rounds, 5 for the pipelines and at 100M rows) after a warm-up. Prints the card and its power limit first.
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

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, sort_by_group)

    print(cs.phase_device(), flush=True)
    out = {"tag": tag, "root": str(Path(root).resolve().name)}
    n, classes, dev = cs.N, cs.CLASSES, cs.DEVICE
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    w = (torch.rand(n, generator=gen, device=dev) >= 0.2).float()

    x, codes, y, schema = cs.make_classify_table(n, 0)
    kw = dict(schema=schema, num_groups=classes)
    out["k4_config4"] = cs.cuda_ms(lambda: grouped_gram(x, codes, w, y,
                                                        **kw))
    args = sort_by_group(x, codes, y, weights=w, **kw)
    out["k5_g8"] = cs.cuda_ms(lambda: grouped_gram_presorted(
        *args, schema=schema))
    ids = torch.randint(0, cs.GROUPS_SORTED, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    args = sort_by_group(x, codes, ids, schema=schema,
                         num_groups=cs.GROUPS_SORTED, weights=w)
    out["k5_g1000"] = cs.cuda_ms(lambda: grouped_gram_presorted(
        *args, schema=schema))
    del args
    for name, pipe in (("qda", cs.qda_pipeline), ("nb", cs.nb_pipeline)):
        out[f"{name}_config4"] = cs.cuda_ms(
            lambda: pipe(x, codes, y, schema, classes), reps=5, warmup=1)
    xu, cu, yu, _ = cs.make_classify_table(n, 5, hot=None)
    out["k4_uniform8"] = cs.cuda_ms(lambda: grouped_gram(xu, cu, w, yu,
                                                         **kw))
    del x, codes, y, xu, cu
    x16, c16, y16, _ = cs.make_classify_table(n, 1, classes=2 * classes,
                                              hot=None)
    out["qda_16"] = cs.cuda_ms(
        lambda: cs.qda_pipeline(x16, c16, y16, schema, 2 * classes), reps=5,
        warmup=1)
    del x16, c16, y16
    sch88 = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    x88 = torch.randn((24, n), generator=gen, device=dev) * 2 + 0.5
    c88 = torch.randint(-1, 22, (3, n), generator=gen, device=dev,
                        dtype=torch.int32)
    out["k4_p88"] = cs.cuda_ms(lambda: grouped_gram(
        x88, c88, w, yu, schema=sch88, num_groups=classes), reps=3)
    del x88, c88, yu
    torch.cuda.empty_cache()

    # K1, K2 and the fused round at config 5, the steps of
    # tools/k2_times.py
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _w_full, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)

    def round_ms(table, rounds=4):
        f = init_fill(table)
        args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
        kw = dict(schema=table.schema, num_cols_to_impute=(1,),
                  cat_cols_to_impute=(0,))
        one = cs.cuda_ms(lambda: mice_loop_device_fused(*args, iters=1,
                                                        **kw), reps=3,
                         warmup=1)
        many = cs.cuda_ms(lambda: mice_loop_device_fused(
            *args, iters=rounds, **kw), reps=3, warmup=1)
        return (many - one) / (rounds - 1)

    for n5, size, reps in ((n, "", 10), (cs.N_DEPLOY, "_100M", 5)):
        t = init_fill(cs.make_table(n5, 0)[0])
        s5 = t.schema
        xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
        w_c0, w_x1 = (~t.cat_null[0]).float(), (~t.num_null[1]).float()
        lda, icpt, keep = _lda_device(
            masked_gram_cols(xs, cs_, w_c0, schema=s5), s5, 0, 0.001)
        cat = (xs, cs_, t.cat_null[0], w_x1, _w_full(lda, keep, s5), icpt)
        theta = linreg_solve_device(
            masked_gram_cols(xs, cs_, w_x1, schema=s5), label=2).clone()
        theta[2] = 0.0
        num = (xs, cs_, t.num_null[1], w_c0, theta[:, None],
               theta.new_zeros(1))
        if not size:
            out["k1_config5"] = cs.cuda_ms(lambda: masked_gram_cols(
                xs, cs_, w_c0, schema=s5))
        out[f"k2_cat_config5{size}"] = cs.cuda_ms(
            lambda: fused_impute_aggregate(*cat, schema=s5, kind="cat",
                                           imp_col=0), reps=reps)
        out[f"k2_num_config5{size}"] = cs.cuda_ms(
            lambda: fused_impute_aggregate(*num, schema=s5, kind="num",
                                           imp_col=1), reps=reps)
        del t, xs, cs_, w_c0, w_x1, cat, num
        torch.cuda.empty_cache()
        out[f"round_config5{size}"] = round_ms(cs.make_table(n5, 0)[0])
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=float, default=600.0)
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
