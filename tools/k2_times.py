"""Time the fused impute+aggregate pass (K2, K2w) of checkouts on one GPU,
for a comparison of two commits in one call (parent, change, change,
parent).

    python3 tools/k2_times.py [--roots DIR [DIR ...]] [--timeout S]
    python3 tools/k2_times.py --root DIR [--tag NAME]
    python3 tools/k2_times.py --plans LD[,LD ...]

With `--roots` (default: this checkout twice) it times each root in turn,
one process each, in the order given, and prints one JSON line per root
and a last line with every run; with `--root` it times that one checkout.
A root is the root of a checkout whose `duckdb_imputation_tpu_torch` is
timed; its kernels build under its own `build/`. The tables are those of
this checkout's `chip_smoke.py`:

- BASELINE config 5 (P = 21), 10M and 100M rows: K2 'cat' (imputing
  categorical 0, LDA trained on the table) and 'num' (numeric 1, no
  noise), K1 (`masked_gram_cols`, binary weights), and ms per fused round
  (`mice_loop_device_fused`, slope of 1 against 4 rounds);
- favorita_wide (P = 492), 10M rows: K2w 'cat' at R = 33 (family) and
  R = 337 (class, 20% of its rows null), each with its impute kernel alone
  (K2w less K7 over the updated columns), K2w 'num' (transactions), and ms
  per fused round (slope of 1 against 3 rounds).

With `--plans` it times only this checkout's K2w 'cat' steps at
favorita_wide (and their impute kernel alone) under each given tiling of
W in its impute kernel (`_build.impute_plan` replaced: ld classes a tile,
the largest batch that fits), in one process.

Times are CUDA events, ms per call, mean of 10 (5 at 100M rows and for
the wide kernels) after a warm-up. Prints the card and its power limit
first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def impute_plans(specs: str) -> list[int]:
    return [int(spec) for spec in specs.split(",")]


def time_root(root: str, tag: str, plans=None) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables and timer
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _w_full, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    print(cs.phase_device(), flush=True)
    out = {"tag": tag, "root": str(Path(root).resolve().name)}

    def steps(t, cat_col, num_col, null_cat, w_cat, w_num):
        """(cat args, num args): a 'cat' step imputing cat_col under
        null_cat (LDA on weights w_cat), a 'num' step imputing num_col
        (least squares on w_num), the next column's mask as w_agg."""
        schema = t.schema
        xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
        sig = masked_gram_cols(xs, cs_, w_cat, schema=schema)
        w, icpt, keep = _lda_device(sig, schema, cat_col, 0.001)
        cat = (xs, cs_, null_cat, w_num, _w_full(w, keep, schema), icpt)
        coeff = linreg_solve_device(
            masked_gram_cols(xs, cs_, w_num, schema=schema),
            label=1 + num_col)
        theta = coeff.clone()
        theta[1 + num_col] = 0.0
        num = (xs, cs_, t.num_null[num_col], w_cat, theta[:, None],
               theta.new_zeros(1))
        return cat, num

    def round_ms(t, cat_col, num_col, rounds):
        f = init_fill(t)
        args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
        kw = dict(schema=t.schema, num_cols_to_impute=(num_col,),
                  cat_cols_to_impute=(cat_col,))

        def loop(k):
            return mice_loop_device_fused(*args, iters=k, **kw)
        one = cs.cuda_ms(lambda: loop(1), reps=3, warmup=1)
        many = cs.cuda_ms(lambda: loop(rounds), reps=3, warmup=1)
        return (many - one) / (rounds - 1)

    sizes = () if plans else ((cs.N, "10M", 10), (cs.N_DEPLOY, "100M", 5))
    for n, tagn, reps in sizes:
        t = init_fill(cs.make_table(n, 0)[0])
        w_c0 = (~t.cat_null[0]).float()
        w_x1 = (~t.num_null[1]).float()
        cat, num = steps(t, 0, 1, t.cat_null[0], w_c0, w_x1)
        kw = dict(schema=t.schema)
        out[f"k2_cat_{tagn}"] = cs.cuda_ms(lambda: fused_impute_aggregate(
            *cat, kind="cat", imp_col=0, **kw), reps=reps)
        out[f"k2_num_{tagn}"] = cs.cuda_ms(lambda: fused_impute_aggregate(
            *num, kind="num", imp_col=1, **kw), reps=reps)
        if n == cs.N:
            xs, cs_ = cat[0], cat[1]
            out["k1_p21"] = cs.cuda_ms(lambda: masked_gram_cols(
                xs, cs_, w_c0, schema=t.schema))
        del cat, num
        out[f"round_p21_{tagn}"] = round_ms(cs.make_table(n, 0)[0], 0, 1, 4)
        del t, w_c0, w_x1
        torch.cuda.empty_cache()

    t = init_fill(cs.make_favorita(cs.N, 13)[0])
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(14)
    null_cls = torch.rand(cs.N, generator=gen, device=cs.DEVICE) < 0.2
    w_fam = (~t.cat_null[1]).float()
    w_tx = (~t.num_null[1]).float()
    if plans:
        from duckdb_imputation_tpu_torch.ring.kernels import _build
        chosen = _build.impute_plan

        def plan_of(ld):
            def fixed(schema, r):
                ld_r = min(ld, r)
                room = _build.WIDE_SMEM - _build.impute_smem_bytes(
                    schema, ld_r, 0)
                per_row = _build.impute_smem_bytes(schema, ld_r, 1) \
                    - _build.impute_smem_bytes(schema, ld_r, 0)
                batch = min(_build.IMP_BATCH, room // per_row // 32 * 32)
                return ld_r, -(-ld_r // 32), batch
            return fixed
    for name, col, null, w_train in (
            ("r33", 1, t.cat_null[1], w_fam),
            ("r337", 2, null_cls, (~null_cls).float())):
        cat, num = steps(t, col, 1, null, w_train, w_tx)
        new, _ = fused_impute_aggregate(*cat, schema=t.schema, kind="cat",
                                        imp_col=col)
        upd = list(cat[1])
        upd[col] = new
        k7 = cs.cuda_ms(lambda: masked_gram_cols(cat[0], upd, cat[3],
                                                 schema=t.schema), reps=5)
        out[f"k2w_k7_{name}"] = k7
        for ld in plans or [None]:
            key = name if ld is None else f"{name}_ld{ld}"
            if ld is not None:
                _build.impute_plan = plan_of(ld)
                out[f"plan_{key}"] = _build.impute_plan(
                    t.schema, t.schema.cat_sizes[col])
                got, _ = fused_impute_aggregate(
                    *cat, schema=t.schema, kind="cat", imp_col=col)
                cs.check(torch.equal(got, new), f"plan {key} differs")
            k2w = cs.cuda_ms(lambda: fused_impute_aggregate(
                *cat, schema=t.schema, kind="cat", imp_col=col), reps=5)
            out[f"k2w_cat_{key}"] = k2w
            out[f"k2w_impute_{key}"] = k2w - k7
        if plans:
            _build.impute_plan = chosen
    if plans:
        return out
    out["k2w_num"] = cs.cuda_ms(lambda: fused_impute_aggregate(
        *num, schema=t.schema, kind="num", imp_col=1), reps=5)
    del t, cat, num
    torch.cuda.empty_cache()
    out["round_favorita_10M"] = round_ms(cs.make_favorita(cs.N, 15)[0], 1, 1,
                                         3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--tag", default="")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--plans", default=None)
    args = ap.parse_args()
    if args.plans is not None:
        print(json.dumps(time_root(str(HERE), "plans",
                                   impute_plans(args.plans))), flush=True)
        return 0
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
