"""Hold the outputs of the kernels at the schemas the port ran before of
checkouts against each other, bit for bit, on one GPU: the guard that
widening the kernels (past P = 1,024, past any column count, past a
task's cells a categorical column beside others, past 32,768 codes in
the scorers, past the shared-memory column limits) left those schemas'
outputs as they were; and time K1 at config 5, K7 at favorita_wide and
at Home Credit, a pass over favorita_items' and wide16k's S and K3w at
favorita_classify's family in each checkout.

    python3 tools/past_1024_bits.py [--roots DIR [DIR ...]] [--rows N]
                                    [--times] [--reps R]
    python3 tools/past_1024_bits.py --root DIR --out FILE [--rows N]

With `--roots` (default: this checkout twice) it runs each root in turn,
one process each, in the order given (e.g. `build/parent . . build/parent`
for a parent unpacked with `git archive`), and prints one JSON line per
root and a last line naming, for each output, whether every root gave the
same bits (and each `_d_err`, every root's, below the gate). With
`--root` it computes one checkout's outputs and saves them to FILE
(torch.save). A root is the root of a checkout whose
`duckdb_imputation_tpu_torch` runs; its kernels build under its own
`build/`. The tables are those of this checkout's `chip_smoke.py`, at
`--rows` rows (default 2M):

- K2w at favorita_wide (P = 492): 'cat' imputing family (R = 33, LDA
  trained on the table) and class (R = 337, 20% of its rows null), 'num'
  imputing transactions with noise: the new column and sigma;
- K7 over column windows at favorita_wide (`masked_gram_window`): the
  four stripes `parallel/overlap.py` cuts S into on one card, and the
  windows of 128 columns, with the weights of the 'num' step;
- K8 at favorita_classify: label family (G = 33, P = 459) through
  sort_by_group and the presorted entry, label onpromotion (G = 2, P =
  490) through the unsorted entry;
- K3/K3w: the tables of QDA trained on each of those (K3w, several
  tasks), naive Bayes's tables of both (K3, one task; centred, written
  straight into the plan's cells), and each scorer's argmax;
- BASELINE config 5 (P = 21): K1 (`masked_gram_cols`, on the tensor
  cores) and K2 'cat' and 'num' steps; config 4 (P = 21, 2 groups past
  one: K4 and, after sort_by_group, K5); K6 there;
- favorita_wide's whole S by K7 (`masked_gram_cols`, one launch);
- favorita_items (P = 4,592): S by K7's keyed windows (the order pass
  and each window), K2w's 'cat' step past P = 1,024 (its impute kernel
  with W in device memory, then the windows), K8's windows at label
  onpromotion, and K3w's argmax on seeded QDA tables there;
- wide16k (P = 16,387: two columns of exactly a task's 8,192 levels): S
  by K7's keyed windows;
- Home Credit (104 numeric, 16 categorical columns) and SECOM (590
  numeric) at min(rows, 1M): S by K7, K2w 'num' on the first column (and
  at Home Credit 'cat' on its 58-level column: W whole in shared memory,
  each batch row's x beside it), sort + K8 by the label, K6w, and the QDA
  (trained on the plain version's K8, the same in every checkout) and NB
  scorers' argmax (K3w); SECOM's stream fold (590 one-level null flags
  beside its columns, P = 1,181): S by K7's windows. These schemas pass
  the crossover of D to the tensor cores (`_build.dense_route`), so each
  of their S is saved as its cells outside D, [1 ‖ x]'s block (`_rest`,
  compared bit for bit), and its D cells' largest error against the f64
  oracle of tests/reference_oracle.py (`_exact_triple_dict`: N, lin_agg,
  quad_agg, exact f64 sums over the rows of w ≠ 0, here one f64 product
  on the card) relative to max|σ| (`_d_err`, held to chip_smoke.py's
  gate of 1e-5 in every checkout in place of the bits).

Each checkout's line also holds `ms`: K1 at config 5, K7 at
favorita_wide and at Home Credit, a pass over favorita_items' and
wide16k's S (their plans made before the timing) and K3w at family, by
CUDA events (mean of 5 calls after one; `--reps`). With `--times` each
checkout computes only what those six timings need, and also times each by torch.profiler
(`<name>_device`: the kernels' device ms a call, host gaps left out);
the last line lists each timing of every root in the order given, in
place of the bit comparison: many alternated roots (`P C P C ...`) in
one call resolve a change of a few percent. Prints the card and its power limit first.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def k2w_and_windows(cs, rows: int, out: dict) -> None:
    """favorita_wide's K2w steps and K7's stripes and windows of 128."""
    import torch

    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import linreg_solve_device
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_window)

    t = init_fill(cs.make_favorita(rows, 13)[0])
    schema = t.schema
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(14)
    null_cls = torch.rand(rows, generator=gen, device=cs.DEVICE) < 0.2
    w_fam, w_tx = (~t.cat_null[1]).float(), (~t.num_null[1]).float()
    for name, col, null, w_train, w_next in (
            ("k2w_family", 1, t.cat_null[1], w_fam, w_tx),
            ("k2w_class", 2, null_cls, (~null_cls).float(), w_fam)):
        sig = masked_gram_cols(xs, cs_, w_train, schema=schema)
        w, icpt, keep = _lda_device(sig, schema, col, 0.001)
        new, sig = fused_impute_aggregate(
            xs, cs_, null, w_next, _w_full(w, keep, schema), icpt,
            schema=schema, kind="cat", imp_col=col)
        out[name + "_codes"], out[name + "_sigma"] = new, sig
    sig_x = masked_gram_cols(xs, cs_, w_tx, schema=schema)
    coeff = linreg_solve_device(sig_x, label=2)
    theta = coeff.clone()
    theta[2] = 0.0
    new, sig = fused_impute_aggregate(
        xs, cs_, t.num_null[1], w_fam, theta[:, None], theta.new_zeros(1),
        schema=schema, kind="num", imp_col=1,
        noise=(0, 0, _noise_std(coeff, sig_x)))
    out["k2w_num_x"], out["k2w_num_sigma"] = new, sig
    p = schema.sigma_size
    for name, wd in (("k7_stripes_of_4", -(-p // 4)),
                     ("k7_windows_of_128", 128)):
        out[name] = torch.cat([masked_gram_window(
            xs, cs_, w_fam, schema=schema, lo=lo, width=min(wd, p - lo))
            for lo in range(0, p, wd)], 1)
    del t, xs, cs_



def config5_and_4(cs, t, xs, cs_, w0, w1, out: dict) -> None:
    """K2 'cat' and 'num' at config 5; K4, K5 and K6 at config 4."""
    import torch

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, sort_by_group)

    p5 = t.schema.sigma_size
    w_cat = torch.linspace(-1, 1, p5 * 8, device=cs.DEVICE).reshape(p5, 8)
    new, sig = fused_impute_aggregate(
        xs, cs_, t.cat_null[0], w1, w_cat, torch.zeros(8, device=cs.DEVICE),
        schema=t.schema, kind="cat", imp_col=0)
    out["k2_config5_cat"], out["k2_config5_cat_sigma"] = new, sig
    new, sig = fused_impute_aggregate(
        xs, cs_, t.num_null[1], w0, w_cat[:, :1].contiguous(), torch.zeros(
            1, device=cs.DEVICE), schema=t.schema, kind="num", imp_col=1)
    out["k2_config5_num"], out["k2_config5_num_sigma"] = new, sig
    c4 = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)
    ids = (t.num_data[0] > 0).to(torch.int32) + (t.num_data[2] > 0).int()
    out["k4_config4"] = grouped_gram(t.num_data, t.cat_codes, w0, ids,
                                     schema=c4, num_groups=3)
    out["k5_config4"] = grouped_gram_presorted(*sort_by_group(
        t.num_data, t.cat_codes, ids, schema=c4, num_groups=3, weights=w0),
        schema=c4)
    out["k6_config4"] = nb_grouped_sums(t.num_data, t.cat_codes, w0, ids,
                                        schema=c4, num_groups=3)


def items_rest(cs, rows: int, t, xs, cs_, out: dict) -> None:
    """favorita_items' K2w 'cat' step, K8 and K3w."""
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _w_full)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram_presorted, sort_by_group)

    schema, sig = t.schema, out["k7_items"]
    w, icpt, keep = _lda_device(sig, schema, 1, 0.001)
    new, sig = fused_impute_aggregate(
        xs, cs_, t.cat_null[1], (~t.num_null[1]).float(),
        _w_full(w, keep, schema), icpt, schema=schema, kind="cat",
        imp_col=1)
    out["k2w_items_codes"], out["k2w_items_sigma"] = new, sig
    del sig, new
    x, codes, y, schema, classes = cs.items_classify(rows, 37, "onpromotion")
    out["k8_items"] = grouped_gram_presorted(*sort_by_group(
        x, codes, y, schema=schema, num_groups=classes), schema=schema)
    tables, plan, _ = cs.seeded_scorer("qda", schema, classes, 38)
    out["k3w_items"] = qda_predict_kernel(tables, plan, x, codes,
                                          schema=schema)
    del x, codes, y, tables, plan


D_GATE = 1e-5    # chip_smoke.py's: |S − σ| ≤ 1e-5 · max|σ|


def split_d(out: dict, name: str, sig, x_cols, w, offsets=None) -> None:
    """S (or S_g a group over `offsets`) as out[name + "_rest"], its cells
    outside D (zeroed), and out[name + "_d_err"]: max |D − D_f64| / max|S|
    over the groups, D_f64 = [1 ‖ x]ᵀ·[1 ‖ x] in f64 over the rows of w ≠
    0 (w None: every row), x taken exactly into f64 (the oracle's
    `_exact_triple_dict` sums for binary weights)."""
    import torch

    m = 1 + len(x_cols)
    n = x_cols[0].shape[0]
    keep = (torch.ones(n, dtype=torch.bool, device=sig.device) if w is None
            else w != 0)
    bounds = [0, n] if offsets is None else offsets.tolist()
    gs = sig if sig.dim() == 3 else sig[None]
    err = 0.0
    for g, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        z = torch.ones((m, b - a), dtype=torch.float64, device=sig.device)
        z[1:] = torch.stack([x[a:b] for x in x_cols]).double()
        z = z[:, keep[a:b]]
        oracle = z @ z.T
        err = max(err, float((gs[g, :m, :m].double() - oracle).abs().max())
                  / max(float(gs[g].abs().max()), 1e-30))
        del z, oracle
    rest = sig.clone()
    rest[..., :m, :m] = 0.0
    out[name + "_rest"] = rest
    out[name + "_d_err"] = torch.tensor([err], dtype=torch.float64)


def device_ms(fn, reps: int) -> float | None:
    """Mean device ms a call of fn spends in kernels, by torch.profiler
    over `reps` calls after one; None where the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
                for ev in prof.key_averages() if "Memcpy" not in ev.key)
    return total / reps / 1e3 if total > 0 else None


def outputs(root: str, rows: int, times: bool = False,
            reps: int = 5) -> dict:
    """Every guarded output of the checkout at `root`, on the card; with
    `times`, only what the timings need."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device, qda_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        nb_center, nb_tables, qda_predict_kernel, qda_tables)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, grouped_gram_presorted_plain,
        sort_by_group)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_device(), flush=True)
    out, ms = {}, {}

    def timed(name, fn):
        ms[name] = cs.cuda_ms(fn, reps=reps, warmup=1)
        if times:
            ms[name + "_device"] = device_ms(fn, reps)
    if not times:
        k2w_and_windows(cs, rows, out)
    for label in ("family",) if times else ("family", "onpromotion"):
        x, codes, y, schema, classes = cs.make_favorita_classify(rows, 20,
                                                                label)
        if label == "family":
            sig = grouped_gram_presorted(
                *sort_by_group(x, codes, y, schema=schema,
                               num_groups=classes), schema=schema)
        else:
            sig = grouped_gram(x, codes, None, y, schema=schema,
                               num_groups=classes)
        out[f"k8_{label}"] = sig
        tables, plan = qda_tables(*qda_train_device(sig, float(rows)),
                                  schema=schema)
        out[f"qda_tables_{label}"] = tables
        out[f"k3w_qda_{label}"] = qda_predict_kernel(tables, plan, x, codes,
                                                     schema=schema)
        if label == "family":
            timed("k3w_family", lambda: qda_predict_kernel(
                tables, plan, x, codes, schema=schema))
        if times:
            continue
        agg = sum_to_nb_agg_grouped(x, codes, y, schema=schema,
                                    num_groups=classes)
        params = nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
        f64 = torch.float64
        var = params[2].to(f64).clamp(min=0.0) + 1e-9
        freqs = params[3].to(f64)
        log_freq = torch.where(freqs > 0.0,
                               torch.log(freqs.clamp(min=1e-38)), -1e30)
        log_prior = torch.log(params[0].to(f64).clamp(min=1e-38))
        center = nb_center(log_prior, params[1])
        out[f"nb_tables_{label}"] = nb_tables(
            log_prior, params[1], var, log_freq, schema=schema,
            center=center)[0]
        out[f"k3_nb_{label}"] = nb_predict_device(*params, x, codes,
                                                  schema=schema)
        del x, codes, y, sig, tables, agg

    # config 5 and config 4: K1, K2, K4, K5, K6
    t = cs.make_table(rows, 31)[0]
    t = init_fill(t)
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w0, w1 = (~t.cat_null[0]).float(), (~t.num_null[1]).float()
    out["k1_config5"] = masked_gram_cols(xs, cs_, w0, schema=t.schema)
    timed("k1_config5", lambda: masked_gram_cols(xs, cs_, w0,
                                                 schema=t.schema))
    if not times:
        config5_and_4(cs, t, xs, cs_, w0, w1, out)
    del t, xs, cs_

    # favorita_wide's whole S by K7's one launch
    t = cs.make_favorita(rows, 33)[0]
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w_fw = (~t.cat_null[1]).float()
    out["k7_favorita_wide"] = masked_gram_cols(xs, cs_, w_fw,
                                               schema=t.schema)
    timed("k7_favorita_wide", lambda: masked_gram_cols(xs, cs_, w_fw,
                                                       schema=t.schema))
    del t, xs, cs_

    # favorita_items past P = 1,024: K7's keyed windows, K2w, K8, K3w
    t = init_fill(cs.make_favorita_items(rows, 35)[0])
    schema = t.schema
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w_fam = (~t.cat_null[1]).float()
    out["k7_items"] = masked_gram_cols(xs, cs_, w_fam, schema=schema)
    timed("k7_items_pass", lambda: masked_gram_cols(xs, cs_, w_fam,
                                                    schema=schema))
    if not times:
        items_rest(cs, rows, t, xs, cs_, out)
    del t, xs, cs_

    # wide16k: two columns of exactly a task's cells
    schema, xs, cs_, w = cs.make_wide16k(rows, 39)
    if not times:
        s16 = masked_gram_cols(xs, cs_, w, schema=schema).cpu()
        out["k7_wide16k_sha256"] = torch.frombuffer(bytearray(
            hashlib.sha256(s16.numpy().tobytes()).digest()),
            dtype=torch.uint8)                   # 1 GB: its digest
        del s16
    timed("k7_wide16k_pass", lambda: masked_gram_cols(xs, cs_, w,
                                                      schema=schema))
    del xs, cs_, w

    # Home Credit and SECOM
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)

    many = min(rows, 1_000_000)
    for name, make, seed in (("home_credit", cs.make_home_credit, 41),
                             ("secom", cs.make_secom, 43))[:1 if times
                                                           else None]:
        made = make(many, seed)
        t, y = init_fill(made[0]), made[-1].to(torch.int32)
        schema = t.schema
        xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
        w = (~t.num_null[0]).float()
        sig = masked_gram_cols(xs, cs_, w, schema=schema)
        split_d(out, f"k7_{name}", sig, xs, w)
        if name == "home_credit":
            timed("k7_home_credit", lambda: masked_gram_cols(
                xs, cs_, w, schema=schema))
        if times:
            break
        p = schema.sigma_size
        theta = torch.linspace(-1, 1, p, device=cs.DEVICE)[:, None]
        new, sig = fused_impute_aggregate(
            xs, cs_, t.num_null[0], w, theta, theta.new_zeros(1),
            schema=schema, kind="num", imp_col=0)
        out[f"k2w_{name}_x"] = new
        split_d(out, f"k2w_{name}_sigma", sig, [new] + xs[1:], w)
        if schema.cat_cols:
            r = schema.cat_sizes[11]
            w_cat = torch.linspace(-1, 1, p * r, device=cs.DEVICE).reshape(
                p, r)
            new, sig = fused_impute_aggregate(
                xs, cs_, t.cat_null[11], w, w_cat, w_cat.new_zeros(r),
                schema=schema, kind="cat", imp_col=11)
            out[f"k2w_{name}_codes"] = new
            split_d(out, f"k2w_{name}_cat_sigma", sig, xs, w)
        else:
            fold = FeatureSchema(num_cols=p - 1, cat_keys=((0,),) * (p - 1))
            flags = list(t.num_null.to(torch.int32).unbind(0))
            split_d(out, f"k7_{name}_fold", masked_gram_cols(
                xs, flags, None, schema=fold), xs, None)
            del flags
        sorted_ = sort_by_group(t.num_data, t.cat_codes, y, schema=schema,
                                num_groups=2)
        sig = grouped_gram_presorted(*sorted_, schema=schema)
        split_d(out, f"k8_{name}", sig, list(sorted_[0]), None,
                sorted_[3].offsets)
        out[f"k6w_{name}"] = nb_grouped_sums(t.num_data, t.cat_codes, None,
                                             y, schema=schema, num_groups=2)
        # QDA on the plain K8 (the same in every checkout): K3w's argmax
        # compared bit for bit over the same tables
        sig = grouped_gram_presorted_plain(*sorted_, schema=schema)
        del sorted_
        tables, plan = qda_tables(*qda_train_device(sig, float(many)),
                                  schema=schema)
        out[f"k3w_qda_{name}"] = qda_predict_kernel(
            tables, plan, t.num_data, t.cat_codes, schema=schema)
        agg = sum_to_nb_agg_grouped(t.num_data, t.cat_codes, y,
                                    schema=schema, num_groups=2)
        out[f"k3_nb_{name}"] = nb_predict_device(
            *nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat),
            t.num_data, t.cat_codes, schema=schema)
        del t, y, xs, cs_, w, sig, tables, plan, agg, new
    torch.cuda.synchronize()
    res = {k: v.cpu() for k, v in out.items()}
    res["__ms__"] = ms
    return res


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.root:
        import torch

        if not torch.cuda.is_available():
            print("past_1024_bits: no CUDA device", file=sys.stderr)
            return 1
        res = outputs(args.root, args.rows, args.times, args.reps)
        torch.save(res, args.out)
        ms = res.pop("__ms__")
        print(json.dumps({"root": Path(args.root).resolve().name, "ms": ms,
                          "digests": {k: digest(v) for k, v in res.items()}}),
              flush=True)
        return 0
    outdir = HERE / "build" / "past_1024_bits"
    outdir.mkdir(parents=True, exist_ok=True)
    files = []
    for i, root in enumerate(args.roots):
        f = outdir / f"{i}.pt"
        proc = subprocess.run(
            [sys.executable, __file__, "--root", root, "--out", str(f),
             "--rows", str(args.rows), "--reps", str(args.reps)]
            + (["--times"] if args.times else []), timeout=args.timeout)
        if proc.returncode != 0:
            print(f"past_1024_bits: root {root} failed ({proc.returncode})",
                  file=sys.stderr)
            return proc.returncode or 1
        files.append(f)
    import torch

    runs = [torch.load(f) for f in files]
    if args.times:
        ms = [r.pop("__ms__") for r in runs]
        print(json.dumps({"roots": args.roots, "ms": {
            k: [m[k] for m in ms] for k in ms[0]}}), flush=True)
        return 0
    for r in runs:
        r.pop("__ms__")
    same = {k: all(torch.equal(runs[0][k], r[k]) for r in runs[1:])
            for k in runs[0] if not k.endswith("_d_err")}
    gate = {k: [float(r[k]) for r in runs] for k in runs[0]
            if k.endswith("_d_err")}
    print(json.dumps({"roots": args.roots, "identical": same,
                      "d_err": gate}), flush=True)
    return 0 if all(same.values()) and all(
        e <= D_GATE for v in gate.values() for e in v) else 2


if __name__ == "__main__":
    sys.exit(main())
