"""Hold the outputs of the kernels at schemas of at most 64 numeric and
64 categorical columns of checkouts against each other, bit for bit, on
one GPU: the guard that widening the kernels (past P = 1,024, and past
any column count) left those schemas' outputs as they were.

    python3 tools/past_1024_bits.py [--roots DIR [DIR ...]] [--rows N]
    python3 tools/past_1024_bits.py --root DIR --out FILE [--rows N]

With `--roots` (default: this checkout twice) it runs each root in turn,
one process each, in the order given (e.g. `build/parent . . build/parent`
for a parent unpacked with `git archive`), and prints one JSON line per
root and a last line naming, for each output, whether every root gave the
same bits. With `--root` it computes one checkout's outputs and saves them
to FILE (torch.save). A root is the root of a checkout whose
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
  onpromotion, and K3w's argmax on seeded QDA tables there.

Prints the card and its power limit first.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def outputs(root: str, rows: int) -> dict:
    """Every guarded output of the checkout at `root`, on the card."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device, nb_predict_device, nb_train_device,
        qda_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        nb_center, nb_tables, qda_predict_kernel, qda_tables)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_window)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, sort_by_group)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_device(), flush=True)
    out = {}
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

    for label in ("family", "onpromotion"):
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
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)

    t = cs.make_table(rows, 31)[0]
    t = init_fill(t)
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w0, w1 = (~t.cat_null[0]).float(), (~t.num_null[1]).float()
    out["k1_config5"] = masked_gram_cols(xs, cs_, w0, schema=t.schema)
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
    del t, xs, cs_

    # favorita_wide's whole S by K7's one launch
    t = cs.make_favorita(rows, 33)[0]
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    out["k7_favorita_wide"] = masked_gram_cols(
        xs, cs_, (~t.cat_null[1]).float(), schema=t.schema)
    del t, xs, cs_

    # favorita_items past P = 1,024: K7's keyed windows, K2w, K8, K3w
    t = init_fill(cs.make_favorita_items(rows, 35)[0])
    schema = t.schema
    xs, cs_ = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w_fam = (~t.cat_null[1]).float()
    out["k7_items"] = masked_gram_cols(xs, cs_, w_fam, schema=schema)
    sig = out["k7_items"]
    w, icpt, keep = _lda_device(sig, schema, 1, 0.001)
    new, sig = fused_impute_aggregate(
        xs, cs_, t.cat_null[1], (~t.num_null[1]).float(),
        _w_full(w, keep, schema), icpt, schema=schema, kind="cat",
        imp_col=1)
    out["k2w_items_codes"], out["k2w_items_sigma"] = new, sig
    del t, xs, cs_, sig, new
    x, codes, y, schema, classes = cs.items_classify(rows, 37, "onpromotion")
    out["k8_items"] = grouped_gram_presorted(*sort_by_group(
        x, codes, y, schema=schema, num_groups=classes), schema=schema)
    tables, plan, _ = cs.seeded_scorer("qda", schema, classes, 38)
    out["k3w_items"] = qda_predict_kernel(tables, plan, x, codes,
                                          schema=schema)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE), str(HERE)])
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    if args.root:
        import torch

        if not torch.cuda.is_available():
            print("past_1024_bits: no CUDA device", file=sys.stderr)
            return 1
        res = outputs(args.root, args.rows)
        torch.save(res, args.out)
        print(json.dumps({"root": Path(args.root).resolve().name,
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
             "--rows", str(args.rows)], timeout=args.timeout)
        if proc.returncode != 0:
            print(f"past_1024_bits: root {root} failed ({proc.returncode})",
                  file=sys.stderr)
            return proc.returncode or 1
        files.append(f)
    import torch

    runs = [torch.load(f) for f in files]
    same = {k: all(torch.equal(runs[0][k], r[k]) for r in runs[1:])
            for k in runs[0]}
    print(json.dumps({"roots": args.roots, "identical": same}), flush=True)
    return 0 if all(same.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
