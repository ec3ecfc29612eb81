"""Command-line interface: CSV in, imputed CSV out; model training and
serving; the benchmark configurations. Counterpart of
`duckdb_imputation_tpu.cli` (the driver role of the reference's
main.cpp), on the card unless `--device cpu` is given:

    python -m duckdb_imputation_tpu_torch.cli impute data.csv \\
        --out imputed.csv --mode low --iters 5
    python -m duckdb_imputation_tpu_torch.cli impute big.csv \\
        --mode stream --engine device
    python -m duckdb_imputation_tpu_torch.cli train data.csv --model lda \\
        --label g --out model.npz
    python -m duckdb_imputation_tpu_torch.cli predict test.csv \\
        --params model.npz
    python -m duckdb_imputation_tpu_torch.cli bench --config all

`--device` takes the place of the JAX CLI's `--platform`. Nothing here
needs pandas.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

MODES = ("baseline", "low", "high", "stream", "device", "fused", "delta")
BENCH_CONFIGS = ("all", "sum_to_triple_4_0", "sum_to_triple_4_2",
                 "nb_grouped")


def _write_table(path: str, out) -> None:
    """The imputed table as CSV: numeric columns, then categorical ones
    (each kind in the order read), numbers as the shortest repr of their
    f32 value, categories as their raw values or string labels."""
    from .table.native import format_csv_block

    num = out.num_data.cpu().numpy()
    cat = out.cat_values()
    labels = out.cat_labels or (None,) * cat.shape[0]
    names = list(out.num_names) + list(out.cat_names)
    is_int = [False] * num.shape[0] + [True] * cat.shape[0]
    with open(path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        if all(lb is None for lb in labels):
            f.write(format_csv_block([*num, *cat], is_int, names=names))
            return
        cols = [bytes(format_csv_block([v], [False])).decode()
                .split("\n")[:-1] for v in num]
        cols += [[str(int(c)) for c in v] if lb is None
                 else np.asarray(lb, object)[v].tolist()
                 for v, lb in zip(cat, labels)]
        f.write("".join(",".join(row) + "\n" for row in zip(*cols))
                .encode())


def cmd_impute(args):
    from .mice import (run_mice_baseline, run_mice_device,
                       run_mice_device_delta, run_mice_high, run_mice_low)
    from .table.native import read_csv
    from .utils.profiling import PhaseTimer

    timer = PhaseTimer(verbose=args.verbose)
    if args.mode == "stream":
        from .mice.streaming import impute_csv_stream
        res = impute_csv_stream(
            args.csv, args.out, iters=args.iters, noise=not args.no_noise,
            linreg_iters=args.linreg_iters, timer=timer,
            block_bytes=args.block_mb << 20,
            dirty_budget_rows=args.dirty_budget_rows,
            engine=args.engine, device=args.device)
        print(timer.report(), file=sys.stderr)
        print(f"wrote {args.out} ({res.ss.n_rows} rows, "
              f"{len(res.idx)} dirty)", file=sys.stderr)
        return

    t = read_csv(args.csv, device=args.device)
    noise = not args.no_noise
    if args.mode in ("device", "fused", "delta"):
        with timer.phase("mice_device"):
            if args.mode == "delta":
                out = run_mice_device_delta(t, iters=args.iters, noise=noise)
            else:
                out = run_mice_device(
                    t, iters=args.iters, noise=noise,
                    kernel="fused" if args.mode == "fused" else "auto")
    else:
        runner = {"baseline": run_mice_baseline, "low": run_mice_low,
                  "high": run_mice_high}[args.mode]
        out = runner(t, iters=args.iters, noise=noise, timer=timer,
                     linreg_iters=args.linreg_iters)
    print(timer.report(), file=sys.stderr)
    _write_table(args.out, out)
    print(f"wrote {args.out} ({out.n_rows} rows)", file=sys.stderr)


def cmd_train(args):
    """Train one model from a CSV and save its flat parameter vector (the
    serving path the reference lacks: its models live as FLOAT[] values
    inside one SQL connection, imputation_base.cpp:46-49). Training uses
    the complete rows only: a weight mask zeroes every row with a null in
    ANY column, the `WHERE <col>_IS_NULL IS FALSE` predicate."""
    from .models import lda_train, linreg_train, nb_train, qda_train
    from .models.io import ModelBundle, save_model
    from .ring.sum import (sum_to_nb_agg_grouped, sum_to_triple,
                           sum_to_triple_grouped)
    from .table.native import read_csv

    t = read_csv(args.csv, device=args.device)
    obs = ~(t.num_null.any(0) | t.cat_null.any(0))
    w = obs.to(torch.float32)
    label = args.label
    # the file's string dictionaries, kept in the bundle so that predict
    # re-encodes another file's labels through the training vocabulary
    file_labels = t.cat_labels or (None,) * len(t.cat_names)

    if args.model == "linreg":
        if label not in t.num_names:
            raise SystemExit(f"label {label!r} is not a numeric column "
                             f"(have {t.num_names})")
        j = t.num_names.index(label)
        triple = sum_to_triple(t.num_data, t.cat_codes, w, schema=t.schema)
        params = linreg_train(
            triple, t.schema, label=j, step_size=args.step_size,
            lam=args.lam, max_iters=args.max_iters,
            compute_variance=args.variance, normalize=args.normalize)
        bundle = ModelBundle("linreg", params, t.schema, t.num_names,
                             t.cat_names, label, "num", (),
                             args.normalize, args.variance,
                             cat_labels=file_labels)
    else:
        if label not in t.cat_names:
            raise SystemExit(f"label {label!r} is not a categorical column "
                             f"(have {t.cat_names})")
        j = t.cat_names.index(label)
        label_keys = t.schema.cat_keys[j]
        if args.model == "lda":
            triple = sum_to_triple(t.num_data, t.cat_codes, w,
                                   schema=t.schema)
            params = lda_train(triple, t.schema, label=j,
                               shrinkage=args.shrinkage,
                               normalize=args.normalize)
            bundle = ModelBundle("lda", params, t.schema, t.num_names,
                                 t.cat_names, label, "cat", label_keys,
                                 args.normalize, False,
                                 cat_labels=file_labels,
                                 label_labels=file_labels[j] or ())
        else:
            # QDA/NB: the label leaves the features; one aggregate per
            # class by the grouped kernels (GROUP BY label)
            fs = t.schema.without_cat(j)
            rows = [r for r in range(t.schema.cat_cols) if r != j]
            codes = t.cat_codes[rows].contiguous()
            g = torch.where(obs, t.cat_codes[j], -1).to(torch.int32)
            labels = list(label_keys)
            if args.model == "qda":
                triples = sum_to_triple_grouped(
                    t.num_data, codes, g, schema=fs, num_groups=len(labels))
                params = qda_train(triples, fs, labels=labels,
                                   normalize=args.normalize)
            else:
                aggs = sum_to_nb_agg_grouped(
                    t.num_data, codes, g, schema=fs, num_groups=len(labels))
                params = nb_train(aggs, fs, labels=labels)
            bundle = ModelBundle(
                args.model, params, fs, t.num_names,
                tuple(nm for k, nm in enumerate(t.cat_names) if k != j),
                label, "cat", label_keys, args.normalize, False,
                cat_labels=tuple(lb for k, lb in enumerate(file_labels)
                                 if k != j),
                label_labels=file_labels[j] or ())
    save_model(args.out, bundle)
    print(f"wrote {args.out} ({args.model}, label={label}, "
          f"{len(bundle.params)} params, {int(obs.sum())} training rows)",
          file=sys.stderr)


def cmd_predict(args):
    """Batch prediction from a saved bundle: features by column NAME,
    categories re-encoded against the TRAINING vocabulary (an unseen value
    takes the find_in_array miss: it contributes 0 / probability 0). Rows
    with a missing feature get the table's placeholder: impute first for
    meaningful predictions there."""
    from .models import lda_predict, linreg_predict, nb_predict, qda_predict
    from .models.io import load_model
    from .table.native import read_csv

    b = load_model(args.params)
    t = read_csv(args.csv, device=args.device)
    dev = t.device
    raw_cat = t.cat_values()
    test_labels = t.cat_labels or (None,) * len(t.cat_names)
    blabels = b.cat_labels or (None,) * len(b.cat_names)

    def num_block(names):
        missing = [nm for nm in names if nm not in t.num_names]
        if missing:
            raise SystemExit(f"CSV lacks numeric columns {missing}")
        return t.num_data[[t.num_names.index(nm) for nm in names]]

    def cat_block(names, schema, train_labels):
        """Raw categorical columns re-encoded against the TRAINING vocab;
        string columns (per-FILE sorted-label codes) go through the
        bundle's training dictionary first (an unseen label → the miss
        code, find_in_array, ML/utils.cpp:152-162)."""
        missing = [nm for nm in names if nm not in t.cat_names]
        if missing:
            raise SystemExit(f"CSV lacks categorical columns {missing}")
        cols = []
        for nm, train_lb in zip(names, train_labels):
            jt = t.cat_names.index(nm)
            raw = raw_cat[jt]
            test_lb = test_labels[jt]
            if (train_lb is None) != (test_lb is None):
                raise SystemExit(
                    f"column {nm!r}: trained as "
                    f"{'string' if train_lb is not None else 'integer'}-"
                    f"categorical but the CSV parses it as the other kind")
            if train_lb is not None:
                to_train = {s: i for i, s in enumerate(train_lb)}
                raw = np.asarray([to_train.get(s, -1) for s in test_lb],
                                 np.int64)[raw]
            cols.append(raw)
        codes = schema.encode(np.stack(cols, axis=1)).T
        return torch.tensor(np.ascontiguousarray(codes, np.int32),
                            device=dev)

    if b.model == "linreg":
        x = num_block([nm for nm in b.num_names if nm != b.label_name])
        codes = (cat_block(b.cat_names, b.schema, blabels)
                 if b.cat_names else None)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        pred = linreg_predict(b.params, x, codes, add_noise=args.noise,
                              normalize=b.normalize, generator=gen)
    elif b.model == "lda":
        j = b.cat_names.index(b.label_name)
        other = [nm for k, nm in enumerate(b.cat_names) if k != j]
        codes = (cat_block(other, b.schema.without_cat(j),
                           [lb for k, lb in enumerate(blabels) if k != j])
                 if other else None)
        idx = lda_predict(b.params, num_block(b.num_names), codes,
                          normalize=b.normalize).cpu().numpy()
        # the reference returns the 0-based class INDEX (lda.cpp:575);
        # the CLI writes the label value
        pred = np.asarray(b.label_keys, np.int64)[idx]
    elif b.model == "qda":
        # qda_train drops each column's first category (qda.cpp:47): the
        # codes address the DROP-FIRST vocab, the first category a miss
        codes = (cat_block(b.cat_names, b.schema.drop_first(), blabels)
                 if b.cat_names else None)
        pred = qda_predict(b.params, num_block(b.num_names), codes,
                           normalize=b.normalize)
    else:
        codes = (cat_block(b.cat_names, b.schema, blabels)
                 if b.cat_names else None)
        pred = nb_predict(b.params, num_block(b.num_names), codes)
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else pred

    with open(args.out, "w") as f:
        f.write(f"{b.label_name}_pred\n")
        if b.label_kind == "cat":
            if b.label_labels:
                # a string label column: predictions are training codes
                f.write("\n".join(b.label_labels[int(v)] for v in pred)
                        + "\n")
            else:
                f.write("\n".join(str(int(v)) for v in pred) + "\n")
        else:
            f.write("\n".join(f"{v:.7g}" for v in pred) + "\n")
    print(f"wrote {args.out} ({len(pred)} predictions)", file=sys.stderr)


def _event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of fn() over `reps` calls by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cmd_bench(args):
    """The BASELINE.json configurations (BASELINE.md), timed on the card
    with CUDA events: K1's stacked entry (`masked_gram`) at 4 numeric
    columns (4M rows) and at 4 numeric + 2 categorical of 8 with a weight
    mask (8.4M rows), and the NB sums kernel K6 at 8 numeric + 4
    categorical of 16, 8 groups (8M rows). One JSON object on stdout."""
    from .ring.kernels.sigma_pallas import masked_gram
    from .ring.sum import sum_to_nb_agg_grouped
    from .schema import FeatureSchema

    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("bench times the kernels on a CUDA card; "
                         "none is available here (--device cuda)")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    results = {"device": torch.cuda.get_device_name(device)}

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def record(name, n, fn):
        ms = _event_ms(fn)
        results[name] = {"ms": ms, "rows_per_s": n / (ms * 1e-3)}

    if args.config in ("sum_to_triple_4_0", "all"):
        n = 1_048_576 * 4
        schema = FeatureSchema(num_cols=4)
        x = normal(4, n)
        c = torch.zeros((0, n), dtype=torch.int32, device=device)
        record("sum_to_triple_4_0@4M", n,
               lambda: masked_gram(x, c, None, schema=schema))
    if args.config in ("nb_grouped", "all"):
        n = 1_048_576 * 8
        schema = FeatureSchema(
            num_cols=8, cat_keys=tuple(tuple(range(16)) for _ in range(4)))
        x, c, g = normal(8, n), ints(16, 4, n), ints(8, n)
        record("sum_to_nb_agg_8_4_grouped@8M", n,
               lambda: sum_to_nb_agg_grouped(x, c, g, schema=schema,
                                             num_groups=8, backend="kernel"))
    if args.config in ("sum_to_triple_4_2", "all"):
        n = 5 * 2048 * 819
        schema = FeatureSchema(
            num_cols=4, cat_keys=(tuple(range(8)), tuple(range(8))))
        x, c = normal(4, n), ints(8, 2, n)
        w = (torch.rand(n, generator=gen, device=device) > 0.2).float()
        record("sum_to_triple_4_2_masked@8.4M", n,
               lambda: masked_gram(x, c, w, schema=schema))
    print(json.dumps(results, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="duckdb_imputation_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tables and kernels: cuda "
                         "(the default: the card) or cpu (the plain "
                         "versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("impute", help="MICE-impute a CSV")
    p.add_argument("csv")
    p.add_argument("--out", default="imputed.csv")
    p.add_argument("--mode", choices=MODES, default="low",
                   help="baseline / low / high: the paper's host drivers; "
                        "stream: out-of-core, two streamed read passes "
                        "(the fold on the device) and delta rounds over "
                        "the dirty rows, the file never resident; device: "
                        "the whole loop on the device; fused: the device "
                        "loop over the fused impute+aggregate kernel; "
                        "delta: the device loop's compact O(dirty) rounds")
    p.add_argument("--engine", choices=["host", "device"], default="host",
                   help="stream mode's rounds: host = f64 trainers (GD "
                        "for numeric columns); device = the delta loop on "
                        "the device")
    p.add_argument("--block-mb", type=int, default=64,
                   help="streamed block size in MiB (stream mode)")
    p.add_argument("--dirty-budget-rows", type=int, default=None,
                   help="stream mode: spill the dirty rows to disk past "
                        "this many (bounded host memory at high missing "
                        "rates; the rounds run windowed)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--linreg-iters", type=int, default=10000)
    p.add_argument("--no-noise", action="store_true",
                   help="deterministic regression imputation")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_impute)

    p = sub.add_parser("train", help="train a model from a CSV, save the "
                                     "flat parameter bundle (.npz)")
    p.add_argument("csv")
    p.add_argument("--model", required=True,
                   choices=["linreg", "lda", "qda", "nb"])
    p.add_argument("--label", required=True,
                   help="label column name (numeric for linreg, "
                        "categorical otherwise)")
    p.add_argument("--out", default="model.npz")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--shrinkage", type=float, default=0.001,
                   help="LDA covariance shrinkage")
    p.add_argument("--step-size", type=float, default=0.001)
    p.add_argument("--lam", type=float, default=0.0,
                   help="ridge lambda (linreg)")
    p.add_argument("--max-iters", type=int, default=10000)
    p.add_argument("--variance", action="store_true",
                   help="store the residual std for stochastic prediction")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="batch-predict a CSV from a saved "
                                       "model bundle")
    p.add_argument("csv")
    p.add_argument("--params", required=True, help="bundle from `train`")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--noise", action="store_true",
                   help="stochastic linreg prediction (needs --variance "
                        "at train time)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("bench", help="time the benchmark configurations "
                                     "on the card")
    p.add_argument("--config", default="all", choices=BENCH_CONFIGS)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
