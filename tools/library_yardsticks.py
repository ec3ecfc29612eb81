"""The cuBLAS yardsticks of the kernels that no one PyTorch call computes:
K2/K2w (impute + Gram), K8 (a Gram per group) and K3/K3w (scores +
argmax), at the schemas and rows of PERF.md §6's kernel table, on one GPU.

    python3 tools/library_yardsticks.py [--seed S] [--many]

Each yardstick is the f32 cuBLAS work (TF32 off) of the same function
from its dense operand, as PERF.md §6 defines them:

- K2/K2w: one product (Zᵀ·w) @ Z of the schema's columns, the Gram the
  fused pass aggregates (the imputing step left out): BASELINE config 5
  (P = 21) and favorita_wide (P = 492) at 10M rows, favorita_items (P =
  4,592) on a 1M-row slice (its dense Zᵀ at 10M rows would be 184 GB);
- K8: one product a group over the rows sorted by the label: favorita_
  classify by onpromotion (G = 2, P = 490) and by family (G = 33, P =
  459) at 10M rows, favorita_items by onpromotion (G = 2) and family (G =
  33) on a 1M-row slice;
- K3/K3w: (Z·A_c ⊙ Z) summed over the columns a class, A_c the dense
  f32 form of seeded tables made into the scorer's plan
  (`chip_smoke.made_qda_tables`): config 4 (8 classes, P = 21) and
  favorita_classify's family (33 classes) and onpromotion (2) at 10M
  rows, favorita_items' onpromotion QDA (2 classes) on 1M rows and its
  family NB (33 classes) on 100k rows.

With `--many` it times, in place of those, the yardsticks of the
schemas of PRs 18-21 (PERF.md §6): Home Credit at 10M rows (K2/K2w the
Gram alone, sort + K5/K8 a product a group by TARGET, K3w QDA's forms of
2 classes), SECOM's K3w at 1M rows, and criteo_pair's and zip5's K3w on
a 20k-row slice (their dense Zᵀ at the kernels' 1M rows would take 110
and 135 GB).

The tables are chip_smoke.py's, made on the device from `--seed`. Prints
the card and its power limit, one line a yardstick, and last one JSON
object of all of them (ms, by CUDA events: the mean of 3 calls after one,
or of one call after one for the scorers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--many", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("library_yardsticks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.fp32_precision = "ieee"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    seed, n, out = args.seed, cs.N, {}

    def record(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms:.3f} ms {extra}", flush=True)

    def grouped_ms(x, codes, y, schema, groups):
        order = torch.argsort(y, stable=True)
        zt = cs.dense_block(x[:, order], codes[:, order], schema)
        bounds = torch.bincount(y.long(), minlength=groups).cumsum(0)
        edges = [0] + bounds.tolist()

        def run():
            for g in range(groups):
                part = zt[:, edges[g]:edges[g + 1]]
                torch.mm(part, part.T)
        ms = cs.cuda_ms(run, reps=3, warmup=1)
        del zt
        torch.cuda.empty_cache()
        return ms

    def scorer_ms(x, codes, schema, classes):
        tables, plan = cs.made_qda_tables(schema, classes, seed + 7)
        ms = cs.library_qda_ms(tables, plan, x, schema, codes)
        del tables
        torch.cuda.empty_cache()
        return ms

    if args.many:
        many(cs, seed, n, record, grouped_ms, scorer_ms)
        print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                              yardsticks=out)))
        return 0
    # K2: config 5
    t, _ = cs.make_table(n, seed + 1)
    w = (~t.num_null[1]).float()
    record("k2_config5", cs.library_gram_ms(t.num_data, t.cat_codes, w,
                                            t.schema), rows=n, p=21)
    del t, w
    # K2w: favorita_wide
    t, _ = cs.make_favorita(n, seed + 2)
    w = (~t.cat_null[1]).float()
    record("k2w_favorita_wide", cs.library_gram_ms(
        t.num_data, t.cat_codes, w, t.schema), rows=n, p=492)
    del t, w
    torch.cuda.empty_cache()
    # K8 and K3w: favorita_classify
    for label in ("onpromotion", "family"):
        x, codes, y, schema, classes = cs.make_favorita_classify(
            n, seed + 3, label)
        record(f"k8_favorita_classify_{label}",
               grouped_ms(x, codes, y, schema, classes), rows=n,
               groups=classes, p=schema.sigma_size)
        record(f"k3w_favorita_classify_{label}",
               scorer_ms(x, codes, schema, classes), rows=n,
               classes=classes,
               p=schema.sigma_size)
        del x, codes, y
        torch.cuda.empty_cache()
    # K3: config 4
    x, codes, y, schema = cs.make_classify_table(n, seed + 4)
    record("k3_config4", scorer_ms(x, codes, schema, cs.CLASSES), rows=n,
           classes=cs.CLASSES, p=schema.sigma_size)
    del x, codes, y
    torch.cuda.empty_cache()
    # past P = 1,024: favorita_items on slices
    m = 1_000_000
    t, _ = cs.make_favorita_items(m, seed + 5)
    w = (~t.cat_null[1]).float()
    record("k2w_favorita_items", cs.library_gram_ms(
        t.num_data, t.cat_codes, w, t.schema), rows=m, p=t.schema.sigma_size)
    del t, w
    torch.cuda.empty_cache()
    for label, rows in (("onpromotion", m), ("family", 100_000)):
        x, codes, y, schema, classes = cs.items_classify(m, seed + 6, label)
        record(f"k8_favorita_items_{label}",
               grouped_ms(x, codes, y, schema, classes), rows=m,
               groups=classes, p=schema.sigma_size)
        record(f"k3w_favorita_items_{label}",
               scorer_ms(x[:, :rows].contiguous(),
                         codes[:, :rows].contiguous(), schema, classes),
               rows=rows, classes=classes, p=schema.sigma_size)
        del x, codes, y
        torch.cuda.empty_cache()
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          yardsticks=out)))
    return 0


def many(cs, seed, n, record, grouped_ms, scorer_ms) -> None:
    """The yardsticks of PRs 18-21's schemas (`--many`)."""
    import torch

    from duckdb_imputation_tpu_torch import FeatureSchema

    t, _, _, y = cs.make_home_credit(n, seed + 8)
    w = (~t.num_null[0]).float()
    p = t.schema.sigma_size
    record("k2w_home_credit", cs.library_gram_ms(
        t.num_data, t.cat_codes, w, t.schema), rows=n, p=p)
    ys = torch.where(y >= 0, y, 0).to(torch.int32)
    record("k8_home_credit", grouped_ms(t.num_data, t.cat_codes, ys,
                                        t.schema, 2), rows=n, groups=2, p=p)
    record("k3w_home_credit", scorer_ms(t.num_data, t.cat_codes, t.schema,
                                        2), rows=n, classes=2, p=p)
    del t, y, ys, w
    torch.cuda.empty_cache()
    t, _, _ = cs.make_secom(cs.N_SECOM, seed + 9)
    record("k3w_secom", scorer_ms(t.num_data, t.cat_codes, t.schema, 2),
           rows=cs.N_SECOM, classes=2, p=t.schema.sigma_size)
    del t
    torch.cuda.empty_cache()
    k = 20_000
    pair = cs.make_criteo(k, seed + 10, cs.CRITEO_PAIR)[0]
    record("k3w_criteo_pair", scorer_ms(pair.num_data, pair.cat_codes,
                                        pair.schema, 2), rows=k, classes=2,
           p=pair.schema.sigma_size)
    del pair
    torch.cuda.empty_cache()
    g = torch.Generator(device=cs.DEVICE)
    g.manual_seed(seed + 11)
    zip5 = FeatureSchema(num_cols=4, cat_keys=tuple(
        tuple(range(v)) for v in cs.ZIP5_VOCABS))
    zx = torch.randn((4, k), generator=g, device=cs.DEVICE)
    zc = torch.stack([cs.zipf_codes(k, cs.ZIP5_VOCABS[0], g),
                      torch.randint(0, 5, (k,), generator=g,
                                    device=cs.DEVICE, dtype=torch.int32)])
    record("k3w_zip5", scorer_ms(zx, zc, zip5, 2), rows=k, classes=2,
           p=zip5.sigma_size)


if __name__ == "__main__":
    sys.exit(main())
