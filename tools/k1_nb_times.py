"""Time K1 and the NB sums kernel of one checkout on one GPU, for a
comparison of two commits in one call (parent, change, change, parent).

    python3 tools/k1_nb_times.py [--root DIR] [--tag NAME]

`--root` is the root of the checkout whose `duckdb_imputation_tpu_torch`
is timed (default: this one); its kernels build under its own `build/`.
The tables are those of this checkout's `chip_smoke.py`, 10M rows:
`masked_gram_cols` (binary weights) at BASELINE config 5 (P = 21, K1 on
the tensor cores), at P = 17 (8 numeric columns, one categorical column of
8), P = 37 (4 numeric, four categorical columns of 8) and P = 88 (24
numeric columns, three categorical columns of 21), K1 on the CUDA cores;
the NB sums (weights None) at BASELINE config 3 with G = 5 and G = 100 and at
favorita_classify, labels family (G = 33, F = 462) and onpromotion (G =
2, F = 493). Prints the card and its power limit, then one JSON line:
ms per call (CUDA events, mean of 10 after a warm-up) and NB launches a
call.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs            # this checkout's tables and timer
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    print(cs.phase_device(), flush=True)
    out = {"tag": args.tag, "root": str(Path(args.root).name)}
    t, _ = cs.make_table(cs.N, 0)
    xs, c = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    w = (torch.rand(cs.N, generator=g, device="cuda") >= 0.2).float()
    out["k1_p21"] = cs.cuda_ms(lambda: masked_gram_cols(xs, c, w,
                                                        schema=t.schema))
    del t, xs, c
    # (name, d, vocabularies): schemas past the tensor cores' one tile
    for name, d, sizes in (("k1_p17_d8", 8, (8,)), ("k1_p37", 4, (8,) * 4),
                           ("k1_p88", 24, (21,) * 3)):
        schema = FeatureSchema(num_cols=d, cat_keys=tuple(
            tuple(range(v)) for v in sizes))
        xk = list(torch.randn((d, cs.N), generator=g,
                              device="cuda").unbind(0))
        ck = list(torch.stack([torch.randint(0, v, (cs.N,), generator=g,
                                             device="cuda", dtype=torch.int32)
                               for v in sizes]).unbind(0))
        out[name] = cs.cuda_ms(lambda: masked_gram_cols(xk, ck, w,
                                                        schema=schema),
                               reps=5)
        del xk, ck
    x, codes, y, schema = cs.make_classify_table(cs.N, 2, num_cols=8,
                                                 cat_cols=4, classes=5,
                                                 hot=None)
    g100 = torch.randint(0, 100, (cs.N,), generator=g, device="cuda",
                         dtype=torch.int32)
    cases = [("nb_g5", x, codes, y, schema, 5),
             ("nb_g100", x, codes, g100, schema, 100)]
    for label in ("family", "onpromotion"):
        xf, cf, yf, sf, classes = cs.make_favorita_classify(cs.N, 23, label)
        cases.append((f"nb_{label}", xf, cf, yf, sf, classes))
    for name, x, codes, y, schema, groups in cases:
        kw = dict(schema=schema, num_groups=groups)
        before = (nb_grouped_sums.launches
                  + getattr(nb_grouped_sums, "wide_launches", 0))
        nb_grouped_sums(x, codes, None, y, **kw)
        torch.cuda.synchronize()
        out[name + "_launches"] = (nb_grouped_sums.launches + getattr(
            nb_grouped_sums, "wide_launches", 0) - before)
        out[name] = cs.cuda_ms(lambda: nb_grouped_sums(x, codes, None, y,
                                                       **kw))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
