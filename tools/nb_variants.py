"""Time design variants of the NB sums kernel (K6, K6w) on one GPU.

Each variant is a copy of `duckdb_imputation_tpu_torch/` with one change,
made under `build/nb_variants/<name>/` and timed in a process of its own
(tools/k1_variants.py: `run`):

- `as_built`: the kernel of the checkout (csrc/nb_grouped_sums.cu; D cut
  into slabs of the count of terms `_build._nb_layout` costs least, tasks
  of 8,192 f64 cells);
- `d_terms_1`, `d_terms_4`, `d_terms_all`: D cut into slabs of one term,
  of four, or not cut;
- `one_chunk`: a warp takes one chunk of 32 rows at a time, not two;
- `count_body`: the K_j counts by shared-memory f64 atomic adds of 1.0
  (exact in any order: right for weights None only, as timed here) in
  place of the keyed sums;
- `budget_2048`, `budget_4096`: tasks of at most 2,048 or 4,096 cells;
- `blocks_528`, `blocks_2048`: about so many blocks over the tasks,
  against 1,024;
- `stage_128`: 128 rows staged a step, against 256;
- `no_slabs`: nothing summed (wrong sums): what the staging costs;
- `no_match`: every lane taken as a peer of every other (wrong sums):
  what `__match_any_sync` costs.

Times (CUDA events, mean of 10 calls after a warm-up), weights None, 10M
rows, the tables of `chip_smoke.py`: BASELINE config 3 (8 numeric, 4
categorical columns of 8) at G = 5 and G = 100, favorita_classify at
label family (G = 33, F = 462) and onpromotion (G = 2, F = 493); each
result also held against the plain version (counts equal, max error of
the x and x² sums relative to their max).

    python3 tools/nb_variants.py [--variants a,b]

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, then one JSON line per variant.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from k1_variants import PKG, ROOT, card, patched, run  # noqa: E402

CU = "csrc/nb_grouped_sums.cu"
CUH = "csrc/wide_gram.cuh"
PY = "ring/kernels/nb_pallas.py"
BUILD = "ring/kernels/_build.py"

ONE_CHUNK = ("      const bool pair = k + 1 < nsub;",
             "      const bool pair = false;")  # the loop steps by 1 then
COUNT_BODY = (
    "          add_keyed(t,\n"
    "                    in0 && v0 >= ulo && v0 < uhi ? (g0 - glo) * vw + v0 - ulo\n"
    "                                                 : -1,\n"
    "                    in1 && v1 >= ulo && v1 < uhi ? (g1 - glo) * vw + v1 - ulo\n"
    "                                                 : -1,\n"
    "                    1, rows0, rows1, R, lane);",
    "          if (in0 && v0 >= ulo && v0 < uhi)\n"
    "            atomicAdd(t + (g0 - glo) * vw + v0 - ulo, 1.0);\n"
    "          if (in1 && v1 >= ulo && v1 < uhi)\n"
    "            atomicAdd(t + (g1 - glo) * vw + v1 - ulo, 1.0);")


NO_SLABS = ("      for (int s = s0; s < s1; ++s) {",
            "      for (int s = s0; s < s1 && k < 0; ++s) {")
STAGE_128 = ("    rows = next(r for r in (256, 128, 64, 32) if wide_smem_bytes(\n"
             "        max_cells, max_cols, max_slabs, r) <= WIDE_SMEM)\n"
             "    return NbPlan(",
             "    rows = next(r for r in (128, 64, 32) if wide_smem_bytes(\n"
             "        max_cells, max_cols, max_slabs, r) <= WIDE_SMEM)\n"
             "    return NbPlan(")
NO_MATCH = ("__match_any_sync(0xffffffffu, key0)", "0xffffffffu + 0 * key0")
NO_MATCH1 = ("__match_any_sync(0xffffffffu, key1)", "0xffffffffu + 0 * key1")


def blocks(k: int):
    return ("    slices = plan.slices(n)\n",
            f"    slices = max(1, min(-(-n // 32), -(-{k} // plan.num_tasks)))\n")


def d_terms(k: int):
    return ("WIDE_TASK_BYTES // 8, d_terms: int = 0) -> NbPlan:",
            f"WIDE_TASK_BYTES // 8, d_terms: int = {k}) -> NbPlan:")


def budget(cells: int):
    return ("             cap: int = WIDE_TASK_BYTES // 8, d_terms",
            f"             cap: int = {cells}, d_terms")


TIMER = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
    nb_grouped_sums, nb_grouped_sums_plain)
log = _build.load().log.splitlines()
at = next(i for i, line in enumerate(log) if "nb_kernel" in line)
out = {"variant": sys.argv[1], "ptxas": " ".join(log[at + 1:at + 4])}
x, c, y, schema = cs.make_classify_table(cs.N, 2, num_cols=8, cat_cols=4,
                                         classes=5, hot=None)
g100 = torch.randint(0, 100, (cs.N,), device="cuda", dtype=torch.int32)
cases = [("config3_G5", x, c, y, schema, 5),
         ("config3_G100", x, c, g100, schema, 100)]
for label in ("family", "onpromotion"):
    xf, cf, yf, sf, classes = cs.make_favorita_classify(cs.N, 23, label)
    cases.append((label, xf, cf, yf, sf, classes))
for name, x, c, y, schema, groups in cases:
    kw = dict(schema=schema, num_groups=groups)
    got = nb_grouped_sums(x, c, None, y, **kw)
    want = nb_grouped_sums_plain(x, c, None, y, **kw)
    d = schema.num_cols
    cnt = torch.cat([got[:, :1] == want[:, :1],
                     got[:, 1 + 2 * d:] == want[:, 1 + 2 * d:]], 1)
    out[name] = dict(
        ms=cs.cuda_ms(lambda: nb_grouped_sums(x, c, None, y, **kw)),
        counts_exact=bool(cnt.all()),
        err=cs.rel_err(got[:, 1:1 + 2 * d], want[:, 1:1 + 2 * d]),
        tasks=_build.nb_plan(schema, groups).num_tasks)
print(json.dumps(out))
'''


def variants() -> dict[str, dict[str, str]]:
    cu = (ROOT / PKG / CU).read_text()
    py = (ROOT / PKG / PY).read_text()
    cuh = (ROOT / PKG / CUH).read_text()
    build = (ROOT / PKG / BUILD).read_text()
    return {
        "as_built": {},
        "d_terms_1": {BUILD: patched(build, d_terms(1))},
        "d_terms_4": {BUILD: patched(build, d_terms(4))},
        "d_terms_all": {BUILD: patched(build, d_terms(129))},
        "one_chunk": {CU: patched(cu, ONE_CHUNK)},
        "count_body": {CU: patched(cu, COUNT_BODY)},
        "budget_2048": {BUILD: patched(build, budget(2048))},
        "budget_4096": {BUILD: patched(build, budget(4096))},
        "blocks_528": {PY: patched(py, blocks(528))},
        "blocks_2048": {PY: patched(py, blocks(2048))},
        "stage_128": {BUILD: patched(build, STAGE_128)},
        "no_slabs": {CU: patched(cu, NO_SLABS)},
        "no_match": {CU: patched(cu, NO_MATCH, NO_MATCH1),
                     CUH: patched(cuh, NO_MATCH, NO_MATCH1)},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    texts = variants()
    names = args.variants.split(",") if args.variants else list(texts)
    print(card(), flush=True)
    return run(names, texts, TIMER, [])


if __name__ == "__main__":
    sys.exit(main())
