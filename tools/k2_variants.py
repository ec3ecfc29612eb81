"""Time design variants of the fused pass K2 and of K2w's impute kernel on
one GPU.

Each variant is a copy of `duckdb_imputation_tpu_torch/` with one change,
made under `build/k2_variants/<name>/` and timed in a process of its own
(each copy builds its own kernels; `tools/k1_variants.py:run`):

- `as_built`: the kernels of the checkout;
- `tc_no_score`: the prologue imputes class 0 without scoring (wrong
  codes): what the scoring of the 'cat' step costs;
- `tc_stage_unchecked`: K2's prologue copies the aligned word of every
  row's null byte, with no test for the rows whose word leaves the tensor
  (wrong only where the mask does not start or end on a word): what that
  test costs;
- `tc_min_blocks_1`: K2's tensor-core kernels at `__launch_bounds__`'s
  one block an SM, against five (the 'cat' kernel then takes more
  registers and fewer blocks);
- `imp_rows_1`, `imp_rows_2`, `imp_rows_8`: a warp of K2w's 'cat' impute
  kernel scores 1, 2 or 8 rows at once, against 4;
- `imp_threads_512`: 512 threads a block (16 rows a thread a compaction
  step), against 1,024 (8);
- `imp_two_blocks`: 512 threads a block and half of shared memory, so
  that two blocks share an SM and one's tile loads overlap the other's
  scoring (one buffer of 32 classes, ~600 null rows a batch);
- `imp_no_score`: no row scored (wrong codes): what the compaction, the
  staging of the terms and the class tiles cost alone;
- `imp_no_merge`: each tile's scores not reduced over the warp (wrong
  codes): what the reductions and the running first max cost;
- `imp_no_cat_terms`: the categorical terms not added (wrong codes): what
  their shared-memory reads of W cost.

Times (CUDA events, mean of 10 calls after a warm-up, 5 for K2w), the
tables of `tools/k2_times.py`: K1, K2 'cat' and 'num' at BASELINE config 5,
10M rows; K2w 'cat' at favorita_wide, R = 33 and R = 337, 10M rows, and
its impute kernel alone (less K7 over the updated columns, timed in the
same process). Each line also holds ptxas's registers and spills of K1's
and K2's tensor-core kernels and of the impute kernel.

    python3 tools/k2_variants.py [--variants a,b]

Run from the root of a checkout on a machine with a CUDA device; prints
the card and its power limit, then one JSON line per variant.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from k1_variants import card, patched, run  # noqa: E402

PKG = "duckdb_imputation_tpu_torch"
CU = "csrc/fused_impute_aggregate.cu"


def imp_rows(k: int):
    return ("constexpr int kImpRows = 4; ", f"constexpr int kImpRows = {k}; ")


TC_NO_SCORE = ("        val = argmax_raw(rb, R, ld(), Ws, bs, cols);",
               "        val = 0;")
IMP_NO_SCORE = ("      for (int e0 = warp * kImpRows; e0 < count;",
                "      for (int e0 = warp * kImpRows; e0 < 0;")
TC_STAGE_UNCHECKED = ("    if (valid && (row < lo || row >= hi)) {",
                      "    if (false) {")
TC_MIN_BLOCKS_1 = ("  static constexpr int kMinBlocks = 5;",
                   "  static constexpr int kMinBlocks = 1;")
IMP_NO_MERGE = ('''          const uint32_t top = __reduce_max_sync(0xffffffffu, key);
          const uint32_t first = __reduce_min_sync(
              0xffffffffu, key == top ? uint32_t(cls) : 0xffffffffu);''',
                '''          const uint32_t top = key;
          const uint32_t first = cls;''')
IMP_NO_CAT_TERMS = ("        int j = cx;\n        for (; j + 4 <= cx + c; j += 4) {",
                    "        int j = cx + c;\n        for (; j + 4 <= cx + c; j += 4) {")
IMP_512 = (("constexpr int kImpThreads = 1024; ",
            "constexpr int kImpThreads = 512; "),
           ("constexpr int kFillRows = 8; ", "constexpr int kFillRows = 16; "))
IMP_512_PY = (("IMP_THREADS = 1024 ", "IMP_THREADS = 512 "),
              ("IMP_FILL_ROWS = 8 ", "IMP_FILL_ROWS = 16 "))

IMP_HALF_SMEM = ("        batch = min(cap, (WIDE_SMEM - fixed)",
                 "        batch = min(cap, (WIDE_SMEM // 2 - 1024 - fixed)")

TIMER = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from duckdb_imputation_tpu_torch.mice.device_round import _lda_device, _w_full
from duckdb_imputation_tpu_torch.mice.partition import init_fill
from duckdb_imputation_tpu_torch.models.device import linreg_solve_device
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols)
log = _build.load().log.splitlines()
out = {"variant": sys.argv[1]}
for key, name in (("ptxas_k1", "masked_gram_cu_"),
                  ("ptxas_tc_cat", "TcImputeILi0E"),
                  ("ptxas_tc_num", "TcImputeILi1E"),
                  ("ptxas_imp_m1", "impute_cat_tiles_kernelILi1E"),
                  ("ptxas_imp_m2", "impute_cat_tiles_kernelILi2E")):
    at = next(i for i, line in enumerate(log) if name in line
              and "Compiling" in line and (key != "ptxas_k1"
                                           or "tc_gram_kernel" in line))
    out[key] = " ".join(log[at + 2:at + 4])
t = init_fill(cs.make_table(cs.N, 0)[0])
xs, c = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
w_c0, w_x1 = (~t.cat_null[0]).float(), (~t.num_null[1]).float()
w, icpt, keep = _lda_device(masked_gram_cols(xs, c, w_c0, schema=t.schema),
                            t.schema, 0, 0.001)
cat = (xs, c, t.cat_null[0], w_x1, _w_full(w, keep, t.schema), icpt)
coeff = linreg_solve_device(masked_gram_cols(xs, c, w_x1, schema=t.schema),
                            label=2)
theta = coeff.clone()
theta[2] = 0.0
num = (xs, c, t.num_null[1], w_c0, theta[:, None], theta.new_zeros(1))
out["k1"] = cs.cuda_ms(lambda: masked_gram_cols(xs, c, w_c0,
                                               schema=t.schema))
out["k2_cat"] = cs.cuda_ms(lambda: fused_impute_aggregate(
    *cat, schema=t.schema, kind="cat", imp_col=0))
out["k2_num"] = cs.cuda_ms(lambda: fused_impute_aggregate(
    *num, schema=t.schema, kind="num", imp_col=1))
del t, xs, c, cat, num
torch.cuda.empty_cache()
t = init_fill(cs.make_favorita(cs.N, 13)[0])
xs, c = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
gen = torch.Generator(device="cuda")
gen.manual_seed(14)
null_cls = torch.rand(cs.N, generator=gen, device="cuda") < 0.2
w_tx = (~t.num_null[1]).float()
for name, col, null in (("r33", 1, t.cat_null[1]), ("r337", 2, null_cls)):
    w, icpt, keep = _lda_device(masked_gram_cols(xs, c, (~null).float(),
                                                 schema=t.schema),
                                t.schema, col, 0.001)
    cat = (xs, c, null, w_tx, _w_full(w, keep, t.schema), icpt)
    new, _ = fused_impute_aggregate(*cat, schema=t.schema, kind="cat",
                                    imp_col=col)
    upd = list(c)
    upd[col] = new
    k7 = cs.cuda_ms(lambda: masked_gram_cols(xs, upd, w_tx, schema=t.schema),
                    reps=5)
    k2w = cs.cuda_ms(lambda: fused_impute_aggregate(
        *cat, schema=t.schema, kind="cat", imp_col=col), reps=5)
    out[f"k2w_{name}"] = k2w
    out[f"impute_{name}"] = k2w - k7
print(json.dumps(out))
'''


def variants() -> dict[str, dict[str, str]]:
    """name → {file under the package: its text}."""
    cu = (ROOT / PKG / CU).read_text()
    build = (ROOT / PKG / "ring/kernels/_build.py").read_text()
    return {
        "as_built": {},
        "tc_no_score": {CU: patched(cu, TC_NO_SCORE)},
        "imp_rows_1": {CU: patched(cu, imp_rows(1))},
        "imp_rows_2": {CU: patched(cu, imp_rows(2))},
        "imp_rows_8": {CU: patched(cu, imp_rows(8))},
        "imp_threads_512": {CU: patched(cu, *IMP_512),
                            "ring/kernels/_build.py": patched(build,
                                                              *IMP_512_PY)},
        "imp_no_score": {CU: patched(cu, IMP_NO_SCORE)},
        "imp_two_blocks": {CU: patched(cu, *IMP_512),
                           "ring/kernels/_build.py": patched(
                               build, *IMP_512_PY, IMP_HALF_SMEM)},
        "tc_min_blocks_1": {CU: patched(cu, TC_MIN_BLOCKS_1)},
        "tc_stage_unchecked": {CU: patched(cu, TC_STAGE_UNCHECKED)},
        "imp_no_merge": {CU: patched(cu, IMP_NO_MERGE)},
        "imp_no_cat_terms": {CU: patched(cu, IMP_NO_CAT_TERMS)},
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
