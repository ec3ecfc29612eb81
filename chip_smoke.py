"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the paths of `duckdb_imputation_tpu_torch` ported so far:

- the MICE loop, `run_mice_device`, unfused over the masked-Gram kernel
  (K1) and fused over the fused impute+aggregate kernel (K2, on K1's
  tensor-core kernel with an impute prologue; `[K2]` also holds its
  CUDA-core route at P = 88), at the
  schema of BASELINE.md config 5 (4 numeric columns, two categorical
  columns of 8: P = 21) and 10M rows, then one fused round at the
  deployment scale of 100M rows;
- the classifier path at BASELINE config 4 (the same schema, 8 classes,
  90% in class 0) and 10M rows: GROUP BY label aggregation
  (`sum_to_triple_grouped` over the unsorted grouped Gram K4, a group
  order of the labels and K5's kernel through it, or a sort and the
  sorted-slab Gram K5 above K4's group limit, both on K1's tensor-core
  body at this schema; `sum_to_nb_agg_grouped`
  over the NB sums K6), device training, and one-pass scoring (K3: QDA's
  and NB's quadratic forms over each row's nonzero pairs);
- MICE on a wide schema and the delta loop: `favorita_wide` (the Kaggle
  Corporacion Favorita schema, 3 numeric and 9 categorical columns,
  P = 492, made on the device with the dataset's hierarchy) at 10M rows,
  where the masked Gram is the wide kernel K7 and the fused pass K2w
  (`[K7]`, `[K2w]`, `[wide]`: `run_mice_device`, unfused and fused); then
  `run_mice_device_delta` at config 5 with 1%, 5% and 20% nulls and at
  `favorita_wide` with 5%, each against `run_mice_device` (`[delta]`);
- the classifier path at wide schemas, `favorita_classify`: the
  favorita_wide table with no nulls, one categorical column taken as the
  label, at 10M rows. Label onpromotion (2 classes, P = 490) and label
  family (33 classes, P = 459): the grouped Gram is the wide kernel K8
  (after a sort), the NB sums K6w, QDA scoring K3w, the scoring kernel
  over a plan of several tasks (`[K8]`, `[K6w]`, `[K3w]`,
  `[classify_wide]`: QDA and NB pipelines for both labels);
- the paper's host MICE algorithms, `run_mice_baseline`, `run_mice_low`
  and `run_mice_high` (full rescan, full − delta, static + delta; f64
  host trainers, predictions on the card), whose every aggregate is K1's
  stacked entry point `masked_gram` at config 5, 10M rows (`[host_mice]`),
  and K7 behind it for `run_mice_low` at favorita_wide
  (`[host_mice_wide]`);
- the GD trainer on the card (`trainer='gd'`) in `run_mice_device` and
  `run_mice_device_delta` at config 5, and in `run_mice_device` at
  favorita_wide, each against the solve trainer on the same table
  (`[gd]`);
- factorized learning over joins on `favorita_star`, the Favorita tables
  normalized as published (fact train: unit_sales, onpromotion, the keys
  store_nbr and item_nbr; stores: 54 rows; items: 4,100 rows) at 10M fact
  rows: `run_mice_factorized` over fact ⋈ items (the items aggregated per
  key once, a sort and K8; each column step a sort and K5 of the fact rows
  by item, then the f64 contraction over the keys; `[factorized]`) and
  `run_mice_star` over fact ⋈ stores ⋈ items (each column step one K1 of
  the fact columns and one K6 a dimension; `[star]`), each join's train
  triple against the materialized join's K7 triple, with quality gates,
  exact launch counts and the card against the CPU at 200k rows; K5 and
  K8 alone at its 4,100 keys;
- the row-sharded loops over torch.distributed: `run_mice_sharded`
  ('gram', 'fused', 'fused' with noise) and `run_mice_sharded_delta` on a
  world of one over NCCL at config 5 and favorita_wide, N rows, each
  bit-identical to `run_mice_device` / `run_mice_device_delta`, with the
  sharded aggregates (`[sharded]`); two ranks on gloo over CUDA tensors,
  spawned as processes sharing the card, each with half of the config-5
  table, against the world of one (`[sharded2]`); a checkpointed run
  killed after 2 rounds and resumed to 4 at 1M rows, bit-identical to 4
  straight, and a resume of another run refused (`[checkpoint]`). `[K3]`
  also scores naive Bayes's centred tables at the variance case of
  ROADMAP Queue 3 against the host predictor;
- the out-of-core path: the streaming fold of the extended Gram (one
  `masked_gram` call a chunk, K7 here) and `run_mice_stream`'s two
  engines on favorita_wide at N rows served from host arrays, against
  the in-core drivers (`[stream]`); a 17M-row config-5 CSV written by the
  native formatter under build/stream/, imputed by `impute_csv_stream`
  and read back by the native reader (`[stream_csv]`); the dirty rows
  spilled to disk and the windowed rounds (`[stream_spill]`); a stream
  checkpoint resumed bit-identically (`[stream_ckpt]`);
- the wide-V path past P = 1,024, on `favorita_items` (favorita_wide's
  columns and item_nbr's 4,100 items: P = 4,592) and `wide16k` (two
  columns of 8,192 levels, tests/test_wide.py's width: P = 16,387) at
  10M rows: K7 over column windows (`masked_gram_window`; `masked_gram`
  assembles S from windows of 1,024; a keyed column's tables walk only
  their keys' rows of the columns ordered once a call, `window_order`)
  against its plain version, each window's keyed tasks, work items and
  rows read, the order kernels against theirs, a hot-key window (one
  item on half the rows), and favorita_wide's windows against K7's one
  launch (`[K7win]`);
  `run_mice_device` at favorita_items, K7 a window a column step and the
  SVD solves (`[items]`); `run_mice_wide` on a 1 × 1 grid (the
  column-sharded CG solves against an f64 dense solve) and
  `sigma_striped` at wide16k (`[wide_v]`); two gloo ranks sharing the
  card as a 1 × 2 grid, sigma's columns split, against the 1 × 1 grid,
  each rank's sigma memory measured (`[wide_v2]`);
- the SQL front end (`sql.connect(device=...)`, numpy on the host, the
  aggregates and predictors on the card): the reference's MICE statement
  sequence, one round, at config 5, 1M rows, against
  api.run_MICE_baseline and api.sum_to_triple, one K1 launch an
  aggregate statement, each statement's wall time (`[sql]`); the
  reference's QDA and NB flows (a GROUP BY label list aggregate, train
  over the text literals, the accuracy as one SQL AVG) at config 4, 1M
  rows, K1 or K6 once a class, the GROUP BY key pass timed against the
  JAX module's tuple loop (`[sql_classify]`);
- the overlapped sharded aggregate, `sum_to_triple_overlapped` (4 column
  stripes, a K7 window launch and an asynchronous all-reduce each),
  against `sum_to_triple_sharded` on a world of one over NCCL at
  favorita_wide and favorita_items, and on two gloo ranks sharing the
  card (`[overlap]`);
- K2w, K8 and K3/K3w past P = 1,024 at favorita_items, 10M rows: the fused
  pass (its impute kernel with W read from device memory, then K7 a
  window of 1,024) imputing family and transactions (`[K2w_items]`), K8 a
  window at labels onpromotion (G = 2) and family (G = 33)
  (`[K8win]`), K3w on naive Bayes's plan (33 classes) and on QDA's cross
  plan (2 classes), seeded tables (`[K3items]`), each against its plain
  version; `run_mice_device(kernel='fused')` on `[items]`' table against
  its 'gram' run (`[items_fused]`); `run_mice_sharded` with its defaults
  on a world of one over NCCL, bit-identical to it (`[sharded_items]`);
  the NB pipeline at label family and the QDA pipeline at label
  onpromotion through the entry points (`[classify_items]`);
- schemas past 64 numeric and 64 categorical columns, made on the device
  from the seed (a rank-8 factor model): the narrow route at d = 80 (P =
  81) and d = 70 with two columns of 8 levels (P = 87), 2M rows: K1, K2,
  sort + K5, K4, K6 and K3 against their plain versions (`[narrow80]`,
  `[narrow70]`); the Home Credit schema (Kaggle "Home Credit Default
  Risk", application_train.csv: 104 numeric and 16 categorical columns, P
  = 245; `[home_credit]`): the plans' host seconds, K7, K2w ('num' past
  the 88 columns a kernel parameter holds, 'cat'), sort + K8, K6w and K3w
  against their plain versions at 10M rows, then at the file's 307,511
  rows run_mice_device 'gram' and 'fused' and run_mice_device_delta (2
  rounds over its 67 null columns, launches exact, imputed numerics
  below a mean fill's error, codes above the mode share + 0.02),
  scan_gram and run_mice_stream ('device') from host arrays (the fold's
  c + K = 83), the QDA and NB pipelines on TARGET (launches exact,
  accuracy above the majority share + 0.02), and the card against the
  CPU at 20k rows; UCI SECOM (590 numeric columns, P = 591; `[secom]`):
  the kernels at 1M rows (K3w's plain version on the rows its memory
  allows), the classifiers on pass/fail at 1M rows, the fold of the
  file's 1,567 rows (590 one-level null flags, P + K = 1,181: K7's
  windows, card against CPU) and run_mice_stream ('device');
- schemas past the shared-memory column limits (K_j cut by column range in
  K7 and K8, the scorer's local plans, K2w's impute kernel reading x from
  device memory, the order pass copying wide rows in pieces): Epsilon
  (the PASCAL 2008 `epsilon` set as LIBSVM gives it: 2,000 dense
  columns of unit-norm rows, a binary label; MICE with the label as a
  column, P = 2,003; `[epsilon]`) at its 400,000 training
  rows: the plans' host seconds, K7, K2w ('cat' on the label, 'num'),
  sort + K8, K6w and K3w (QDA and NB) against their plain versions on a
  slice, each timed at all rows beside its bound and the cuBLAS product
  of the same work; on 100,000 of its rows run_mice_device 'gram' and 'fused' and
  run_mice_wide (one round, quality gates) and the QDA and NB pipelines;
  scan_gram card against CPU;
  MNIST's 784 pixels over 10 classes at 70,000 rows (`[mnist]`): K3w on
  the local plans and the QDA and NB pipelines; and two test schemas at
  1M rows (`[past_smem]`): d900_r33 (K7's whole plan with KB slabs, K2w
  'cat' at R = 33 with x read from device memory) and d1000_v5000 (the
  order pass of a 5,000-level column over rows of 1,008 ints, K7's six
  windows);
- D, the dense block of [1 ‖ x] in S, on the tensor cores past the
  crossover in d (`_build.dense_route`: the D kernel, csrc/dense_gram.cu,
  the nine bf16 part products of K1's split in 64 × 64 tiles), under K7,
  K8 and K2w's Gram: the D kernel alone against its plain version at
  Epsilon (`[epsilon]`), SECOM (`[secom]`), Home Credit
  (`[home_credit]`), d900_r33 and d1000_v5000 (`[past_smem]`) and, over
  the rows sorted by digit, K8's D at MNIST (10 groups, `[mnist]`), each
  timed at the phase's rows beside its bound (nine bf16 products on the
  tensor cores; the f32 bound beside) and one cuBLAS product; the
  wrappers' launches read exactly (K7 and K8 launch only where their
  plans have a task, `wide_launches`; the D kernel once a Gram);
- IEEE f32 whatever the caller set (`[tf32]`): run_mice_device 'gram'
  and 'fused' at config 5 with TF32 turned on by the caller, bit for bit
  as under the default setting; and P past 46,340 (`[criteo]` at
  criteo_c18, Criteo's Kaggle schema with C18: P = 47,412, 47 windows):
  the windows' plans, a pass over S, three windows, sort + K8, K2w,
  scan_gram and run_mice_wide.

First it builds the kernels from `duckdb_imputation_tpu_torch/csrc/` and
holds each against its plain torch version at the shapes its path gives
it (K6 at config 3: 8 numeric and 4 categorical columns, 5 labels). K1's
stacked entry point, `masked_gram`, is driven through `sum_to_triple`, the
ungrouped aggregate, on the config-4 table.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Prints one line per phase, then a JSON
line of per-kernel results (`launches` from the run of each kernel's
path; for K1 and K7 also `delta_launches`, from the delta runs alone,
and `gd_launches`, from the GD runs; for K1's stacked entry and K7
`host_launches`, from the host MICE runs; `factorized_launches` on K4, K5
and K8 and `star_launches` on K1's stacked entry, K6 and K7, from the
run_mice_factorized and run_mice_star runs; `sharded_launches` on
K1, its stacked entry, K2, K4, K5, K7 and K2w, from the `[sharded]`
runs; `g4100` on K5 and K8, each timed alone at 4,100 groups; `nb_centred`
on K3, the variance case; `stream_launches` on K1, its stacked entry
and K7, from the out-of-core phases; on K7 `items_launches` (the
`[items]` run); `wide_gram_window` (K7 over windows past P = 1,024:
`launches` and `order_passes` of `[items]`, `wide_v_launches`
(run_mice_wide in `[wide_v]`), `window_launches` (`[wide_v]`'s stripes),
`overlap_launches` (`[overlap]`'s world-1 stripes), `[K7win]`'s times of
a favorita_items pass and of each window with their records and bounds,
`wide16k` and `hot_key` beside) and `window_order` (the order kernels:
`launches` a keyed column in `[items]`, against their plain version);
`sql_launches` on K1's stacked entry and K6,
from `[sql]` and `[sql_classify]`; the routes past P = 1,024 as entries
of their own: `fused_impute_aggregate_window` (`launches`: its impute
kernel's in `[items_fused]`, `window_launches` its K7 windows there,
`sharded_launches` from `[sharded_items]`), `grouped_wide_gram_window`
and `qda_predict_items` (`launches` from `[classify_items]`), with the
numbers of `[K2w_items]`, `[K8win]` and `[K3items]`; `narrow80` and
`narrow70c2` on K1-K6 and K3, `home_credit` and `secom` on K7 (with the
plans' seconds), K2w, K8, K6w and K3w, `secom_fold` on the window kernel;
`epsilon`, `mnist`, `d900_r33` and `d1000_v5000` on the kernels of those
phases (K7's whole plan and windows, the order, K2w's both routes, K8,
K6w and K3w with the pipelines' launches); `dense_gram` (the D kernel:
`launches` from `[epsilon]`'s run_mice_device 'gram' and 'fused', its
numbers at Epsilon, and `home_credit`, `secom`, `d900_r33`,
`d1000_v5000` and `mnist_k8` beside);
`bound_ms`, the least time the card could take for the kernel's work,
computed from this run's shapes with `bound`; `library_ms`, one PyTorch
call computing the same function, where there is one), then the card's
name and power limit, then the device as the last line. Any failed check
raises and ends the run with a nonzero exit; so does a machine without a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N = 10_000_000
N_RAGGED = N + 12_345
N_DEPLOY = 100_000_000
ROUNDS = 3
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of fn() over `reps` calls, by CUDA events, after warmup."""
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


def make_table(n: int, seed: int, *, noise_fixture: bool = False,
               null_frac: float = 0.2):
    """The BASELINE config-5 table, made on the device from `seed`: x1 is
    linear in x0 and x2 (x1 = 3·x0 + x2; with noise_fixture, x1 = 2·x0 +
    0.5·eps), c0 is predictable from x0, `null_frac` MCAR nulls in numeric
    column 1 and categorical column 0. Returns (table, true x1)."""
    from duckdb_imputation_tpu_torch import FeatureSchema, Table

    dev = DEVICE
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn():
        return torch.randn(n, generator=g, device=dev)

    z0, z1 = randn(), randn()
    if noise_fixture:
        x = torch.stack([z0, 2 * z0 + 0.5 * z1, randn(), randn()])
    else:
        x = torch.stack([z0, 2 * z0 + z1, z1 - z0, randn()])
    c0 = torch.clamp(z0 + 4.0, 0, 7).to(torch.int32)
    c1 = torch.randint(0, 8, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    codes = torch.stack([c0, c1])
    num_null = torch.zeros((4, n), dtype=torch.bool, device=dev)
    cat_null = torch.zeros((2, n), dtype=torch.bool, device=dev)
    num_null[1] = torch.rand(n, generator=g, device=dev) < null_frac
    cat_null[0] = torch.rand(n, generator=g, device=dev) < null_frac
    truth = x[1].clone()
    x = torch.where(num_null, 0.0, x)
    codes = torch.where(cat_null, 0, codes)
    schema = FeatureSchema(num_cols=4,
                           cat_keys=(tuple(range(8)), tuple(range(8))))
    return Table(num_data=x, cat_codes=codes, num_null=num_null,
                 cat_null=cat_null, schema=schema), truth


def phase_device() -> str:
    """Logs the versions and the card; returns nvidia-smi's name and power
    limit line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count "
        f"{torch.cuda.device_count()}")
    log(card)
    return card


def phase_build():
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[build] {lib.path.name} nvcc {lib.build_seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")


def count_entries(schema):
    """Mask of the sigma entries that are integer counts: N, the one-hot
    counts and the one-hot cross counts."""
    p, d = schema.sigma_size, schema.num_cols
    m = torch.zeros((p, p), dtype=torch.bool, device=DEVICE)
    m[0, 0] = True
    m[0, 1 + d:] = True
    m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# Bounds and library yardsticks of the kernels line
# ---------------------------------------------------------------------------

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W
# limit): HBM bytes a second, f32 FLOP/s on the CUDA cores, and dense bf16
# FLOP/s on the tensor cores, where D (the dense block of [1 ‖ x]) runs
# past the crossover as nine bf16 products of each value's three parts
# (csrc/dense_gram.cu).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
SPLIT_PRODUCTS = 9       # bf16 part products a multiply-add of f32 values


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> dict:
    """bound_ms: the least time the card could take for work that must
    move `nbytes` (each input read once, each output written once) and do
    `flops` f32 operations (a multiply-add is 2) on the CUDA cores and
    `tc_flops` bf16 operations on the tensor cores, the larger of the
    bytes' time and the operations'; bound_by names which. With
    `tc_flops`, also f32_bound_ms: the same work all in f32 (D's products
    as one f32 multiply-add each, not nine bf16), chip_smoke's bound
    before D left the CUDA cores."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_F32 + tc_flops / PEAK_BF16) * 1e3
    out = dict(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if tc_flops:
        f32 = (flops + tc_flops / SPLIT_PRODUCTS) / PEAK_F32 * 1e3
        out["f32_bound_ms"] = max(t_bytes, f32)
    return out


def dense_bound(n_weighted: int, n: int, d: int, groups: int = 1) -> dict:
    """The D kernel's bound: x and w read once (4·(1 + d) bytes a row),
    f32[G, 1 + d, 1 + d] written once; the upper triangle's (1+d)(2+d)/2
    multiply-adds for each of the `n_weighted` rows of w ≠ 0, nine bf16
    products each on the tensor cores (`bound`'s f32_bound_ms beside:
    one f32 multiply-add each). The kernel is held to the tensor-core
    bound."""
    m = 1 + d
    fma = n_weighted * m * (m + 1) // 2
    return bound(4 * m * n + 4 * groups * m * m, 0.0,
                 2 * SPLIT_PRODUCTS * fma)


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi (clocks.max.sm, MHz)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def row_bytes(schema, extra: int = 0) -> int:
    """Bytes a row of x f32 and codes i32 takes, plus `extra`."""
    return 4 * schema.num_cols + 4 * schema.cat_cols + extra


def gram_bound(codes, schema, weights=None, groups: int = 1,
               extra: int = 4, scores: int = 0, scored=None) -> dict:
    """A (grouped) masked Gram over the rows of codes i32[c, n]: x, codes
    and `extra` bytes a row (the weights; + group ids) read once, f32[G, P,
    P] written once. Zᵀ·diag(w)·Z is a sparse product: a row's z has
    k = 1 + d + (its codes in range) nonzeros, so the rows with w ≠ 0
    need k(k+1)/2 multiply-adds each (the upper triangle), not P(P+1)/2.
    Plus `scores` multiply-adds for each of `scored` rows (a fused pass
    scoring its null rows; all n when None). Past the crossover
    (`_build.dense_route`) D's (1+d)(2+d)/2 of them are nine bf16
    products each on the tensor cores, the rest f32 (`bound`)."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    d, n = schema.num_cols, codes.shape[-1]
    k = 1 + d + sum(((codes[j] >= 0) & (codes[j] < size)).long()
                    for j, size in enumerate(schema.cat_sizes))
    fma = k * (k + 1) // 2
    if weights is not None:
        fma = torch.where(weights != 0, fma, 0)
    fma = int(fma.sum()) + (n if scored is None else scored) * scores
    nbytes = (n * row_bytes(schema, extra) + groups * schema.sigma_size
              * schema.sigma_size * 4)
    if schema.sigma_size > _build.MAX_SIGMA_SIZE and _build.dense_route(d):
        # D's multiply-adds on the tensor cores, nine bf16 products each
        rows = n if weights is None else int(weights.count_nonzero())
        dense = rows * (1 + d) * (2 + d) // 2
        return bound(nbytes, 2 * (fma - dense),
                     2 * SPLIT_PRODUCTS * dense)
    return bound(nbytes, 2 * fma)


def nb_bound(n: int, schema, groups: int) -> dict:
    """NB sums: x, codes, weights and ids read once, f32[G, F] written
    once; 1 + 3d + c operations a row (count, x, x², one-hots)."""
    f = 1 + 2 * schema.num_cols + schema.vocab_size
    return bound(n * row_bytes(schema, 8) + groups * f * 4,
                 n * (1 + 3 * schema.num_cols + schema.cat_cols))


def qda_bound(codes, schema, classes: int, tables: int) -> dict:
    """QDA scoring over the rows of codes i32[c, n]: x and codes read,
    i32[n] written, the tables f32[C, cells] (`tables` bytes) read once;
    C multiply-adds for each of a row's cells, the pairs of its nonzeros
    in the plan: (1+d)(2+d)/2 of [1 ‖ x], 1 + d for each in-range code, 1
    for each pair of in-range codes. Counted at the f32 rate (the kernel
    adds in f64, at half of it)."""
    d, n = schema.num_cols, codes.shape[-1]
    hits = sum((((codes[j] >= 0) & (codes[j] < size)).long()
                for j, size in enumerate(schema.cat_sizes)),
               torch.zeros(n, dtype=torch.long, device=codes.device))
    cells = (1 + d) * (2 + d) // 2 + (1 + d) * hits + hits * (hits - 1) // 2
    return bound(n * row_bytes(schema, 4) + tables,
                 2 * classes * int(cells.sum()))


def dense_block(x, codes, schema, squares: bool = False):
    """Zᵀ = [1 ‖ x ‖ onehot(codes)] f32[P, n] in device memory, or with
    `squares` the NB features [1 ‖ x ‖ x² ‖ onehot] f32[F, n]; a code
    outside [0, size) sets nothing. The dense operand of a library call."""
    d, n = schema.num_cols, codes.shape[-1]
    base = 1 + (2 if squares else 1) * d
    zt = torch.zeros((base + schema.vocab_size, n), device=DEVICE)
    zt[0] = 1.0
    zt[1:1 + d] = x
    if squares:
        zt[1 + d:base] = x * x
    rows = torch.arange(n, device=DEVICE)
    for j, (off, size) in enumerate(zip(schema.offsets, schema.cat_sizes)):
        ok = (codes[j] >= 0) & (codes[j] < size)
        zt[base + off + codes[j][ok].long(), rows[ok]] = 1.0
    return zt


def library_gram_ms(x, codes, w, schema) -> float:
    """ms of one cuBLAS f32 product (Zᵀ·w) @ Z, the masked Gram from its
    dense operand (TF32 off)."""
    zt = dense_block(x, codes, schema)
    zw = zt * w
    ms = cuda_ms(lambda: torch.mm(zw, zt.T), reps=3, warmup=1)
    del zt, zw
    torch.cuda.empty_cache()
    return ms


def library_nb_ms(x, codes, w, ids, schema, groups: int) -> float:
    """ms of one cuBLAS f32 product F @ Wᵀ, the grouped NB sums from the
    dense features and W[g, r] = w_r·[id_r = g] (TF32 off)."""
    ft = dense_block(x, codes, schema, squares=True)
    wm = (ids[None] == torch.arange(groups, device=DEVICE)[:, None]).float()
    if w is not None:
        wm = wm * w
    ms = cuda_ms(lambda: torch.mm(ft, wm.T), reps=3, warmup=1)
    del ft, wm
    torch.cuda.empty_cache()
    return ms


def wide_launches(schema) -> int:
    """K7's (and K8's) launches a call of the schema's Gram: one where its
    plan has a task, past P = 1,024 one a window whose plans have one.
    Past the crossover (`_build.dense_route`) D is the D kernel's, once a
    call (`dense_launches`), and a schema of no categorical column leaves
    K7 no task."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    p = schema.sigma_size
    if p <= _build.MAX_WIDE_SIGMA_SIZE:
        return int(_build.wide_plan(schema).num_tasks > 0)
    return sum(any(pl is not None and pl.num_tasks
                   for pl in _build.keyed_window_plan(
                       schema, lo, min(lo + _build.WINDOW_WIDTH, p)))
               for lo in range(0, p, _build.WINDOW_WIDTH))


def dense_launches(schema) -> int:
    """The D kernel's launches a call of a wide schema's Gram (K7, K8 or
    K2w's): one past the crossover, else none."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    return int(schema.sigma_size > _build.MAX_SIGMA_SIZE
               and _build.dense_route(schema.num_cols))


N_DENSE_PLAIN = 1_000_000   # most rows the D kernel's plain version takes
                            # (its f64 copies of [1 ‖ x] and w·[1 ‖ x])


def dense_compare(tag):
    """The D kernel's output against its plain version's, f32[P, P] or
    f32[G, P, P]: each S exactly symmetric and finite, D[0, 0] (Σw, binary
    weights) exact, within 1e-5 of max|σ|."""
    def compare(got, want):
        g, wt = (got, want) if got.dim() == 3 else (got[None], want[None])
        check(torch.equal(g, g.transpose(1, 2)), f"{tag}: not symmetric")
        check(torch.isfinite(g).all(), f"{tag}: not finite")
        check(torch.equal(g[:, 0, 0], wt[:, 0, 0]),
              f"{tag}: the counts differ from the plain version")
        err = float((g - wt).abs().max())
        scale = float(wt.abs().max())
        check(err <= 1e-5 * scale, f"{tag}: max abs err {err} > 1e-5 of "
              f"max|σ| {scale}")
        return err
    return compare


def dense_kernel(tag: str, xs, w, schema, offsets=None,
                 rows: int | None = None) -> dict:
    """The D kernel alone (`dense_gram`: csrc/dense_gram.cu) at a phase's
    shapes against its plain version (`dense_gram_plain`, f64 sums of the
    same products) on its first `rows` rows (all by default; with
    `offsets`, all of them): one launch a call, a rerun bit-identical;
    timed at all rows beside its bound (nine bf16 products on the tensor
    cores; the f32 bound beside) and one cuBLAS f32 product (Zᵀ·w) @ Z of
    [1 ‖ x] (TF32 off), over every group's rows together where grouped."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, dense_gram_plain)

    xs = list(xs)
    n, d = w.shape[0], schema.num_cols
    k = n if rows is None or offsets is not None else min(rows, n)
    sx, sw = [x[:k] for x in xs], w[:k]
    kw = dict(schema=schema, offsets=offsets)
    zt = torch.cat([torch.ones((1, n), device=DEVICE), torch.stack(xs)])
    zw = zt * w
    library_ms = cuda_ms(lambda: torch.mm(zw, zt.T), reps=3, warmup=1)
    del zt, zw
    torch.cuda.empty_cache()
    groups = 1 if offsets is None else offsets.shape[0] - 1
    res = slice_kernel(
        f"{tag} D kernel (d = {d}, {groups} group(s)) n={n}",
        [(dense_gram, "launches", 1)],
        lambda: dense_gram(sx, sw, **kw),
        lambda: dense_gram_plain(sx, sw, **kw),
        dense_compare(f"{tag} D kernel"),
        dense_bound(int(w.count_nonzero()), n, d, groups), library_ms,
        full=lambda: dense_gram(xs, w, **kw))
    log(f"{tag} D kernel: f32 bound {res['f32_bound_ms']:.4f} ms beside the "
        f"tensor cores' {res['bound_ms']:.4f} ms, which it is held to")
    res.update(rows=n, plain_rows=k)
    return res


def phase_k1(seed: int) -> dict:
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_cols_plain)

    t, _ = make_table(N_RAGGED, seed)
    schema = t.schema
    x_cols = list(t.num_data.unbind(0))
    codes = t.cat_codes.clone()
    codes[0, :1000] = 8          # out of vocab: the encode() miss code
    codes[1, 1000:2000] = -1     # negative: contributes nothing either
    code_cols = list(codes.unbind(0))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    w = (torch.rand(N_RAGGED, generator=g, device=DEVICE) >= 0.2).float()
    counts = count_entries(schema)
    out = {}
    for n in (N, N_RAGGED):
        xs = [c[:n] for c in x_cols]
        cs = [c[:n] for c in code_cols]
        got = masked_gram_cols(xs, cs, w[:n], schema=schema)
        again = masked_gram_cols(xs, cs, w[:n], schema=schema)
        want = masked_gram_cols_plain(xs, cs, w[:n], schema=schema)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all(), "K1 sigma not finite")
        check(torch.equal(got, again), "K1 repeated run not bit-identical")
        check(torch.equal(got[counts], want[counts]),
              "K1 counts differ from the plain version")
        check(float(got[0, 0]) == float(w[:n].sum()), "K1 sigma[0,0] != Σw")
        err = rel_err(got, want)
        check(err <= 1e-5, f"K1 max rel error {err:.3e} > 1e-5")
        ms = cuda_ms(lambda: masked_gram_cols(xs, cs, w[:n], schema=schema))
        plain_ms = cuda_ms(
            lambda: masked_gram_cols_plain(xs, cs, w[:n], schema=schema),
            reps=3, warmup=1)
        log(f"[K1] n={n}: counts exact, max rel err {err:.3e} (of max|σ|),"
            f" max abs err {float((got - want).abs().max()):.3e}, "
            f"bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if n == N:
            out = dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                       plain_ms=plain_ms,
                       **gram_bound(torch.stack(cs), schema, w[:n]),
                       library_ms=library_gram_ms(
                           torch.stack(xs), torch.stack(cs), w[:n], schema))
    log(f"[K1] n={N}: bound {out['bound_ms']:.4f} ms ({out['bound_by']}), "
        f"library (Zᵀw)@Z {out['library_ms']:.4f} ms")
    out["p88"] = k1_near_limit(seed)
    return out


def k1_near_limit(seed: int) -> dict:
    """K1 at a schema near its limit with many numerics, P = 88 (24 numeric
    columns, three categorical columns of 21: past the tensor cores' one
    output tile, so K1's CUDA-core route), 10M rows, binary then general
    weights: the gates of [K1]; kernel, plain, bound and library times of
    the binary run."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_cols_plain)

    schema = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 30)
    xs = list((torch.randn((24, N), generator=g, device=DEVICE) * 2 + 0.5)
              .unbind(0))
    cs = list(torch.randint(-1, 22, (3, N), generator=g, device=DEVICE,
                            dtype=torch.int32).unbind(0))
    w_gen = torch.rand(N, generator=g, device=DEVICE)
    out = {}
    check(not _build.tc_fits(24, 88), "K1 P=88 is not on its CUDA-core route")
    for name, w in (("binary", (w_gen >= 0.2).float()), ("general", w_gen)):
        binary = name == "binary"
        got = masked_gram_cols(xs, cs, w, schema=schema)
        again = masked_gram_cols(xs, cs, w, schema=schema)
        want = masked_gram_cols_plain(xs, cs, w, schema=schema)
        torch.cuda.synchronize()
        err = check_gram(f"K1 P=88 {name}", got, again, want, schema, binary)
        if binary:
            check(float(got[0, 0]) == float(w.sum()), "K1 P=88 sigma[0,0] != Σw")
        ms = cuda_ms(lambda: masked_gram_cols(xs, cs, w, schema=schema),
                     reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: masked_gram_cols_plain(xs, cs, w,
                                                          schema=schema),
                           reps=2, warmup=1)
        abs_err = float((got - want).abs().max())
        log(f"[K1] n={N} P=88 d=24 (CUDA cores) {name} "
            f"weights: " + ("counts exact, " if binary else "")
            + f"max rel err {err:.3e} (of max|σ|), max abs err {abs_err:.3e},"
            f" bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if binary:
            out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       **gram_bound(torch.stack(cs), schema, w),
                       library_ms=library_gram_ms(torch.stack(xs),
                                                  torch.stack(cs), w, schema))
    log(f"[K1] n={N} P=88: bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}), library (Zᵀw)@Z {out['library_ms']:.4f} ms")
    return out


def phase_k1_stacked(seed: int) -> dict:
    """K1's stacked entry point, `masked_gram`, driven through the entry
    point a user calls, `sum_to_triple`, on the config-4 table at 10M rows
    (some codes out of vocab), with binary, then general weights; held
    against `masked_gram_plain`. Counts its launches around those two
    calls alone."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_plain)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    x, codes, _, schema = make_classify_table(N, seed + 6)
    codes[0, :1000] = 8          # out of vocab: the encode() miss code
    codes[1, 1000:2000] = -1
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 7)
    w_gen = torch.rand(N, generator=gen, device=DEVICE)
    w_bin = (w_gen >= 0.2).float()
    weights = (("binary", w_bin), ("general", w_gen))

    def triple_sigma(w):
        return sigma_from_triple(sum_to_triple(x, codes, w, schema=schema))

    torch.cuda.synchronize()
    masked_gram.launches = 0
    got = {name: triple_sigma(w) for name, w in weights}
    torch.cuda.synchronize()
    launches = masked_gram.launches
    log(f"[K1s] sum_to_triple n={N} P={schema.sigma_size} (binary, then "
        f"general weights): masked_gram launches {launches}")
    check(launches == 2, f"sum_to_triple launched masked_gram {launches} "
          f"times, not 2")
    counts = count_entries(schema)
    out = {}
    for name, w in weights:
        again = triple_sigma(w)
        want = masked_gram_plain(x, codes, w, schema=schema)
        torch.cuda.synchronize()
        g = got[name]
        check(torch.isfinite(g).all(), "K1s sigma not finite")
        check(torch.equal(g, again), "K1s repeated run not bit-identical")
        if name == "binary":
            check(torch.equal(g[counts], want[counts]),
                  "K1s counts differ from the plain version")
            check(float(g[0, 0]) == float(w.sum()), "K1s sigma[0,0] != Σw")
        err = rel_err(g, want)
        check(err <= 1e-5, f"K1s {name} max rel error {err:.3e} > 1e-5")
        ms = cuda_ms(lambda: masked_gram(x, codes, w, schema=schema))
        plain_ms = cuda_ms(lambda: masked_gram_plain(x, codes, w,
                                                     schema=schema),
                           reps=3, warmup=1)
        abs_err = float((g - want).abs().max())
        log(f"[K1s] n={N} {name} weights: "
            + ("counts exact, " if name == "binary" else "")
            + f"max rel err {err:.3e} (of max|σ|), max abs err {abs_err:.3e},"
            f" bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if name == "binary":
            out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       **gram_bound(codes, schema, w),
                       library_ms=library_gram_ms(x, codes, w, schema))
    del x, codes, w_gen, w_bin, got

    # near K1's limit: P = 88 (24 numeric, three categorical columns of 21)
    # through sum_to_triple, general weights
    from duckdb_imputation_tpu_torch import FeatureSchema
    s88 = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    x = torch.randn((24, N), generator=gen, device=DEVICE) + 1.0
    codes = torch.randint(0, 21, (3, N), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    w = torch.rand(N, generator=gen, device=DEVICE)
    before = masked_gram.launches
    got = sigma_from_triple(sum_to_triple(x, codes, w, schema=s88))
    again = sigma_from_triple(sum_to_triple(x, codes, w, schema=s88))
    want = masked_gram_plain(x, codes, w, schema=s88)
    torch.cuda.synchronize()
    check(masked_gram.launches == before + 2, "K1s P=88 was not launched")
    err = check_gram("K1s P=88 general", got, again, want, s88, False)
    ms = cuda_ms(lambda: masked_gram(x, codes, w, schema=s88), reps=5,
                 warmup=1)
    plain_ms = cuda_ms(lambda: masked_gram_plain(x, codes, w, schema=s88),
                       reps=2, warmup=1)
    b88 = gram_bound(codes, s88, w)
    lib_ms = library_gram_ms(x, codes, w, s88)
    log(f"[K1s] n={N} P=88 general weights: max rel err {err:.3e} (of "
        f"max|σ|), max abs err {float((got - want).abs().max()):.3e}, "
        f"bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b88['bound_ms']:.4f} ms ({b88['bound_by']}), library "
        f"{lib_ms:.4f} ms")
    out["p88_general"] = dict(max_abs_err=float((got - want).abs().max()),
                              ms=ms, plain_ms=plain_ms, **b88,
                              library_ms=lib_ms)
    return out, launches


def phase_k2(seed: int) -> dict:
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t = init_fill(make_table(N, seed)[0])
    schema = t.schema
    route = ("tensor cores" if _build.tc_fits(schema.num_cols,
                                              schema.sigma_size)
             else "CUDA cores")
    x_cols = list(t.num_data.unbind(0))
    code_cols = list(t.cat_codes.unbind(0))
    w_c0 = (~t.cat_null[0]).float()
    w_x1 = (~t.num_null[1]).float()

    sig = masked_gram_cols(x_cols, code_cols, w_c0, schema=schema)
    w, icpt, keep = _lda_device(sig, schema, 0, 0.001)
    cat_args = (x_cols, code_cols, t.cat_null[0], w_x1,
                _w_full(w, keep, schema), icpt)
    cat_kw = dict(schema=schema, kind="cat", imp_col=0)
    new_k, sig_k = fused_impute_aggregate(*cat_args, **cat_kw)
    new_p, sig_p = fused_impute_aggregate_plain(*cat_args, **cat_kw)
    torch.cuda.synchronize()
    agree = float((new_k == new_p).float().mean())
    err = rel_err(sig_k, sig_p)
    abs_err = float((sig_k - sig_p).abs().max())
    check(agree >= 0.9999, f"K2 cat code agreement {agree}")
    check(err <= 1e-5, f"K2 cat sigma rel err {err:.3e} > 1e-5")
    ms = cuda_ms(lambda: fused_impute_aggregate(*cat_args, **cat_kw))
    plain_ms = cuda_ms(lambda: fused_impute_aggregate_plain(*cat_args,
                                                            **cat_kw),
                       reps=3, warmup=1)
    # mask byte and weights read, the new column written: 9 bytes a row
    k2_bound = gram_bound(t.cat_codes, schema, w_x1, extra=9,
                          scores=8 * (1 + 4 + 2),
                          scored=int(t.cat_null[0].sum()))
    log(f"[K2] cat step n={N} P={schema.sigma_size} ({route}): code "
        f"agreement {agree:.6f}, sigma max rel "
        f"err {err:.3e}, max abs err {abs_err:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {k2_bound['bound_ms']:.4f} ms "
        f"({k2_bound['bound_by']})")

    sig_x = masked_gram_cols(x_cols, code_cols, w_x1, schema=schema)
    coeff = linreg_solve_device(sig_x, label=2)
    theta = coeff.clone()
    theta[2] = 0.0
    std = _noise_std(coeff, sig_x)
    num_ms = {}
    for noise in (None, (seed, 0, std)):
        num_args = (x_cols, code_cols, t.num_null[1], w_c0, theta[:, None],
                    theta.new_zeros(1))
        num_kw = dict(schema=schema, kind="num", imp_col=1, noise=noise)
        nk, sk = fused_impute_aggregate(*num_args, **num_kw)
        np_, sp = fused_impute_aggregate_plain(*num_args, **num_kw)
        torch.cuda.synchronize()
        dx = float((nk - np_).abs().max())
        e = rel_err(sk, sp)
        check(torch.isfinite(nk).all(), "K2 num column not finite")
        check(dx <= 1e-4, f"K2 num max|Δx| {dx:.3e} > 1e-4")
        check(e <= 1e-5, f"K2 num sigma rel err {e:.3e} > 1e-5")
        k_ms = cuda_ms(lambda: fused_impute_aggregate(*num_args, **num_kw))
        num_ms[f"noise={noise is not None}"] = k_ms
        log(f"[K2] num step n={N} noise={noise is not None} ({route}): "
            f"max|Δx| {dx:.3e}, sigma max rel err {e:.3e}; kernel "
            f"{k_ms:.4f} ms")
    # no single PyTorch call imputes and aggregates in one pass
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **k2_bound,
                library_ms=None, k2_route=route, num_ms=num_ms,
                p88=k2_near_limit(seed))


def k2_near_limit(seed: int) -> dict:
    """K2 at the P = 88 schema of K1's near-limit case (24 numeric
    columns, three categorical columns of 21: past the tensor cores' one
    output tile, so K2's CUDA-core route), 10M rows, 20% nulls, random
    coefficients, a 'cat' then a 'num' step: the gates of [K2], kernel,
    plain and bound times of the 'cat' step."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)

    schema = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    check(not _build.tc_fits(24, 88), "K2 P=88 is not on its CUDA-core route")
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 31)
    xs = list(torch.randn((24, N), generator=g, device=DEVICE).unbind(0))
    cs = list(torch.randint(-1, 22, (3, N), generator=g, device=DEVICE,
                            dtype=torch.int32).unbind(0))
    null = torch.rand(N, generator=g, device=DEVICE) < 0.2
    w = (torch.rand(N, generator=g, device=DEVICE) >= 0.2).float()
    out = {}
    for kind, col, r in (("cat", 0, 21), ("num", 1, 1)):
        args = (xs, cs, null, w,
                torch.randn((88, r), generator=g, device=DEVICE),
                torch.randn(r, generator=g, device=DEVICE))
        kw = dict(schema=schema, kind=kind, imp_col=col)
        before = fused_impute_aggregate.launches
        new_k, sig_k = fused_impute_aggregate(*args, **kw)
        new_a, sig_a = fused_impute_aggregate(*args, **kw)
        new_p, sig_p = fused_impute_aggregate_plain(*args, **kw)
        torch.cuda.synchronize()
        check(fused_impute_aggregate.launches == before + 2,
              "K2 P=88 was not launched")
        check(torch.equal(new_k, new_a) and torch.equal(sig_k, sig_a),
              "K2 P=88 repeated run not bit-identical")
        err = rel_err(sig_k, sig_p)
        check(err <= 1e-5, f"K2 P=88 {kind} sigma rel err {err:.3e} > 1e-5")
        if kind == "cat":
            agree = float((new_k == new_p).float().mean())
            check(agree >= 0.9999, f"K2 P=88 cat code agreement {agree}")
            what = f"code agreement {agree:.6f}"
        else:
            dx = float((new_k - new_p).abs().max())
            check(dx <= 1e-4, f"K2 P=88 num max|Δx| {dx:.3e} > 1e-4")
            what = f"max|Δx| {dx:.3e}"
        ms = cuda_ms(lambda: fused_impute_aggregate(*args, **kw), reps=5,
                     warmup=1)
        plain_ms = cuda_ms(lambda: fused_impute_aggregate_plain(*args, **kw),
                           reps=2, warmup=1)
        b = gram_bound(torch.stack(cs), schema, w, extra=9,
                       scores=r * (1 + 24 + 3), scored=int(null.sum()))
        log(f"[K2] {kind} step n={N} P=88 d=24 (CUDA cores): {what}, sigma "
            f"max rel err {err:.3e}, bit-identical rerun; kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        out[kind] = dict(max_abs_err=float((sig_k - sig_p).abs().max()),
                         ms=ms, plain_ms=plain_ms, **b, library_ms=None)
    return out


def phase_reference(seed: int) -> None:
    """The fused loop on the card against the plain loop on the CPU at a
    small size."""
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.table import Table

    t, _ = make_table(200_000, seed)
    cpu = Table(*(a.cpu() for a in (t.num_data, t.cat_codes, t.num_null,
                                    t.cat_null)), schema=t.schema)
    ref = run_mice_device(cpu, iters=2, kernel="plain")
    got = run_mice_device(t, iters=2, kernel="fused")
    m = t.cat_null[0].cpu()
    agree = float((got.cat_codes[0].cpu() == ref.cat_codes[0])[m]
                  .float().mean())
    dx = float((got.num_data.cpu() - ref.num_data).abs().max())
    check(agree >= 0.999 and dx < 1e-2,
          f"fused (GPU) vs plain (CPU): agreement {agree}, x diff {dx}")
    log(f"[reference] n=200000 fused on the card vs plain on the CPU: "
        f"code agreement {agree:.6f}, x max diff {dx:.3e}")


def phase_main_path(seed: int) -> dict:
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t, truth = make_table(N, seed)
    torch.cuda.synchronize()
    masked_gram_cols.launches = 0
    fused_impute_aggregate.launches = 0
    unf = run_mice_device(t, iters=ROUNDS, kernel="gram")
    fus = run_mice_device(t, iters=ROUNDS, kernel="fused")
    torch.cuda.synchronize()
    launches = {"masked_gram_cols": masked_gram_cols.launches,
                "fused_impute_aggregate": fused_impute_aggregate.launches}
    log(f"[main] run_mice_device n={N} rounds={ROUNDS} (gram, then fused): "
        f"launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")

    for name, out in (("gram", unf), ("fused", fus)):
        check(out.num_data.shape == t.num_data.shape
              and out.cat_codes.shape == t.cat_codes.shape, "shape")
        check(torch.isfinite(out.num_data).all(), f"{name}: x not finite")
        check(torch.equal(out.num_data[0], t.num_data[0]),
              f"{name}: observed column changed")
    m = t.cat_null[0]
    agree = float((fus.cat_codes[0] == unf.cat_codes[0])[m].float().mean())
    dx = float((fus.num_data[1] - unf.num_data[1]).abs().max())
    nm = t.num_null[1]
    rmse = {k: float(((o.num_data[1] - truth)[nm] ** 2).mean().sqrt())
            for k, o in (("gram", unf), ("fused", fus))}
    check(agree >= 0.999, f"fused vs unfused code agreement {agree}")
    check(dx < 1e-2, f"fused vs unfused x max diff {dx}")
    check(max(rmse.values()) < 0.05, f"imputed x1 RMSE {rmse}")
    log(f"[main] fused vs unfused: code agreement {agree:.6f}, x max diff "
        f"{dx:.3e}; RMSE of imputed x1 vs truth {rmse}")

    f = init_fill(t)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("gram", lambda k: mice_loop_device(*args, iters=k,
                                                kernel="gram", **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=3, warmup=1)
        four = cuda_ms(lambda: loop(4), reps=3, warmup=1)
        per_round[name] = (four - one) / 3
    log(f"[main] ms per round at n={N} (slope of 1 vs 4 rounds, CUDA "
        f"events): {per_round}")
    return launches


N_TF32 = 1_000_000   # rows of [tf32]'s config-5 table


def phase_tf32(seed: int) -> dict:
    """[tf32]: with TF32 turned on by the caller, first by
    torch.set_float32_matmul_precision("high"), then by
    torch.backends.cuda.matmul.fp32_precision = "tf32", run_mice_device
    'gram' and 'fused' (noise on) at config 5 over N_TF32 rows give the
    default setting's outputs bit for bit (the port's f32 products run
    under `utils.precision.ieee_f32`), the caller's setting reads back
    unchanged after them, and a product outside the port does take TF32
    there."""
    from duckdb_imputation_tpu_torch.mice.device_round import run_mice_device

    t, _ = make_table(N_TF32, seed + 31)
    matmul = torch.backends.cuda.matmul
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 32)
    a = torch.randn(1024, 1024, device=DEVICE, generator=g)
    ieee = a @ a

    def runs():
        return [run_mice_device(t, iters=2, kernel=k, noise=True)
                for k in ("gram", "fused")]

    want = runs()
    out = {}
    for way, turn_on in (
            ("set_float32_matmul_precision_high",
             lambda: torch.set_float32_matmul_precision("high")),
            ("fp32_precision_tf32",
             lambda: setattr(matmul, "fp32_precision", "tf32"))):
        turn_on()
        before = matmul.fp32_precision
        tf32_outside = not torch.equal(a @ a, ieee)
        got = runs()
        kept = matmul.fp32_precision == before
        torch.set_float32_matmul_precision("highest")
        check(tf32_outside, f"[tf32] {way}: TF32 is not on outside the port")
        check(kept, f"[tf32] {way}: the caller's setting changed")
        for k, gt, wt in zip(("gram", "fused"), got, want):
            check(torch.equal(gt.num_data, wt.num_data)
                  and torch.equal(gt.cat_codes, wt.cat_codes),
                  f"[tf32] {way}: run_mice_device '{k}' differs from the "
                  f"default setting's")
        out[way] = dict(bit_identical=True, setting_kept=True)
    log(f"[tf32] config 5 n={N_TF32}: run_mice_device 'gram' and 'fused' "
        f"bit-identical to the default setting under {sorted(out)}; the "
        f"caller's setting kept")
    return out


def phase_noise(seed: int) -> None:
    from duckdb_imputation_tpu_torch import run_mice_device

    t, _ = make_table(N, seed, noise_fixture=True)
    kw = dict(iters=2, kernel="fused")
    xn = run_mice_device(t, **kw).num_data
    xa = run_mice_device(t, noise=True, seed=seed, **kw).num_data
    xb = run_mice_device(t, noise=True, seed=seed, **kw).num_data
    xc = run_mice_device(t, noise=True, seed=seed + 7, **kw).num_data
    m = t.num_null[1]
    check(torch.equal(xa, xb), "same-seed noise not deterministic")
    check(not torch.equal(xa[1][m], xc[1][m]), "seed has no effect")
    d = (xa[1] - xn[1])[m].double()
    z = d / d.std().clamp(min=1e-9)
    std, mean = float(d.std()), float(d.mean())
    skew, kurt = float((z ** 3).mean()), float((z ** 4).mean())
    # the residual std of the x1 model is 0.5 (x1 = 2·x0 + 0.5·eps)
    check(0.4 < std < 0.6, f"noise std {std}")
    check(abs(mean) < 0.01, f"noise mean {mean}")
    check(abs(skew) < 0.1, f"noise skew {skew}")
    check(abs(kurt - 3.0) < 0.2, f"noise kurtosis {kurt}")
    log(f"[noise] fused n={N}: std {std:.4f}, mean {mean:.2e}, skew "
        f"{skew:.4f}, kurtosis {kurt:.4f}; same seed equal, other seed "
        f"differs")


def phase_deploy(seed: int) -> None:
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_cols_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, sort_by_group)

    t, truth = make_table(N_DEPLOY, seed)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_mice_device(t, iters=1, kernel="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nm = t.num_null[1]
    rmse = float(((out.num_data[1] - truth)[nm] ** 2).mean().sqrt())
    check(torch.isfinite(out.num_data).all(), "100M: x not finite")
    check(rmse < 0.05, f"100M: imputed x1 RMSE {rmse}")
    del out

    # counts past 2**24 rows: K1 rounds the exact count to f32 once
    obs = ~t.num_null[1]
    sig = masked_gram_cols(list(t.num_data.unbind(0)),
                           list(t.cat_codes.unbind(0)), obs.float(),
                           schema=t.schema)
    exact = torch.cat([obs.sum().reshape(1), torch.bincount(
        t.cat_codes[1][obs].long(), minlength=8)]).double().float()
    got = torch.cat([sig[0, :1], sig[0, 1 + 4 + 8:]])
    check(torch.equal(got, exact), f"100M: K1 counts {got} != {exact}")
    k1_err = rel_err(sig, masked_gram_cols_plain(
        list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0)), obs.float(),
        schema=t.schema))
    check(k1_err <= 1e-5, f"100M: K1 max rel error {k1_err:.3e} > 1e-5")

    # the grouped kernels' counts past 2**24 rows in one group (~25M and
    # ~75M rows): N and column 0's one-hot counts, rounded once to f32
    grp = (t.cat_codes[1] >= 2).to(torch.int32)
    exact = torch.bincount(grp.long() * 8 + t.cat_codes[0].long(),
                           minlength=16).view(2, 8).double()
    exact = torch.cat([exact.sum(1, keepdim=True), exact], 1).float()
    x, c = t.num_data, t.cat_codes
    kw = dict(schema=t.schema, num_groups=2)
    torch.cuda.synchronize()
    before_k4 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s4 = grouped_gram(x, c, None, grp, **kw)
    torch.cuda.synchronize()
    k4_peak = torch.cuda.max_memory_allocated()
    s5 = grouped_gram_presorted(*sort_by_group(x, c, grp, **kw),
                                schema=t.schema)
    nb = nb_grouped_sums(x, c, None, grp, **kw)
    for name, got in (("K4", s4[:, 0, [0] + list(range(5, 13))]),
                      ("K5", s5[:, 0, [0] + list(range(5, 13))]),
                      ("K6", nb[:, [0] + list(range(9, 17))])):
        check(torch.equal(got, exact),
              f"100M: {name} counts {got.tolist()} != {exact.tolist()}")
    del s4, s5, nb
    f = init_fill(t)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("gram", lambda k: mice_loop_device(*args, iters=k,
                                                kernel="gram", **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=2, warmup=1)
        three = cuda_ms(lambda: loop(3), reps=2, warmup=1)
        per_round[name] = (three - one) / 2
    log(f"[deploy] n={N_DEPLOY}: one fused run_mice_device round {wall:.3f}"
        f" s wall (init fill included), RMSE {rmse:.3e}; K1, K4, K5 and K6"
        f" counts equal the exact counts rounded once to f32, K1 max rel err "
        f"{k1_err:.3e} (of max|σ|); table resident "
        f"{resident / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; K4's "
        f"call (G = 2): {before_k4 / 2**30:.2f} GiB before it, peak "
        f"{k4_peak / 2**30:.2f} GiB; ms per round (slope of 1 vs 3 rounds):"
        f" {per_round}")


# ---------------------------------------------------------------------------
# The classifier path: grouped aggregation (K4, K5, K6), device training,
# one-pass QDA scoring (K3)
# ---------------------------------------------------------------------------

CLASSES = 8                # BASELINE config 4: 8 classes, 90% in class 0
N_CLASSIFY_CPU = 200_000   # the CPU pipeline held against the card's
GROUPS_SORTED = 1000       # a G above K4's limit
NB_GROUPS_WIDE = 100       # a G above the old K6's 32 groups a launch


def make_classify_table(n: int, seed: int, *, num_cols: int = 4,
                        cat_cols: int = 2, classes: int = CLASSES,
                        hot: float | None = 0.9, device=None):
    """A labelled table made from `seed`: `num_cols` numeric columns
    N(shift[y], 1), with one fixed shift per class and column, 2·N(0, 1)
    from numpy's generator at seed 0 (for every seed and device, and as in
    tests/test_torch_qda.py's full one-hot fixture), `cat_cols` categorical
    columns uniform over 8 codes, labels y with `hot` of the rows in class
    0 and the rest uniform over the others (None: all uniform). Defaults:
    BASELINE config 4 (P = 21). Returns (x f32[d, n], codes i32[c, n],
    y i32[n], schema)."""
    import numpy as np

    from duckdb_imputation_tpu_torch import FeatureSchema

    dev = DEVICE if device is None else device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if hot is None:
        y = torch.randint(0, classes, (n,), generator=g, device=dev)
    else:
        other = torch.randint(1, classes, (n,), generator=g, device=dev)
        y = torch.where(torch.rand(n, generator=g, device=dev) < hot, 0,
                        other)
    shift = torch.tensor(2.0 * np.random.default_rng(0).normal(
        size=(classes, num_cols)).T, dtype=torch.float32, device=dev)
    x = torch.randn((num_cols, n), generator=g, device=dev) + shift[:, y]
    codes = torch.randint(0, 8, (cat_cols, n), generator=g, device=dev,
                          dtype=torch.int32)
    schema = FeatureSchema(num_cols=num_cols,
                           cat_keys=(tuple(range(8)),) * cat_cols)
    return x.contiguous(), codes, y.to(torch.int32), schema


def group_rel_err(got, want) -> float:
    """Largest, over groups, max|got − want| / max|want| of the group."""
    scale = want.flatten(1).abs().max(1).values.clamp(min=1.0)
    return float(((got - want).flatten(1).abs().max(1).values / scale).max())


def check_grouped(tag, got, again, want, schema, binary: bool):
    """The grouped-Gram checks: finite, bit-identical rerun, counts exact
    (binary weights), max rel error ≤ 1e-5 of max|σ| per group."""
    check(torch.isfinite(got).all(), f"{tag} sigma not finite")
    check(torch.equal(got, again), f"{tag} repeated run not bit-identical")
    if binary:
        counts = count_entries(schema)
        check(torch.equal(got[:, counts], want[:, counts]),
              f"{tag} counts differ from the plain version")
    err = group_rel_err(got, want)
    check(err <= 1e-5, f"{tag} max rel error {err:.3e} > 1e-5")
    return err


def phase_k4(seed: int) -> dict:
    """K4 at BASELINE config 4: 10M rows, G = 8, labels unsorted and 90% in
    class 0; some ids out of range, some codes out of vocab; binary, then
    general weights. Then at 8 uniform classes (every class's rows
    scattered) and at P = 88 (24 numeric and three categorical columns of
    21: the CUDA-core route), binary weights."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_plain, grouped_route)

    x, codes, y, schema = make_classify_table(N, seed)
    codes[0, :1000] = 8          # out of vocab: the encode() miss code
    codes[1, 1000:2000] = -1
    g = y.clone()
    g[:777] = CLASSES + 3        # out of range: dropped
    g[777:1500] = -2
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 3)
    w_bin = (torch.rand(N, generator=gen, device=DEVICE) >= 0.2).float()
    w_gen = torch.rand(N, generator=gen, device=DEVICE)
    route = grouped_route(schema)
    check(route == "tensor_cores", f"K4 at config 4 takes {route}")
    out = {}
    for name, w in (("binary", w_bin), ("general", w_gen)):
        kw = dict(schema=schema, num_groups=CLASSES)
        got = grouped_gram(x, codes, w, g, **kw)
        again = grouped_gram(x, codes, w, g, **kw)
        want = grouped_gram_plain(x, codes, w, g, **kw)
        torch.cuda.synchronize()
        err = check_grouped("K4", got, again, want, schema,
                            binary=name == "binary")
        ms = cuda_ms(lambda: grouped_gram(x, codes, w, g, **kw))
        plain_ms = cuda_ms(lambda: grouped_gram_plain(x, codes, w, g, **kw),
                           reps=3, warmup=1)
        abs_err = float((got - want).abs().max())
        log(f"[K4] n={N} G={CLASSES} {name} weights ({route}: a group order,"
            f" then K5 through it): "
            + ("counts exact, " if name == "binary" else "")
            + f"max rel err {err:.3e} (of max|σ| per group), max abs err "
            f"{abs_err:.3e}, bit-identical rerun; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if name == "binary":
            # no single PyTorch call computes a Gram per group
            out = dict(gram_route=route, max_abs_err=abs_err, ms=ms,
                       plain_ms=plain_ms,
                       **gram_bound(codes, schema,
                                    w * ((g >= 0) & (g < CLASSES)), CLASSES,
                                    extra=8),
                       library_ms=None)
    del x, codes, y, g, w_gen
    xu, cu, yu, _ = make_classify_table(N, seed + 5, hot=None)
    sch88 = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    x88 = torch.randn((24, N), generator=gen, device=DEVICE) * 2 + 0.5
    c88 = torch.randint(-1, 22, (3, N), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    for tag, args, sch, key in (
            ("8 uniform classes", (xu, cu, w_bin, yu), schema, "uniform_ms"),
            ("P=88 d=24, 8 uniform classes", (x88, c88, w_bin, yu), sch88,
             "p88_ms")):
        kw = dict(schema=sch, num_groups=CLASSES)
        got, again = grouped_gram(*args, **kw), grouped_gram(*args, **kw)
        want = grouped_gram_plain(*args, **kw)
        torch.cuda.synchronize()
        err = check_grouped(f"K4 {tag}", got, again, want, sch, binary=True)
        reps = 3 if key == "p88_ms" else 10
        out[key] = cuda_ms(lambda: grouped_gram(*args, **kw), reps=reps)
        log(f"[K4] n={N} {tag} ({grouped_route(sch)}): counts exact, max rel"
            f" err {err:.3e}, bit-identical rerun; kernel {out[key]:.4f} ms")
    return out


def phase_k5(seed: int) -> dict:
    """K5: the config-4 table through sort_by_group and the presorted
    kernel, at G = 8 and at G = 1000 uniform groups."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, grouped_gram_presorted_plain,
        grouped_route, sort_by_group)

    x, codes, y, schema = make_classify_table(N, seed)
    route = grouped_route(schema)
    check(route == "tensor_cores", f"K5 at config 4 takes {route}")
    g = y.clone()
    g[:777] = CLASSES + 3
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 4)
    w = (torch.rand(N, generator=gen, device=DEVICE) >= 0.2).float()
    g1000 = torch.randint(0, GROUPS_SORTED, (N,), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    out = {}
    for groups, ids in ((CLASSES, g), (GROUPS_SORTED, g1000)):
        t0 = time.perf_counter()
        xs, cs, ws, layout = sort_by_group(x, codes, ids, schema=schema,
                                           num_groups=groups, weights=w)
        torch.cuda.synchronize()
        sort_s = time.perf_counter() - t0
        args = (xs, cs, ws, layout)
        got = grouped_gram_presorted(*args, schema=schema)
        again = grouped_gram_presorted(*args, schema=schema)
        want = grouped_gram_presorted_plain(*args, schema=schema)
        torch.cuda.synchronize()
        err = check_grouped(f"K5 G={groups}", got, again, want, schema,
                            binary=True)
        if groups == CLASSES:    # the same sums as K4 over unsorted rows
            k4 = grouped_gram(x, codes, w, g, schema=schema,
                              num_groups=groups)
            counts = count_entries(schema)
            check(torch.equal(got[:, counts], k4[:, counts]),
                  "K5 counts differ from K4's")
        ms = cuda_ms(lambda: grouped_gram_presorted(*args, schema=schema))
        plain_ms = cuda_ms(
            lambda: grouped_gram_presorted_plain(*args, schema=schema),
            reps=3, warmup=1)
        abs_err = float((got - want).abs().max())
        log(f"[K5] n={N} G={groups} ({route}): sort_by_group "
            f"{sort_s * 1e3:.1f} ms (host clock, first call); counts exact, "
            f"max rel err {err:.3e}, max abs err {abs_err:.3e}, "
            f"bit-identical rerun; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms")
        if groups == CLASSES:
            out = dict(gram_route=route, max_abs_err=abs_err, ms=ms,
                       plain_ms=plain_ms,
                       **gram_bound(codes, schema, w * (g < CLASSES),
                                    CLASSES), library_ms=None)
        else:
            out["g1000_ms"] = ms
    return out


def phase_k6(seed: int) -> dict:
    """K6 at BASELINE config 3: sum_to_nb_agg_8_4 GROUP BY label, 8
    numeric and 4 categorical columns of 8, 5 labels, 10M rows."""
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums, nb_grouped_sums_plain)

    x, codes, y, schema = make_classify_table(
        N, seed + 2, num_cols=8, cat_cols=4, classes=5, hot=None)
    d = schema.num_cols
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 5)
    w_gen = torch.rand(N, generator=gen, device=DEVICE)
    kw = dict(schema=schema, num_groups=5)
    out = {}
    for name, w in (("none", None), ("general", w_gen)):
        got = nb_grouped_sums(x, codes, w, y, **kw)
        again = nb_grouped_sums(x, codes, w, y, **kw)
        want = nb_grouped_sums_plain(x, codes, w, y, **kw)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all(), "K6 sums not finite")
        check(torch.equal(got, again), "K6 repeated run not bit-identical")
        if w is None:
            cnt = torch.cat([got[:, :1], got[:, 1 + 2 * d:]], 1)
            check(torch.equal(cnt, torch.cat([want[:, :1],
                                              want[:, 1 + 2 * d:]], 1)),
                  "K6 counts differ from the plain version")
            check(float(got[:, 0].sum()) == N, "K6 counts do not sum to n")
        errs = {sec: rel_err(got[:, lo:hi], want[:, lo:hi])
                for sec, lo, hi in (("lin", 1, 1 + d),
                                    ("quad_diag", 1 + d, 1 + 2 * d),
                                    ("counts", 0, 1))}
        check(max(errs.values()) <= 1e-5,
              f"K6 {name} weights: rel errors {errs} > 1e-5")
        ms = cuda_ms(lambda: nb_grouped_sums(x, codes, w, y, **kw))
        plain_ms = cuda_ms(lambda: nb_grouped_sums_plain(x, codes, w, y,
                                                         **kw),
                           reps=3, warmup=1)
        abs_err = float((got - want).abs().max())
        log(f"[K6] n={N} G=5 d=8 c=4 weights {name}: "
            + ("counts exact, " if w is None else "")
            + f"rel err (of the section's max) {errs}, max abs err "
            f"{abs_err:.3e}, bit-identical rerun; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if w is None:
            out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       **nb_bound(N, schema, 5),
                       library_ms=library_nb_ms(x, codes, w, y, schema, 5))

    # 100 groups: one launch (the old kernel took one per 32 groups)
    groups = NB_GROUPS_WIDE
    gw = torch.randint(0, groups, (N,), generator=gen, device=DEVICE,
                       dtype=torch.int32)
    kw = dict(schema=schema, num_groups=groups)
    before = nb_grouped_sums.launches
    got = nb_grouped_sums(x, codes, None, gw, **kw)
    per_call = nb_grouped_sums.launches - before
    again = nb_grouped_sums(x, codes, None, gw, **kw)
    want = nb_grouped_sums_plain(x, codes, None, gw, **kw)
    torch.cuda.synchronize()
    check(per_call == 1, f"K6 G={groups}: {per_call} launches, not 1")
    check(torch.equal(got, again), "K6 wide repeated run not bit-identical")
    cnt = torch.cat([got[:, :1], got[:, 1 + 2 * d:]], 1)
    check(torch.equal(cnt, torch.cat([want[:, :1], want[:, 1 + 2 * d:]], 1)),
          f"K6 G={groups} counts differ from the plain version")
    err = rel_err(got[:, 1:1 + 2 * d], want[:, 1:1 + 2 * d])
    check(err <= 1e-5, f"K6 G={groups} rel error {err:.3e} > 1e-5")
    ms = cuda_ms(lambda: nb_grouped_sums(x, codes, None, gw, **kw))
    plain_ms = cuda_ms(lambda: nb_grouped_sums_plain(x, codes, None, gw,
                                                     **kw),
                       reps=3, warmup=1)
    log(f"[K6] n={N} G={groups} d=8 c=4 ({per_call} launches a call): "
        f"counts exact, rel err {err:.3e}, bit-identical rerun; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return out


def phase_k3(seed: int) -> dict:
    """K3 at C = 8, P = 21, 10M rows: the QDA trained on the config-4
    table (f64 training), its tables in the plan's cells (one task)."""
    from duckdb_imputation_tpu_torch.models.device import qda_train_device
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain, qda_tables)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram)

    x, codes, y, schema = make_classify_table(N, seed)
    codes[1, :1000] = 8          # out of vocab: reads no cell
    sig = grouped_gram(x, codes, None, y, schema=schema, num_groups=CLASSES)
    tables, plan = qda_tables(*qda_train_device(sig, float(N)),
                              schema=schema)
    check(bool(torch.isfinite(tables).all()), "K3 tables not finite")
    check(plan.num_tasks == 1, f"K3: {plan.num_tasks} tasks")
    before = qda_predict_kernel.launches
    got = qda_predict_kernel(tables, plan, x, codes, schema=schema)
    again = qda_predict_kernel(tables, plan, x, codes, schema=schema)
    want = qda_predict_plain(tables, plan, x, codes, schema=schema)
    torch.cuda.synchronize()
    check(qda_predict_kernel.launches == before + 2, "K3 was not launched")
    check(torch.equal(got, again), "K3 repeated run not bit-identical")
    agree = float((got == want).float().mean())
    check(agree >= 0.9999, f"K3 argmax agreement {agree} < 0.9999")
    ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, x, codes,
                                            schema=schema))
    plain_ms = cuda_ms(lambda: qda_predict_plain(tables, plan, x, codes,
                                                 schema=schema),
                       reps=3, warmup=1)
    out = dict(max_abs_err=float((got - want).abs().max()), ms=ms,
               plain_ms=plain_ms,
               **qda_bound(codes, schema, CLASSES, tables.numel() * 4),
               library_ms=None)
    # no single PyTorch call scores and takes the argmax over classes
    log(f"[K3] n={N} C={CLASSES} P={schema.sigma_size} ({tables.shape[1]} "
        f"cells a class, one task): argmax agreement with the plain version "
        f"{agree:.7f}, bit-identical rerun; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    out["nb_centred"] = k3_nb_centring(seed)
    return out


def k3_nb_centring(seed: int) -> dict:
    """K3 on naive Bayes's centred tables (its x shift) at ROADMAP Queue
    3's variance case, N rows: 2 classes at ~50%, x0 ~ N(2y, 1), x1
    exactly 1000.1 in class 1 and N(1000.1, 1) in class 0 (class 1's
    variance clamps to 0, +1e-9). The NB sums by K6, device training,
    `nb_predict_device` (K3 with the shift) against the host predictor
    (`models.nb_train` / `nb_predict`) and the f64 log-space formula on
    the same parameters: agreement ≥ 0.999 with each; the kernel with the
    shift against its plain version; the uncentred tables' agreement
    beside it."""
    from duckdb_imputation_tpu_torch import FeatureSchema, models
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        nb_center, nb_tables, qda_predict_kernel, qda_predict_plain)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 44)
    y = (torch.rand(N, generator=g, device=DEVICE) < 0.5).to(torch.int32)
    x0 = torch.randn(N, generator=g, device=DEVICE) + 2 * y
    x1 = torch.where(y == 1, 1000.1,
                     torch.randn(N, generator=g, device=DEVICE) + 1000.1)
    x = torch.stack([x0, x1]).float()
    codes = torch.zeros((0, N), dtype=torch.int32, device=DEVICE)
    schema = FeatureSchema(num_cols=2)
    agg = sum_to_nb_agg_grouped(x, None, y, schema=schema, num_groups=2)
    params = models.nb_train(agg, schema, labels=[0, 1])
    host = models.nb_predict(params, x).to(torch.int32)
    p = models.NBParams.decode(params, 2)
    f64 = torch.float64
    mu = torch.tensor(p.mean, dtype=f64, device=DEVICE)[:, :, None]
    var = torch.tensor(p.var, dtype=f64, device=DEVICE)[:, :, None] + 1e-9
    formula = (torch.log(torch.tensor(p.priors, dtype=f64,
                                      device=DEVICE))[:, None]
               - ((x[None].double() - mu) ** 2 / (2 * var)
                  + 0.5 * torch.log(2 * torch.pi * var)).sum(1)).argmax(0)
    priors, mean, var_d, freqs = nb_train_device(agg.n, agg.lin,
                                                 agg.quad_diag, agg.lin_cat)
    before = qda_predict_kernel.launches
    dev = nb_predict_device(priors, mean, var_d, freqs, x, codes,
                            schema=schema)
    torch.cuda.synchronize()
    check(qda_predict_kernel.launches == before + 1,
          "nb_predict_device did not launch K3")
    vs_host = float((dev == host).float().mean())
    vs_formula = float((dev == formula).float().mean())
    check(vs_host >= 0.999, f"K3 NB vs host predictor {vs_host} < 0.999")
    check(vs_formula >= 0.999, f"K3 NB vs the f64 formula {vs_formula}")
    lp = torch.log(priors.double())
    v64 = var_d.double().clamp(min=0.0) + 1e-9
    lf = torch.zeros((2, 0), dtype=f64, device=DEVICE)
    center = nb_center(lp, mean)
    tables, plan = nb_tables(lp, mean, v64, lf, schema=schema, center=center)
    got = qda_predict_kernel(tables, plan, x, codes, schema=schema,
                             shift=center)
    want = qda_predict_plain(tables, plan, x, codes, schema=schema,
                             shift=center)
    check(torch.equal(got, want), "K3 with a shift differs from its plain "
          "version")
    ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, x, codes,
                                            schema=schema, shift=center))
    raw, raw_plan = nb_tables(lp, mean, v64, lf, schema=schema)
    raw_ms = cuda_ms(lambda: qda_predict_kernel(raw, raw_plan, x, codes,
                                                schema=schema))
    uncentred = float((qda_predict_kernel(raw, raw_plan, x, codes,
                                          schema=schema) == host)
                      .float().mean())
    out = dict(vs_host=vs_host, vs_formula=vs_formula,
               uncentred_vs_host=uncentred, ms=ms, unshifted_ms=raw_ms,
               accuracy=float((dev == y).float().mean()))
    log(f"[K3] NB centred at the variance case n={N} (class 1's x1 "
        f"exactly 1000.1): nb_predict_device (K3, shift {center.tolist()}) "
        f"agrees with the host predictor on {vs_host:.7f} of rows, with "
        f"the f64 formula on {vs_formula:.7f} (uncentred tables: "
        f"{uncentred:.7f}); accuracy {out['accuracy']:.6f}; kernel with the "
        f"shift equal to its plain version; {ms:.4f} ms (the uncentred "
        f"tables without a shift {raw_ms:.4f} ms)")
    return out


def qda_pipeline(x, codes, y, schema, classes: int):
    """GROUP BY label → qda_train_device → qda_predict_device."""
    from duckdb_imputation_tpu_torch.models.device import (
        qda_predict_device, qda_train_device)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple_grouped
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    sig = sigma_from_triple(sum_to_triple_grouped(
        x, codes, y, schema=schema, num_groups=classes))
    quad, lin, b = qda_train_device(sig, float(y.shape[0]))
    return qda_predict_device(quad, lin, b, x, codes, schema=schema)


def nb_pipeline(x, codes, y, schema, classes: int):
    """GROUP BY label NB aggregate → nb_train_device → nb_predict_device."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    agg = sum_to_nb_agg_grouped(x, codes, y, schema=schema,
                                num_groups=classes)
    params = nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
    return nb_predict_device(*params, x, codes, schema=schema)


def phase_classify(seed: int) -> dict:
    """The classifier path end to end on the config-4 table: QDA and NB,
    8 classes (K4, K6, K3), and QDA on a 16-class label (sort + K5); then
    the same pipelines on the CPU's plain versions at 200k rows against
    the card's."""
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted)

    x, codes, y, schema = make_classify_table(N, seed)
    x16, codes16, y16, _ = make_classify_table(N, seed + 1,
                                               classes=2 * CLASSES, hot=None)
    wrappers = {"qda_predict_kernel": qda_predict_kernel,
                "grouped_gram": grouped_gram,
                "grouped_gram_presorted": grouped_gram_presorted,
                "nb_grouped_sums": nb_grouped_sums}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    pred_q = qda_pipeline(x, codes, y, schema, CLASSES)
    pred_n = nb_pipeline(x, codes, y, schema, CLASSES)
    pred_16 = qda_pipeline(x16, codes16, y16, schema, 2 * CLASSES)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"[classify] n={N}: QDA and NB over {CLASSES} classes, QDA over "
        f"{2 * CLASSES}: launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the classifier path was not launched: {launches}")

    prior = float((y == 0).float().mean())
    acc = {}
    for name, pred, labels, classes in (("qda", pred_q, y, CLASSES),
                                        ("nb", pred_n, y, CLASSES),
                                        ("qda16", pred_16, y16,
                                         2 * CLASSES)):
        check(pred.shape == (N,) and pred.dtype == torch.int32,
              f"{name}: prediction shape {tuple(pred.shape)} {pred.dtype}")
        check(bool(((pred >= 0) & (pred < classes)).all()),
              f"{name}: class index out of range")
        acc[name] = float((pred == labels).float().mean())
    prior16 = float(torch.bincount(y16.long()).max()) / N
    # the same fixture on the CPU reaches 0.958 (QDA and NB) against a
    # prior of 0.900 at 200k rows; a predictor that returns class 0 (the
    # JAX package's, whose Cholesky fails here) scores the prior
    check(acc["qda"] > prior + 0.02 and acc["nb"] > prior + 0.02,
          f"accuracy {acc} does not beat the class-0 prior {prior} by 0.02")
    check(acc["qda16"] > prior16, f"16-class accuracy {acc['qda16']} is not"
          f" above its majority share {prior16}")
    log(f"[classify] accuracy against the true labels {acc}; class-0 prior"
        f" {prior:.5f}, 16-class majority share {prior16:.5f}")

    xs, cs, ys, _ = make_classify_table(N_CLASSIFY_CPU, seed + 9)
    agree = {}
    for name, pipe in (("qda", qda_pipeline), ("nb", nb_pipeline)):
        card = pipe(xs, cs, ys, schema, CLASSES).cpu()
        cpu = pipe(xs.cpu(), cs.cpu(), ys.cpu(), schema, CLASSES)
        agree[name] = float((card == cpu).float().mean())
    check(min(agree.values()) >= 0.999,
          f"card vs CPU pipeline agreement {agree} < 0.999")
    log(f"[classify] n={N_CLASSIFY_CPU}: kernels on the card vs plain "
        f"versions on the CPU, prediction agreement {agree}")

    ms = {name: cuda_ms(lambda: pipe(*table, schema, classes), reps=5,
                        warmup=1)
          for name, pipe, table, classes in (
              ("qda", qda_pipeline, (x, codes, y), CLASSES),
              ("nb", nb_pipeline, (x, codes, y), CLASSES),
              ("qda16", qda_pipeline, (x16, codes16, y16), 2 * CLASSES))}
    log(f"[classify] ms per pipeline at n={N} (aggregate + train + "
        f"predict, CUDA events, mean of 5): {ms}")
    return launches


# ---------------------------------------------------------------------------
# Wide schemas (P > 88: K7, K2w) and the delta MICE loop
# ---------------------------------------------------------------------------

N_WIDE_CPU = 200_000       # the wide loop on the CPU, held against the card's
N_SPLIT = 2_000_000        # rows of [K7]'s P = 1,022 case (its plain Gram
                           # is ~4× favorita_wide's a row)
DELTA_FRACS = (0.01, 0.05, 0.20)
# favorita_wide: the Kaggle "Corporacion Favorita Grocery Sales Forecasting"
# schema (stores.csv, items.csv, train.csv's onpromotion): numeric
# unit_sales, transactions, dcoilwtico; categorical store_nbr, family,
# class, perishable, onpromotion, city, state, type, cluster
FAVORITA_VOCABS = (54, 33, 337, 2, 2, 22, 16, 5, 17)


def favorita_schema():
    from duckdb_imputation_tpu_torch import FeatureSchema

    return FeatureSchema(num_cols=3, cat_keys=tuple(
        tuple(range(v)) for v in FAVORITA_VOCABS))


def make_favorita(n: int, seed: int, *, null_frac: float = 0.2,
                  device=None):
    """favorita_wide (P = 492) made on the device from `seed`, with the
    dataset's hierarchy: city, state, type and cluster are fixed functions
    of the store (state of the city); family and perishable of the class
    (each family owns at least one class); transactions = 2·(store level)
    + N(0, 1); unit_sales = class level + 1.5·onpromotion + 0.5·N(0, 1);
    the oil price N(0, 1); stores uniform, 20% on promotion. Class sizes
    follow a Zipf law (weight 1/rank): an assumption, since the dataset's
    per-class row counts are not in the repository.
    `null_frac` MCAR nulls in transactions (numeric 1) and family
    (categorical 1). Returns (table, truth): truth holds the true
    transactions and family."""
    from duckdb_imputation_tpu_torch import Table

    dev = DEVICE if device is None else device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    i32 = torch.int32

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=g, device=dev,
                             dtype=i32)

    stores, families, classes = FAVORITA_VOCABS[:3]
    city_of_store = randint(22, stores)
    state_of_city = randint(16, 22)
    type_of_store = randint(5, stores)
    cluster_of_store = randint(17, stores)
    family_of_class = torch.cat([torch.arange(families, device=dev, dtype=i32),
                                 randint(families, classes - families)])
    family_of_class = family_of_class[torch.randperm(
        classes, generator=g, device=dev)]
    perishable_of_family = randint(2, families)
    store_level = torch.randn(stores, generator=g, device=dev)
    class_level = torch.randn(classes, generator=g, device=dev)

    store = randint(stores, n)
    # assumed class sizes: Zipf weights 1/rank, ranks shuffled so the
    # large classes fall in every family
    rank = torch.randperm(classes, generator=g, device=dev) + 1
    cls = torch.multinomial(1.0 / rank.double(), n, replacement=True,
                            generator=g).to(i32)
    promo = (torch.rand(n, generator=g, device=dev) < 0.2).to(i32)
    sl, cl = store.long(), cls.long()
    family = family_of_class[cl]
    transactions = 2.0 * store_level[sl] + torch.randn(n, generator=g,
                                                       device=dev)
    unit_sales = (class_level[cl] + 1.5 * promo
                  + 0.5 * torch.randn(n, generator=g, device=dev))
    oil = torch.randn(n, generator=g, device=dev)
    city = city_of_store[sl]
    codes = torch.stack([store, family, cls,
                         perishable_of_family[family.long()], promo, city,
                         state_of_city[city.long()], type_of_store[sl],
                         cluster_of_store[sl]])
    x = torch.stack([unit_sales, transactions, oil])
    num_null = torch.zeros((3, n), dtype=torch.bool, device=dev)
    cat_null = torch.zeros((9, n), dtype=torch.bool, device=dev)
    num_null[1] = torch.rand(n, generator=g, device=dev) < null_frac
    cat_null[1] = torch.rand(n, generator=g, device=dev) < null_frac
    truth = {"transactions": transactions, "family": family}
    x = torch.where(num_null, 0.0, x)
    codes = torch.where(cat_null, 0, codes)
    return Table(num_data=x, cat_codes=codes, num_null=num_null,
                 cat_null=cat_null, schema=favorita_schema()), truth


def check_gram(tag, got, again, want, schema, binary: bool) -> float:
    """The masked-Gram checks: finite, bit-identical rerun, counts exact
    (binary weights), max rel error ≤ 1e-5 of max|σ|. Returns the error."""
    check(torch.isfinite(got).all(), f"{tag} sigma not finite")
    check(torch.equal(got, again), f"{tag} repeated run not bit-identical")
    if binary:
        counts = count_entries(schema)
        check(torch.equal(got[counts], want[counts]),
              f"{tag} counts differ from the plain version")
    err = rel_err(got, want)
    check(err <= 1e-5, f"{tag} max rel error {err:.3e} > 1e-5")
    return err


def phase_k7(seed: int, n: int = N) -> dict:
    """K7 at favorita_wide (P = 492): masked_gram_cols with binary weights
    and masked_gram with general weights; masked_gram_cols at P = 124 (3
    numeric columns, one categorical column of 120); with a hot key (90%
    of the rows on one store and one class: a warp's lanes meet on one
    cell); and at P = 1,022 (2 numeric columns, two categorical columns of
    510: a cross table of 2 MB in f64, split by key range over 32 tasks)
    on N_SPLIT rows."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels._build import wide_plan
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols, masked_gram_cols_plain,
        masked_gram_plain)

    t, _ = make_favorita(n, seed + 11)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 12)
    w_gen = torch.rand(n, generator=gen, device=DEVICE)
    w_bin = (w_gen >= 0.2).float()
    codes = t.cat_codes.clone()
    codes[2, :1000] = 337        # out of vocab: the encode() miss code
    codes[0, 1000:2000] = -1
    xs, cs = list(t.num_data.unbind(0)), list(codes.unbind(0))
    narrow = FeatureSchema(num_cols=3, cat_keys=(tuple(range(120)),))
    c120 = [torch.randint(0, 121, (n,), generator=gen, device=DEVICE,
                          dtype=torch.int32)]
    hot = torch.rand(n, generator=gen, device=DEVICE) < 0.9
    c_hot = list(cs)
    c_hot[0] = torch.where(hot, 7, codes[0]).to(torch.int32)
    c_hot[2] = torch.where(hot, 5, codes[2]).to(torch.int32)
    split = FeatureSchema(num_cols=2, cat_keys=(tuple(range(510)),) * 2)
    x_sp = [x[:N_SPLIT] for x in xs[:2]]
    c_sp = [torch.randint(-1, 511, (N_SPLIT,), generator=gen, device=DEVICE,
                          dtype=torch.int32) for _ in range(2)]
    w_sp = w_bin[:N_SPLIT]
    cases = (
        ("cols P=492 binary", t.schema, w_bin,
         lambda: masked_gram_cols(xs, cs, w_bin, schema=t.schema),
         lambda: masked_gram_cols_plain(xs, cs, w_bin, schema=t.schema)),
        ("stacked P=492 general", t.schema, None,
         lambda: masked_gram(t.num_data, codes, w_gen, schema=t.schema),
         lambda: masked_gram_plain(t.num_data, codes, w_gen,
                                   schema=t.schema)),
        ("cols P=124 binary", narrow, w_bin,
         lambda: masked_gram_cols(xs, c120, w_bin, schema=narrow),
         lambda: masked_gram_cols_plain(xs, c120, w_bin, schema=narrow)),
        ("cols P=492 hot key binary", t.schema, w_bin,
         lambda: masked_gram_cols(xs, c_hot, w_bin, schema=t.schema),
         lambda: masked_gram_cols_plain(xs, c_hot, w_bin, schema=t.schema)),
        (f"cols P=1022 split table binary n={N_SPLIT} "
         f"({wide_plan(split).num_tasks} tasks)", split, w_sp,
         lambda: masked_gram_cols(x_sp, c_sp, w_sp, schema=split),
         lambda: masked_gram_cols_plain(x_sp, c_sp, w_sp, schema=split)))
    out = {}
    for name, schema, w_bin_case, kernel, plain in cases:
        binary = w_bin_case is not None
        before = masked_gram_cols.wide_launches + masked_gram.wide_launches
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        wide = masked_gram_cols.wide_launches + masked_gram.wide_launches
        check(wide == before + 2, f"K7 {name}: {wide - before} wide "
              f"launches, not 2")
        err = check_gram(f"K7 {name}", got, again, want, schema, binary)
        if binary:
            check(float(got[0, 0]) == float(w_bin_case.sum()),
                  f"K7 {name}: sigma[0,0] != Σw")
        ms = cuda_ms(kernel, reps=5, warmup=1)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        abs_err = float((got - want).abs().max())
        log(f"[K7] n={n} {name}: " + ("counts exact, " if binary else "")
            + f"max rel err {err:.3e} (of max|σ|), max abs err "
            f"{abs_err:.3e}, bit-identical rerun; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        if name == "cols P=492 binary":
            out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       **gram_bound(codes, t.schema, w_bin))
    out["library_ms"] = library_gram_ms(t.num_data, codes, w_bin, t.schema)
    log(f"[K7] n={n} P=492: bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}), library (Zᵀw)@Z {out['library_ms']:.4f} ms")
    return out


def phase_k2w(seed: int, n: int = N) -> dict:
    """K2w at favorita_wide: a 'cat' step imputing family (R = 33), one at
    R = 337 (class, with 20% of its rows set to impute), and a 'num' step
    imputing transactions with noise; the coefficients are trained on the
    table's own sigma. Each 'cat' step also times its impute kernel alone
    (K2w less K7 over the updated columns, with its own bounds)."""
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t = init_fill(make_favorita(n, seed + 13)[0])
    schema = t.schema
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w_fam = (~t.cat_null[1]).float()
    w_tx = (~t.num_null[1]).float()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 14)
    null_cls = torch.rand(n, generator=gen, device=DEVICE) < 0.2
    out = {}
    for name, col, null, w_train, w_next in (
            ("family R=33", 1, t.cat_null[1], w_fam, w_tx),
            ("class R=337", 2, null_cls, (~null_cls).float(), w_fam)):
        sig = masked_gram_cols(xs, cs, w_train, schema=schema)
        w, icpt, keep = _lda_device(sig, schema, col, 0.001)
        args = (xs, cs, null, w_next, _w_full(w, keep, schema), icpt)
        kw = dict(schema=schema, kind="cat", imp_col=col)
        before = fused_impute_aggregate.wide_launches
        new_k, sig_k = fused_impute_aggregate(*args, **kw)
        new_p, sig_p = fused_impute_aggregate_plain(*args, **kw)
        torch.cuda.synchronize()
        check(fused_impute_aggregate.wide_launches == before + 1,
              "K2w was not launched")
        agree = float((new_k == new_p).float().mean())
        err = rel_err(sig_k, sig_p)
        abs_err = float((sig_k - sig_p).abs().max())
        check(agree >= 0.9999, f"K2w {name} code agreement {agree}")
        check(err <= 1e-5, f"K2w {name} sigma rel err {err:.3e} > 1e-5")
        ms = cuda_ms(lambda: fused_impute_aggregate(*args, **kw), reps=5,
                     warmup=1)
        plain_ms = cuda_ms(lambda: fused_impute_aggregate_plain(*args, **kw),
                           reps=2, warmup=1)
        rclasses = schema.cat_sizes[col]
        nulls = int(null.sum())
        k_bound = gram_bound(t.cat_codes, schema, w_next, extra=9,
                             scores=rclasses * (1 + 3 + 9), scored=nulls)
        log(f"[K2w] cat step {name} n={n}: code agreement {agree:.7f}, "
            f"sigma max rel err {err:.3e}, max abs err {abs_err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{k_bound['bound_ms']:.4f} ms ({k_bound['bound_by']})")
        # the impute kernel alone: K2w less K7 over the updated columns,
        # timed in turn; its bound: the mask, the old and the new code of
        # every row, x and codes of the null rows and W once; R·(1 + d +
        # c) multiply-adds a null row. Logged beside it, not in the
        # kernels line: the floor of its categorical lookups in W in
        # shared memory, c words a class a null row (the numeric terms
        # can stay in registers) at one 128-byte warp read a clock on
        # each SM at the card's highest SM clock
        upd = list(cs)
        upd[col] = new_k
        ms2 = cuda_ms(lambda: fused_impute_aggregate(*args, **kw), reps=5,
                      warmup=1)
        k7_ms = [cuda_ms(lambda: masked_gram_cols(xs, upd, w_next,
                                                  schema=schema),
                         reps=5, warmup=1) for _ in range(2)]
        k2w_ms = (ms + ms2) / 2
        imp_ms = k2w_ms - sum(k7_ms) / 2
        terms = 1 + schema.num_cols + schema.cat_cols
        imp = dict(ms=imp_ms, k2w_ms=k2w_ms, k7_ms=sum(k7_ms) / 2,
                   **bound(n * 9 + nulls * row_bytes(schema)
                           + 4 * (schema.sigma_size + 1) * rclasses,
                           2 * rclasses * terms * nulls))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = sm_clock_hz()
        lookups_ms = (nulls * rclasses * schema.cat_cols
                      / (sms * 32 * clock) * 1e3)
        log(f"[K2w] impute kernel alone, {name}: K2w {k2w_ms:.4f} ms less "
            f"K7 {imp['k7_ms']:.4f} ms = {imp_ms:.4f} ms; bound "
            f"{imp['bound_ms']:.4f} ms ({imp['bound_by']}); shared-memory "
            f"floor of the categorical lookups {lookups_ms:.4f} ms "
            f"({nulls} null rows × {rclasses} classes × {schema.cat_cols} "
            f"codes over {sms} SMs × 32 words at {clock / 1e6:.0f} MHz), "
            f"{imp_ms / lookups_ms:.2f}× it")
        if col == 1:
            out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       **k_bound, library_ms=None)
        out.setdefault("impute", {})[f"R={rclasses}"] = imp

    sig_x = masked_gram_cols(xs, cs, w_tx, schema=schema)
    coeff = linreg_solve_device(sig_x, label=2)
    theta = coeff.clone()
    theta[2] = 0.0
    args = (xs, cs, t.num_null[1], w_fam, theta[:, None], theta.new_zeros(1))
    kw = dict(schema=schema, kind="num", imp_col=1,
              noise=(seed, 0, _noise_std(coeff, sig_x)))
    nk, sk = fused_impute_aggregate(*args, **kw)
    np_, sp = fused_impute_aggregate_plain(*args, **kw)
    torch.cuda.synchronize()
    dx = float((nk - np_).abs().max())
    e = rel_err(sk, sp)
    check(torch.isfinite(nk).all(), "K2w num column not finite")
    check(dx <= 1e-4, f"K2w num max|Δx| {dx:.3e} > 1e-4")
    check(e <= 1e-5, f"K2w num sigma rel err {e:.3e} > 1e-5")
    ms = cuda_ms(lambda: fused_impute_aggregate(*args, **kw), reps=5,
                 warmup=1)
    log(f"[K2w] num step with noise n={n}: max|Δx| {dx:.3e}, sigma max rel "
        f"err {e:.3e}; kernel {ms:.4f} ms")
    out["num_ms"] = ms
    return out


def wide_quality(t, truth, out, tag: str) -> dict:
    """The imputation checks of a favorita_wide run: finite, observed cells
    unchanged, family accuracy on its null cells above the mode prior +
    0.02, transactions RMSE below the mean-fill RMSE."""
    nm, cm = t.num_null[1], t.cat_null[1]
    check(torch.isfinite(out.num_data).all(), f"{tag}: x not finite")
    check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null])
          and torch.equal(out.cat_codes[~t.cat_null],
                          t.cat_codes[~t.cat_null]),
          f"{tag}: observed cells changed")
    fam = truth["family"]
    prior = float(torch.bincount(fam[~cm].long()).max()) / int((~cm).sum())
    acc = float((out.cat_codes[1][cm] == fam[cm]).float().mean())
    tx = truth["transactions"]
    rmse = float(((out.num_data[1] - tx)[nm] ** 2).mean().sqrt())
    mean_fill = float(((tx[~nm].double().mean() - tx[nm].double()) ** 2)
                      .mean().sqrt())
    check(acc > prior + 0.02, f"{tag}: family accuracy {acc} not above the "
          f"mode prior {prior} + 0.02")
    check(rmse < mean_fill, f"{tag}: transactions RMSE {rmse} not below "
          f"the mean fill's {mean_fill}")
    return dict(acc=acc, prior=prior, rmse=rmse, mean_fill=mean_fill)


def phase_wide(seed: int, n: int = N) -> dict:
    """run_mice_device on favorita_wide at `n` rows, 'gram' then 'fused',
    ROUNDS rounds: launch counts, quality, fused vs unfused; the card's
    fused loop against the CPU's plain loop at N_WIDE_CPU rows; ms per
    round."""
    from duckdb_imputation_tpu_torch import Table, run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    t, truth = make_favorita(n, seed + 15)
    torch.cuda.synchronize()
    masked_gram_cols.wide_launches = 0
    fused_impute_aggregate.wide_launches = 0
    unf = run_mice_device(t, iters=ROUNDS, kernel="gram")
    fus = run_mice_device(t, iters=ROUNDS, kernel="fused")
    torch.cuda.synchronize()
    launches = {"wide_gram": masked_gram_cols.wide_launches,
                "fused_impute_aggregate_wide":
                    fused_impute_aggregate.wide_launches}
    log(f"[wide] run_mice_device favorita_wide P={t.schema.sigma_size} "
        f"n={n} rounds={ROUNDS} (gram, then fused): launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a wide kernel was not launched: {launches}")
    q = {name: wide_quality(t, truth, o, name)
         for name, o in (("gram", unf), ("fused", fus))}
    m = t.cat_null[1]
    agree = float((fus.cat_codes[1] == unf.cat_codes[1])[m].float().mean())
    dx = float((fus.num_data[1] - unf.num_data[1]).abs().max())
    check(agree >= 0.999, f"wide fused vs unfused code agreement {agree}")
    log(f"[wide] fused vs unfused: family agreement {agree:.6f}, x max diff "
        f"{dx:.3e}; quality {q}")
    del unf, fus

    small, _ = make_favorita(N_WIDE_CPU, seed + 16)
    cpu = Table(*(a.cpu() for a in (small.num_data, small.cat_codes,
                                    small.num_null, small.cat_null)),
                schema=small.schema)
    t0 = time.perf_counter()
    ref = run_mice_device(cpu, iters=2, kernel="plain")
    cpu_s = time.perf_counter() - t0
    got = run_mice_device(small, iters=2, kernel="fused")
    sm = small.cat_null[1].cpu()
    agree_cpu = float((got.cat_codes[1].cpu() == ref.cat_codes[1])[sm]
                      .float().mean())
    dx_cpu = float((got.num_data.cpu() - ref.num_data).abs().max())
    check(agree_cpu >= 0.999, f"wide fused (card) vs plain (CPU) agreement "
          f"{agree_cpu}")
    log(f"[wide] n={N_WIDE_CPU}: fused on the card vs plain on the CPU "
        f"({cpu_s:.1f} s): family agreement {agree_cpu:.6f}, x max diff "
        f"{dx_cpu:.3e}")

    f = init_fill(t)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(1,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("gram", lambda k: mice_loop_device(*args, iters=k,
                                                kernel="gram", **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=2, warmup=1)
        three = cuda_ms(lambda: loop(3), reps=2, warmup=1)
        per_round[name] = (three - one) / 2
    log(f"[wide] ms per round at n={n} P={t.schema.sigma_size} (slope of 1 "
        f"vs 3 rounds, CUDA events): {per_round}")
    return launches


def delta_vs_full(t, truth_x, truth_c, tag: str, num_col: int,
                  cat_col: int, n: int) -> dict:
    """run_mice_device_delta against run_mice_device (fused) on one table:
    the launch counts of the delta run alone (its one full aggregation and
    two per column step, every one through K1, or K7 when P > 88), the
    quality bounds of tests/test_mice.py's delta test, the union size, and
    ms per round of both loops (slope of 1 vs 3 rounds). Returns the delta
    run's counts."""
    from duckdb_imputation_tpu_torch import (run_mice_device,
                                             run_mice_device_delta)
    from duckdb_imputation_tpu_torch.mice.device_round import (
        build_union_gather, mice_loop_device_delta, mice_loop_device_fused)
    from duckdb_imputation_tpu_torch.mice.partition import (
        build_partitions, init_fill)
    from duckdb_imputation_tpu_torch.ring.kernels._build import (
        MAX_SIGMA_SIZE)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    torch.cuda.synchronize()
    masked_gram_cols.launches = 0
    masked_gram_cols.wide_launches = 0
    delta = run_mice_device_delta(t, iters=ROUNDS)
    torch.cuda.synchronize()
    launches = {"masked_gram_cols": masked_gram_cols.launches,
                "wide_gram": masked_gram_cols.wide_launches}
    wide = t.schema.sigma_size > MAX_SIGMA_SIZE
    want = 1 + 2 * 2 * ROUNDS     # 2 imputed columns, 2 aggregations a step
    expect = {"masked_gram_cols": 0 if wide else want,
              "wide_gram": want if wide else 0}
    log(f"[delta] {tag}: run_mice_device_delta launches {launches}")
    check(launches == expect, f"{tag}: the delta path launched {launches}, "
          f"not {expect}")
    full = run_mice_device(t, iters=ROUNDS, kernel="fused")
    nm, cm = t.num_null[num_col], t.cat_null[cat_col]
    rmse = {k: float(((o.num_data[num_col] - truth_x)[nm] ** 2).mean()
                     .sqrt()) for k, o in (("full", full), ("delta", delta))}
    agree = float((delta.cat_codes == full.cat_codes).float().mean())
    agree_null = float((delta.cat_codes[cat_col] == full.cat_codes[cat_col])
                       [cm].float().mean())
    acc = {k: float((o.cat_codes[cat_col][cm] == truth_c[cm]).float().mean())
           for k, o in (("full", full), ("delta", delta))}
    check(torch.isfinite(delta.num_data).all(), f"{tag}: x not finite")
    check(rmse["delta"] <= 1.15 * rmse["full"] + 0.02,
          f"{tag}: delta RMSE {rmse['delta']} > 1.15·{rmse['full']} + 0.02")
    check(agree > 0.95, f"{tag}: delta vs full code agreement {agree}")
    check(torch.equal(delta.num_data[~t.num_null], full.num_data[~t.num_null])
          and torch.equal(delta.cat_codes[~t.cat_null],
                          full.cat_codes[~t.cat_null]),
          f"{tag}: observed cells differ")
    del full, delta

    f = init_fill(t)
    parts = build_partitions(f)
    union_idx, union_valid = build_union_gather(
        [parts.num_dirty_idx[num_col], parts.cat_dirty_idx[cat_col]],
        blk=None)
    kw = dict(schema=t.schema, num_cols_to_impute=(num_col,),
              cat_cols_to_impute=(cat_col,))
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    per_round = {}
    for name, loop in (
            ("delta", lambda k: mice_loop_device_delta(
                *args, union_idx, union_valid, iters=k, kernel="gram",
                **kw)),
            ("fused", lambda k: mice_loop_device_fused(*args, iters=k,
                                                       **kw))):
        one = cuda_ms(lambda: loop(1), reps=2, warmup=1)
        three = cuda_ms(lambda: loop(3), reps=2, warmup=1)
        per_round[name] = (three - one) / 2
    log(f"[delta] {tag} n={n}: union K={union_idx.numel()}; RMSE {rmse}; "
        f"code agreement {agree:.6f} (null cells {agree_null:.6f}); "
        f"accuracy {acc}; observed cells identical; ms per round (slope of "
        f"1 vs 3 rounds): {per_round}")
    return launches


def phase_delta(seed: int, n: int = N) -> dict:
    """run_mice_device_delta on the config-5 table at 1%, 5% and 20% MCAR
    nulls, then on favorita_wide at 5%, each against run_mice_device.
    Returns the delta runs' own launch counts: K1's summed over the three
    config-5 runs, K7's of the favorita_wide run."""
    k1 = 0
    for frac in DELTA_FRACS:
        t, truth = make_table(n, seed + 17, null_frac=frac)
        c0 = torch.clamp(t.num_data[0] + 4.0, 0, 7).to(torch.int32)
        k1 += delta_vs_full(t, truth, c0, f"config 5, {frac:.0%} nulls", 1,
                            0, n)["masked_gram_cols"]
    t, truth = make_favorita(n, seed + 18, null_frac=0.05)
    k7 = delta_vs_full(t, truth["transactions"], truth["family"],
                       "favorita_wide, 5% nulls", 1, 1, n)["wide_gram"]
    return {"masked_gram_cols": k1, "wide_gram": k7}


# ---------------------------------------------------------------------------
# The host MICE path (run_mice_baseline / low / high, aggregating through
# K1's stacked entry point, or K7 at favorita_wide) and the GD trainer in
# the device loops
# ---------------------------------------------------------------------------

HOST_ROUNDS = 2
N_HOST_CPU = 200_000       # the host drivers on the CPU, held against the card
GD_ITERS = 500


def host_drivers():
    from duckdb_imputation_tpu_torch import (run_mice_baseline,
                                             run_mice_high, run_mice_low)
    return {"baseline": run_mice_baseline, "low": run_mice_low,
            "high": run_mice_high}


def host_launches_expected(t, driver: str, rounds: int) -> int:
    """Aggregates of one host driver run, each one launch: baseline one a
    column step; low one full scan, then two a column step (delta and
    re-add); high one static scan (when the table has complete rows), then
    one a column step whose dirty-but-observed row set is not empty."""
    masks = [m for m in (*t.num_null, *t.cat_null) if bool(m.any())]
    if driver == "baseline":
        return rounds * len(masks)
    if driver == "low":
        return 1 + 2 * rounds * len(masks)
    dirty = torch.stack(masks).any(0)
    return (int(bool((~dirty).any()))
            + rounds * sum(int(bool((dirty & ~m).any())) for m in masks))


def timed_host_run(fn, t, **kw):
    """One host driver run with a device-synchronized PhaseTimer and each
    round's end marked. Returns (out, timer, ms per round, wall s); round 1
    holds the set-up (init fill, partitions, the full or static scan)."""
    from duckdb_imputation_tpu_torch.utils import PhaseTimer

    timer = PhaseTimer(sync=torch.cuda.synchronize)
    marks = []

    def mark(_t, _it):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(t, timer=timer, on_iteration=mark, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ends = [t0] + marks
    per_round = [round((b - a) * 1e3, 3) for a, b in zip(ends, ends[1:])]
    return out, timer, per_round, wall


def close_to(a, b, rtol: float, atol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def phase_host_mice(seed: int) -> int:
    """run_mice_baseline, run_mice_low and run_mice_high at config 5, 10M
    rows, HOST_ROUNDS rounds, noise off, linreg_iters at its default: exact
    masked_gram launches of each run (and no other Gram kernel), imputed-x1
    RMSE, low and high against baseline at the bounds of
    tests/test_mice.py::test_mice_low_matches_baseline_imputation, the card
    against the CPU at N_HOST_CPU rows; phase times and ms per round.
    Returns the launches of the three 10M-row runs."""
    from duckdb_imputation_tpu_torch.table import Table
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols)

    t, truth = make_table(N, seed + 20)
    kw = dict(iters=HOST_ROUNDS, noise=False)
    outs, total = {}, 0
    for name, fn in host_drivers().items():
        torch.cuda.synchronize()
        masked_gram.launches = masked_gram.wide_launches = 0
        masked_gram_cols.launches = masked_gram_cols.wide_launches = 0
        out, timer, per_round, wall = timed_host_run(fn, t, **kw)
        got = (masked_gram.launches, masked_gram.wide_launches,
               masked_gram_cols.launches + masked_gram_cols.wide_launches)
        want = (host_launches_expected(t, name, HOST_ROUNDS), 0, 0)
        log(f"[host_mice] run_mice_{name} n={N} rounds={HOST_ROUNDS}: "
            f"masked_gram launches {got[0]} (expected {want[0]}), wide "
            f"{got[1]}, masked_gram_cols {got[2]}")
        check(got == want, f"run_mice_{name} launched {got}, not {want}")
        check(torch.isfinite(out.num_data).all(), f"{name}: x not finite")
        check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null])
              and torch.equal(out.cat_codes[~t.cat_null],
                              t.cat_codes[~t.cat_null]),
              f"{name}: observed cells changed")
        nm = t.num_null[1]
        rmse = float(((out.num_data[1] - truth)[nm] ** 2).mean().sqrt())
        check(rmse < 0.05, f"{name}: imputed x1 RMSE {rmse}")
        phases = {k: round(v * 1e3, 3) for k, v in timer.summary().items()}
        log(f"[host_mice] run_mice_{name}: RMSE of imputed x1 {rmse:.3e}; "
            f"wall {wall * 1e3:.3f} ms, ms per round {per_round} (round 1 "
            f"holds the set-up); PhaseTimer ms {phases}, calls "
            f"{dict(timer.counts)}")
        outs[name] = out
        total += got[0]

    base = outs["baseline"]
    m = t.cat_null[0]
    for name in ("low", "high"):
        o = outs[name]
        agree = float((o.cat_codes == base.cat_codes).float().mean())
        agree_null = float((o.cat_codes[0] == base.cat_codes[0])[m]
                           .float().mean())
        dx = float((o.num_data - base.num_data).abs().max())
        check(close_to(o.num_data, base.num_data, 1e-3, 1e-2),
              f"{name} vs baseline: x max diff {dx}")
        check(agree > 0.99, f"{name} vs baseline code agreement {agree}")
        log(f"[host_mice] run_mice_{name} vs run_mice_baseline: x max diff "
            f"{dx:.3e}, code agreement {agree:.6f} (null cells "
            f"{agree_null:.6f})")
    del outs, base

    small, _ = make_table(N_HOST_CPU, seed + 21)
    cpu = Table(*(a.cpu() for a in (small.num_data, small.cat_codes,
                                    small.num_null, small.cat_null)),
                schema=small.schema)
    sm = small.cat_null[0].cpu()
    for name, fn in host_drivers().items():
        ref = fn(cpu, **kw)
        got = fn(small, **kw)
        agree = float((got.cat_codes[0].cpu() == ref.cat_codes[0])[sm]
                      .float().mean())
        dx = float((got.num_data.cpu() - ref.num_data).abs().max())
        check(agree >= 0.999 and dx < 1e-2,
              f"{name} card vs CPU: agreement {agree}, x diff {dx}")
        log(f"[host_mice] n={N_HOST_CPU} run_mice_{name} on the card vs on "
            f"the CPU: code agreement {agree:.6f}, x max diff {dx:.3e}")
    return total


def phase_host_mice_wide(seed: int) -> int:
    """run_mice_low at favorita_wide (P = 492), 10M rows, one round: every
    aggregate through K7 (`masked_gram.wide_launches`, exact), the [wide]
    quality gates, the host f64 train time of each column. Returns the K7
    launches."""
    from duckdb_imputation_tpu_torch import run_mice_low
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram)

    t, truth = make_favorita(N, seed + 22)
    torch.cuda.synchronize()
    masked_gram.launches = masked_gram.wide_launches = 0
    out, timer, per_round, wall = timed_host_run(run_mice_low, t, iters=1,
                                                 noise=False)
    got = (masked_gram.launches, masked_gram.wide_launches)
    want = (0, host_launches_expected(t, "low", 1))
    log(f"[host_mice_wide] run_mice_low favorita_wide P="
        f"{t.schema.sigma_size} n={N} rounds=1: masked_gram launches "
        f"{got[0]}, wide (K7) {got[1]} (expected {want[1]})")
    check(got == want, f"run_mice_low at favorita_wide launched {got}, not "
          f"{want}")
    q = wide_quality(t, truth, out, "host_mice_wide")
    phases = {k: round(v * 1e3, 3) for k, v in timer.summary().items()}
    log(f"[host_mice_wide] quality {q}; wall {wall * 1e3:.3f} ms, ms per "
        f"round {per_round}; PhaseTimer ms {phases} (train: the f64 host "
        f"trainers of family, LDA, and transactions, GD with linreg_iters "
        f"10000, together), calls {dict(timer.counts)}")
    return got[1]


def phase_gd(seed: int) -> dict:
    """trainer='gd' (gd_iters=500) against trainer='solve' on one table:
    run_mice_device (kernel='gram') at config 5 with 20% nulls and
    run_mice_device_delta at 5%, 10M rows; the bounds of
    tests/test_mice.py::test_mice_device_solve_vs_gd_trainer; the GD run's
    K1 launches equal the solve run's; host reads a column step, the GD
    column step's ms and ms per round. Then the unfused GD loop at
    favorita_wide over K7. Returns the GD runs' launches."""
    from duckdb_imputation_tpu_torch import (run_mice_device,
                                             run_mice_device_delta)
    from duckdb_imputation_tpu_torch.mice.device_round import (
        mice_loop_device)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    def counted(fn, t, **kw):
        torch.cuda.synchronize()
        masked_gram_cols.launches = masked_gram_cols.wide_launches = 0
        reads = linreg_train_device.host_reads
        out = fn(t, **kw)
        torch.cuda.synchronize()
        return out, (masked_gram_cols.launches,
                     masked_gram_cols.wide_launches), \
            linreg_train_device.host_reads - reads

    launches = {"masked_gram_cols": 0, "wide_gram": 0}
    for tag, fn, frac, extra in (
            ("run_mice_device", run_mice_device, 0.2, {"kernel": "gram"}),
            ("run_mice_device_delta", run_mice_device_delta, 0.05,
             {"kernel": "gram"})):
        t, truth = make_table(N, seed + 23, null_frac=frac)
        solve, n_solve, _ = counted(fn, t, iters=2, trainer="solve", **extra)
        gd, n_gd, reads = counted(fn, t, iters=2, trainer="gd",
                                  gd_iters=GD_ITERS, **extra)
        check(n_gd == n_solve and n_gd[0] > 0 and n_gd[1] == 0,
              f"{tag} GD launched {n_gd}, solve {n_solve}")
        nm, cm = t.num_null[1], t.cat_null[0]
        dx = float((gd.num_data[1] - solve.num_data[1])[nm].abs().max())
        agree = float((gd.cat_codes[0] == solve.cat_codes[0])[cm].float()
                      .mean())
        rmse = {k: float(((o.num_data[1] - truth)[nm] ** 2).mean().sqrt())
                for k, o in (("solve", solve), ("gd", gd))}
        check(dx <= 0.1, f"{tag} GD vs solve: imputed x1 max diff {dx}")
        check(agree > 0.95, f"{tag} GD vs solve: code agreement {agree}")
        log(f"[gd] {tag} n={N} {frac:.0%} nulls, 2 rounds, gd_iters="
            f"{GD_ITERS}: K1 launches {n_gd[0]} (solve {n_solve[0]}); GD vs "
            f"solve: imputed x1 max diff {dx:.3e}, code agreement "
            f"{agree:.6f}; RMSE {rmse}; host reads {reads / 2:.1f} a "
            f"column step")
        launches["masked_gram_cols"] += n_gd[0]
        del solve, gd

    # the GD column step alone, and ms per round of the unfused GD loop,
    # on the 20% table
    t, _ = make_table(N, seed + 23)
    f = init_fill(t)
    x_cols = list(f.num_data.unbind(0))
    code_cols = list(f.cat_codes.unbind(0))
    sigma = masked_gram_cols(x_cols, code_cols, (~f.num_null[1]).float(),
                             schema=f.schema)
    reads = linreg_train_device.host_reads
    step_ms = cuda_ms(lambda: linreg_train_device(sigma, label=2,
                                                  max_iters=GD_ITERS),
                      reps=3, warmup=1)
    step_reads = (linreg_train_device.host_reads - reads) / 4
    args = (f.num_data, f.cat_codes, f.num_null, f.cat_null)
    kw = dict(schema=t.schema, num_cols_to_impute=(1,),
              cat_cols_to_impute=(0,), kernel="gram")
    per_round = {}
    for trainer in ("solve", "gd"):
        def loop(k):
            return mice_loop_device(*args, iters=k, trainer=trainer,
                                    gd_iters=GD_ITERS, **kw)
        one = cuda_ms(lambda: loop(1), reps=2, warmup=1)
        four = cuda_ms(lambda: loop(4), reps=2, warmup=1)
        per_round[trainer] = (four - one) / 3
    log(f"[gd] linreg_train_device at P={t.schema.sigma_size} (config 5, "
        f"x1, {GD_ITERS} steps at most): {step_ms:.3f} ms a column step "
        f"(CUDA events), {step_reads:.1f} host reads; ms per round of the "
        f"unfused loop at n={N} (slope of 1 vs 4 rounds, CUDA events): "
        f"{per_round}")

    # favorita_wide: the unfused GD loop over K7
    t, truth = make_favorita(N, seed + 24)
    solve, n_solve, _ = counted(run_mice_device, t, iters=1, kernel="gram",
                                trainer="solve")
    gd, n_gd, reads = counted(run_mice_device, t, iters=1, kernel="gram",
                              trainer="gd", gd_iters=GD_ITERS)
    check(n_gd == n_solve and n_gd[1] > 0 and n_gd[0] == 0,
          f"favorita_wide GD launched {n_gd}, solve {n_solve}")
    q = {k: wide_quality(t, truth, o, f"favorita_wide {k}")
         for k, o in (("solve", solve), ("gd", gd))}
    nm, cm = t.num_null[1], t.cat_null[1]
    dx = float((gd.num_data[1] - solve.num_data[1])[nm].abs().max())
    agree = float((gd.cat_codes[1] == solve.cat_codes[1])[cm].float().mean())
    check(agree > 0.95, f"favorita_wide GD vs solve code agreement {agree}")
    check(q["gd"]["rmse"] <= 1.15 * q["solve"]["rmse"] + 0.02,
          f"favorita_wide GD RMSE {q['gd']['rmse']} > 1.15·"
          f"{q['solve']['rmse']} + 0.02")
    log(f"[gd] run_mice_device favorita_wide P={t.schema.sigma_size} n={N}, "
        f"1 round, gd_iters={GD_ITERS}: K7 launches {n_gd[1]} (solve "
        f"{n_solve[1]}); GD vs solve: family agreement {agree:.6f}, "
        f"transactions max diff {dx:.3e} (f32 GD stalls short of the "
        f"solve at this schema, tests/test_torch_gd.py); quality {q}; host "
        f"reads {reads} in the column step")
    launches["wide_gram"] = n_gd[1]
    return launches


# ---------------------------------------------------------------------------
# The classifier path at wide schemas: favorita_classify (K8, K6w, K3w)
# ---------------------------------------------------------------------------

# favorita_classify: one categorical column of favorita_wide as the label
LABELS = {"onpromotion": 4, "family": 1}


def make_favorita_classify(n: int, seed: int, label: str, device=None):
    """make_favorita's table with no nulls, categorical column `label`
    taken out of the features as the class. onpromotion: 2 classes, ~20%
    positive, P = 490; family: 33 classes, P = 459. Returns (x f32[3, n],
    codes i32[8, n], y i32[n], schema, classes)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    t, _ = make_favorita(n, seed, null_frac=0.0, device=device)
    col = LABELS[label]
    keep = [j for j in range(len(FAVORITA_VOCABS)) if j != col]
    schema = FeatureSchema(num_cols=3, cat_keys=tuple(
        t.schema.cat_keys[j] for j in keep))
    return (t.num_data, t.cat_codes[keep].contiguous(),
            t.cat_codes[col].contiguous(), schema, FAVORITA_VOCABS[col])


def phase_k8(seed: int) -> dict:
    """K8 at favorita_classify, 10M rows: label family (G = 33, P = 459)
    through sort_by_group and the presorted entry, binary weights, some
    ids out of range and codes out of vocab; then label onpromotion (G = 2,
    P = 490) through the unsorted entry (which sorts first), binary and
    general weights. Each against its plain version."""
    from duckdb_imputation_tpu_torch.ring.kernels._build import wide_plan
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_plain, grouped_gram_presorted,
        grouped_gram_presorted_plain, sort_by_group)

    x, codes, y, schema, classes = make_favorita_classify(N, seed + 20,
                                                          "family")
    codes[1, :1000] = 337        # class: out of vocab
    codes[0, 1000:2000] = -1
    ids = y.clone()
    ids[:777] = classes + 3      # out of range: dropped
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 21)
    w = (torch.rand(N, generator=gen, device=DEVICE) >= 0.2).float()
    t0 = time.perf_counter()
    args = sort_by_group(x, codes, ids, schema=schema, num_groups=classes,
                         weights=w)
    torch.cuda.synchronize()
    sort_ms = (time.perf_counter() - t0) * 1e3
    before = grouped_gram_presorted.wide_launches
    got = grouped_gram_presorted(*args, schema=schema)
    again = grouped_gram_presorted(*args, schema=schema)
    want = grouped_gram_presorted_plain(*args, schema=schema)
    torch.cuda.synchronize()
    check(grouped_gram_presorted.wide_launches == before + 2,
          "K8 was not launched by grouped_gram_presorted")
    err = check_grouped("K8 family", got, again, want, schema, binary=True)
    ms = cuda_ms(lambda: grouped_gram_presorted(*args, schema=schema),
                 reps=3, warmup=1)
    plain_ms = cuda_ms(lambda: grouped_gram_presorted_plain(
        *args, schema=schema), reps=1, warmup=1)
    abs_err = float((got - want).abs().max())
    out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
               **gram_bound(codes, schema, w * (ids < classes), classes),
               library_ms=None)
    log(f"[K8] n={N} family G={classes} P={schema.sigma_size} "
        f"({wide_plan(schema).num_tasks} tasks): sort_by_group {sort_ms:.1f} ms "
        f"(host clock, first call); counts exact, max rel err {err:.3e} (of "
        f"max|σ| per group), max abs err {abs_err:.3e}, bit-identical rerun;"
        f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    del args, got, again, want

    x, codes, y, schema, classes = make_favorita_classify(N, seed + 22,
                                                          "onpromotion")
    for name, wt in (("binary", w), ("general", torch.rand(
            N, generator=gen, device=DEVICE))):
        kw = dict(schema=schema, num_groups=classes)
        before = grouped_gram_presorted.wide_launches
        got = grouped_gram(x, codes, wt, y, **kw)
        again = grouped_gram(x, codes, wt, y, **kw)
        want = grouped_gram_plain(x, codes, wt, y, **kw)
        torch.cuda.synchronize()
        check(grouped_gram_presorted.wide_launches == before + 2,
              "K8 was not launched through grouped_gram")
        err = check_grouped(f"K8 onpromotion {name}", got, again, want,
                            schema, binary=name == "binary")
        k_ms = cuda_ms(lambda: grouped_gram(x, codes, wt, y, **kw), reps=3,
                       warmup=1)
        p_ms = cuda_ms(lambda: grouped_gram_plain(x, codes, wt, y, **kw),
                       reps=1, warmup=1)
        k_bound = gram_bound(codes, schema, wt, classes, extra=8)
        log(f"[K8] n={N} onpromotion G={classes} P={schema.sigma_size} "
            f"{name} weights, unsorted entry (sort + K8): "
            + ("counts exact, " if name == "binary" else "")
            + f"max rel err {err:.3e}, max abs err "
            f"{float((got - want).abs().max()):.3e}, bit-identical rerun; "
            f"sort + kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{k_bound['bound_ms']:.4f} ms ({k_bound['bound_by']})")
    return out


def phase_k6w(seed: int) -> dict:
    """K6w at favorita_classify, 10M rows, no weights: label family (33
    groups, F = 462: two tasks) and label onpromotion (2 groups, F = 493:
    one task), one launch a call each; some codes out of vocab."""
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums, nb_grouped_sums_plain)

    out = {}
    for label in ("family", "onpromotion"):
        x, codes, y, schema, classes = make_favorita_classify(
            N, seed + 23, label)
        codes[-1, :1000] = 17        # cluster: out of vocab
        d = schema.num_cols
        kw = dict(schema=schema, num_groups=classes)
        before = nb_grouped_sums.launches
        got = nb_grouped_sums(x, codes, None, y, **kw)
        per_call = nb_grouped_sums.launches - before
        again = nb_grouped_sums(x, codes, None, y, **kw)
        want = nb_grouped_sums_plain(x, codes, None, y, **kw)
        torch.cuda.synchronize()
        check(per_call == 1, f"K6w {label}: {per_call} launches a call")
        check(torch.isfinite(got).all(), "K6w sums not finite")
        check(torch.equal(got, again), "K6w repeated run not bit-identical")
        cnt = torch.cat([got[:, :1], got[:, 1 + 2 * d:]], 1)
        check(torch.equal(cnt, torch.cat([want[:, :1], want[:, 1 + 2 * d:]],
                                         1)),
              f"K6w {label} counts differ from the plain version")
        check(float(got[:, 0].sum()) == N, "K6w counts do not sum to n")
        errs = {sec: rel_err(got[:, lo:hi], want[:, lo:hi])
                for sec, lo, hi in (("lin", 1, 1 + d),
                                    ("quad_diag", 1 + d, 1 + 2 * d))}
        check(max(errs.values()) <= 1e-5, f"K6w {label}: rel errors {errs}")
        ms = cuda_ms(lambda: nb_grouped_sums(x, codes, None, y, **kw))
        plain_ms = cuda_ms(lambda: nb_grouped_sums_plain(x, codes, None, y,
                                                         **kw),
                           reps=2, warmup=1)
        abs_err = float((got - want).abs().max())
        res = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                   **nb_bound(N, schema, classes))
        log(f"[K6w] n={N} {label} G={classes} F={got.shape[1]} ({per_call} "
            f"launches a call): counts exact, rel err {errs}, max abs err "
            f"{abs_err:.3e}, bit-identical rerun; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']})")
        if label == "family":
            res["library_ms"] = library_nb_ms(x, codes, None, y, schema,
                                              classes)
            log(f"[K6w] library F@Wᵀ {res['library_ms']:.4f} ms")
            out = res
        else:
            out["onpromotion_ms"] = ms
    return out


def phase_k3w(seed: int) -> dict:
    """K3w with the tables of QDA trained on favorita_classify (K8 and f64
    training at 10M rows), over a plan of several tasks: label family (C =
    33) held against the plain scorer at 1M rows and timed at 10M; label
    onpromotion (C = 2) held and timed at 10M."""
    from duckdb_imputation_tpu_torch.models.device import qda_train_device
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain, qda_tables)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple_grouped
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    out = {}
    for label, n_check in (("family", 1_000_000), ("onpromotion", N)):
        x, codes, y, schema, classes = make_favorita_classify(
            N, seed + 24, label)
        sig = sigma_from_triple(sum_to_triple_grouped(
            x, codes, y, schema=schema, num_groups=classes))
        tables, plan = qda_tables(*qda_train_device(sig, float(N)),
                                  schema=schema)
        check(plan.num_tasks > 1, f"K3w {label}: the tables fit one task")
        xs, cs = x[:, :n_check].contiguous(), codes[:, :n_check].contiguous()
        before = qda_predict_kernel.wide_launches
        got = qda_predict_kernel(tables, plan, xs, cs, schema=schema)
        again = qda_predict_kernel(tables, plan, xs, cs, schema=schema)
        want = qda_predict_plain(tables, plan, xs, cs, schema=schema)
        torch.cuda.synchronize()
        check(qda_predict_kernel.wide_launches == before + 2,
              f"K3w {label} was not launched")
        check(torch.equal(got, again), "K3w repeated run not bit-identical")
        agree = float((got == want).float().mean())
        check(agree >= 0.9999, f"K3w {label} argmax agreement {agree}")
        ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, x, codes,
                                                schema=schema),
                     reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: qda_predict_plain(tables, plan, x, codes,
                                                     schema=schema),
                           reps=1, warmup=0)
        res = dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                   plain_ms=plain_ms,
                   **qda_bound(codes, schema, classes, tables.numel() * 4),
                   library_ms=None)
        log(f"[K3w] {label} C={classes} P={schema.sigma_size} "
            f"({plan.num_tasks} tasks, {tables.shape[1]} cells a class, "
            f"tables {tables.numel() * 4 / 2**20:.2f} MiB): argmax agreement "
            f"with the plain version at n={n_check} {agree:.7f}, "
            f"bit-identical rerun; at n={N} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']})")
        if label == "family":
            out = res
    return out


def _stages(label_table, model: str) -> dict:
    """ms of each stage of one pipeline (host clock around work that ends
    in a synchronize): aggregate, train, scorers (QDA's tables, packed from
    A_c in f64; NB builds its tables in predict), predict."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device, qda_predict_device,
        qda_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_tables)
    from duckdb_imputation_tpu_torch.ring.sum import (
        sum_to_nb_agg_grouped, sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    x, codes, y, schema, classes = label_table
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return r

    if model == "qda":
        sig = timed("aggregate", lambda: sigma_from_triple(
            sum_to_triple_grouped(x, codes, y, schema=schema,
                                  num_groups=classes)))
        params = timed("train", lambda: qda_train_device(sig, float(N)))
        tables, plan = timed("scorers", lambda: qda_tables(
            *params, schema=schema))
        timed("predict", lambda: qda_predict_kernel(tables, plan, x, codes,
                                                    schema=schema))
        ms["tasks"] = plan.num_tasks
        timed("predict_device", lambda: qda_predict_device(
            *params, x, codes, schema=schema))
    else:
        agg = timed("aggregate", lambda: sum_to_nb_agg_grouped(
            x, codes, y, schema=schema, num_groups=classes))
        params = timed("train", lambda: nb_train_device(
            agg.n, agg.lin, agg.quad_diag, agg.lin_cat))
        timed("predict", lambda: nb_predict_device(*params, x, codes,
                                                   schema=schema))
    return ms


def phase_classify_wide(seed: int) -> dict:
    """The classifier path at favorita_classify, 10M rows, through the
    entry points a user calls: QDA and NB for label onpromotion (unsorted
    entry: sort + K8; K6w; K3w for QDA, K3 for NB, whose tables have no
    cross tables and fit one task) and label family (sort + K8; K6w; K3w
    for QDA, K3 for NB). Launch
    counts checked exactly; accuracy against the true labels; card against
    CPU at 200k rows; ms per pipeline and per stage; the f64 SVD drivers
    of QDA training."""
    from duckdb_imputation_tpu_torch.ring.kernels._build import qda_plan
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple_grouped
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    tables = {label: make_favorita_classify(N, seed + 25, label)
              for label in LABELS}
    counters = [(grouped_gram, "launches"),
                (grouped_gram_presorted, "launches"),
                (grouped_gram_presorted, "wide_launches"),
                (nb_grouped_sums, "launches"),
                (qda_predict_kernel, "launches"),
                (qda_predict_kernel, "wide_launches")]
    torch.cuda.synchronize()
    for fn, attr in counters:
        setattr(fn, attr, 0)
    preds = {}
    for label, (x, codes, y, schema, classes) in tables.items():
        preds[label, "qda"] = qda_pipeline(x, codes, y, schema, classes)
        preds[label, "nb"] = nb_pipeline(x, codes, y, schema, classes)
    torch.cuda.synchronize()
    launches = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                for fn, attr in counters}
    log(f"[classify_wide] favorita_classify n={N}, QDA and NB for labels "
        f"onpromotion and family: launches {launches}")

    # the launches each pipeline must make, from the routes of its schema
    expect = dict.fromkeys(launches, 0)
    for label, (x, codes, y, schema, classes) in tables.items():
        expect["grouped_gram_presorted.wide_launches"] += 1
        expect["nb_grouped_sums.launches"] += 1
        for cross in (True, False):        # QDA's tables, NB's
            expect["qda_predict_kernel." + (
                "launches" if qda_plan(schema, cross).num_tasks == 1
                else "wide_launches")] += 1
    check(launches == expect, f"classifier launches {launches}, not {expect}")

    acc = {}
    for (label, model), pred in preds.items():
        y, classes = tables[label][2], tables[label][4]
        check(pred.shape == (N,) and pred.dtype == torch.int32,
              f"{label} {model}: prediction {tuple(pred.shape)} {pred.dtype}")
        check(bool(((pred >= 0) & (pred < classes)).all()),
              f"{label} {model}: class index out of range")
        prior = float(torch.bincount(y.long()).max()) / N
        acc[label, model] = float((pred == y).float().mean())
        # QDA learns family, a function of the class column, only weakly:
        # a row's class one-hot lies in the null space of every other
        # family's covariance, which the pseudo-inverse ignores
        # (tests/test_torch_classify_wide.py shows the f64 oracle alike)
        check(acc[label, model] > prior + 0.02,
              f"{label} {model}: accuracy {acc[label, model]} not above the "
              f"majority share {prior} + 0.02")
        log(f"[classify_wide] {label} {model}: accuracy {acc[label, model]:.5f}"
            f" against a majority share of {prior:.5f}")
    del preds

    agree = {}
    for label in LABELS:
        x, codes, y, schema, classes = make_favorita_classify(
            N_CLASSIFY_CPU, seed + 26, label)
        for model, pipe in (("qda", qda_pipeline), ("nb", nb_pipeline)):
            t0 = time.perf_counter()
            cpu = pipe(x.cpu(), codes.cpu(), y.cpu(), schema, classes)
            cpu_s = time.perf_counter() - t0
            card = pipe(x, codes, y, schema, classes).cpu()
            agree[label, model] = float((card == cpu).float().mean())
            log(f"[classify_wide] n={N_CLASSIFY_CPU} {label} {model}: card "
                f"vs CPU ({cpu_s:.1f} s) agreement {agree[label, model]:.6f}")
    check(min(agree.values()) >= 0.999,
          f"card vs CPU pipeline agreement {agree} < 0.999")

    for label, table in tables.items():
        x, codes, y, schema, classes = table
        for model, pipe in (("qda", qda_pipeline), ("nb", nb_pipeline)):
            ms = cuda_ms(lambda: pipe(x, codes, y, schema, classes), reps=2,
                         warmup=1)
            stages = _stages(table, model)
            log(f"[classify_wide] {label} {model} n={N}: {ms:.3f} ms per "
                f"pipeline (aggregate + train + predict, CUDA events, mean "
                f"of 2); stages (host clock, ms): "
                + json.dumps({k: round(v, 3) for k, v in stages.items()}))

    # the f64 SVD of QDA training at C = 33, m = 458, by driver
    x, codes, y, schema, classes = tables["family"]
    sig = sigma_from_triple(sum_to_triple_grouped(
        x, codes, y, schema=schema, num_groups=classes)).double()
    n_c = sig[:, 0, 0].clamp(min=1.0)[:, None, None]
    sv = sig[:, 0, 1:]
    cov = (sig[:, 1:, 1:] - sv[:, :, None] * sv[:, None, :] / n_c) / n_c
    drivers = {}
    for driver in (None, "gesvd", "gesvdj", "gesvda"):
        try:
            torch.linalg.svd(cov, driver=driver)
            drivers[str(driver)] = cuda_ms(
                lambda: torch.linalg.svd(cov, driver=driver), reps=2,
                warmup=0)
        except RuntimeError as e:      # a driver this build lacks
            drivers[str(driver)] = f"unavailable: {str(e).splitlines()[0]}"
    log(f"[classify_wide] f64 SVD of {classes} covariances of "
        f"{cov.shape[-1]}²: ms by driver {drivers}")
    return {"grouped_wide_gram":
            launches["grouped_gram_presorted.wide_launches"],
            "nb_grouped_sums_wide": launches["nb_grouped_sums.launches"],
            "qda_predict_wide": launches["qda_predict_kernel.wide_launches"]}


# ---------------------------------------------------------------------------
# Factorized learning over joins: run_mice_factorized and run_mice_star on
# the normalized Favorita schema (favorita_star)
# ---------------------------------------------------------------------------

# favorita_star: the Kaggle "Corporacion Favorita Grocery Sales
# Forecasting" tables, normalized as published: the fact table train.csv
# (unit_sales; onpromotion) with the foreign keys store_nbr and item_nbr,
# stores.csv (54 rows: city, state, type, cluster) and items.csv (4,100
# rows: family, class, perishable).
STORES, ITEMS = 54, 4_100
STORE_VOCABS = (22, 16, 5, 17)     # city, state, type, cluster
ITEM_VOCABS = (33, 337, 2)         # family, class, perishable
STAR_ROUNDS = 2
N_STAR_CPU = 200_000               # the star drivers on the CPU, held
                                   # against the card's


def _star_table(x, codes, vocabs, num_null=None, cat_null=None):
    """A Table of x f32[d, n], codes i32[c, n] over the vocabs, nulls
    (None: none) zeroed."""
    from duckdb_imputation_tpu_torch import FeatureSchema, Table

    if num_null is None:
        num_null = torch.zeros_like(x, dtype=torch.bool)
    if cat_null is None:
        cat_null = torch.zeros_like(codes, dtype=torch.bool)
    return Table(num_data=torch.where(num_null, 0.0, x).contiguous(),
                 cat_codes=torch.where(cat_null, 0, codes).contiguous(),
                 num_null=num_null, cat_null=cat_null,
                 schema=FeatureSchema(num_cols=x.shape[0], cat_keys=tuple(
                     tuple(range(v)) for v in vocabs)))


def make_favorita_star(n: int, seed: int, *, null_frac: float = 0.2,
                       device=None) -> dict:
    """favorita_star made on the device from `seed`, with the dataset's
    hierarchy: a store's state is its city's; every class has at least one
    item and every family at least one class; an item's family is its
    class's, perishable its family's. Fact rows: stores uniform, items by
    Zipf row shares (weight 1/rank, ranks shuffled: an assumption, as in
    make_favorita), 20% on promotion; unit_sales = class level + store
    level + 1.5·onpromotion + 0.5·N(0, 1). `null_frac` MCAR nulls in
    unit_sales and onpromotion. Returns the tables `fact` (unit_sales;
    store_nbr, onpromotion: the fact of [factorized], which keeps the
    store as a feature), `star_fact` (unit_sales; onpromotion), `stores`,
    `items`, the keys `store`, `item` (i64[n]) and `truth`."""
    dev = DEVICE if device is None else device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    i32 = torch.int32

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=g, device=dev,
                             dtype=i32)

    def onto(parents, children):
        """A parent of each child, every parent taken at least once."""
        p = torch.cat([torch.arange(parents, device=dev, dtype=i32),
                       randint(parents, children - parents)])
        return p[torch.randperm(children, generator=g, device=dev)]

    cities, states, types, clusters = STORE_VOCABS
    families, classes, _ = ITEM_VOCABS
    city = randint(cities, STORES)
    store_codes = torch.stack([city, randint(states, cities)[city.long()],
                               randint(types, STORES),
                               randint(clusters, STORES)])
    family_of_class = onto(families, classes)
    class_of_item = onto(classes, ITEMS)
    family = family_of_class[class_of_item.long()]
    item_codes = torch.stack([family, class_of_item,
                              randint(2, families)[family.long()]])
    store_level = torch.randn(STORES, generator=g, device=dev)
    class_level = torch.randn(classes, generator=g, device=dev)

    store = randint(STORES, n).long()
    rank = torch.randperm(ITEMS, generator=g, device=dev) + 1
    item = torch.multinomial(1.0 / rank.double(), n, replacement=True,
                             generator=g)
    promo = (torch.rand(n, generator=g, device=dev) < 0.2).to(i32)
    unit_sales = (class_level[class_of_item[item].long()]
                  + store_level[store] + 1.5 * promo
                  + 0.5 * torch.randn(n, generator=g, device=dev))
    num_null = (torch.rand(n, generator=g, device=dev) < null_frac)[None]
    promo_null = (torch.rand(n, generator=g, device=dev) < null_frac)[None]
    x = unit_sales[None]
    fact = _star_table(x, torch.stack([store.to(i32), promo]),
                       (STORES, 2), num_null,
                       torch.cat([torch.zeros_like(promo_null), promo_null]))
    star_fact = _star_table(x, promo[None], (2,), num_null, promo_null)
    none = torch.zeros((0, STORES), device=dev)
    stores = _star_table(none, store_codes, STORE_VOCABS)
    items = _star_table(torch.zeros((0, ITEMS), device=dev), item_codes,
                        ITEM_VOCABS)
    return dict(fact=fact, star_fact=star_fact, stores=stores, items=items,
                store=store, item=item,
                truth=dict(unit_sales=unit_sales, onpromotion=promo))


def _star_cpu(t):
    """A Table's copy on the CPU."""
    import dataclasses

    return dataclasses.replace(
        t, num_data=t.num_data.cpu(), cat_codes=t.cat_codes.cpu(),
        num_null=t.num_null.cpu(), cat_null=t.cat_null.cpu())


def _call_timer():
    """A device-synchronized PhaseTimer that also keeps every phase call's
    seconds in order, so that each round's split can be read."""
    import contextlib

    from duckdb_imputation_tpu_torch.utils import PhaseTimer

    class CallTimer(PhaseTimer):
        def __init__(self):
            super().__init__(sync=torch.cuda.synchronize)
            self.calls = []

        @contextlib.contextmanager
        def phase(self, name):
            before = self.totals[name]
            with PhaseTimer.phase(self, name):
                yield
            self.calls.append((name, self.totals[name] - before))

    return CallTimer()


def _round_split(timer, rounds: int) -> list:
    """ms per phase of each round (`prepare` counts in round 1)."""
    calls = timer.calls
    per = (len(calls) - 1) // rounds
    out = []
    for r in range(rounds):
        split = {}
        for name, s in ([calls[0]] if r == 0 else []) + \
                calls[1 + r * per:1 + (r + 1) * per]:
            split[name] = round(split.get(name, 0.0) + s * 1e3, 3)
        out.append(split)
    return out


def _join_checks(tag, got, want, schema) -> float:
    """A join's sigma against the materialized join's (K7): finite, counts
    exact, within 1e-5 of max|σ|. Returns the error."""
    check(torch.isfinite(got).all(), f"{tag} sigma not finite")
    counts = count_entries(schema)
    check(torch.equal(got[counts], want[counts]),
          f"{tag} counts differ from the materialized join's")
    err = rel_err(got, want)
    check(err <= 1e-5, f"{tag} max rel error {err:.3e} > 1e-5")
    return err


def _star_quality(tag, t, out, truth, fact_only) -> dict:
    """Imputed unit_sales (numeric 0) RMSE below the mean fill's and the
    fact-only run's; onpromotion (the last categorical column) accuracy on
    its null cells at least its mode share there; observed cells kept."""
    from duckdb_imputation_tpu_torch.mice import init_fill

    check(torch.isfinite(out.num_data).all(), f"{tag}: x not finite")
    check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null])
          and torch.equal(out.cat_codes[~t.cat_null],
                          t.cat_codes[~t.cat_null]),
          f"{tag}: observed cells changed")
    nm, cm = t.num_null[0], t.cat_null[-1]
    us, promo = truth["unit_sales"], truth["onpromotion"]

    def rmse(o):
        return float(((o.num_data[0] - us)[nm] ** 2).mean().sqrt())

    q = dict(rmse=rmse(out), mean_fill=rmse(init_fill(t)),
             fact_only=rmse(fact_only))
    share = float(promo[cm].float().mean())
    q["mode_share"] = max(share, 1.0 - share)
    q["promo_acc"] = float((out.cat_codes[-1][cm] == promo[cm])
                           .float().mean())
    check(q["rmse"] < q["mean_fill"] and q["rmse"] < q["fact_only"],
          f"{tag}: unit_sales RMSE {q} not below the mean fill's and the "
          f"fact-only run's")
    check(q["promo_acc"] >= q["mode_share"],
          f"{tag}: onpromotion accuracy {q} below its mode share")
    return q


def _card_vs_cpu(tag, run, small: dict, fact: str) -> None:
    """`run(tables)` on the card and on the CPU at N_STAR_CPU rows: the
    imputed onpromotion of the fact table `small[fact]` agrees on ≥ 0.999
    of its null cells; unit_sales within 1e-2 (the bound of [host_mice])
    on the rows whose imputed codes agree (a row whose onpromotion differs
    in round 1 is predicted 1.5 apart); the RMSE of imputed unit_sales
    within 1% of the CPU's."""
    got = run(small)
    cpu = {k: _star_cpu(v) if hasattr(v, "num_data") else v.cpu()
           for k, v in small.items() if k != "truth"}
    ref = run(cpu)
    t = small[fact]
    cm, nm = t.cat_null[-1].cpu(), t.num_null[0].cpu()
    same = (got.cat_codes.cpu() == ref.cat_codes).all(0)
    agree = float(same[cm].float().mean())
    dx = (got.num_data.cpu() - ref.num_data).abs().max(0).values
    us = small["truth"]["unit_sales"].cpu()

    def rmse(o):
        return float(((o.num_data[0].cpu() - us)[nm] ** 2).mean().sqrt())

    r_card, r_cpu = rmse(got), rmse(ref)
    log(f"[{tag}] n={N_STAR_CPU} on the card vs on the CPU: onpromotion "
        f"agreement {agree:.6f} on its null cells; unit_sales max diff "
        f"{float(dx[same].max()):.3e} on the rows whose codes agree "
        f"({float(dx.max()):.3e} on all); RMSE of imputed unit_sales "
        f"{r_card:.6f} (CPU {r_cpu:.6f})")
    check(agree >= 0.999, f"{tag} card vs CPU: agreement {agree}")
    check(float(dx[same].max()) < 1e-2,
          f"{tag} card vs CPU: x diff {float(dx[same].max())}")
    check(abs(r_card - r_cpu) <= 0.01 * r_cpu,
          f"{tag} card vs CPU: RMSE {r_card} against {r_cpu}")


def phase_factorized(seed: int) -> dict:
    """run_mice_factorized over favorita_star's fact ⋈ items on item_nbr
    at N rows (P_fact = 58, P_items = 373, joined P = 430): the train
    triple of unit_sales (K5 of the fact rows by item after a sort, K8 of
    the items, the f64 contraction over the 4,100 keys) against the
    materialized join's (K7), against the same triple from the plain
    grouped path on the card and from `api.factorized_sum`; STAR_ROUNDS
    rounds with noise off: exact launches (K8 1, K5 2 a round, no K4),
    quality against mean fill and run_mice_baseline on the fact alone,
    PhaseTimer split per round, the cofactor step's time against K7 on
    the materialized join, card against CPU. Returns the launches."""
    import numpy as np

    from duckdb_imputation_tpu_torch import (api, run_mice_baseline,
                                             run_mice_factorized)
    from duckdb_imputation_tpu_torch.mice import init_fill, observed_weights
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, sort_by_group)
    from duckdb_imputation_tpu_torch.ring.sum import (sum_to_triple,
                                                      sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import (factorized_join_sum,
                                                         sigma_from_triple)

    s = make_favorita_star(N, seed + 30)
    fact, items, item = s["fact"], s["items"], s["item"]
    fs, ds = fact.schema, items.schema
    joined = fs.concat(ds)
    log(f"[factorized] favorita_star fact ⋈ items on item_nbr: n={N}, "
        f"P_fact={fs.sigma_size}, P_items={ds.sigma_size} ({ITEMS} keys), "
        f"joined P={joined.sigma_size}")

    filled = init_fill(fact)
    w = observed_weights(filled, "num", 0)
    keys = torch.arange(ITEMS, device=DEVICE)

    def fact_side(method="auto"):
        return sum_to_triple_grouped(filled.num_data, filled.cat_codes, item,
                                     schema=fs, num_groups=ITEMS, weights=w,
                                     method=method)

    def materialize():
        return (torch.cat([filled.num_data, items.num_data[:, item]]),
                torch.cat([filled.cat_codes, items.cat_codes[:, item]]))

    dim_g = sum_to_triple_grouped(items.num_data, items.cat_codes, keys,
                                  schema=ds, num_groups=ITEMS)
    got = sigma_from_triple(factorized_join_sum(fact_side(), dim_g))
    jn, jc = materialize()
    want = sigma_from_triple(sum_to_triple(jn, jc, w, schema=joined))
    err = _join_checks("[factorized] train triple vs materialized join",
                       got, want, joined)
    plain_dim = sum_to_triple_grouped(items.num_data, items.cat_codes, keys,
                                      schema=ds, num_groups=ITEMS,
                                      method="sorted")
    plain = sigma_from_triple(factorized_join_sum(fact_side("sorted"),
                                                  plain_dim))
    del plain_dim
    err_plain = _join_checks("[factorized] plain grouped path vs "
                             "materialized join", plain, want, joined)
    host = [a.cpu().numpy() for a in (filled.num_data[0], *filled.cat_codes,
                                      w, item, *items.cat_codes)]
    us, st, pr, w_np, item_np, fam, cls, per = host
    a = api.sum_to_triple(us, st, pr, weights=w_np, group_by=item_np,
                          num_groups=ITEMS, schema=fs, device=DEVICE)
    b = api.sum_to_triple(fam, cls, per, group_by=np.arange(ITEMS),
                          num_groups=ITEMS, schema=ds, device=DEVICE)
    via_api = sigma_from_triple(api.factorized_sum(a, b).triple)
    del a, b, host
    check(torch.equal(via_api, got),
          "[factorized] api.factorized_sum differs from the driver's triple")
    log(f"[factorized] train triple of unit_sales: vs the materialized "
        f"join's K7 triple max rel err {err:.3e}; plain grouped path on the "
        f"card {err_plain:.3e} (vs the kernels' {rel_err(got, plain):.3e}); "
        f"api.factorized_sum of api.sum_to_triple(group_by=item_nbr) "
        f"bit-identical; counts exact")
    del plain, via_api

    fz_ms = cuda_ms(lambda: factorized_join_sum(fact_side(), dim_g), reps=5,
                    warmup=1)
    fact_ms = cuda_ms(fact_side, reps=5, warmup=1)
    k7_ms = cuda_ms(lambda: sum_to_triple(jn, jc, w, schema=joined), reps=5,
                    warmup=1)
    mat_ms = cuda_ms(lambda: sum_to_triple(*materialize(), w, schema=joined),
                     reps=5, warmup=1)
    log(f"[factorized] cofactor step (fact sort + K5 + f64 contraction over "
        f"{ITEMS} keys) {fz_ms:.3f} ms, of it the fact side (sort + K5) "
        f"{fact_ms:.3f}; one K7 aggregation of the materialized join "
        f"{k7_ms:.3f} ms, with its gather {mat_ms:.3f}")
    del got, want, jn, jc, dim_g

    # K5 (fact rows by item, P = 58) and K8 (items, P = 373) alone at
    # G = 4,100, on rows already sorted by key
    alone = {}
    for name, t_, ids, weights in (("k5", filled, item, w),
                                   ("k8", items, keys, None)):
        xs, cs, ws, layout = sort_by_group(
            t_.num_data, t_.cat_codes, ids, schema=t_.schema,
            num_groups=ITEMS, weights=weights)
        ms = cuda_ms(lambda: grouped_gram_presorted(xs, cs, ws, layout,
                                                    schema=t_.schema),
                     reps=5, warmup=1)
        alone[name] = dict(ms=ms, **gram_bound(cs, t_.schema, ws,
                                               groups=ITEMS, extra=8))
        del xs, cs, ws, layout
    log(f"[factorized] alone at G={ITEMS}, rows sorted by key: K5 (fact, "
        f"P={fs.sigma_size}) {alone['k5']['ms']:.4f} ms, bound "
        f"{alone['k5']['bound_ms']:.4f} ms ({alone['k5']['bound_by']}); K8 "
        f"(items, P={ds.sigma_size}) {alone['k8']['ms']:.4f} ms, bound "
        f"{alone['k8']['bound_ms']:.4f} ms ({alone['k8']['bound_by']})")

    torch.cuda.synchronize()
    grouped_gram.launches = 0
    grouped_gram_presorted.launches = grouped_gram_presorted.wide_launches = 0
    timer = _call_timer()
    t0 = time.perf_counter()
    out = run_mice_factorized(fact, item, items, iters=STAR_ROUNDS,
                              noise=False, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(grouped_gram=grouped_gram.launches,
                    grouped_gram_presorted=grouped_gram_presorted.launches,
                    grouped_wide_gram=grouped_gram_presorted.wide_launches)
    expect = dict(grouped_gram=0, grouped_gram_presorted=2 * STAR_ROUNDS,
                  grouped_wide_gram=1)
    log(f"[factorized] run_mice_factorized rounds={STAR_ROUNDS}: launches "
        f"{launches} (expected {expect}); wall {wall * 1e3:.3f} ms; "
        f"PhaseTimer ms per round {_round_split(timer, STAR_ROUNDS)}")
    check(launches == expect, f"run_mice_factorized launched {launches}")
    fact_only = run_mice_baseline(fact, iters=STAR_ROUNDS, noise=False)
    q = _star_quality("factorized", fact, out, s["truth"], fact_only)
    log(f"[factorized] quality {q}")
    del out, fact_only, s, filled

    def run(t):
        return run_mice_factorized(t["fact"], t["item"], t["items"],
                                   iters=STAR_ROUNDS, noise=False)

    _card_vs_cpu("factorized", run, make_favorita_star(N_STAR_CPU, seed + 31),
                 "fact")
    return dict(launches, alone=alone)


def phase_star(seed: int) -> dict:
    """run_mice_star over favorita_star's fact ⋈ stores ⋈ items at N rows
    (joined P = 436): star_join_triple (K1 of the fact columns at P = 4,
    K6 of the fact rows by store and by item, the stores × items
    co-occurrence by bincount) against the materialized join's K7 triple;
    STAR_ROUNDS rounds with noise off: exact launches (K1 1 and K6 2 a
    column step), quality, PhaseTimer split per round, the cofactor
    step's time against K7, card against CPU. Returns the launches."""
    from duckdb_imputation_tpu_torch import run_mice_baseline, run_mice_star
    from duckdb_imputation_tpu_torch.mice import init_fill, observed_weights
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram)
    from duckdb_imputation_tpu_torch.ring.star import (star_join_triple,
                                                       star_schema)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    s = make_favorita_star(N, seed + 32)
    fact, stores, items = s["star_fact"], s["stores"], s["items"]
    store, item = s["store"], s["item"]
    fs, dss = fact.schema, [stores.schema, items.schema]
    js = star_schema(fs, dss)
    log(f"[star] favorita_star fact ⋈ stores ⋈ items: n={N}, P_fact="
        f"{fs.sigma_size}, P_stores={dss[0].sigma_size} ({STORES} keys), "
        f"P_items={dss[1].sigma_size} ({ITEMS} keys), joined P="
        f"{js.sigma_size}")
    filled = init_fill(fact)
    w = observed_weights(filled, "num", 0)
    dims = [(stores.num_data, stores.cat_codes),
            (items.num_data, items.cat_codes)]

    def star_triple():
        return star_join_triple(filled.num_data, filled.cat_codes, w,
                                keys=[store, item], dims=dims,
                                fact_schema=fs, dim_schemas=dss)

    def materialize():
        return (filled.num_data,
                torch.cat([filled.cat_codes, stores.cat_codes[:, store],
                           items.cat_codes[:, item]]))

    got = sigma_from_triple(star_triple())
    jn, jc = materialize()
    want = sigma_from_triple(sum_to_triple(jn, jc, w, schema=js))
    err = _join_checks("[star] star_join_triple vs materialized join", got,
                       want, js)
    star_ms = cuda_ms(star_triple, reps=5, warmup=1)
    k7_ms = cuda_ms(lambda: sum_to_triple(jn, jc, w, schema=js), reps=5,
                    warmup=1)
    mat_ms = cuda_ms(lambda: sum_to_triple(*materialize(), w, schema=js),
                     reps=5, warmup=1)
    log(f"[star] star_join_triple vs the materialized join's K7 triple: max "
        f"rel err {err:.3e}, counts exact; cofactor step {star_ms:.3f} ms; "
        f"one K7 aggregation of the materialized join {k7_ms:.3f} ms, with "
        f"its gather {mat_ms:.3f}")
    del got, want, jn, jc

    torch.cuda.synchronize()
    masked_gram.launches = masked_gram.wide_launches = 0
    nb_grouped_sums.launches = 0
    timer = _call_timer()
    t0 = time.perf_counter()
    out = run_mice_star(fact, [store, item], [stores, items],
                        iters=STAR_ROUNDS, noise=False, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(masked_gram=masked_gram.launches,
                    wide_gram=masked_gram.wide_launches,
                    nb_grouped_sums=nb_grouped_sums.launches)
    expect = dict(masked_gram=2 * STAR_ROUNDS, wide_gram=0,
                  nb_grouped_sums=2 * 2 * STAR_ROUNDS)
    log(f"[star] run_mice_star rounds={STAR_ROUNDS}: launches {launches} "
        f"(expected {expect}); wall {wall * 1e3:.3f} ms; PhaseTimer ms per "
        f"round {_round_split(timer, STAR_ROUNDS)}")
    check(launches == expect, f"run_mice_star launched {launches}")
    fact_only = run_mice_baseline(fact, iters=STAR_ROUNDS, noise=False)
    q = _star_quality("star", fact, out, s["truth"], fact_only)
    log(f"[star] quality {q}")
    del out, fact_only, s, filled

    def run(t):
        return run_mice_star(t["star_fact"], [t["store"], t["item"]],
                             [t["stores"], t["items"]], iters=STAR_ROUNDS,
                             noise=False)

    _card_vs_cpu("star", run, make_favorita_star(N_STAR_CPU, seed + 33),
                 "star_fact")
    return launches


# ---------------------------------------------------------------------------
# The row-sharded MICE loops over torch.distributed and their checkpoints
# ---------------------------------------------------------------------------

N_CKPT = 1_000_000
SHARDED2_DEADLINE_S = 300


def _store(path: str, world: int):
    import torch.distributed as dist
    return dist.FileStore(path, world)


def _slope(fn, reps: int = 2) -> float:
    """ms per round: the slope of fn(1) and fn(3) by CUDA events."""
    one = cuda_ms(lambda: fn(1), reps=reps, warmup=1)
    three = cuda_ms(lambda: fn(3), reps=reps, warmup=1)
    return (three - one) / 2


def _sharded_vs_device(tag, t, mesh, seed, gram, fused) -> dict:
    """run_mice_sharded ('gram', 'fused', 'fused' with noise) and
    run_mice_sharded_delta on one table and a world of one, each
    bit-identical to run_mice_device / run_mice_device_delta with the same
    kernel; launches of the sharded runs alone against the derived counts
    (ROUNDS rounds, 2 null columns: 'gram' 2 a round, 'fused' 1 seed + 2 a
    round, delta 1 + 4 a round); ms per round against run_mice_device's."""
    from duckdb_imputation_tpu_torch import (run_mice_device,
                                             run_mice_device_delta)
    from duckdb_imputation_tpu_torch.mice import (run_mice_sharded,
                                                  run_mice_sharded_delta)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols)

    def reset():
        torch.cuda.synchronize()
        masked_gram_cols.launches = masked_gram_cols.wide_launches = 0
        fused_impute_aggregate.launches = 0
        fused_impute_aggregate.wide_launches = 0

    def read():
        torch.cuda.synchronize()
        return {gram: getattr(masked_gram_cols, _COUNT[gram]),
                fused: getattr(fused_impute_aggregate, _COUNT[fused])}

    launches = {gram: 0, fused: 0}
    cases = (("gram", dict(kernel="gram"), {gram: 2 * ROUNDS, fused: 0}),
             ("fused", dict(kernel="fused"), {gram: 1, fused: 2 * ROUNDS}),
             ("fused+noise", dict(kernel="fused", noise=True, seed=seed),
              {gram: 1, fused: 2 * ROUNDS}))
    for name, kw, want in cases:
        reset()
        got = run_mice_sharded(t, iters=ROUNDS, mesh=mesh, **kw)
        counts = read()
        ref = run_mice_device(t, iters=ROUNDS, **kw)
        check(counts == want, f"{tag} {name}: sharded launches {counts}, "
              f"derived {want}")
        check(torch.equal(got.num_data, ref.num_data)
              and torch.equal(got.cat_codes, ref.cat_codes),
              f"{tag} {name}: run_mice_sharded at world 1 differs from "
              f"run_mice_device")
        for k in launches:
            launches[k] += counts[k]
    reset()
    got = run_mice_sharded_delta(t, iters=ROUNDS, mesh=mesh)
    counts = read()
    ref = run_mice_device_delta(t, iters=ROUNDS)
    want = {gram: 1 + 4 * ROUNDS, fused: 0}
    check(counts == want, f"{tag} delta: sharded launches {counts}, derived "
          f"{want}")
    check(torch.equal(got.num_data, ref.num_data)
          and torch.equal(got.cat_codes, ref.cat_codes),
          f"{tag} delta: run_mice_sharded_delta at world 1 differs")
    launches[gram] += counts[gram]
    del got, ref
    per_round = {
        "sharded gram": _slope(lambda k: run_mice_sharded(
            t, iters=k, kernel="gram", mesh=mesh)),
        "device gram": _slope(lambda k: run_mice_device(
            t, iters=k, kernel="gram")),
        "sharded fused": _slope(lambda k: run_mice_sharded(
            t, iters=k, kernel="fused", mesh=mesh)),
        "device fused": _slope(lambda k: run_mice_device(
            t, iters=k, kernel="fused")),
    }
    log(f"[sharded] {tag}: run_mice_sharded gram, fused, fused with noise "
        f"and run_mice_sharded_delta bit-identical to run_mice_device / "
        f"run_mice_device_delta; launches of the sharded runs {launches} "
        f"(as derived); ms per round (slope of 1 vs 3 rounds, CUDA events)"
        f" {per_round}")
    return launches


_COUNT = {"masked_gram_cols": "launches", "wide_gram": "wide_launches",
          "fused_impute_aggregate": "launches",
          "fused_impute_aggregate_wide": "wide_launches"}


def phase_sharded(seed: int, mesh) -> dict:
    """A world of one on NCCL: run_mice_sharded / _delta against
    run_mice_device / _delta at config 5 and favorita_wide, N rows; then
    the sharded aggregates against the single-process ones
    (sum_to_triple_sharded: K1's stacked entry; sum_to_triple_grouped_
    sharded at config 4, 8 classes: K4; factorized_join_sum_sharded of the
    config-4 table with itself over 1,000 keys: a sort and K5 a side).
    Returns the sharded runs' launches."""
    from duckdb_imputation_tpu_torch.parallel import (
        factorized_join_sum_sharded, sum_to_triple_grouped_sharded,
        sum_to_triple_sharded)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted)
    from duckdb_imputation_tpu_torch.ring.sum import (sum_to_triple,
                                                      sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import (factorized_join_sum,
                                                         sigma_from_triple)

    log(f"[sharded] world {mesh.world} on {mesh.backend}, rank {mesh.rank} "
        f"on {mesh.device}")
    t, _ = make_table(N, seed + 40)
    launches = _sharded_vs_device("config 5", t, mesh, seed,
                                  "masked_gram_cols", "fused_impute_aggregate")
    del t
    t, _ = make_favorita(N, seed + 41)
    launches.update(_sharded_vs_device(
        "favorita_wide", t, mesh, seed, "wide_gram",
        "fused_impute_aggregate_wide"))
    del t

    x, codes, y, schema = make_classify_table(N, seed + 42)
    torch.cuda.synchronize()
    masked_gram.launches = grouped_gram.launches = 0
    grouped_gram_presorted.launches = 0
    got = sum_to_triple_sharded(x, codes, None, schema=schema, mesh=mesh)
    grp = sum_to_triple_grouped_sharded(x, codes, y, schema=schema,
                                        num_groups=CLASSES, mesh=mesh)
    keys = torch.remainder(torch.arange(N, device=DEVICE) * 7919, 1000)
    join = factorized_join_sum_sharded(x, codes, keys, x, codes, keys,
                                       schema1=schema, schema2=schema,
                                       num_keys=1000, mesh=mesh)
    torch.cuda.synchronize()
    agg = {"masked_gram": masked_gram.launches,
           "grouped_gram": grouped_gram.launches,
           "grouped_gram_presorted": grouped_gram_presorted.launches}
    want = {"masked_gram": 1, "grouped_gram": 1, "grouped_gram_presorted": 2}
    check(agg == want, f"[sharded] aggregate launches {agg}, derived {want}")
    single = sum_to_triple_grouped(x, codes, keys, schema=schema,
                                   num_groups=1000)
    for name, a, b in (
            ("sum_to_triple_sharded", got, sum_to_triple(x, codes, None,
                                                         schema=schema)),
            ("sum_to_triple_grouped_sharded", grp, sum_to_triple_grouped(
                x, codes, y, schema=schema, num_groups=CLASSES)),
            ("factorized_join_sum_sharded", join,
             factorized_join_sum(single, single))):
        check(torch.equal(sigma_from_triple(a), sigma_from_triple(b)),
              f"[sharded] {name} at world 1 differs from one process")
    log(f"[sharded] sum_to_triple_sharded, sum_to_triple_grouped_sharded "
        f"(G={CLASSES}) and factorized_join_sum_sharded (1,000 keys) "
        f"bit-identical to one process; launches {agg} (as derived)")
    launches.update(agg)
    return launches


def sharded_rank(rank: int, world: int, out_dir: str, seed: int) -> int:
    """One rank of [sharded2] (a child process): gloo over CUDA tensors,
    the rank's half of the config-5 table; writes its results to
    out_dir/rank<rank>.pt."""
    from duckdb_imputation_tpu_torch.mice import run_mice_sharded
    from duckdb_imputation_tpu_torch.parallel import (
        initialize, local_shard, shutdown, sum_to_triple_sharded)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    import datetime
    mesh = initialize("gloo", store=_store(f"{out_dir}/store", world),
                      world_size=world, rank=rank, device=DEVICE,
                      timeout=datetime.timedelta(seconds=120))
    tables = {"fused": make_table(N, seed + 40)[0],
              "fused_noise": make_table(N, seed + 45, noise_fixture=True)[0]}
    out = {}
    local = local_shard(tables["fused"], mesh)
    sig = sigma_from_triple(sum_to_triple_sharded(
        local.num_data, local.cat_codes, (~local.num_null[1]).float(),
        schema=local.schema, mesh=mesh))
    out["sigma"] = sig.cpu()
    for name, kw in (("fused", {}), ("fused_noise",
                                     dict(noise=True, seed=seed))):
        local = local_shard(tables.pop(name), mesh)
        torch.cuda.synchronize()
        masked_gram_cols.launches = fused_impute_aggregate.launches = 0
        masked_gram.launches = 0
        got = run_mice_sharded(local, iters=ROUNDS, kernel="fused",
                               mesh=mesh, **kw)
        torch.cuda.synchronize()
        out[name] = dict(
            x1=got.num_data[1][local.num_null[1]].cpu(),
            c0=got.cat_codes[0][local.cat_null[0]].cpu(),
            c0_at_x1=got.cat_codes[0][local.num_null[1]].cpu(),
            observed_same=bool(
                torch.equal(got.num_data[~local.num_null],
                            local.num_data[~local.num_null])
                and torch.equal(got.cat_codes[~local.cat_null],
                                local.cat_codes[~local.cat_null])),
            launches={"masked_gram_cols": masked_gram_cols.launches,
                      "fused_impute_aggregate":
                          fused_impute_aggregate.launches})
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    shutdown()
    return 0


def phase_sharded2(seed: int, mesh) -> dict:
    """Two ranks on gloo over CUDA tensors, spawned as processes that
    share the card, each holding half of the config-5 table (N rows):
    the all-reduced sigma and run_mice_sharded 'fused' (noise off and on)
    against world size 1 (NCCL, this process): counts exact, codes equal
    on ≥ 0.9999 of the null rows, imputed x within 1e-3 relative (noise
    off); with noise, on the noise fixture's table (x1 = 2·x0 + 0.5·eps:
    in config 5, x1 is exact in x0 and x2, and the residual std the noise
    scales by is rounding error, different for any order of the sums),
    codes equal on ≥ 0.9999 of the null rows and, in the rows whose c0
    agrees, test_mice_sharded_noise_mesh_invariant's bounds (rtol 1e-4,
    atol 5e-4). At 2M imputed codes a few lie within the sums' rounding of
    a tie between two classes, and the two world sizes round the sums in
    another order (each rank's f32 sigma, then their sum); a flipped c0
    moves that row's x1 by the class coefficients' difference. Each rank's
    launches exact. Every child is killed at the deadline."""
    import tempfile

    from duckdb_imputation_tpu_torch.mice import run_mice_sharded
    from duckdb_imputation_tpu_torch.parallel import sum_to_triple_sharded
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    tables = {"fused": make_table(N, seed + 40)[0],
              "fused_noise": make_table(N, seed + 45, noise_fixture=True)[0]}
    t = tables["fused"]
    want_sig = sigma_from_triple(sum_to_triple_sharded(
        t.num_data, t.cat_codes, (~t.num_null[1]).float(), schema=t.schema,
        mesh=mesh)).cpu()
    want = {name: run_mice_sharded(tables[name], iters=ROUNDS,
                                   kernel="fused", mesh=mesh, **kw)
            for name, kw in (("fused", {}),
                             ("fused_noise", dict(noise=True, seed=seed)))}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--sharded-rank", str(r),
             "--sharded-dir", d, "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                left = SHARDED2_DEADLINE_S - (time.perf_counter() - t0)
                logs.append(p.communicate(timeout=max(1.0, left))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"[sharded2] rank {r} failed "
                  f"({p.returncode}):\n{text[-4000:]}")
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(2)]
    err = rel_err(ranks[0]["sigma"], want_sig)
    cm = count_entries(t.schema).cpu()
    check(torch.equal(ranks[0]["sigma"][cm], want_sig[cm])
          and torch.equal(ranks[0]["sigma"], ranks[1]["sigma"]),
          "[sharded2] the all-reduced counts differ from world 1's")
    check(err <= 1e-5, f"[sharded2] sigma max rel err {err:.3e} > 1e-5")
    out = {"sigma_rel_err": err, "wall_s": wall}
    for name, ref in want.items():
        # the null rows of rank 0's half, then rank 1's: the whole table's
        t = tables[name]
        x_ref = ref.num_data[1][t.num_null[1]].cpu()
        c_ref = ref.cat_codes[0][t.cat_null[0]].cpu()
        x2 = torch.cat([r[name]["x1"] for r in ranks])
        c2 = torch.cat([r[name]["c0"] for r in ranks])
        same_c0 = (torch.cat([r[name]["c0_at_x1"] for r in ranks])
                   == ref.cat_codes[0][t.num_null[1]].cpu())
        check(all(r[name]["observed_same"] for r in ranks),
              f"[sharded2] {name}: observed cells changed")
        derived = {"masked_gram_cols": 1,
                   "fused_impute_aggregate": 2 * ROUNDS}
        check(all(r[name]["launches"] == derived for r in ranks),
              f"[sharded2] {name}: launches "
              f"{[r[name]['launches'] for r in ranks]}, derived {derived}")
        agree = float((c2 == c_ref).float().mean())
        dx = float(((x2 - x_ref).abs() / x_ref.abs().clamp(min=1.0)).max())
        check(agree >= 0.9999, f"[sharded2] {name} code agreement {agree}")
        if name == "fused":
            check(dx <= 1e-3, f"[sharded2] imputed x rel diff {dx:.3e}")
        else:
            check(torch.allclose(x2[same_c0], x_ref[same_c0], rtol=1e-4,
                                 atol=5e-4),
                  f"[sharded2] noisy x beyond rtol 1e-4, atol 5e-4 where c0 "
                  f"agrees: max |Δx| "
                  f"{float((x2 - x_ref)[same_c0].abs().max()):.3e}")
        out[name] = dict(
            code_agreement=agree, codes_differ=int((c2 != c_ref).sum()),
            x_rel_diff=dx, x_max_abs_diff=float((x2 - x_ref).abs().max()),
            x_max_abs_diff_same_c0=float((x2 - x_ref)[same_c0].abs().max()),
            x1_rows_c0_differs=int((~same_c0).sum()))
    log(f"[sharded2] 2 ranks on gloo over CUDA tensors sharing the card, "
        f"half of config 5 (n={N}) each, against world 1 on NCCL: "
        f"all-reduced sigma counts exact, max rel err {err:.3e}; "
        f"run_mice_sharded fused rounds={ROUNDS} {out}; each rank's "
        f"launches as derived; {wall:.1f} s for the two processes")
    return out


def phase_checkpoint(seed: int, mesh) -> None:
    """run_mice_sharded ('fused') and run_mice_sharded_delta with noise at
    N_CKPT rows of config 5: 2 rounds with a checkpoint
    ("killed"), then resumed to 4, bit-identical to 4 rounds run straight
    through; a resume with another seed raises ValueError."""
    import tempfile

    from duckdb_imputation_tpu_torch.mice import (run_mice_sharded,
                                                  run_mice_sharded_delta)

    t, _ = make_table(N_CKPT, seed + 43)
    with tempfile.TemporaryDirectory() as d:
        for name, fn, kw in (
                ("fused", run_mice_sharded, dict(kernel="fused")),
                ("delta", run_mice_sharded_delta, {})):
            kw = dict(kw, noise=True, seed=seed, mesh=mesh)
            path = f"{d}/{name}"
            straight = fn(t, iters=4, **kw)
            fn(t, iters=2, checkpoint_path=path, **kw)
            t0 = time.perf_counter()
            resumed = fn(t, iters=4, checkpoint_path=path, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(torch.equal(straight.num_data, resumed.num_data)
                  and torch.equal(straight.cat_codes, resumed.cat_codes),
                  f"[checkpoint] {name}: resumed run differs")
            try:
                fn(t, iters=4, checkpoint_path=path, **dict(kw, seed=seed + 1))
                check(False, f"[checkpoint] {name}: another seed resumed")
            except ValueError as e:
                check("field 'seed'" in str(e), f"[checkpoint] {e}")
            size = sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d) if f.startswith(name))
            log(f"[checkpoint] {name} n={N_CKPT}: 2 rounds, then resumed to "
                f"4: bit-identical to 4 straight; another seed raises "
                f"ValueError naming 'seed'; resume + 2 rounds + 2 "
                f"checkpoints {wall * 1e3:.1f} ms wall, file {size} bytes")


def phase_sharded_all(seed: int) -> dict:
    """[sharded], [sharded2] and [checkpoint] under one NCCL process group
    of one rank (FileStore in a temporary directory), left at the end.
    Returns [sharded]'s launches."""
    import datetime
    import tempfile

    from duckdb_imputation_tpu_torch.parallel import initialize, shutdown

    with tempfile.TemporaryDirectory() as d:
        mesh = initialize("nccl", store=_store(f"{d}/store", 1),
                          world_size=1, rank=0, device=DEVICE,
                          timeout=datetime.timedelta(minutes=5))
        try:
            launches = phase_sharded(seed, mesh)
            phase_sharded2(seed, mesh)
            phase_checkpoint(seed, mesh)
        finally:
            shutdown()
    return launches


# ---------------------------------------------------------------------------
# The out-of-core path: the streaming fold (K1 or K7 over the extended
# schema, one call a chunk, summed in f64), run_mice_stream's two engines,
# impute_csv_stream over the native CSV binding, the spill path and the
# stream checkpoints
# ---------------------------------------------------------------------------

STREAM_CHUNK = 1_000_000      # rows of a chunk of the host source
N_STREAM_CSV = 17_000_000     # rows of [stream_csv]'s file: past 2^24
                              # (25M before the run neared its limit)
N_SPILL = 2_000_000
SPILL_BUDGET = 100_000
STREAM_ROUNDS = 2
STREAM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "stream")
_STREAM_COUNTERS = (("masked_gram", "launches"),
                    ("masked_gram", "wide_launches"),
                    ("masked_gram_cols", "launches"),
                    ("masked_gram_cols", "wide_launches"))


def _gram_wrappers():
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols)
    return {"masked_gram": masked_gram, "masked_gram_cols": masked_gram_cols}


def stream_counts_reset() -> None:
    torch.cuda.synchronize()
    for name, attr in _STREAM_COUNTERS:
        setattr(_gram_wrappers()[name], attr, 0)


def stream_counts() -> dict:
    """The masked-Gram launches since the last reset: K1's stacked entry
    (`masked_gram`), K1's column entry (`masked_gram_cols`) and K7 behind
    either (`wide`)."""
    torch.cuda.synchronize()
    w = _gram_wrappers()
    return {"masked_gram": w["masked_gram"].launches,
            "masked_gram_cols": w["masked_gram_cols"].launches,
            "wide_gram": (w["masked_gram"].wide_launches
                          + w["masked_gram_cols"].wide_launches)}


def add_counts(total: dict, part: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in part.items()}


def host_arrays(t):
    """A table's columns as a chunk source's host arrays: (num f32[d, n],
    cat i64[c, n], num_null, cat_null)."""
    return (t.num_data.cpu().numpy(), t.cat_codes.cpu().numpy().astype(
        np.int64), t.num_null.cpu().numpy(), t.cat_null.cpu().numpy())


def embed(t, res):
    """The in-core table with a stream result's dirty rows put in."""
    import dataclasses

    idx = torch.as_tensor(res.idx, device=t.device)
    x, c = t.num_data.clone(), t.cat_codes.clone()
    x[:, idx] = res.dirty.num_data
    c[:, idx] = res.dirty.cat_codes
    return dataclasses.replace(t, num_data=x, cat_codes=c)


def fold_chunks(n: int) -> int:
    """Chunks of the fold's re-blocking at its default size."""
    from duckdb_imputation_tpu_torch.ring.streaming import (
        DEFAULT_STREAM_CHUNK)
    return -(-n // DEFAULT_STREAM_CHUNK)


def phase_stream(seed: int) -> dict:
    """favorita_wide at N rows served from host arrays in 1M-row chunks,
    5% nulls in transactions and family, so the fold is K7 at P + K = the
    observed vocabularies' P (at most 492) + 2: the streamed filled triple against init_fill + sum_to_triple
    on the card (counts exact, 1e-5 of max|σ|), the fills against
    init_fill's (means 1e-6 relative, modes exact); run_mice_stream
    'device' (2 rounds) against run_mice_device_delta on the in-core table
    (codes ≥ 0.999 on the null cells, transactions within 1e-3 of
    max|x| where family agrees, tests/test_torch_delta.py's bound) and
    'host' (1 round) against run_mice_low (rtol 1e-3, atol 1e-2, codes >
    0.99; tests/test_torch_host_mice.py's low-vs-baseline bounds), both
    with [wide]'s quality gates (better than mean fill); scan_gram over a
    world-1 NCCL mesh bit-identical to none; exact launches; seconds and
    rows/s of each pass. Returns the launches of the stream runs."""
    import datetime
    import tempfile

    from duckdb_imputation_tpu_torch import (from_numpy,
                                             run_mice_device_delta,
                                             run_mice_low)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.parallel import initialize, shutdown
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram)
    from duckdb_imputation_tpu_torch.ring.streaming import (
        assemble_filled_triple, chunks_from_arrays, encode_chunk,
        extended_schema, scan_gram, scan_schema)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple
    from duckdb_imputation_tpu_torch.utils.profiling import PhaseTimer

    made, truth = make_favorita(N, seed + 60, null_frac=0.05)
    arrays = host_arrays(made)
    del made
    src = chunks_from_arrays(*arrays, chunk_rows=STREAM_CHUNK)
    chunks = fold_chunks(N)
    t0 = time.perf_counter()
    ss, cache = scan_schema(src)
    s_schema = time.perf_counter() - t0
    # the in-core table on the stream's schema: the vocabularies of the
    # observed values (a city, state or cluster no store has is absent)
    check(ss.k == 2 and ss.schema.cat_keys[1] == tuple(range(33)),
          f"[stream] nullable columns {ss.nullable_num, ss.nullable_cat} or "
          f"family's vocabulary differ")
    t = from_numpy(*arrays, schema=ss.schema, rows_first=False,
                   device=DEVICE)
    f = init_fill(t)
    want = sigma_from_triple(sum_to_triple(f.num_data, f.cat_codes, None,
                                           schema=t.schema))
    del f
    stream_counts_reset()
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    gram = scan_gram(src, ss, timer=timer)
    torch.cuda.synchronize()
    s_gram = time.perf_counter() - t0
    fold = stream_counts()
    check(fold == {"masked_gram": 0, "masked_gram_cols": 0,
                   "wide_gram": chunks},
          f"[stream] the fold launched {fold}, not {chunks} K7")
    full, fills = assemble_filled_triple(gram, ss)
    got = sigma_from_triple(full)
    cm = count_entries(t.schema)
    check(torch.equal(got[cm], want[cm]),
          "[stream] streamed counts differ from init_fill + sum_to_triple")
    err = rel_err(got, want)
    check(err <= 1e-5, f"[stream] filled triple max rel err {err:.3e}")
    for j in ss.nullable_num:
        ref = float(t.num_data[j][~t.num_null[j]].double().mean())
        check(abs(fills.num_means[j] - ref) <= 1e-6 * abs(ref),
              f"[stream] mean of numeric {j}: {fills.num_means[j]} vs {ref}")
    for j in ss.nullable_cat:
        ref = int(torch.bincount(t.cat_codes[j][~t.cat_null[j]].long())
                  .argmax())
        check(fills.cat_modes[j] == ref,
              f"[stream] mode of categorical {j}: {fills.cat_modes[j]} vs "
              f"{ref}")
    x0, c0 = encode_chunk(*(a[:, :1 << 20] for a in arrays), ss)
    xt, ct = torch.from_numpy(x0).to(DEVICE), torch.from_numpy(c0).to(DEVICE)
    k7_ms = cuda_ms(lambda: masked_gram(xt, ct, None,
                                        schema=extended_schema(ss)),
                    reps=5, warmup=1)
    del xt, ct
    log(f"[stream] favorita_wide n={N}, P={t.schema.sigma_size} (the "
        f"observed vocabularies), P + K = {extended_schema(ss).sigma_size}: "
        f"scan_schema {s_schema:.3f} s ({N / s_schema:.4g} rows/s), "
        f"scan_gram {s_gram:.3f} s ({N / s_gram:.4g} rows/s; host encode "
        f"{timer.totals['encode']:.3f} s, copies + launches "
        f"{timer.totals['fold']:.3f} s; K7 alone on a 2^20-row chunk "
        f"{k7_ms:.3f} ms × {chunks}); fold launches {fold}; filled triple "
        f"vs init_fill + sum_to_triple: counts exact, max rel err "
        f"{err:.3e}; fills {fills.num_means}, modes {fills.cat_modes}")
    total = fold

    stream_counts_reset()
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    dev = run_mice_stream(src, iters=STREAM_ROUNDS, noise=False,
                          engine="device", timer=timer)
    torch.cuda.synchronize()
    s_dev = time.perf_counter() - t0
    launches = stream_counts()
    cols = len(ss.nullable_num) + len(ss.nullable_cat)
    expect = {"masked_gram": 0, "masked_gram_cols": 0,
              "wide_gram": chunks + 2 * cols * STREAM_ROUNDS}
    check(launches == expect, f"[stream] device engine launched {launches}, "
          f"not {expect}")
    total = add_counts(total, launches)
    phases_dev = {k: round(v, 3) for k, v in timer.summary().items()}
    ref = run_mice_device_delta(t, iters=STREAM_ROUNDS)
    idx = torch.as_tensor(dev.idx, device=DEVICE)
    nm, cmask = dev.dirty.num_null[1], dev.dirty.cat_null[1]
    ref_c = ref.cat_codes[1][idx]
    agree = float((dev.dirty.cat_codes[1][cmask] == ref_c[cmask]).float()
                  .mean())
    check(agree >= 0.999, f"[stream] device engine family agreement {agree}")
    same = nm & (dev.dirty.cat_codes[1] == ref_c)
    ref_x = ref.num_data[1][idx]
    dx = float((dev.dirty.num_data[1] - ref_x)[same].abs().max())
    check(dx <= 1e-3 * float(ref_x.abs().max()),
          f"[stream] device engine transactions |Δx| {dx:.3e}")
    q_dev = wide_quality(t, truth, embed(t, dev), "[stream] device engine")
    del ref

    stream_counts_reset()
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    host = run_mice_stream(src, iters=1, noise=False, engine="host",
                           timer=timer)
    torch.cuda.synchronize()
    s_host = time.perf_counter() - t0
    launches = stream_counts()
    expect = {"masked_gram": 0, "masked_gram_cols": 0,
              "wide_gram": chunks + 2 * cols}
    check(launches == expect, f"[stream] host engine launched {launches}, "
          f"not {expect}")
    total = add_counts(total, launches)
    phases_host = {k: round(v, 3) for k, v in timer.summary().items()}
    low = run_mice_low(t, iters=1, noise=False)
    lx, lc = low.num_data[:, idx], low.cat_codes[:, idx]
    check(close_to(host.dirty.num_data, lx, 1e-3, 1e-2),
          f"[stream] host engine vs run_mice_low: max |Δx| "
          f"{float((host.dirty.num_data - lx).abs().max()):.3e}")
    agree_h = float((host.dirty.cat_codes[1][cmask] == lc[1][cmask]).float()
                    .mean())
    check(agree_h > 0.99, f"[stream] host engine family agreement {agree_h}")
    q_host = wide_quality(t, truth, embed(t, host), "[stream] host engine")
    del low

    with tempfile.TemporaryDirectory() as d:
        mesh = initialize("nccl", store=_store(f"{d}/store", 1),
                          world_size=1, rank=0, device=DEVICE,
                          timeout=datetime.timedelta(minutes=5))
        try:
            g_mesh = scan_gram(src, ss, mesh=mesh)
        finally:
            shutdown()
    check(torch.equal(g_mesh, gram),
          "[stream] scan_gram over a world-1 NCCL mesh differs")
    log(f"[stream] run_mice_stream device engine rounds={STREAM_ROUNDS}: "
        f"{s_dev:.3f} s, phases s {phases_dev}; dirty rows {len(dev.idx)}; "
        f"vs run_mice_device_delta: family agreement {agree:.6f}, "
        f"transactions max |Δx| {dx:.3e} where family agrees; quality "
        f"{q_dev}. Host engine rounds=1: {s_host:.3f} s, phases s "
        f"{phases_host}; vs run_mice_low family agreement {agree_h:.6f}; "
        f"quality {q_host}. scan_gram over a world-1 NCCL mesh "
        f"bit-identical. Launches of the stream runs {total}")
    return total


def write_config5_csv(path: str, seed: int, n: int, null_frac: float):
    """The config-5 table at n rows written as CSV by format_csv_block, in
    1M-row blocks (null cells empty). Returns (x f32[4, n] on the card,
    codes, num_null, cat_null, true x1, seconds, bytes)."""
    from duckdb_imputation_tpu_torch.table.native import format_csv_block

    t, truth = make_table(n, seed, null_frac=null_frac)
    x, c = t.num_data.cpu().numpy(), t.cat_codes.cpu().numpy()
    nn, cn = t.num_null.cpu().numpy(), t.cat_null.cpu().numpy()
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(b"x0,x1,x2,x3,c0,c1\n")
        for lo in range(0, n, STREAM_CHUNK):
            hi = min(lo + STREAM_CHUNK, n)
            cols = ([np.where(nn[j, lo:hi], np.nan, x[j, lo:hi])
                     for j in range(4)]
                    + [np.where(cn[j, lo:hi], np.nan, c[j, lo:hi])
                       for j in range(2)])
            f.write(format_csv_block(cols, [0, 0, 0, 0, 1, 1]))
    return t, truth, time.perf_counter() - t0, os.path.getsize(path)


def phase_stream_csv(seed: int) -> dict:
    """BASELINE config 5 at N_STREAM_CSV rows, 1% nulls in x1 and c0,
    written as a CSV under build/stream/ by format_csv_block, then
    impute_csv_stream(engine='device', noise=False, 2 rounds): the fold's
    filled triple has n exact past 2^24 and one-hot counts equal to the
    bincounts of the mode-filled input; the output read back by read_csv: observed
    cells bit-identical to the input, imputed cells equal to res.dirty;
    x1 RMSE < 0.05; exact launches (the fold K1 at P + K = 23 on the CUDA
    cores, one a chunk; the rounds K1 on the tensor cores); seconds and MB/s
    of each pass. The files are removed whatever happens."""
    from duckdb_imputation_tpu_torch.mice.streaming import impute_csv_stream
    from duckdb_imputation_tpu_torch.table.native import read_csv
    from duckdb_imputation_tpu_torch.utils.profiling import PhaseTimer

    import shutil

    n = N_STREAM_CSV
    os.makedirs(STREAM_DIR, exist_ok=True)
    in_path = os.path.join(STREAM_DIR, "config5.csv")
    out_path = os.path.join(STREAM_DIR, "config5_imputed.csv")
    free = shutil.disk_usage(STREAM_DIR).free
    try:
        t, truth, s_write, nbytes = write_config5_csv(in_path, seed + 61, n,
                                                      0.01)
        stream_counts_reset()
        timer = PhaseTimer(sync=torch.cuda.synchronize)
        t0 = time.perf_counter()
        res = impute_csv_stream(in_path, out_path, iters=STREAM_ROUNDS,
                                engine="device", noise=False, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = stream_counts()
        chunks = fold_chunks(n)
        expect = {"masked_gram": chunks,
                  "masked_gram_cols": 2 * 2 * STREAM_ROUNDS, "wide_gram": 0}
        check(launches == expect, f"[stream_csv] launched {launches}, not "
              f"{expect}")
        check(res.ss.n_rows == n and float(res.filled.n) == n,
              f"[stream_csv] n {res.ss.n_rows}, filled n "
              f"{float(res.filled.n)}")
        t1 = time.perf_counter()
        out = read_csv(out_path)
        s_read = time.perf_counter() - t1
        check(out.num_names == ("x0", "x1", "x2", "x3")
              and out.cat_names == ("c0", "c1") and out.n_rows == n,
              "[stream_csv] the output's columns or rows differ")
        check(not bool(out.num_null.any() or out.cat_null.any()),
              "[stream_csv] the output has nulls")
        check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null]),
              "[stream_csv] observed numbers differ from the input")
        raw = torch.as_tensor(out.cat_values(), device=DEVICE)
        dirty_raw = torch.as_tensor(res.dirty.cat_values(), device=DEVICE)
        check(torch.equal(raw[~t.cat_null], t.cat_codes[~t.cat_null].long()),
              "[stream_csv] observed categories differ from the input")
        idx = torch.as_tensor(res.idx, device=DEVICE)
        dn, dc = res.dirty.num_null, res.dirty.cat_null
        check(torch.equal(out.num_data[:, idx][dn], res.dirty.num_data[dn])
              and torch.equal(raw[:, idx][dc], dirty_raw[dc]),
              "[stream_csv] imputed cells differ from res.dirty")
        # the mode-filled input's one-hot counts, f32 sums of 24 chunks
        # past 2^24 rows in all
        filled = [torch.where(t.cat_null[j], res.fills.cat_modes[j],
                              t.cat_codes[j]).long() for j in range(2)]
        counts = torch.cat([torch.bincount(c, minlength=8)
                            for c in filled]).double()
        check(torch.equal(res.filled.lin_cat.double(), counts),
              "[stream_csv] the filled triple's one-hot counts differ from "
              "the mode-filled input's bincounts")
        nm = t.num_null[1]
        rmse = float(((out.num_data[1] - truth)[nm] ** 2).mean().sqrt())
        check(rmse < 0.05, f"[stream_csv] x1 RMSE {rmse}")
        ph = timer.summary()
        mb = nbytes / 1e6
        log(f"[stream_csv] config 5 n={n} ({nbytes} bytes, {free / 1e9:.1f} "
            f"GB free): written by format_csv_block in {s_write:.3f} s "
            f"({mb / s_write:.1f} MB/s); impute_csv_stream engine='device' "
            f"rounds={STREAM_ROUNDS} {wall:.3f} s: scan_schema (parse) "
            f"{ph['scan_schema']:.3f} s ({mb / ph['scan_schema']:.1f} MB/s), "
            f"scan_gram (parse + fold) {ph['scan_gram']:.3f} s "
            f"({mb / ph['scan_gram']:.1f} MB/s), prepare "
            f"{ph['prepare']:.3f} s, rounds "
            f"{ph['delta_rounds_device']:.3f} s, write_out (parse + format "
            f"+ write) {ph['write_out']:.3f} s ({mb / ph['write_out']:.1f} "
            f"MB/s); read_csv of the output {s_read:.3f} s; dirty rows "
            f"{len(res.idx)}; the filled triple's n exact, its one-hot "
            f"counts the mode-filled input's bincounts; observed cells bit-identical, imputed "
            f"cells res.dirty's; x1 RMSE {rmse:.4g}; launches {launches}")
    finally:
        for p in (in_path, out_path):
            if os.path.exists(p):
                os.remove(p)
    return launches


def phase_stream_spill(seed: int) -> dict:
    """Config 5 at N_SPILL rows, 20% nulls, dirty_budget_rows =
    SPILL_BUDGET: the cache spills to memmaps and the windowed host rounds
    (noise off, 2 rounds) match the in-core cache's on the same data at
    tests/test_streaming.py:109-145's bounds (x within 5e-3·(max|x| + 1),
    codes agree > 0.98); every window's aggregate K1's stacked entry,
    counted exactly."""
    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.ring.streaming import chunks_from_arrays
    from duckdb_imputation_tpu_torch.utils.profiling import PhaseTimer

    t, _ = make_table(N_SPILL, seed + 62, null_frac=0.2)
    src = chunks_from_arrays(*host_arrays(t), chunk_rows=STREAM_CHUNK)
    stream_counts_reset()
    timer = PhaseTimer(sync=torch.cuda.synchronize)
    t0 = time.perf_counter()
    sp = run_mice_stream(src, iters=STREAM_ROUNDS, noise=False,
                         dirty_budget_rows=SPILL_BUDGET, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = stream_counts()
    try:
        check(sp.spill is not None and sp.dirty is None
              and sp.spill.n > SPILL_BUDGET
              and isinstance(sp.spill.num, np.memmap),
              "[stream_spill] the dirty rows did not spill past the budget")
        windows = [(lo, min(lo + SPILL_BUDGET, sp.spill.n))
                   for lo in range(0, sp.spill.n, SPILL_BUDGET)]
        steps = sum(bool(sp.spill.num_null[lo:hi, 1].any())
                    + bool(sp.spill.cat_null[lo:hi, 0].any())
                    for lo, hi in windows)
        expect = {"masked_gram": fold_chunks(N_SPILL)
                  + 2 * STREAM_ROUNDS * steps,
                  "masked_gram_cols": 0, "wide_gram": 0}
        check(launches == expect, f"[stream_spill] launched {launches}, "
              f"not {expect}")
        inc = run_mice_stream(src, iters=STREAM_ROUNDS, noise=False)
        check(np.array_equal(sp.idx, inc.idx), "[stream_spill] dirty rows")
        num_sp, cat_sp = sp._dirty_slice(0, sp.spill.n)
        num_ic = inc.dirty.num_data.cpu().numpy()
        cat_ic = inc.dirty.cat_values()
        m = inc.dirty.num_null[1].cpu().numpy()
        dx = float(np.abs(num_sp[1][m] - num_ic[1][m]).max())
        bound_x = 5e-3 * (float(np.abs(num_ic[1]).max()) + 1)
        check(dx <= bound_x, f"[stream_spill] x1 |Δ| {dx:.3e} > {bound_x}")
        mc = inc.dirty.cat_null[0].cpu().numpy()
        agree = float((cat_sp[0][mc] == cat_ic[0][mc]).mean())
        check(agree > 0.98, f"[stream_spill] c0 agreement {agree}")
        log(f"[stream_spill] config 5 n={N_SPILL}, 20% nulls, budget "
            f"{SPILL_BUDGET}: {sp.spill.n} dirty rows spilled to memmaps; "
            f"windowed host rounds={STREAM_ROUNDS} {wall:.3f} s, phases s "
            f"{ {k: round(v, 3) for k, v in timer.summary().items()} }; vs "
            f"the in-core cache: x1 max |Δ| {dx:.3e}, c0 agreement "
            f"{agree:.6f}; launches {launches}")
    finally:
        sp.spill.cleanup()
    return launches


def phase_stream_ckpt(seed: int) -> dict:
    """N_CKPT rows of config 5, 5% nulls, noise on: for both engines a
    checkpointed stream run stopped after 1 round and resumed to 2 is
    bit-identical to 2 straight rounds; a resume with another seed raises
    ValueError naming it."""
    import tempfile

    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.ring.streaming import chunks_from_arrays

    t, _ = make_table(N_CKPT, seed + 63, null_frac=0.05)
    src = chunks_from_arrays(*host_arrays(t), chunk_rows=STREAM_CHUNK)
    stream_counts_reset()
    walls = {}
    with tempfile.TemporaryDirectory() as d:
        for engine in ("host", "device"):
            kw = dict(noise=True, seed=seed, engine=engine)
            path = f"{d}/{engine}.ckpt"
            straight = run_mice_stream(src, iters=2, **kw)
            run_mice_stream(src, iters=1, checkpoint_path=path, **kw)
            t0 = time.perf_counter()
            resumed = run_mice_stream(src, iters=2, checkpoint_path=path,
                                      **kw)
            torch.cuda.synchronize()
            walls[engine] = round((time.perf_counter() - t0) * 1e3, 1)
            check(torch.equal(straight.dirty.num_data,
                              resumed.dirty.num_data)
                  and torch.equal(straight.dirty.cat_codes,
                                  resumed.dirty.cat_codes),
                  f"[stream_ckpt] {engine}: the resumed run differs")
            try:
                run_mice_stream(src, iters=2, checkpoint_path=path,
                                **dict(kw, seed=seed + 1))
                check(False, f"[stream_ckpt] {engine}: another seed resumed")
            except ValueError as e:
                check("field 'seed'" in str(e), f"[stream_ckpt] {e}")
    launches = stream_counts()
    log(f"[stream_ckpt] config 5 n={N_CKPT}, noise on: for the host and "
        f"device engines 1 round, then resumed to 2: bit-identical to 2 "
        f"straight; another seed raises ValueError naming 'seed'; a resume "
        f"(pass 0 again, the fold skipped) + 1 round + 1 checkpoint ms "
        f"{walls}; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# The wide-V path past P = 1,024: K7 over a column window ([K7win]),
# run_mice_device at favorita_items ([items]), run_mice_wide on a 1 × 1
# grid and sigma_striped ([wide_v]), and a 1 × 2 grid of two gloo ranks
# sharing the card ([wide_v2])
# ---------------------------------------------------------------------------

# favorita_items: favorita_wide's columns and item_nbr's 4,100 items
# (items.csv): P = 4,592
ITEMS_VOCABS = FAVORITA_VOCABS + (ITEMS,)
# wide16k: tests/test_wide.py's width, two columns of 8,192 levels
WIDE16K_VOCABS = (8192, 8192)
WINDOW_PASS_LIMIT_S = 30.0   # a K7 pass over all of wide16k's S past this
N_WIDE16K_CUT = 2_000_000    # cuts wide16k to this many rows
N_LIBRARY = {"favorita_items": 1_000_000, "wide16k": 100_000}  # rows of
                             # the dense cuBLAS Gram (the full Z does not fit)
ITEMS_ROUNDS = 2
N_ITEMS_CPU = 100_000        # [items] on the CPU, held against the card
                             # (200,000 before the run neared its limit)
ITEMS_CPU_ROUNDS = 1         # rounds of that comparison (2 before the run
                             # neared its limit: an f64 SVD of P = 4,592 on
                             # the host a column step, ~90 s a round)
WIDE_V2_DEADLINE_S = 600
CG_CHECK = dict(label=2, ridge=1e-2, iters=2000, tol=1e-9)  # [wide_v]'s
                             # cg_solve_wide: transactions at test_wide's
                             # ridge and stop rule


def items_schema():
    from duckdb_imputation_tpu_torch import FeatureSchema

    return FeatureSchema(num_cols=3, cat_keys=tuple(
        tuple(range(v)) for v in ITEMS_VOCABS))


def make_favorita_items(n: int, seed: int, *, null_frac: float = 0.2,
                        device=None):
    """favorita_items (P = 4,592) made on the device from `seed`:
    favorita_wide's columns with make_favorita's store hierarchy, plus
    item_nbr. Each of the 4,100 items fixes its class (every class has at
    least one item, every family one class), hence its family and
    perishable, as make_favorita_star makes them; rows draw items by Zipf
    shares (weight 1/rank, ranks shuffled: an assumption), stores
    uniformly, 20% on promotion. unit_sales = class level + item level +
    1.5·onpromotion + 0.5·N(0, 1); transactions = 2·(store level) + N(0,
    1); the oil price N(0, 1). `null_frac` MCAR nulls in transactions
    (numeric 1) and family (categorical 1). Returns (table, truth): truth
    holds the true transactions and family."""
    from duckdb_imputation_tpu_torch import Table

    dev = DEVICE if device is None else device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    i32 = torch.int32

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=g, device=dev,
                             dtype=i32)

    def onto(parents, children):
        """A parent of each child, every parent taken at least once."""
        p = torch.cat([torch.arange(parents, device=dev, dtype=i32),
                       randint(parents, children - parents)])
        return p[torch.randperm(children, generator=g, device=dev)]

    stores, families, classes = FAVORITA_VOCABS[:3]
    city_of_store = randint(22, stores)
    state_of_city = randint(16, 22)
    type_of_store = randint(5, stores)
    cluster_of_store = randint(17, stores)
    family_of_class = onto(families, classes)
    class_of_item = onto(classes, ITEMS)
    perishable_of_family = randint(2, families)
    store_level = torch.randn(stores, generator=g, device=dev)
    class_level = torch.randn(classes, generator=g, device=dev)
    item_level = 0.5 * torch.randn(ITEMS, generator=g, device=dev)

    store = randint(stores, n)
    rank = torch.randperm(ITEMS, generator=g, device=dev) + 1
    item = torch.multinomial(1.0 / rank.double(), n, replacement=True,
                             generator=g)
    cls = class_of_item[item]
    family = family_of_class[cls.long()]
    promo = (torch.rand(n, generator=g, device=dev) < 0.2).to(i32)
    sl = store.long()
    transactions = 2.0 * store_level[sl] + torch.randn(n, generator=g,
                                                       device=dev)
    unit_sales = (class_level[cls.long()] + item_level[item] + 1.5 * promo
                  + 0.5 * torch.randn(n, generator=g, device=dev))
    oil = torch.randn(n, generator=g, device=dev)
    city = city_of_store[sl]
    codes = torch.stack([store, family, cls,
                         perishable_of_family[family.long()], promo, city,
                         state_of_city[city.long()], type_of_store[sl],
                         cluster_of_store[sl], item.to(i32)])
    x = torch.stack([unit_sales, transactions, oil])
    num_null = torch.zeros((3, n), dtype=torch.bool, device=dev)
    cat_null = torch.zeros((10, n), dtype=torch.bool, device=dev)
    num_null[1] = torch.rand(n, generator=g, device=dev) < null_frac
    cat_null[1] = torch.rand(n, generator=g, device=dev) < null_frac
    truth = {"transactions": transactions, "family": family}
    x = torch.where(num_null, 0.0, x)
    codes = torch.where(cat_null, 0, codes)
    return Table(num_data=x, cat_codes=codes, num_null=num_null,
                 cat_null=cat_null, schema=items_schema()), truth


def make_wide16k(n: int, seed: int):
    """wide16k (P = 16,387) made on the device from `seed`, as
    tests/test_wide.py's `_wide_data`: x1 = 0.5·x0 + 0.1·N(0, 1), two
    columns of 8,192 uniform codes, 25% zero weights. Returns (schema,
    x_cols, code_cols, w)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    x0 = torch.randn(n, generator=g, device=DEVICE)
    x1 = 0.5 * x0 + 0.1 * torch.randn(n, generator=g, device=DEVICE)
    cs = [torch.randint(0, v, (n,), generator=g, device=DEVICE,
                        dtype=torch.int32) for v in WIDE16K_VOCABS]
    w = (torch.rand(n, generator=g, device=DEVICE) >= 0.25).float()
    schema = FeatureSchema(num_cols=2, cat_keys=tuple(
        tuple(range(v)) for v in WIDE16K_VOCABS))
    return schema, [x0, x1], cs, w


def window_scratch(schema, lo: int, hi: int, n: int, groups: int = 1
                   ) -> dict:
    """Device bytes K7 over the window [lo, hi) holds beside its output
    and inputs (`_build.keyed_window_plan`): its plans' tensors, the
    residual's f64 partial (slices + G − 1 slots of its cells), the keyed
    tasks' (`keyed_items_bound` items of their largest task), the order's
    copies of the columns (rows of `_build.order_stride` ints), its keys'
    offsets and chunks, and its kernels' counters of
    one column at a time (i32 counts and their copy by key, i64 scan and
    starts, i32 positions, over the G·V keys of `_build.order_segments`
    segments each).
    `total` is their sum."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    residual, keyed = _build.keyed_window_plan(schema, lo, hi)
    parts = [pl for pl in (residual, keyed and keyed.plan) if pl]
    plans = sum(x.numel() * x.element_size() for pl in parts for x in (
        pl.slabs, pl.warp_begin, pl.task_base, pl.stage_cols, pl.entries))
    out = dict(plans=plans, residual_partial=0, keyed_partial=0, order=0)
    if residual is not None:
        out["residual_partial"] = (int(residual.task_base[-1]) * 8
                                   * (residual.slices(n) + groups - 1))
    if keyed is not None:
        out["plans"] += keyed.task_keys.numel() * 4
        out["keyed_partial"] = (_build.keyed_items_bound(keyed, n, groups)
                                * keyed.plan.max_task_cells * 8)
        cols = _build.order_stride(1 + schema.num_cols + schema.cat_cols)
        keys = [groups * schema.cat_sizes[j] for j in keyed.columns]
        out["order"] = (len(keys) * cols * n * 4      # the copies, and
                        + 16 * sum(k + 1 for k in keys)   # offsets, chunks
                        + max(32 * k * _build.order_segments(groups, k
                                                            // groups)
                              + 8 * (k + 1) for k in keys))
    out["total"] = sum(out.values())
    return out


def window_bound(code_cols, w, schema, lo: int, hi: int) -> dict:
    """K7 over the window S[:, lo:hi]: x, codes and w read once, f32[P, hi
    − lo] written once; a row with w ≠ 0 and k = 1 + d + (its codes in
    range) nonzeros, k_w of them in the window, needs k·k_w multiply-adds
    (the window is not symmetric)."""
    d, n = schema.num_cols, w.shape[0]
    base = [1 + d + o for o in schema.offsets]
    k = torch.full((n,), 1 + d, dtype=torch.int64, device=w.device)
    kw = torch.full_like(k, max(0, min(hi, 1 + d) - lo))
    for c, b, size in zip(code_cols, base, schema.cat_sizes):
        ok = (c >= 0) & (c < size)
        k += ok.long()
        kw += (ok & (b + c >= lo) & (b + c < hi)).long()
    fma = int(torch.where(w != 0, k * kw, 0).sum())
    return bound(n * row_bytes(schema, 4)
                 + schema.sigma_size * (hi - lo) * 4, 2 * fma)


def _window_check(tag, got, again, want, schema, lo) -> float:
    """[K7win]'s checks of a window: finite, bit-identical rerun, counts
    exact, ≤ 1e-5 of max|σ|. Returns the max abs error."""
    d = schema.num_cols
    check(torch.isfinite(got).all(), f"{tag} not finite")
    check(torch.equal(got, again), f"{tag} rerun not bit-identical")
    rows = torch.arange(schema.sigma_size, device=got.device)
    cols = torch.arange(lo, lo + got.shape[1], device=got.device)
    cm = (((rows[:, None] == 0) | (rows[:, None] > d))
          & ((cols[None] == 0) | (cols[None] > d)))
    check(torch.equal(got[cm], want[cm]),
          f"{tag} counts differ from the plain version")
    err = rel_err(got, want)
    check(err <= 1e-5, f"{tag} max rel error {err:.3e} > 1e-5")
    return float((got - want).abs().max())


def order_check(tag, xs, cs, w, schema, cols, offsets=None) -> dict:
    """The order kernels (`window_order`: a counting sort of each keyed
    column and the copy of every column in its order) against their plain
    version on the card (`window_order_plain`: a stable torch.sort and a
    gather): the keys' offsets equal and the copies equal bit for bit over
    the rows with a key, a rerun bit-identical, one launch a column; ms of
    both by CUDA events, the stable sort of the keys alone (one PyTorch
    call a column: the permutation, without the copy) and the bound (each
    column read once, each copied row's columns written once: not the
    padding of the copies' rows to whole sectors, a choice of the
    kernel's)."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_order, window_order_plain)

    groups = 1 if offsets is None else offsets.shape[0] - 1
    before = window_order.launches
    got = window_order(xs, cs, w, schema=schema, columns=cols,
                       offsets=offsets)
    again = window_order(xs, cs, w, schema=schema, columns=cols,
                         offsets=offsets)
    want = window_order_plain(xs, cs, w, schema=schema, columns=cols,
                              offsets=offsets)
    torch.cuda.synchronize()
    check(window_order.launches - before == 2 * len(cols),
          f"{tag}: {window_order.launches - before} order launches, not "
          f"{2 * len(cols)}")
    check(torch.equal(got.key_off, want.key_off),
          f"{tag}: the keys' offsets differ from the plain version's")
    check(torch.equal(got.key_chunks, want.key_chunks),
          f"{tag}: the keys' chunks differ from the plain version's")
    ncols = 1 + schema.num_cols + schema.cat_cols
    copied = 0
    for q, j in enumerate(cols):
        keys = groups * schema.cat_sizes[j]
        last = int(want.key_off[int(want.off_of[j]) + keys])
        check(torch.equal(got.rows[q, :last, :ncols],
                          want.rows[q, :last, :ncols])
              and torch.equal(again.rows[q, :last, :ncols],
                              got.rows[q, :last, :ncols]),
              f"{tag}: column {j}'s copy differs from the plain version's "
              f"or a rerun's")
        copied += last
    del got, again, want
    n = w.shape[0]
    ms = cuda_ms(lambda: window_order(xs, cs, w, schema=schema, columns=cols,
                                      offsets=offsets), reps=3, warmup=1)
    plain = cuda_ms(lambda: window_order_plain(
        xs, cs, w, schema=schema, columns=cols, offsets=offsets), reps=3,
        warmup=1)

    def sorts():
        for j in cols:
            c, v = cs[j].long(), schema.cat_sizes[j]
            key = torch.where((c >= 0) & (c < v), c, v).to(torch.int32)
            torch.sort(key, stable=True)
    library = cuda_ms(sorts, reps=3, warmup=1)
    b = bound(n * ncols * 4 + copied * 4 * ncols, 0)
    log(f"{tag}: the order kernels equal the plain version (offsets, copies "
        f"of {copied} rows with a key) and a rerun; kernels {ms:.3f} ms, "
        f"plain {plain:.3f} ms, the stable sort alone {library:.3f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=library,
                rows_copied=copied, **b)


def window_record(xs, cs, w, schema, lo: int, wd: int, n: int,
                  tag: str, offsets=None) -> dict:
    """What a window's plan does on these rows (`keyed_window_plan`): its
    residual tasks, and its keyed tasks over one order of its keyed
    columns (`window_order`; with `offsets`, K8's by group and code): the
    keyed tasks, their work items, the rows each layer walks, checked equal
    to the rows whose code lies in the layer's key range, and the order's
    ms alone by CUDA events."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        keyed_work, window_columns, window_order)

    residual, keyed = _build.keyed_window_plan(schema, lo, lo + wd)
    rec = dict(residual_tasks=residual.num_tasks if residual else 0,
               keyed_columns=list(keyed.columns) if keyed else [],
               keyed_tasks=0, items=0, rows_read=0, order_ms=0.0)
    if keyed is None:
        return rec
    cols = window_columns(schema, [lo], wd)
    order = window_order(xs, cs, w, schema=schema, columns=cols,
                         offsets=offsets)
    work = keyed_work(keyed, order, n, schema)
    check(work["rows"] == work["in_range"],
          f"{tag}: a layer's work items walk {work['rows']} rows, not the "
          f"rows of its key range {work['in_range']}")
    del order
    rec.update(keyed_tasks=work["tasks"], items=work["items"],
               rows_read=sum(work["rows"].values()), layer_rows=work["rows"],
               order_ms=cuda_ms(lambda: window_order(
                   xs, cs, w, schema=schema, columns=cols, offsets=offsets),
                   reps=3, warmup=1))
    return rec


def phase_k7win(seed: int) -> dict:
    """K7 over column windows. favorita_wide (P = 492): its windows of 128
    columns side by side against today's one launch of the whole plan.
    favorita_items (P = 4,592) and wide16k (P = 16,387) at N rows (wide16k
    cut to N_WIDE16K_CUT rows if one pass over all of S takes more than
    WINDOW_PASS_LIMIT_S): the plans' host time, a pass over all of S
    (masked_gram_cols: one order pass of the windows' keyed columns, then
    one launch a window of WINDOW_WIDTH), each window (all five at
    favorita_items, the first, one across the two one-hot blocks and the
    last at wide16k) against masked_gram_window_plain (counts exact, ≤
    1e-5 of max|σ|, reruns bit-identical, equal to the pass's columns), ms
    of each window alone (its own order pass included) and of the pass by
    CUDA events, their bounds, each window's record (`window_record`: its
    keyed tasks, work items and rows read, each layer's rows equal to its
    key range's, the order's ms), and one cuBLAS f32 Gram of the dense Z
    on a slice of N_LIBRARY rows. Then the hot-key window: favorita_items
    with one item on HOT_SHARE of the rows, the window of that item's
    columns held the same way. Returns the kernels line's window numbers
    and wide16k's rows."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_window, masked_gram_window_plain,
        window_columns, window_order)

    t, _ = make_favorita(N, seed + 60)
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w = (~t.num_null[1]).float()
    p = t.schema.sigma_size
    one = masked_gram_cols(xs, cs, w, schema=t.schema)
    wins = torch.cat([masked_gram_window(xs, cs, w, schema=t.schema, lo=lo,
                                         width=min(128, p - lo))
                      for lo in range(0, p, 128)], 1)
    torch.cuda.synchronize()
    err = _window_check("[K7win] favorita_wide windows of 128 vs one launch",
                        wins, wins, one, t.schema, 0)
    log(f"[K7win] favorita_wide P={p} n={N}: {-(-p // 128)} windows of 128 "
        f"side by side vs K7's one launch: counts exact, max abs err "
        f"{err:.3e}, bit-identical {bool(torch.equal(wins, one))}")
    del t, xs, cs, w, one, wins

    out = {}
    for name in ("favorita_items", "wide16k"):
        n = N
        while True:
            if name == "favorita_items":
                t, _ = make_favorita_items(n, seed + 61)
                schema = t.schema
                xs, cs = list(t.num_data.unbind(0)), list(
                    t.cat_codes.unbind(0))
                gen = torch.Generator(device=DEVICE)
                gen.manual_seed(seed + 62)
                w = (torch.rand(n, generator=gen, device=DEVICE)
                     >= 0.2).float()
            else:
                schema, xs, cs, w = make_wide16k(n, seed + 64)
            p, width = schema.sigma_size, _build.WINDOW_WIDTH
            lows = list(range(0, p, width))
            if n == N:         # the plans: on the host, once a schema
                t0 = time.perf_counter()
                for lo in lows:
                    _build.keyed_window_plan(schema, lo, min(lo + width, p))
                plan_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = masked_gram_cols(xs, cs, w, schema=schema)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            pass_ms = cuda_ms(lambda: masked_gram_cols(xs, cs, w,
                                                       schema=schema),
                              reps=1, warmup=0)
            if (name == "wide16k" and pass_ms > WINDOW_PASS_LIMIT_S * 1e3
                    and n > N_WIDE16K_CUT):
                log(f"[K7win] wide16k n={n}: a pass {pass_ms:.1f} ms > "
                    f"{WINDOW_PASS_LIMIT_S} s: cut to {N_WIDE16K_CUT} rows")
                n = N_WIDE16K_CUT
                del full, xs, cs, w
                continue
            break
        check(torch.equal(full, full.T), f"[K7win] {name} S not symmetric")
        check(float(full[0, 0]) == float(w.sum()),
              f"[K7win] {name} sigma[0,0] != Σw")
        if name == "wide16k":
            mid = 3 + schema.cat_sizes[0] - width // 2
            lows = [0, mid, lows[-1]]
        per_window, worst = [], 0.0
        plain_total = 0.0
        for lo in lows:
            wd = min(width, p - lo)
            tag = f"[K7win] {name} window [{lo}, {lo + wd})"
            got = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                     width=wd)
            again = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                       width=wd)
            want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                            width=wd)
            torch.cuda.synchronize()
            worst = max(worst, _window_check(tag, got, again, want, schema,
                                             lo))
            check(torch.equal(got, full[:, lo:lo + wd]),
                  f"{tag} differs from the pass's columns")
            del got, again, want
            ms = cuda_ms(lambda: masked_gram_window(
                xs, cs, w, schema=schema, lo=lo, width=wd), reps=3,
                warmup=1)
            plain = cuda_ms(lambda: masked_gram_window_plain(
                xs, cs, w, schema=schema, lo=lo, width=wd), reps=1,
                warmup=0)
            plain_total += plain
            rec = window_record(xs, cs, w, schema, lo, wd, n, tag)
            b = window_bound(cs, w, schema, lo, lo + wd)
            per_window.append(dict(lo=lo, width=wd, ms=ms, plain_ms=plain,
                                   **rec, **b))
            log(f"{tag}: counts exact, bit-identical rerun, the pass's "
                f"columns; {rec['residual_tasks']} residual tasks over all "
                f"rows; keyed columns {rec['keyed_columns']}: "
                f"{rec['keyed_tasks']} tasks, {rec['items']} work items, "
                f"{rec['rows_read']} rows read (each layer its key range's: "
                f"{rec.get('layer_rows', {})}), their order {rec['order_ms']:.3f}"
                f" ms; kernel {ms:.3f} ms (its order included), plain "
                f"{plain:.3f} ms, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']})")
        whole = window_bound(cs, w, schema, 0, p)
        cols = window_columns(schema, range(0, p, width), width)
        order = order_check(f"[K7win] {name} order of columns {list(cols)}",
                            xs, cs, w, schema, cols)
        order_ms = order["ms"]
        lib_rows = N_LIBRARY[name]
        x_st = torch.stack(xs)[:, :lib_rows]
        c_st = torch.stack(cs)[:, :lib_rows]
        library = library_gram_ms(x_st, c_st, w[:lib_rows], schema)
        del x_st, c_st
        out[name] = dict(
            rows=n, sigma_size=p, windows=len(range(0, p, width)),
            ms=pass_ms, first_call_s=first_s, plan_host_s=plan_s,
            plain_ms=(plain_total if name == "favorita_items" else None),
            bound_ms=whole["bound_ms"], bound_by=whole["bound_by"],
            library_ms=library, library_rows=lib_rows,
            max_abs_err=worst, order_ms=order_ms, keyed_columns=list(cols),
            order=order, per_window=per_window)
        log(f"[K7win] {name} P={p} n={n}: a pass over all of S "
            f"({len(range(0, p, width))} windows of {width}) {pass_ms:.3f} ms"
            f", of which its one order pass of columns {list(cols)} "
            f"{order_ms:.3f} ms (first call {first_s:.2f} s with the plans' "
            f"upload; the plans {plan_s:.2f} s on the host), bound "
            f"{whole['bound_ms']:.4f} ms ({whole['bound_by']}); cuBLAS "
            f"(Zᵀw)@Z of the dense Z on a {lib_rows}-row slice "
            f"{library:.3f} ms; max abs err {worst:.3e}")
        del full, xs, cs, w
        torch.cuda.empty_cache()
    out["hot_key"] = hot_key_window(seed)
    return out


HOT_SHARE = 0.5              # [K7win]'s hot-key window: one item's rows


def hot_key_window(seed: int) -> dict:
    """[K7win]'s hot-key window: favorita_items at N rows with HOT_SHARE
    of the rows moved to one item (the first of the second window of
    WINDOW_WIDTH), that window against masked_gram_window_plain (counts
    exact, ≤ 1e-5 of max|σ|, a bit-identical rerun, equal to the pass's
    columns), its record (`window_record`) and ms by CUDA events."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_window, masked_gram_window_plain)

    t, _ = make_favorita_items(N, seed + 66)
    schema = t.schema
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    p, d = schema.sigma_size, schema.num_cols
    base = 1 + d + schema.offsets[-2]       # item_nbr's first column
    lo = _build.WINDOW_WIDTH
    width = min(_build.WINDOW_WIDTH, p - lo)
    hot = lo - base
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 67)
    moved = torch.rand(N, generator=gen, device=DEVICE) < HOT_SHARE
    cs[-1] = torch.where(moved, hot, cs[-1]).contiguous()
    w = (torch.rand(N, generator=gen, device=DEVICE) >= 0.2).float()
    share = float((cs[-1] == hot).float().mean())
    tag = f"[K7win] hot key: favorita_items n={N}, item {hot} on {share:.4f}"\
          f" of the rows, window [{lo}, {lo + width})"
    full = masked_gram_cols(xs, cs, w, schema=schema)
    got = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=width)
    again = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=width)
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                    width=width)
    torch.cuda.synchronize()
    err = _window_check(tag, got, again, want, schema, lo)
    check(torch.equal(got, full[:, lo:lo + width]),
          f"{tag}: differs from the pass's columns")
    check(float(got[base + hot, base + hot - lo]) == float(
        w[cs[-1] == hot].sum()), f"{tag}: the hot item's count is not exact")
    del got, again, want, full
    ms = cuda_ms(lambda: masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                            width=width), reps=3, warmup=1)
    plain = cuda_ms(lambda: masked_gram_window_plain(
        xs, cs, w, schema=schema, lo=lo, width=width), reps=1, warmup=0)
    rec = window_record(xs, cs, w, schema, lo, width, N, tag)
    b = window_bound(cs, w, schema, lo, lo + width)
    log(f"{tag}: counts exact (the hot item's too), max abs err {err:.3e}, "
        f"bit-identical rerun, the pass's columns; keyed columns "
        f"{rec['keyed_columns']}: {rec['keyed_tasks']} tasks, "
        f"{rec['items']} work items, {rec['rows_read']} rows read, their "
        f"order {rec['order_ms']:.3f} ms; kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    del t, xs, cs, w
    torch.cuda.empty_cache()
    return dict(lo=lo, width=width, share=share, max_abs_err=err, ms=ms,
                plain_ms=plain, **rec, **b)


def phase_items(seed: int) -> dict:
    """run_mice_device at favorita_items (P = 4,592), N rows, ITEMS_ROUNDS
    rounds, kernel 'auto' ('gram': K7 a window of WINDOW_WIDTH a column
    step, then the SVD solves): launches exact (rounds × 2 columns × 5
    windows), quality (family accuracy above its mode share + 0.02,
    transactions RMSE below the mean fill's), wall s; ITEMS_CPU_ROUNDS
    rounds on the CPU's plain versions at N_ITEMS_CPU rows against the
    card's (family codes ≥ 0.999)."""
    from duckdb_imputation_tpu_torch import Table, run_mice_device
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, window_columns, window_order)

    t, truth = make_favorita_items(N, seed + 63)
    p = t.schema.sigma_size
    windows = -(-p // _build.WINDOW_WIDTH)
    torch.cuda.synchronize()
    keyed = len(window_columns(t.schema, range(0, p, _build.WINDOW_WIDTH),
                               _build.WINDOW_WIDTH))
    masked_gram_cols.wide_launches = 0
    window_order.passes = window_order.launches = 0
    t0 = time.perf_counter()
    out = run_mice_device(t, iters=ITEMS_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = masked_gram_cols.wide_launches
    want = ITEMS_ROUNDS * 2 * windows
    check(launches == want, f"[items] {launches} K7 launches, derived "
          f"{want}")
    orders, order_launches = window_order.passes, window_order.launches
    check(orders == ITEMS_ROUNDS * 2
          and order_launches == ITEMS_ROUNDS * 2 * keyed,
          f"[items] {orders} order passes and {order_launches} order "
          f"launches, derived {ITEMS_ROUNDS * 2} (one a column step) and "
          f"{ITEMS_ROUNDS * 2 * keyed} (one a keyed column)")
    q = wide_quality(t, truth, out, "[items]")
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w = (~t.num_null[1]).float()
    sigma = masked_gram_cols(xs, cs, w, schema=t.schema)
    solve_ms = cuda_ms(lambda: linreg_solve_device(sigma, label=2), reps=1,
                       warmup=1)
    log(f"[items] run_mice_device favorita_items P={p} n={N} "
        f"rounds={ITEMS_ROUNDS} ('auto' = 'gram'): {launches} K7 launches "
        f"({windows} windows a column step, as derived) after {orders} "
        f"order passes (one a column step, {order_launches} order launches:"
        f" {keyed} keyed column a pass); {wall:.2f} s "
        f"wall; one SVD solve (linreg_solve_device) {solve_ms:.1f} ms; "
        f"quality {q}")
    run = (t, truth, out)
    del sigma, xs, cs, w

    small, _ = make_favorita_items(N_ITEMS_CPU, seed + 64)
    cpu = Table(*(a.cpu() for a in (small.num_data, small.cat_codes,
                                    small.num_null, small.cat_null)),
                schema=small.schema)
    t0 = time.perf_counter()
    ref = run_mice_device(cpu, iters=ITEMS_CPU_ROUNDS, kernel="plain")
    cpu_s = time.perf_counter() - t0
    got = run_mice_device(small, iters=ITEMS_CPU_ROUNDS)
    sm = small.cat_null[1].cpu()
    agree = float((got.cat_codes[1].cpu() == ref.cat_codes[1])[sm]
                  .float().mean())
    dx = float((got.num_data.cpu() - ref.num_data).abs().max())
    check(agree >= 0.999, f"[items] card vs CPU family agreement {agree}")
    log(f"[items] n={N_ITEMS_CPU}: the card vs the CPU's plain versions "
        f"({cpu_s:.1f} s): family agreement {agree:.6f}, x max diff "
        f"{dx:.3e}")
    return dict(launches=launches, order_passes=orders,
                order_launches=order_launches, wall_s=wall,
                solve_ms=solve_ms, run=run, **q)


def _dense_ridge(block, p: int):
    """The f64 dense ridge solve (on the card) of the normal equations
    cg_solve_wide solves under CG_CHECK, from the same S: (coefficients
    of the kept rows, the kept rows)."""
    label, ridge = CG_CHECK["label"], CG_CHECK["ridge"]
    sigma = block[:, :p].double()
    keep = torch.tensor([i for i in range(p) if i != label], device=DEVICE)
    nrows = sigma[0, 0].clamp(min=1.0)
    dd = torch.ones(p - 1, dtype=torch.float64, device=DEVICE)
    dd[0] = 0.0
    a = sigma[keep][:, keep] / nrows + ridge * torch.diag(dd)
    ref = torch.linalg.solve(a, sigma[keep, label] / nrows)
    return ref, keep


def phase_wide_v(seed: int, rows16k: int) -> dict:
    """[wide_v]: run_mice_wide on a 1 × 1 grid made over an NCCL group of
    one rank (an axis of one rank has no group: no collective runs) at
    favorita_items, N rows, 2 rounds, the entry point's defaults: its K7
    launches (one window of all P columns a column step), quality (as
    [items]), wall s; cg_solve_wide of transactions against an f64 dense
    ridge solve of the same S at tests/test_wide.py's 2e-3; sigma_striped
    at wide16k (`rows16k` rows, [K7win]'s), stripes of WINDOW_WIDTH, each
    equal to masked_gram's columns, peak device memory beside S. Then
    [wide_v2]. Returns the
    launches and numbers of the kernels line."""
    import dataclasses
    import datetime
    import tempfile

    from duckdb_imputation_tpu_torch.parallel import (
        cg_solve_wide, initialize, make_mesh_2d, run_mice_wide, shutdown,
        sigma_wide)
    from duckdb_imputation_tpu_torch.ring import sigma_striped
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_window)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        initialize("nccl", store=_store(f"{d}/store", 1), world_size=1,
                   rank=0, device=DEVICE,
                   timeout=datetime.timedelta(minutes=5))
        try:
            grid = make_mesh_2d(1, 1)
            t, truth = make_favorita_items(N, seed + 63)
            p = t.schema.sigma_size
            w = (~t.num_null[1]).float()
            block = sigma_wide(t.num_data, t.cat_codes, w, schema=t.schema,
                               mesh=grid)
            check(block.shape == (p, p), f"[wide_v] block {block.shape}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coeff = cg_solve_wide(block, mesh=grid, p=p, **CG_CHECK)
            torch.cuda.synchronize()
            cg_s = time.perf_counter() - t0
            ref, keep = _dense_ridge(block, p)
            diff = (coeff[keep].double() - ref).abs()
            over = float((diff - (2e-3 + 2e-3 * ref.abs())).max())
            check(over <= 0, f"[wide_v] cg_solve_wide beyond 2e-3 of the "
                  f"f64 dense solve by {over:.3e}")
            out["coeff"] = coeff.cpu()
            del block
            torch.cuda.synchronize()
            masked_gram_window.launches = 0
            t0 = time.perf_counter()
            x, c = run_mice_wide(t.num_data, t.cat_codes, t.num_null,
                                 t.cat_null, schema=t.schema, mesh=grid,
                                 iters=ITEMS_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = masked_gram_window.launches
            check(launches == ITEMS_ROUNDS * 2,
                  f"[wide_v] {launches} K7 window launches, derived "
                  f"{ITEMS_ROUNDS * 2}")
            q = wide_quality(t, truth, dataclasses.replace(
                t, num_data=x, cat_codes=c), "[wide_v]")
            out["x"] = x[1][t.num_null[1]].cpu()
            out["c"] = c[1][t.cat_null[1]].cpu()
            out["c_at_x"] = c[1][t.num_null[1]].cpu()
            log(f"[wide_v] run_mice_wide favorita_items P={p} n={N} on a "
                f"1 × 1 grid over NCCL (no collective), rounds="
                f"{ITEMS_ROUNDS}: {launches} K7 window launches (one of "
                f"{p} columns a column step); {wall:.2f} s wall; quality "
                f"{q}; cg_solve_wide (transactions, ridge "
                f"{CG_CHECK['ridge']}, ≤ {CG_CHECK['iters']} steps) "
                f"{cg_s:.2f} s, within 2e-3 of the f64 dense solve (max "
                f"|Δ| {float(diff.max()):.3e} at max|θ| "
                f"{float(ref.abs().max()):.3e}; worst margin {over:.3e})")
            del t, truth, x, c, w

            schema, xs, cs, w16 = make_wide16k(rows16k, seed + 64)
            p16 = schema.sigma_size
            x_st, c_st = torch.stack(xs), torch.stack(cs)
            full = masked_gram(x_st, c_st, w16, schema=schema)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            masked_gram_window.launches = 0
            scratch = 0
            for lo, stripe in sigma_striped(x_st, c_st, w16, schema=schema,
                                            stripe=_build.WINDOW_WIDTH):
                check(torch.equal(stripe, full[:, lo:lo + stripe.shape[1]]),
                      f"[wide_v] stripe {lo} differs from masked_gram's S")
                need = window_scratch(schema, lo, lo + stripe.shape[1],
                                      x_st.shape[1])
                scratch = max(scratch, need["total"] - need["plans"])
                del stripe
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            stripes = masked_gram_window.launches
            stripe_bytes = p16 * _build.WINDOW_WIDTH * 4
            check(stripes == -(-p16 // _build.WINDOW_WIDTH),
                  f"[wide_v] {stripes} stripe launches")
            check(peak <= stripe_bytes + scratch + (1 << 20),
                  f"[wide_v] striped peak {peak} B > a stripe "
                  f"{stripe_bytes} + K7's scratch {scratch} + 1 MiB")
            log(f"[wide_v] sigma_striped wide16k P={p16} n={x_st.shape[1]}: "
                f"{stripes} stripes of {_build.WINDOW_WIDTH}, each equal to "
                f"masked_gram's columns; peak device memory beside S (and "
                f"the plans, cached) {peak} B ≤ a stripe {stripe_bytes} B "
                f"+ K7's scratch (`window_scratch`: f64 partials, the "
                f"order's copies and transients) {scratch} B (a dense S is "
                f"{p16 * p16 * 4} B)")
            del full, x_st, c_st, xs, cs, w16
            torch.cuda.empty_cache()
            out["v2"] = phase_wide_v2(seed, out)
        finally:
            shutdown()
    return dict(wide_v_launches=launches, window_launches=stripes,
                striped_peak_bytes=peak, cg_s=cg_s, wall_s=wall, **q,
                wide_v2=out["v2"])


def wide_rank(rank: int, out_dir: str, seed: int) -> int:
    """One rank of [wide_v2] (a child process): gloo over CUDA tensors, a
    1 × 2 grid (sigma's columns split, every row on both ranks) at
    favorita_items; the sigma block's peak memory, cg_solve_wide and
    run_mice_wide as [wide_v] runs them; writes out_dir/rank<rank>.pt."""
    import datetime

    from duckdb_imputation_tpu_torch.parallel import (
        cg_solve_wide, initialize, make_mesh_2d, run_mice_wide, shutdown,
        sigma_wide)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)

    initialize("gloo", store=_store(f"{out_dir}/store", 2), world_size=2,
               rank=rank, device=DEVICE,
               timeout=datetime.timedelta(seconds=300))
    grid = make_mesh_2d(1, 2)
    t, _ = make_favorita_items(N, seed + 63)
    p = t.schema.sigma_size
    w = (~t.num_null[1]).float()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    block = sigma_wide(t.num_data, t.cat_codes, w, schema=t.schema,
                       mesh=grid)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    cols_per = block.shape[1]
    lo = rank * cols_per
    need = window_scratch(t.schema, lo, min(lo + cols_per, p), N)
    plan_bytes = need["plans"]
    partial = need["total"] - need["plans"]
    coeff = cg_solve_wide(block, mesh=grid, p=p, **CG_CHECK)
    del block
    torch.cuda.synchronize()
    masked_gram_window.launches = 0
    t0 = time.perf_counter()
    x, c = run_mice_wide(t.num_data, t.cat_codes, t.num_null, t.cat_null,
                         schema=t.schema, mesh=grid, iters=ITEMS_ROUNDS)
    torch.cuda.synchronize()
    torch.save(dict(
        peak=peak, block_shape=(p, cols_per), plan_bytes=plan_bytes,
        partial_bytes=partial, coeff=coeff.cpu(),
        wall_s=time.perf_counter() - t0,
        launches=masked_gram_window.launches,
        x=x[1][t.num_null[1]].cpu(), c=c[1][t.cat_null[1]].cpu(),
        c_at_x=c[1][t.num_null[1]].cpu(),
        observed_same=bool(
            torch.equal(x[~t.num_null], t.num_data[~t.num_null])
            and torch.equal(c[~t.cat_null], t.cat_codes[~t.cat_null]))),
        f"{out_dir}/rank{rank}.pt")
    shutdown()
    return 0


def phase_wide_v2(seed: int, one: dict) -> dict:
    """[wide_v2]: two gloo ranks over CUDA tensors sharing the card as a 1
    × 2 grid (each holds P × ⌈P/2⌉ of sigma, every row), spawned as
    [sharded2]'s are, at favorita_items, against [wide_v]'s 1 × 1 grid
    (`one`): family codes agree on ≥ 0.999 of the null rows; imputed
    transactions and the CG coefficients within 5e-3 (the transactions
    rows whose family agrees: a flipped family moves its row by the class
    coefficients' difference); each rank's peak memory for its sigma
    block ≤ P·⌈P/2⌉·4 B + its window's plans + K7's scratch (f64
    partials, the order's copies and transients: `window_scratch`) + 1
    MiB (torch.cuda.max_memory_allocated). Every child is killed at the
    deadline."""
    import tempfile

    p = items_schema().sigma_size
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--wide-rank", str(r),
             "--sharded-dir", d, "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for proc in procs:
                left = WIDE_V2_DEADLINE_S - (time.perf_counter() - t0)
                logs.append(proc.communicate(timeout=max(1.0, left))[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (proc, text) in enumerate(zip(procs, logs)):
            check(proc.returncode == 0, f"[wide_v2] rank {r} failed "
                  f"({proc.returncode}):\n{text[-4000:]}")
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(2)]
    half = -(-p // 2)
    for r, res in enumerate(ranks):
        check(res["block_shape"] == (p, half),
              f"[wide_v2] rank {r} block {res['block_shape']}")
        limit = p * half * 4 + res["plan_bytes"] + res["partial_bytes"] + (
            1 << 20)
        check(res["peak"] <= limit, f"[wide_v2] rank {r} sigma peak "
              f"{res['peak']} B > {limit} B")
        check(res["observed_same"], f"[wide_v2] rank {r} observed changed")
        check(res["launches"] == ITEMS_ROUNDS * 2,
              f"[wide_v2] rank {r}: {res['launches']} window launches")
    for key in ("x", "c", "coeff"):
        check(torch.equal(ranks[0][key], ranks[1][key]),
              f"[wide_v2] the ranks' {key} differ")
    res = ranks[0]
    agree = float((res["c"] == one["c"]).float().mean())
    check(agree >= 0.999, f"[wide_v2] family agreement {agree}")
    same = res["c_at_x"] == one["c_at_x"]
    check(torch.allclose(res["x"][same], one["x"][same], rtol=5e-3,
                         atol=5e-3),
          f"[wide_v2] transactions beyond 5e-3 of the 1 × 1 grid's: max "
          f"|Δ| {float((res['x'] - one['x'])[same].abs().max()):.3e}")
    check(torch.allclose(res["coeff"], one["coeff"], rtol=5e-3, atol=5e-3),
          "[wide_v2] CG coefficients beyond 5e-3 of the 1 × 1 grid's")
    out = dict(code_agreement=agree,
               codes_differ=int((res["c"] != one["c"]).sum()),
               x_max_abs_diff=float((res["x"] - one["x"])[same].abs().max()),
               coeff_max_abs_diff=float((res["coeff"] - one["coeff"])
                                        .abs().max()),
               peak_bytes=[r["peak"] for r in ranks],
               block_bytes=p * half * 4,
               plan_bytes=[r["plan_bytes"] for r in ranks],
               partial_bytes=[r["partial_bytes"] for r in ranks],
               rank_wall_s=[r["wall_s"] for r in ranks], wall_s=wall)
    log(f"[wide_v2] 2 gloo ranks over CUDA tensors sharing the card, a 1 × "
        f"2 grid at favorita_items P={p} n={N}, against the 1 × 1 grid: "
        f"{out}; a dense S is {p * p * 4} B")
    return out


# ---------------------------------------------------------------------------
# The SQL front end (the reference's statement sequences over the port's
# api, evaluated in numpy on the host) and the overlapped sharded
# aggregate (sigma in column stripes of K7 windows, each stripe's
# all-reduce issued asynchronously before the next)
# ---------------------------------------------------------------------------

N_SQL = 1_000_000             # rows of [sql] and [sql_classify]
SQL_STRUCT = ("::STRUCT(N int, lin_agg FLOAT[], quad_agg FLOAT[], "
              "lin_cat STRUCT(key INT, value FLOAT)[][], "
              "quad_num_cat STRUCT(key INT, value FLOAT)[][], "
              "quad_cat STRUCT(key1 INT, key2 INT, value FLOAT)[][])")
SQL_NB_STRUCT = ("::STRUCT(N int, lin_agg FLOAT[], quad_agg FLOAT[], "
                 "lin_cat STRUCT(key INT, value FLOAT)[][])")
OVERLAP_STRIPES = 4
OVERLAP_DEADLINE_S = 300


def _kernel_counters():
    """Every kernel wrapper's launch counters: K1's two entries and K7
    behind them, K7's window entry, the D kernel (`dense_gram.launches`,
    by whichever entry ran it), the windows' order passes
    (`window_order.passes`) and its kernels (`window_order.launches`),
    K2/K2w (and past P = 1,024 K2w's impute
    kernel and its K7 windows), K4, K5/K8, K6/K6w and K3/K3w."""
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, masked_gram, masked_gram_cols, masked_gram_window,
        window_order)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted)

    both = ("launches", "wide_launches")
    return [(fn, attr) for fn, attrs in (
        (masked_gram, both), (masked_gram_cols, both),
        (masked_gram_window, ("launches",)), (dense_gram, ("launches",)),
        (window_order, ("passes", "launches")),
        (fused_impute_aggregate, both + ("impute_launches",
                                         "window_launches")),
        (grouped_gram, ("launches",)), (grouped_gram_presorted, both),
        (nb_grouped_sums, ("launches",)), (qda_predict_kernel, both))
        for attr in attrs]


def kernel_counts_reset() -> None:
    torch.cuda.synchronize()
    for fn, attr in _kernel_counters():
        setattr(fn, attr, 0)


def kernel_counts() -> dict:
    """The nonzero counters, keyed wrapper.counter."""
    torch.cuda.synchronize()
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in _kernel_counters() if getattr(fn, attr)}


class StatementClock:
    """Runs SQL statements on a connection and keeps each one's wall time:
    the host clock from a synchronized card to the statement's end and a
    synchronize."""

    def __init__(self, con):
        self.con = con
        self.times = []

    def __call__(self, label: str, q: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = self.con.execute(q).fetchall()
        torch.cuda.synchronize()
        self.times.append((label, time.perf_counter() - t0))
        return rows


def sql_triple_check(tag, got: dict, cols, weights) -> tuple[float, float]:
    """A masked aggregate statement's triple (its dict) against
    api.sum_to_triple over the same columns with the WHERE as weights, on
    the card: N exact, every entry within 1e-5 of max|σ|. Returns the
    max error over max|σ| and the ms of the statement's aggregate alone
    (ring.sum.sum_to_triple, K1, over the statement's rows: CUDA
    events)."""
    from duckdb_imputation_tpu_torch import api
    from duckdb_imputation_tpu_torch.ring import serialize
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    want = api.sum_to_triple(*cols, weights=weights, device=DEVICE)
    t, _ = serialize.dict_to_triple(got, want.schema, device=DEVICE)
    a, b = sigma_from_triple(t), sigma_from_triple(want.triple)
    err = rel_err(a, b)
    check(int(got["N"]) == int(round(float(b[0, 0]))),
          f"[sql] {tag}: N {got['N']} against {float(b[0, 0])}")
    check(err <= 1e-5, f"[sql] {tag}: triple max rel err {err:.3e} > 1e-5")
    rows = np.flatnonzero(weights)
    x = torch.tensor(np.stack([c[rows] for c in cols[:4]]), device=DEVICE)
    codes = torch.tensor(want.schema.encode(np.stack(
        [c[rows] for c in cols[4:]], 1)).T.copy(), device=DEVICE)
    ms = cuda_ms(lambda: sum_to_triple(x, codes, None, schema=want.schema))
    return err, ms


def phase_sql(seed: int, card: str) -> dict:
    """[sql]: the reference's MICE statement sequence, one round, at
    BASELINE config 5 (make_table, N_SQL rows) on a card connection:
    init_baseline's statements (AVG / MODE, the flag columns by ADD COLUMN
    and the swap, the COALESCE fills by the swap;
    tests/test_sql_partition.py::test_init_baseline_statement_sequence),
    then the MICE driver's (tests/test_sql.py::test_mice_driver_sql_
    sequence): c0 by sum_to_triple_4_2 … WHERE c0_IS_NULL IS FALSE,
    lda_train over the triple's text literal, CASE-WHEN lda_predict into
    rep and the swap; then x1 the same way with linreg_train /
    linreg_predict, noise off. The categorical columns are registered as
    float columns with NaN (register gives integer columns no NULLs) and
    cast back with ::INTEGER, which keeps the NULL flag. Gates: observed
    cells bit-identical; imputed x1 RMSE < 0.05; against
    api.run_MICE_baseline(con.to_table('t'), mice_iters=1, noise=False)
    [host_mice]'s low-vs-baseline bounds (x within 1e-3 rel + 1e-2, codes
    agree > 0.99); each aggregate's triple equals api.sum_to_triple with
    the WHERE as weights (N exact, 1e-5 of max|σ|); masked_gram launches
    exactly once an aggregate statement and no other Gram kernel
    launches. Prints each statement's wall time beside the card."""
    from duckdb_imputation_tpu_torch import api, sql

    t, truth = make_table(N_SQL, seed + 70)
    x = torch.where(t.num_null, float("nan"), t.num_data).cpu().numpy()
    c = torch.where(t.cat_null, float("nan"),
                    t.cat_codes.double()).cpu().numpy()
    con = sql.connect(device=DEVICE)
    run = StatementClock(con)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    con.register("raw", {"x0": x[0], "x1": x[1], "x2": x[2], "x3": x[3],
                         "c0f": c[0], "c1f": c[1]})
    run.times.append(("register", time.perf_counter() - t0))
    run("create_t", "CREATE TABLE t AS SELECT x0, x1, x2, x3, "
        "c0f::INTEGER AS c0, c1f::INTEGER AS c1 FROM raw")
    avg_x1, mode_c0 = run("avg_mode", "SELECT AVG(x1), MODE(c0) FROM t "
                          "LIMIT 10000")[0]
    run("create_t_complete", "CREATE TABLE t_complete AS SELECT * FROM t")
    for col, fill in (("x1", avg_x1), ("c0", int(mode_c0))):
        run(f"{col}_flag_rep", f"CREATE TABLE rep AS SELECT {col} IS NULL "
            "FROM t")
        run(f"{col}_flag_add", f"ALTER TABLE t_complete ADD COLUMN "
            f"{col}_IS_NULL BOOLEAN DEFAULT false;")
        run(f"{col}_flag_swap", f"ALTER TABLE t_complete ALTER COLUMN "
            f"{col}_IS_NULL SET DEFAULT 10;")
        run(f"{col}_fill_rep", f"CREATE TABLE rep AS SELECT "
            f"COALESCE({col} , {fill}) FROM t")
        run(f"{col}_fill_swap", f"ALTER TABLE t_complete ALTER COLUMN "
            f"{col} SET DEFAULT 10;")
    cols = ("x0", "x1", "x2", "x3", "c0", "c1")

    def snapshot():
        rel = con.tables["t_complete"]
        return ([rel.get(n).data.astype(np.float32) for n in cols[:4]]
                + [rel.get(n).data.astype(np.int64) for n in cols[4:]])

    kernel_counts_reset()
    aggs = []
    # c0 first (categorical columns first, imputation_base.cpp:18-87)
    before = snapshot()
    triple = run("c0_aggregate", "SELECT sum_to_triple_4_2(x0, x1, x2, x3,"
                 " c0, c1) FROM t_complete WHERE c0_IS_NULL IS FALSE")[0][0]
    aggs.append(("c0", triple, before, ~t.cat_null[0].cpu().numpy()))
    params = run("c0_train", f"SELECT lda_train({triple!r}{SQL_STRUCT}, 0, "
                 "0.001)")[0][0]
    run("c0_predict", f"CREATE TABLE rep AS SELECT CASE WHEN c0_IS_NULL "
        f"THEN lda_predict({params!r}::FLOAT[], false, x0, x1, x2, x3, c1) "
        "ELSE c0 END FROM t_complete")
    run("c0_swap", "ALTER TABLE t_complete ALTER COLUMN c0 SET DEFAULT 10;")
    before = snapshot()
    triple = run("x1_aggregate", "SELECT sum_to_triple_4_2(x0, x1, x2, x3,"
                 " c0, c1) FROM t_complete WHERE x1_IS_NULL IS FALSE")[0][0]
    aggs.append(("x1", triple, before, ~t.num_null[1].cpu().numpy()))
    params = run("x1_train", f"SELECT linreg_train({triple!r}{SQL_STRUCT}, "
                 "1, 0.001::FLOAT, 0::FLOAT, 10000::INTEGER, false, "
                 "false)")[0][0]
    run("x1_predict", f"CREATE TABLE rep AS SELECT CASE WHEN x1_IS_NULL "
        f"THEN linreg_predict({params!r}::FLOAT[], false, false, x0, x2, "
        "x3, c0, c1) ELSE x1 END FROM t_complete")
    run("x1_swap", "ALTER TABLE t_complete ALTER COLUMN x1 SET DEFAULT 10;")
    launches = kernel_counts()
    check(launches == {"masked_gram.launches": len(aggs)},
          f"[sql] kernel launches {launches}, not one masked_gram launch "
          f"an aggregate statement ({len(aggs)}) and no other")

    out = con.to_table("t_complete")
    check(torch.isfinite(out.num_data).all(), "[sql] x not finite")
    check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null])
          and torch.equal(out.cat_codes[~t.cat_null],
                          t.cat_codes[~t.cat_null]),
          "[sql] observed cells changed")
    nm = t.num_null[1]
    rmse = float(((out.num_data[1] - truth)[nm] ** 2).mean().sqrt())
    check(rmse < 0.05, f"[sql] imputed x1 RMSE {rmse}")
    checked = {tag: sql_triple_check(tag, d, snap, w)
               for tag, d, snap, w in aggs}
    errs = {tag: e for tag, (e, _) in checked.items()}
    k1_ms = {tag: ms for tag, (_, ms) in checked.items()}
    base = api.run_MICE_baseline(con.to_table("t"), mice_iters=1,
                                 noise=False)
    dx = float((out.num_data - base.num_data).abs().max())
    agree = float((out.cat_codes == base.cat_codes).float().mean())
    check(close_to(out.num_data, base.num_data, 1e-3, 1e-2),
          f"[sql] vs run_MICE_baseline: x max diff {dx}")
    check(agree > 0.99, f"[sql] vs run_MICE_baseline code agreement {agree}")
    total = sum(s for _, s in run.times)
    log(f"[sql] config 5, n={N_SQL}, one round: masked_gram launches "
        f"{launches} (one an aggregate statement), no other Gram kernel; "
        f"RMSE of imputed x1 {rmse:.3e}; observed cells bit-identical; "
        f"aggregates against api.sum_to_triple(weights=WHERE) max rel err "
        f"{errs}; against api.run_MICE_baseline(mice_iters=1): x max diff "
        f"{dx:.3e}, code agreement {agree:.6f}; each aggregate's K1 alone "
        f"over its rows, ms (CUDA events) {k1_ms}")
    log(f"[sql] statement wall s (host clock, synchronized; {card}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in run.times)
        + f"; all {total:.6f}")
    return dict(launches=launches.get("masked_gram.launches", 0),
                statement_s=dict(run.times), total_s=total, k1_ms=k1_ms)


def _timed_group_ids(sql_module, times: list):
    """sql._group_ids with its host time appended to `times`; returns the
    original to put back."""
    real = sql_module._group_ids

    def timed(keys):
        t0 = time.perf_counter()
        out = real(keys)
        times.append(time.perf_counter() - t0)
        return out
    sql_module._group_ids = timed
    return real


def tuple_group_ids(sql_module, keys) -> np.ndarray:
    """The JAX module's GROUP BY key pass (sql.py:1211-1218): a dict of
    Python tuples, row by row; the yardstick of the port's vectorised
    `_group_ids`."""
    seen, gid = {}, np.empty(len(keys[0]), np.int64)
    for r in range(len(gid)):
        k = tuple(sql_module._pyval(c, r) for c in keys)
        gid[r] = seen.setdefault(k, len(seen))
    return gid


def phase_sql_classify(seed: int, card: str) -> dict:
    """[sql_classify]: the reference's QDA and NB flows (tests/test_sql.py::
    test_qda_list_aggregate / test_nb_list_aggregate) at BASELINE config 4
    (make_classify_table: 8 classes, 90% in class 0), N_SQL rows, on a
    card connection: SELECT list(agg), list(label) FROM (SELECT
    sum_to_triple_4_2(…) AS agg, label FROM t GROUP BY label), qda_train
    over the literals, the accuracy as one SQL AVG(CASE WHEN
    qda_predict(…) = label …); the same for NB. Gates: K1 (masked_gram)
    launches 8 times for QDA, K6 8 times for NB, nothing else; the
    parameters equal the direct api path's (api.sum_to_triple /
    sum_to_nb_agg of each class's rows in the list's order, stacked,
    api.qda_train / nb_train) within rtol 1e-6; each class's triple
    against the grouped api call (group_by=label: K4 / K6 over all rows)
    with counts exact and within 1e-5 of max|σ|; accuracy > the class-0
    share + 0.02. Prints the GROUP BY key pass's and each statement's wall
    times (each statement twice: the first call and a repeat), and the
    JAX module's tuple loop over the same keys."""
    from duckdb_imputation_tpu_torch import api, sql
    from duckdb_imputation_tpu_torch.ring import serialize
    from duckdb_imputation_tpu_torch.ring.triple import (_map,
                                                         sigma_from_triple)

    x, codes, y, schema = make_classify_table(N_SQL, seed + 71)
    xs, cs, ys = x.cpu().numpy(), codes.cpu().numpy(), y.cpu().numpy()
    data = {f"x{j}": xs[j] for j in range(4)}
    data.update(c0=cs[0].astype(np.int64), c1=cs[1].astype(np.int64),
                label=ys.astype(np.int64))
    con = sql.connect(device=DEVICE)
    con.register("t", data)
    run = StatementClock(con)
    prior = float((y == 0).float().mean())
    key_s = []
    out = {}
    for model, fn, struct, train in (
            ("qda", "sum_to_triple_4_2", SQL_STRUCT, "qda_train"),
            ("nb", "sum_to_nb_agg_4_2", SQL_NB_STRUCT, "nb_train")):
        kernel_counts_reset()
        real = _timed_group_ids(sql, key_s)
        try:
            aggs, labels = run(f"{model}_list_aggregate",
                               f"SELECT list(agg), list(label) FROM (SELECT "
                               f"{fn}(x0, x1, x2, x3, c0, c1) AS agg, label "
                               f"FROM t GROUP BY label)")[0]
        finally:
            sql._group_ids = real
        launches = kernel_counts()
        want = ({"masked_gram.launches": CLASSES} if model == "qda"
                else {"nb_grouped_sums.launches": CLASSES})
        check(launches == want, f"[sql_classify] {model} launches "
              f"{launches}, not {want}")
        extra = ", false" if model == "qda" else ""
        q = (f"SELECT {train}({aggs!r}{struct}[], {labels}::int[]{extra})")
        params = run(f"{model}_train", q)[0][0]
        check(run(f"{model}_train_again", q)[0][0] == params,
              f"[sql_classify] {model}: a repeated train differs")
        q = (f"SELECT AVG(CASE WHEN {model}_predict({params!r}::float[], "
             "false, x0, x1, x2, x3, c0, c1) = label THEN 1.0 ELSE 0.0 END) "
             "FROM t")
        acc = run(f"{model}_accuracy", q)[0][0]
        check(run(f"{model}_accuracy_again", q)[0][0] == acc,
              f"[sql_classify] {model}: a repeated accuracy differs")
        check(acc > prior + 0.02, f"[sql_classify] {model} accuracy {acc} "
              f"does not beat the class-0 share {prior} by 0.02")

        # the direct api path: each class's rows in the list's order
        cols = [xs[j] for j in range(4)] + [data["c0"], data["c1"]]
        api_fn = api.sum_to_triple if model == "qda" else api.sum_to_nb_agg
        per_class = [api_fn(*[col[ys == k] for col in cols], device=DEVICE)
                     for k in labels]
        check(all(v.schema == per_class[0].schema for v in per_class),
              f"[sql_classify] {model}: the classes' vocabularies differ")
        train_fn = ((lambda v, lab: api.qda_train(v, lab, normalize=False))
                    if model == "qda" else api.nb_train)
        direct = train_fn(sql._stack_cofactors(per_class),
                          np.asarray(labels))
        perr = float(np.max(np.abs(np.asarray(params) - direct)
                            / np.maximum(np.abs(direct), 1e-30)))
        check(np.allclose(params, direct, rtol=1e-6, atol=0),
              f"[sql_classify] {model} params against the api path: max "
              f"rel diff {perr:.3e}")
        # each class's aggregate against the grouped api call over all
        # rows (K4 / K6 over every class at once), stacked in the list's
        # order
        grouped = api_fn(*cols, group_by=ys, num_groups=CLASSES,
                         device=DEVICE)
        field = "triple" if model == "qda" else "agg"
        order = torch.tensor(labels, device=DEVICE)
        in_order = _map(lambda a: a[order], getattr(grouped, field))
        gerr = 0.0
        for i, d in enumerate(aggs):
            one = _map(lambda a: a[i], in_order)
            if model == "qda":
                t_i, _ = serialize.dict_to_triple(d, grouped.schema,
                                                  device=DEVICE)
                a, b = sigma_from_triple(t_i), sigma_from_triple(one)
                cm = count_entries(grouped.schema)
                check(torch.equal(a[cm], b[cm]), f"[sql_classify] class "
                      f"{labels[i]} counts differ from the grouped api call")
            else:
                t_i, _ = serialize.dict_to_nb(d, grouped.schema,
                                              device=DEVICE)
                check(torch.equal(t_i.n, one.n)
                      and torch.equal(t_i.lin_cat, one.lin_cat),
                      f"[sql_classify] class {labels[i]} NB counts differ")
                a = torch.cat([t_i.lin, t_i.quad_diag])
                b = torch.cat([one.lin, one.quad_diag])
            gerr = max(gerr, rel_err(a, b))
        check(gerr <= 1e-5, f"[sql_classify] {model} classes against the "
              f"grouped api call: max rel err {gerr:.3e}")
        gparams = train_fn(type(grouped)(in_order, grouped.schema,
                                         batched=True), np.asarray(labels))
        g_diff = np.abs(np.asarray(params) - gparams)
        g_rel = float(np.max(g_diff / np.maximum(np.abs(gparams), 1e-30)))
        g_scaled = float(g_diff.max() / np.abs(gparams).max())
        out[model] = dict(accuracy=acc, launches=launches,
                          params_rel_diff=perr, grouped_rel_err=gerr,
                          grouped_params_rel_diff=g_rel,
                          grouped_params_diff_over_max=g_scaled)
    keys = [con.tables["t"].get("label")]
    gid, _ = sql._group_ids(keys)
    t0 = time.perf_counter()
    loop_gid = tuple_group_ids(sql, keys)
    loop_s = time.perf_counter() - t0
    check(np.array_equal(gid, loop_gid), "[sql_classify] the vectorised "
          "GROUP BY ids differ from the tuple loop's")
    out["tuple_loop_s"] = loop_s
    times = dict(run.times)
    log(f"[sql_classify] config 4, n={N_SQL}, {CLASSES} classes: {out}; "
        f"class-0 share {prior:.5f}")
    log(f"[sql_classify] wall s (host clock, synchronized; {card}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in times.items())
        + f"; GROUP BY key pass of each list statement "
        f"{[round(s, 6) for s in key_s]}, the JAX module's tuple loop over "
        f"the same keys {loop_s:.6f} (equal ids)")
    out["statement_s"] = times
    out["group_key_s"] = key_s
    return out


def overlap_check(tag, got, want, schema) -> float:
    """tests/test_sharded.py:205-228's bounds: n, lin_cat and cat_cat
    exact; quad, lin and num_cat within rtol 1e-6, atol 1e-3. Returns the
    largest |Δ| of the latter."""
    for f in ("n", "lin_cat", "cat_cat"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"[overlap] {tag}: {f} differs")
    worst = 0.0
    for f in ("quad", "lin", "num_cat"):
        a, b = getattr(got, f), getattr(want, f)
        check(torch.allclose(a, b, rtol=1e-6, atol=1e-3),
              f"[overlap] {tag}: {f} beyond rtol 1e-6, atol 1e-3: max |Δ| "
              f"{float((a - b).abs().max()):.3e}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def _overlap_inputs(name: str, seed: int):
    """(x, codes, weights, schema) of an [overlap] cell: the table's
    columns, the rows where transactions is observed as weights."""
    t, _ = (make_favorita if name == "favorita_wide"
            else make_favorita_items)(N, seed + 72)
    return (t.num_data, t.cat_codes, (~t.num_null[1]).float(), t.schema)


def overlap_rank(rank: int, out_dir: str, seed: int) -> int:
    """One rank of [overlap]'s two-rank cell (a child process): gloo over
    CUDA tensors sharing the card, its half of favorita_wide's N rows,
    sum_to_triple_overlapped with OVERLAP_STRIPES stripes; writes its
    sigma and K7 window launches to out_dir/rank<rank>.pt."""
    import datetime

    from duckdb_imputation_tpu_torch.parallel import (
        initialize, local_shard, shutdown, sum_to_triple_overlapped)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    mesh = initialize("gloo", store=_store(f"{out_dir}/store", 2),
                      world_size=2, rank=rank, device=DEVICE,
                      timeout=datetime.timedelta(seconds=120))
    x, c, w, schema = _overlap_inputs("favorita_wide", seed)
    x, c, w = (local_shard(a, mesh) for a in (x, c, w))
    torch.cuda.synchronize()
    masked_gram_window.launches = 0
    got = sum_to_triple_overlapped(x, c, w, schema=schema, mesh=mesh,
                                   n_stripes=OVERLAP_STRIPES)
    torch.cuda.synchronize()
    torch.save(dict(sigma=sigma_from_triple(got).cpu(), rows=x.shape[1],
                    launches=masked_gram_window.launches),
               f"{out_dir}/rank{rank}.pt")
    shutdown()
    return 0


def phase_overlap(seed: int) -> dict:
    """[overlap]: sum_to_triple_overlapped (OVERLAP_STRIPES column stripes,
    one K7 window launch and one asynchronous all-reduce each) against
    sum_to_triple_sharded on a world of one over NCCL at favorita_wide (P =
    492) and favorita_items (P = 4,592), N rows each, and on two gloo ranks
    over CUDA tensors sharing the card (spawned as [sharded2]'s are), half
    of favorita_wide's rows each, against the world of one. Gates:
    test_sharded.py's bounds; K7 window launches = the stripes on every
    rank. Prints ms of the overlapped pass and of the unstriped one (CUDA
    events). One card cannot show the overlap itself: NCCL refuses two
    ranks on one card, and a world of one has nothing to exchange."""
    import datetime
    import tempfile

    from duckdb_imputation_tpu_torch.parallel import (
        initialize, shutdown, sum_to_triple_overlapped, sum_to_triple_sharded)
    from duckdb_imputation_tpu_torch.parallel.overlap import stripe_bounds
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)
    from duckdb_imputation_tpu_torch.ring.triple import (sigma_from_triple,
                                                         triple_from_sigma)

    out, launches = {}, 0
    with tempfile.TemporaryDirectory() as d:
        mesh = initialize("nccl", store=_store(f"{d}/store", 1),
                          world_size=1, rank=0, device=DEVICE,
                          timeout=datetime.timedelta(minutes=5))
        try:
            for name in ("favorita_wide", "favorita_items"):
                x, c, w, schema = _overlap_inputs(name, seed)
                stripes = len(stripe_bounds(schema.sigma_size,
                                            OVERLAP_STRIPES))

                def over():
                    return sum_to_triple_overlapped(
                        x, c, w, schema=schema, mesh=mesh,
                        n_stripes=OVERLAP_STRIPES)

                def plain():
                    return sum_to_triple_sharded(x, c, w, schema=schema,
                                                 mesh=mesh)
                torch.cuda.synchronize()
                masked_gram_window.launches = 0
                got = over()
                torch.cuda.synchronize()
                check(masked_gram_window.launches == stripes,
                      f"[overlap] {name}: {masked_gram_window.launches} "
                      f"window launches for {stripes} stripes")
                launches += masked_gram_window.launches
                want = plain()
                worst = overlap_check(name, got, want, schema)
                ms = {"overlapped": cuda_ms(over, reps=3, warmup=1),
                      "sharded": cuda_ms(plain, reps=3, warmup=1)}
                out[name] = dict(p=schema.sigma_size, stripes=stripes,
                                 max_abs_diff=worst, ms=ms)
                if name == "favorita_wide":
                    world1 = sigma_from_triple(got).cpu()
                log(f"[overlap] {name} P={schema.sigma_size} n={N}, world 1 "
                    f"on NCCL: {stripes} stripes, one K7 window launch each "
                    f"({stripes} launches); against sum_to_triple_sharded: "
                    f"counts exact, max |Δ| {worst:.3e}; ms {ms}")
                del x, c, w, got, want
        finally:
            shutdown()

    wide = favorita_schema()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--overlap-rank", str(r),
             "--sharded-dir", d, "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for proc in procs:
                left = OVERLAP_DEADLINE_S - (time.perf_counter() - t0)
                logs.append(proc.communicate(timeout=max(1.0, left))[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (proc, text) in enumerate(zip(procs, logs)):
            check(proc.returncode == 0, f"[overlap] rank {r} failed "
                  f"({proc.returncode}):\n{text[-4000:]}")
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(2)]
    stripes = len(stripe_bounds(wide.sigma_size, OVERLAP_STRIPES))
    check(all(r["launches"] == stripes for r in ranks),
          f"[overlap] two ranks: window launches "
          f"{[r['launches'] for r in ranks]}, not {stripes} each")
    check(torch.equal(ranks[0]["sigma"], ranks[1]["sigma"]),
          "[overlap] the two ranks' sigmas differ")
    check(sum(r["rows"] for r in ranks) == N, "[overlap] rows lost")
    d = wide.num_cols
    worst = overlap_check("two ranks vs world 1",
                          triple_from_sigma(ranks[0]["sigma"], d),
                          triple_from_sigma(world1, d), wide)
    out["two_ranks"] = dict(rows=[r["rows"] for r in ranks],
                            launches=[r["launches"] for r in ranks],
                            max_abs_diff=worst, wall_s=wall)
    log(f"[overlap] favorita_wide, 2 gloo ranks over CUDA tensors sharing "
        f"the card, {[r['rows'] for r in ranks]} rows: {stripes} window "
        f"launches on each rank; against world 1: counts exact, max |Δ| "
        f"{worst:.3e}; {wall:.1f} s for the two processes")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# K2w, K8 and K3/K3w past P = 1,024 at favorita_items: the kernels alone
# ([K2w_items], [K8win], [K3items]), the fused and the sharded MICE loops
# ([items_fused], [sharded_items]) and the classifier pipelines
# ([classify_items])
# ---------------------------------------------------------------------------

N_K3_PLAIN = 1_000_000   # rows [K3items] holds K3w against its plain
                         # version at (the plain scorer keeps an f64 term
                         # and a mask a slab a row: ~550 slabs at 10M rows
                         # would not fit the card)
N_CLASSIFY_HOST = 200_000  # rows [classify_items] scores with the host's
                           # QDA parameters on the CPU, and with the f64
                           # oracle on the card, against the card's scorer


def items_classify(n: int, seed: int, label: str):
    """make_favorita_items' table with no nulls, categorical column `label`
    taken out as the class: onpromotion (2 classes, ~20% positive, P =
    4,590) or family (33 classes, P = 4,559). Returns (x f32[3, n], codes
    i32[9, n], y i32[n], schema, classes)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    t, _ = make_favorita_items(n, seed, null_frac=0.0)
    col = LABELS[label]
    keep = [j for j in range(len(ITEMS_VOCABS)) if j != col]
    schema = FeatureSchema(num_cols=3, cat_keys=tuple(
        t.schema.cat_keys[j] for j in keep))
    return (t.num_data, t.cat_codes[keep].contiguous(),
            t.cat_codes[col].contiguous(), schema, ITEMS_VOCABS[col])


def phase_k2w_items(seed: int) -> dict:
    """K2w past P = 1,024 at favorita_items, N rows: a 'cat' step imputing
    family (R = 33) from LDA coefficients trained on the table's own sigma
    and a 'num' step imputing transactions with noise. Each call is the
    impute kernel (W read from device memory) and K7 a window of 1,024
    over the updated columns: launches exact (1 and 5 a call), reruns
    bit-identical; against the plain version, codes ≥ 0.9999 equal or x
    within 1e-4, sigma within 1e-5 of max|σ|, its counts exact against the
    plain Gram of the kernel's own columns; ms by CUDA events, and of the
    impute kernel alone by CUDA events around its one launch (its column
    bit-identical to K2w's); each window's record over the updated
    columns (`window_record`) and their order pass's ms."""
    from duckdb_imputation_tpu_torch.mice.device_round import (
        _lda_device, _noise_std, _w_full)
    from duckdb_imputation_tpu_torch.mice.partition import init_fill
    from duckdb_imputation_tpu_torch.models.device import (
        linreg_solve_device)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain, impute_wide,
        impute_wide_inputs)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_window_plain, window_columns,
        window_order)

    t = init_fill(make_favorita_items(N, seed + 70)[0])
    schema = t.schema
    p, d = schema.sigma_size, schema.num_cols
    windows = -(-p // _build.WINDOW_WIDTH)
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    w_fam = (~t.cat_null[1]).float()
    w_tx = (~t.num_null[1]).float()
    sig = masked_gram_cols(xs, cs, w_fam, schema=schema)
    w, icpt, keep = _lda_device(sig, schema, 1, 0.001)
    sig_x = masked_gram_cols(xs, cs, w_tx, schema=schema)
    coeff = linreg_solve_device(sig_x, label=2)
    theta = coeff.clone()
    theta[2] = 0.0
    steps = {
        "cat": ((xs, cs, t.cat_null[1], w_tx, _w_full(w, keep, schema),
                 icpt), dict(schema=schema, kind="cat", imp_col=1),
                t.cat_null[1], w_tx, schema.cat_sizes[1]),
        "num": ((xs, cs, t.num_null[1], w_fam, theta[:, None],
                 theta.new_zeros(1)),
                dict(schema=schema, kind="num", imp_col=1,
                     noise=(seed, 0, _noise_std(coeff, sig_x))),
                t.num_null[1], w_fam, 1)}
    del sig, sig_x
    cm = count_entries(schema)
    out = {}
    for kind, (args, kw, null, w_next, rclasses) in steps.items():
        tag = f"[K2w_items] {kind} n={N} P={p}"
        imp0 = fused_impute_aggregate.impute_launches
        win0 = fused_impute_aggregate.window_launches
        wide0 = fused_impute_aggregate.wide_launches
        new_k, sig_k = fused_impute_aggregate(*args, **kw)
        new_2, sig_2 = fused_impute_aggregate(*args, **kw)
        torch.cuda.synchronize()
        launched = (fused_impute_aggregate.impute_launches - imp0,
                    fused_impute_aggregate.window_launches - win0,
                    fused_impute_aggregate.wide_launches - wide0)
        check(launched == (2, 2 * windows, 0),
              f"{tag}: (impute, window, whole-plan) launches {launched}, "
              f"not (2, {2 * windows}, 0)")
        check(torch.equal(new_k, new_2) and torch.equal(sig_k, sig_2),
              f"{tag}: rerun not bit-identical")
        new_p, sig_p = fused_impute_aggregate_plain(*args, **kw)
        upd_x, upd_c = list(xs), list(cs)
        if kind == "cat":
            agree = float((new_k == new_p).float().mean())
            check(agree >= 0.9999, f"{tag}: code agreement {agree}")
            check(torch.equal(new_k[~null], cs[1][~null]),
                  f"{tag}: observed codes changed")
            upd_c[1] = new_k
            what = f"code agreement {agree:.7f}"
        else:
            dx = float((new_k - new_p).abs().max())
            check(torch.isfinite(new_k).all() and dx <= 1e-4,
                  f"{tag}: max|Δx| {dx:.3e} > 1e-4")
            upd_x[1] = new_k
            what = f"max|Δx| {dx:.3e}"
        own = masked_gram_window_plain(upd_x, upd_c, w_next, schema=schema,
                                       lo=0, width=p)
        check(torch.equal(sig_k[cm], own[cm]),
              f"{tag}: counts differ from the plain Gram of its columns")
        err = rel_err(sig_k, sig_p)
        check(err <= 1e-5, f"{tag}: sigma max rel err {err:.3e} > 1e-5")
        abs_err = float((sig_k - sig_p).abs().max())
        del new_2, sig_2, new_p, sig_p, own
        ms = cuda_ms(lambda: fused_impute_aggregate(*args, **kw), reps=3,
                     warmup=1)
        plain_ms = cuda_ms(lambda: fused_impute_aggregate_plain(*args, **kw),
                           reps=1, warmup=0)
        k7_ms = cuda_ms(lambda: masked_gram_cols(upd_x, upd_c, w_next,
                                                 schema=schema),
                        reps=3, warmup=1)
        width = _build.WINDOW_WIDTH
        recs = [dict(lo=lo, **window_record(
            upd_x, upd_c, w_next, schema, lo, min(width, p - lo), N,
            f"{tag} window {lo}")) for lo in range(0, p, width)]
        keyed_cols = window_columns(schema, range(0, p, width), width)
        order_ms = cuda_ms(lambda: window_order(
            upd_x, upd_c, w_next, schema=schema, columns=keyed_cols),
            reps=3, warmup=1)
        # the impute kernel alone: its one launch, on K2w's own inputs
        noise = kw.get("noise")
        std = None if noise is None else torch.as_tensor(noise[2]).reshape(1)
        imp_in = impute_wide_inputs(args[4], args[5], rclasses, kind, N,
                                    schema, DEVICE)
        alone = torch.empty_like(new_k)
        lib = _build.load()
        stream = torch.cuda.current_stream().cuda_stream

        def impute_alone():
            impute_wide(lib, xs, cs, null, imp_in[0], args[5], *imp_in[1:],
                        alone, rclasses, kind, 1, noise, 0, std, N, schema,
                        DEVICE, stream)

        impute_ms = cuda_ms(impute_alone, reps=10, warmup=2)
        check(torch.equal(alone, new_k),
              f"{tag}: the impute kernel alone differs from K2w's column")
        del alone, imp_in
        nulls = int(null.sum())
        codes_now = torch.stack(upd_c)
        k_bound = gram_bound(codes_now, schema, w_next, extra=9,
                             scores=rclasses * (1 + d + schema.cat_cols),
                             scored=nulls)
        imp_bound = bound(N * 9 + nulls * row_bytes(schema)
                          + 4 * (p + 1) * rclasses,
                          2 * rclasses * (1 + d + schema.cat_cols) * nulls)
        log(f"{tag}: {what}, sigma max rel err {err:.3e}, max abs err "
            f"{abs_err:.3e}, counts exact, bit-identical rerun; launches a "
            f"call: 1 impute + {windows} windows; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {k_bound['bound_ms']:.4f} ms "
            f"({k_bound['bound_by']}); the impute kernel alone "
            f"{impute_ms:.4f} ms (CUDA events around its launch; K7 over "
            f"the updated columns {k7_ms:.3f} ms, of which their order "
            f"pass of columns {list(keyed_cols)} {order_ms:.3f} ms), bound "
            f"{imp_bound['bound_ms']:.4f} ms ({imp_bound['bound_by']}); "
            f"windows " + json.dumps([{k: r[k] for k in (
                "lo", "residual_tasks", "keyed_tasks", "items",
                "rows_read")} for r in recs]))
        res = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **k_bound,
                   library_ms=None, impute_ms=impute_ms, windows_ms=k7_ms,
                   impute_bound_ms=imp_bound["bound_ms"],
                   impute_bound_by=imp_bound["bound_by"],
                   order_ms=order_ms, per_window=recs)
        if kind == "cat":
            out = res
        else:
            out["num"] = res
        del new_k, sig_k, codes_now
    del t, xs, cs, steps
    torch.cuda.empty_cache()
    return out


def phase_k8win(seed: int) -> dict:
    """K8 past P = 1,024 at favorita_items, N rows, one launch a column
    window of 1,024 over group-sorted rows, binary weights: label
    onpromotion (G = 2, P = 4,590) and label family (G = 33, P = 4,559:
    2.74 GB of f32[G, P, P]). Each group's S against the plain version
    (its tables, no dense Z): counts exact, within 1e-5 of max|σ|, reruns
    bit-identical, launches exact; the unsorted entry (a sort, then K8)
    gives the same; ms of the kernel and the plain version by CUDA
    events; each window's record (`window_record`, its keyed tasks over
    the rows ordered by group and code) and the order pass's ms."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_columns, window_order)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_presorted, grouped_gram_presorted_plain,
        sort_by_group)

    out = {}
    for label in ("onpromotion", "family"):
        x, codes, y, schema, classes = items_classify(N, seed + 71, label)
        p = schema.sigma_size
        windows = -(-p // _build.WINDOW_WIDTH)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + 72)
        w = (torch.rand(N, generator=gen, device=DEVICE) >= 0.2).float()
        args = sort_by_group(x, codes, y, schema=schema, num_groups=classes,
                             weights=w)
        tag = f"[K8win] {label} G={classes} P={p} n={N}"
        before = grouped_gram_presorted.wide_launches
        got = grouped_gram_presorted(*args, schema=schema)
        again = grouped_gram_presorted(*args, schema=schema)
        torch.cuda.synchronize()
        launched = grouped_gram_presorted.wide_launches - before
        check(launched == 2 * windows,
              f"{tag}: {launched} launches, not {2 * windows}")
        want = grouped_gram_presorted_plain(*args, schema=schema)
        err = check_grouped(tag, got, again, want, schema, binary=True)
        check(torch.equal(got[:, 0, 0], torch.bincount(
            y.long(), weights=w.double(), minlength=classes).float()),
            f"{tag}: group counts differ from a bincount of the labels")
        abs_err = float((got - want).abs().max())
        del again, want
        unsorted = grouped_gram(x, codes, w, y, schema=schema,
                                num_groups=classes)
        check(torch.equal(unsorted, got),
              f"{tag}: the unsorted entry differs from the presorted one")
        del unsorted
        ms = cuda_ms(lambda: grouped_gram_presorted(*args, schema=schema),
                     reps=2, warmup=1)
        plain_ms = cuda_ms(lambda: grouped_gram_presorted_plain(
            *args, schema=schema), reps=1, warmup=0)
        cols_s, width = (list(args[0]), list(args[1])), _build.WINDOW_WIDTH
        recs = [dict(lo=lo, **window_record(
            *cols_s, args[2], schema, lo, min(width, p - lo), N,
            f"{tag} window {lo}", offsets=args[3].offsets))
            for lo in range(0, p, width)]
        keyed_cols = window_columns(schema, range(0, p, width), width)
        order_ms = cuda_ms(lambda: window_order(
            *cols_s, args[2], schema=schema, columns=keyed_cols,
            offsets=args[3].offsets), reps=3, warmup=1)
        res = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                   **gram_bound(codes, schema, w, classes), library_ms=None,
                   groups=classes, sigma_size=p, windows=windows,
                   order_ms=order_ms, per_window=recs)
        log(f"{tag}: {windows} launches a call after one order pass of "
            f"columns {list(keyed_cols)} by (group, code), {order_ms:.3f} ms;"
            f" counts exact, max rel err {err:.3e} (of max|σ| per group), "
            f"max abs err {abs_err:.3e}, bit-identical rerun, the unsorted "
            f"entry equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); windows "
            + json.dumps([{k: r[k] for k in ("lo", "residual_tasks",
                                             "keyed_tasks", "items",
                                             "rows_read")} for r in recs]))
        if label == "onpromotion":
            out = res
        else:
            out["family"] = res
        del got, args, x, codes, y
        torch.cuda.empty_cache()
    return out


def seeded_scorer(kind: str, schema, classes: int, seed: int):
    """Tables of seeded parameters for K3w: naive Bayes's (means, spreads,
    log frequencies, priors; centred as nb_predict_device centres them) or
    QDA's (quad = −B·Bᵀ of a rank-4 B, lin, intercept). Returns (tables,
    plan, shift or None)."""
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        nb_center, nb_tables, qda_tables)

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    f64 = torch.float64
    d, m = schema.num_cols, schema.sigma_size - 1

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE, dtype=f64)

    if kind == "nb":
        mean = randn(classes, d)
        var = torch.rand(classes, d, generator=g, device=DEVICE,
                         dtype=f64) + 0.1
        log_freq = torch.log(torch.rand(classes, schema.vocab_size,
                                        generator=g, device=DEVICE,
                                        dtype=f64) + 1e-3)
        log_prior = torch.log_softmax(randn(classes), 0)
        center = nb_center(log_prior, mean)
        tables, plan = nb_tables(log_prior, mean, var, log_freq,
                                 schema=schema, center=center)
        return tables, plan, center
    b = 0.1 * randn(classes, m, 4)
    quad = -(b @ b.transpose(1, 2))
    tables, plan = qda_tables(quad, randn(classes, m), randn(classes),
                              schema=schema)
    return tables, plan, None


def phase_k3items(seed: int) -> dict:
    """K3w past P = 1,024 at favorita_items with tables of seeded
    parameters: naive Bayes's plan (no cross tables) at label family (33
    classes, P = 4,559) and QDA's cross plan at label onpromotion (2
    classes, P = 4,590; the cross tables with item_nbr keyed on the item).
    Against qda_predict_plain at N_K3_PLAIN rows: argmax ≥ 0.9999, reruns
    bit-identical, one wide launch a call; ms of kernel and plain there by
    CUDA events, and of the kernel at N rows."""
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain)

    out = {}
    for kind, label in (("qda", "onpromotion"), ("nb", "family")):
        x, codes, _, schema, classes = items_classify(N, seed + 73, label)
        tables, plan, shift = seeded_scorer(kind, schema, classes, seed + 74)
        tag = (f"[K3items] {kind} {label} C={classes} P={schema.sigma_size} "
               f"({plan.num_tasks} tasks, {tables.shape[1]} cells a class)")
        check(plan.num_tasks > 1 and plan.cross == (kind == "qda"),
              f"{tag}: not the plan expected")
        xs = x[:, :N_K3_PLAIN].contiguous()
        cs = codes[:, :N_K3_PLAIN].contiguous()
        kw = dict(schema=schema, shift=shift)
        before = qda_predict_kernel.wide_launches
        got = qda_predict_kernel(tables, plan, xs, cs, **kw)
        again = qda_predict_kernel(tables, plan, xs, cs, **kw)
        torch.cuda.synchronize()
        check(qda_predict_kernel.wide_launches - before == 2,
              f"{tag}: K3w was not launched once a call")
        check(torch.equal(got, again), f"{tag}: rerun not bit-identical")
        want = qda_predict_plain(tables, plan, xs, cs, **kw)
        agree = float((got == want).float().mean())
        check(agree >= 0.9999, f"{tag}: argmax agreement {agree}")
        check(len(torch.unique(got)) > 1, f"{tag}: one class wins every row")
        max_abs_err = float((got - want).abs().max())
        del want
        ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, xs, cs, **kw),
                     reps=2, warmup=1)
        plain_ms = cuda_ms(lambda: qda_predict_plain(tables, plan, xs, cs,
                                                     **kw), reps=1, warmup=0)
        full_ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, x, codes,
                                                     **kw), reps=1, warmup=0)
        res = dict(max_abs_err=max_abs_err, ms=ms,
                   plain_ms=plain_ms,
                   **qda_bound(cs, schema, classes, tables.numel() * 4),
                   library_ms=None, rows=N_K3_PLAIN, agreement=agree,
                   tasks=plan.num_tasks, cells=tables.shape[1],
                   ms_at_n=full_ms, bound_ms_at_n=qda_bound(
                       codes, schema, classes, tables.numel() * 4)["bound_ms"])
        log(f"{tag}: argmax agreement with the plain version {agree:.7f} at "
            f"n={N_K3_PLAIN}, bit-identical rerun; there kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}); at n={N} kernel {full_ms:.3f} ms, bound "
            f"{res['bound_ms_at_n']:.4f} ms")
        if kind == "qda":
            out = res
        else:
            out["nb"] = res
        del tables, x, codes, xs, cs, got, again
        torch.cuda.empty_cache()
    return out


def phase_items_fused(run) -> dict:
    """run_mice_device(kernel='fused') at favorita_items, N rows,
    ITEMS_ROUNDS rounds, on [items]' table: K7 seeds the loop (one call:
    an order pass, then a launch a window), then every column step is K2w
    past 1,024 (one impute launch, an order pass of the updated columns
    and one K7 launch a window): the counts, zeroed just before and read
    just after, exact; wide_quality; family codes ≥ 0.999
    of the null cells against [items]' 'gram' run; wall s."""
    from duckdb_imputation_tpu_torch import run_mice_device
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_columns)

    t, truth, gram_out = run
    p = t.schema.sigma_size
    windows = -(-p // _build.WINDOW_WIDTH)
    keyed = len(window_columns(t.schema, range(0, p, _build.WINDOW_WIDTH),
                               _build.WINDOW_WIDTH))
    steps = ITEMS_ROUNDS * 2
    kernel_counts_reset()
    t0 = time.perf_counter()
    out = run_mice_device(t, iters=ITEMS_ROUNDS, kernel="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    expect = {"masked_gram_cols.wide_launches": windows,
              "fused_impute_aggregate.impute_launches": steps,
              "fused_impute_aggregate.window_launches": steps * windows,
              "window_order.passes": 1 + steps,
              "window_order.launches": (1 + steps) * keyed}
    check(launches == expect, f"[items_fused] launches {launches}, derived "
          f"{expect}")
    q = wide_quality(t, truth, out, "[items_fused]")
    m = t.cat_null[1]
    agree = float((out.cat_codes[1] == gram_out.cat_codes[1])[m]
                  .float().mean())
    dx = float((out.num_data[1] - gram_out.num_data[1]).abs().max())
    check(agree >= 0.999, f"[items_fused] family codes agree with the 'gram'"
          f" loop on {agree} of the null cells")
    log(f"[items_fused] run_mice_device(kernel='fused') favorita_items "
        f"P={t.schema.sigma_size} n={N} rounds={ITEMS_ROUNDS}: launches "
        f"{launches} (as derived); {wall:.2f} s wall; against [items]' "
        f"'gram' run: family agreement {agree:.6f}, x max diff {dx:.3e}; "
        f"quality {q}")
    return dict(launches=launches, wall_s=wall, agree_gram=agree, out=out,
                **q)


def phase_sharded_items(run, fused: dict) -> dict:
    """run_mice_sharded with its defaults ('auto' = 'fused' on a CUDA
    table with the solve trainer) at favorita_items, N rows, ITEMS_ROUNDS
    rounds, on a world of one over NCCL (FileStore in a temporary
    directory): bit-identical to [items_fused]'s run_mice_device, with the
    same launches (zeroed just before, read just after); wall s."""
    import datetime
    import tempfile

    from duckdb_imputation_tpu_torch.mice import run_mice_sharded
    from duckdb_imputation_tpu_torch.parallel import initialize, shutdown

    t = run[0]
    want = fused["out"]
    with tempfile.TemporaryDirectory() as d:
        mesh = initialize("nccl", store=_store(f"{d}/store", 1),
                          world_size=1, rank=0, device=DEVICE,
                          timeout=datetime.timedelta(minutes=5))
        try:
            kernel_counts_reset()
            t0 = time.perf_counter()
            got = run_mice_sharded(t, iters=ITEMS_ROUNDS, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_counts()
        finally:
            shutdown()
    check(launches == fused["launches"], f"[sharded_items] launches "
          f"{launches}, not [items_fused]'s {fused['launches']}")
    check(torch.equal(got.num_data, want.num_data)
          and torch.equal(got.cat_codes, want.cat_codes),
          "[sharded_items] not bit-identical to run_mice_device('fused')")
    log(f"[sharded_items] run_mice_sharded (defaults: 'auto' = 'fused') on a "
        f"world of one over NCCL, favorita_items n={N} rounds={ITEMS_ROUNDS}:"
        f" bit-identical to run_mice_device(kernel='fused'); launches "
        f"{launches}; {wall:.2f} s wall (run_mice_device {fused['wall_s']:.2f}"
        f" s)")
    return dict(launches=launches, wall_s=wall)


def qda_oracle(sig, total: float, x, codes, schema, rows: int):
    """The plain reference of QDA's trainer and scorer, independent of the
    port's: in f64 on the card, each class's covariance from its sigma,
    its pseudo-inverse and log-pseudo-determinant by a symmetric
    eigendecomposition (eigenvalues ≤ 1e-9 cut, the rule of the host
    trainer models/qda.py), and the centred quadratic form of the dense
    feature vector [x ‖ onehot(codes)] of each of the first `rows` rows.
    Returns the first-max class i32[rows]."""
    f64 = torch.float64
    d = schema.num_cols
    m = schema.sigma_size - 1
    offs = [d]
    for v in schema.cat_sizes[:-1]:
        offs.append(offs[-1] + v)
    offs = torch.tensor(offs, device=x.device)[:, None]
    scores = []
    for c in range(sig.shape[0]):
        s = sig[c].to(f64)
        n_c = s[0, 0].clamp(min=1.0)
        mu = s[0, 1:] / n_c
        cov = (s[1:, 1:] - torch.outer(s[0, 1:], s[0, 1:]) / n_c) / n_c
        ev, vec = torch.linalg.eigh(cov)
        keep = ev > 1e-9
        half = vec[:, keep] / ev[keep].sqrt()          # A = half·halfᵀ
        const = (-0.5 * ev[keep].log().sum()
                 + torch.log(s[0, 0] / total))
        del cov, vec
        sc = torch.empty(rows, dtype=f64, device=x.device)
        for lo in range(0, rows, 20_000):
            hi = min(rows, lo + 20_000)
            z = torch.zeros((m, hi - lo), dtype=f64, device=x.device)
            z[:d] = x[:, lo:hi].to(f64)
            cols = torch.arange(hi - lo, device=x.device).expand(
                codes.shape[0], -1)
            z[codes[:, lo:hi].long() + offs, cols] = 1.0
            q = ((half.T @ (z - mu[:, None])) ** 2).sum(0)
            sc[lo:hi] = -0.5 * q + const
        scores.append(sc)
        del half
    return torch.stack(scores).argmax(0).to(torch.int32)


def phase_classify_items(seed: int) -> dict:
    """The classifier path past P = 1,024 at favorita_items, N rows,
    through the entry points a user calls: naive Bayes for label family
    (sum_to_nb_agg_grouped: K6w; nb_train_device; nb_predict_device: K3w
    on NB's plan) and QDA for label onpromotion (sum_to_triple_grouped: a
    sort and K8 a window; qda_train_device: two f64 SVDs of 4,589²;
    qda_predict_device: K3w on the cross plan). Counts zeroed before each
    pipeline and read after it, exact. NB: accuracy above the majority
    share + 0.02; parameters within 1e-6 of their scale from the host's
    (the same trainer on the CPU from the same aggregates). QDA: the
    card's predictions against the CPU's plain scorer with the host's
    parameters, and against `qda_oracle` (f64, eigh, dense centred form)
    on the same sigma, each on N_CLASSIFY_HOST rows, ≥ 0.999; its accuracy
    is logged beside the majority share and the oracle's, not held above
    the majority: with ~4,589 feature dimensions against 2M rows of the
    minority class, exact QDA scores below the majority share here
    (tests/test_torch_items.py shows the row count at which it passes it);
    ms of each stage (host clock after a synchronize)."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device, qda_predict_device,
        qda_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_columns)
    from duckdb_imputation_tpu_torch.ring.sum import (
        sum_to_nb_agg_grouped, sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    def timed(ms, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return r

    out = {}
    x, codes, y, schema, classes = items_classify(N, seed + 75, "family")
    ms = {}
    kernel_counts_reset()
    agg = timed(ms, "aggregate", lambda: sum_to_nb_agg_grouped(
        x, codes, y, schema=schema, num_groups=classes))
    params = timed(ms, "train", lambda: nb_train_device(
        agg.n, agg.lin, agg.quad_diag, agg.lin_cat))
    pred = timed(ms, "predict", lambda: nb_predict_device(
        *params, x, codes, schema=schema))
    launches = kernel_counts()
    expect = {"nb_grouped_sums.launches": 1,
              "qda_predict_kernel.wide_launches": 1}
    check(launches == expect, f"[classify_items] NB launches {launches}, "
          f"not {expect}")
    host = nb_train_device(*(a.cpu() for a in (agg.n, agg.lin,
                                               agg.quad_diag, agg.lin_cat)))
    p_err = max(float((a.cpu() - h).abs().max())
                / max(float(h.abs().max()), 1e-30)
                for a, h in zip(params, host))
    check(p_err <= 1e-6, f"[classify_items] NB parameters {p_err:.3e} of "
          f"their scale from the host's")
    prior = float(torch.bincount(y.long()).max()) / N
    acc = float((pred == y).float().mean())
    check(acc > prior + 0.02, f"[classify_items] NB family accuracy {acc} "
          f"not above the majority share {prior} + 0.02")
    out["nb"] = dict(launches=launches, accuracy=acc, prior=prior,
                     param_err=p_err, stage_ms=ms,
                     pipeline_ms=sum(ms.values()))
    log(f"[classify_items] NB family C={classes} P={schema.sigma_size} "
        f"n={N}: launches {launches}; parameters {p_err:.3e} of their scale "
        f"from the host's; accuracy {acc:.5f} against a majority share of "
        f"{prior:.5f}; stages (host clock, ms) "
        + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    del x, codes, y, agg, params, pred, host

    x, codes, y, schema, classes = items_classify(N, seed + 76, "onpromotion")
    ms = {}
    kernel_counts_reset()
    sig = timed(ms, "aggregate", lambda: sigma_from_triple(
        sum_to_triple_grouped(x, codes, y, schema=schema,
                              num_groups=classes)))
    agg_launches = kernel_counts()
    windows = -(-schema.sigma_size // _build.WINDOW_WIDTH)
    keyed = len(window_columns(schema, range(
        0, schema.sigma_size, _build.WINDOW_WIDTH), _build.WINDOW_WIDTH))
    check(agg_launches == {"grouped_gram_presorted.wide_launches": windows,
                           "window_order.passes": 1,
                           "window_order.launches": keyed},
          f"[classify_items] QDA aggregate launches {agg_launches}")
    kernel_counts_reset()
    params = timed(ms, "train", lambda: qda_train_device(sig, float(N)))
    pred = timed(ms, "predict", lambda: qda_predict_device(
        *params, x, codes, schema=schema))
    launches = kernel_counts()
    check(launches == {"qda_predict_kernel.wide_launches": 1},
          f"[classify_items] QDA predict launches {launches}")
    launches.update(agg_launches)
    check(bool(((pred >= 0) & (pred < classes)).all()),
          "[classify_items] QDA: a class index out of range")
    prior = float(torch.bincount(y.long()).max()) / N
    acc = float((pred == y).float().mean())
    t0 = time.perf_counter()
    host = qda_train_device(sig.cpu(), float(N))
    host_s = time.perf_counter() - t0
    rows = N_CLASSIFY_HOST
    host_pred = qda_predict_device(*host, x[:, :rows].cpu(),
                                   codes[:, :rows].cpu(), schema=schema)
    agree = float((pred[:rows].cpu() == host_pred).float().mean())
    check(agree >= 0.999, f"[classify_items] QDA: the card's predictions "
          f"agree with the host parameters' on {agree} of the rows")
    t0 = time.perf_counter()
    oracle = qda_oracle(sig, float(N), x, codes, schema, rows)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    agree_oracle = float((pred[:rows] == oracle).float().mean())
    check(agree_oracle >= 0.999, f"[classify_items] QDA: the card's "
          f"predictions agree with the f64 oracle's on {agree_oracle} of "
          f"the rows")
    acc_rows = float((pred[:rows] == y[:rows]).float().mean())
    oracle_acc = float((oracle == y[:rows]).float().mean())
    out["qda"] = dict(launches=launches, aggregate_launches=agg_launches,
                      accuracy=acc, prior=prior, host_agreement=agree,
                      oracle_agreement=agree_oracle,
                      accuracy_oracle_rows=acc_rows,
                      oracle_accuracy=oracle_acc,
                      stage_ms=ms, pipeline_ms=sum(ms.values()),
                      host_train_s=host_s, oracle_s=oracle_s)
    log(f"[classify_items] QDA onpromotion C={classes} P={schema.sigma_size}"
        f" n={N}: launches {launches}; accuracy {acc:.5f} against a majority"
        f" share of {prior:.5f}; on the first {rows} rows the card's "
        f"predictions agree with the CPU's plain scorer under the host's "
        f"parameters ({host_s:.1f} s to train) on {agree:.6f} and with the "
        f"f64 oracle ({oracle_s:.1f} s) on {agree_oracle:.6f}, accuracy "
        f"{acc_rows:.5f} against the oracle's {oracle_acc:.5f}; stages (host "
        f"clock, ms) " + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    return out


# ---------------------------------------------------------------------------
# Schemas of many columns: Home Credit and SECOM, and the narrow
# route at d = 80
# ---------------------------------------------------------------------------

# Kaggle "Home Credit Default Risk" application_train.csv: 104 numeric
# columns (its 106 less SK_ID_CURR and TARGET) and 16 categorical ones
# (NAME_CONTRACT_TYPE .. EMERGENCYSTATE_MODE), P = 245; nulls in 61 numeric
# and six categorical columns (NAME_TYPE_SUITE, OCCUPATION_TYPE,
# FONDKAPREMONT_MODE, HOUSETYPE_MODE, WALLSMATERIAL_MODE,
# EMERGENCYSTATE_MODE): its stream fold has c + K = 16 + 67 = 83
# categorical columns
HC_VOCABS = (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2)
HC_NULL_CATS = (4, 9, 12, 13, 14, 15)
HC_ROWS = 307_511          # the file's own row count
# UCI SECOM: 590 numeric sensor columns (P = 591) with nulls, a pass/fail
# label with the file's 104 fails in 1,567 rows; its fold has 590
# one-level flags (P + K = 1,181: K7's windows)
SECOM_ROWS = 1_567
SECOM_FAILS = 104
N_SECOM = 1_000_000        # rows of SECOM's schema for the kernels (2.4 GB
                           # of x)
N_MANY_CPU = 20_000        # the CPU run a card's run is held against
N_K3_MANY = 100_000        # rows K3w meets its plain version on at these
                           # schemas (the plain scorer walks every slab)
N_NARROW = 2_000_000       # rows of [narrow80]


LABEL_COLS = 30            # numeric columns a positive label moves
LABEL_SHIFT = 1.5          # by this much


def factor_table(n: int, d: int, vocabs, seed: int, share: float,
                 rank: int = 8):
    """x f32[d, n] from a rank-8 Gaussian factor model (column j loads on
    factor j mod 8, and 0.3 of a dense loading on all) plus noise, codes
    i32[c, n] the argmax of a linear function of the factors plus Gumbel
    noise (imputation can beat a mean fill), and a label i32[n], 1 with
    probability `share`, that moves the first LABEL_COLS numerics by
    LABEL_SHIFT (a label carried by the shared factors instead sinks naive
    Bayes below the majority share: its columns are not independent given
    the label); all on the device from `seed`."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE)

    f = randn(rank, n)
    a = 0.3 * randn(d, rank)
    a[torch.arange(d), torch.arange(d) % rank] += 1.0
    x = a @ f
    x += 0.5 * randn(d, n)
    y = (torch.rand(n, generator=g, device=DEVICE) < share).to(torch.int32)
    x[:LABEL_COLS] += LABEL_SHIFT * y
    codes = torch.empty((len(vocabs), n), dtype=torch.int32, device=DEVICE)
    for j, v in enumerate(vocabs):
        u = torch.rand(v, n, generator=g, device=DEVICE).clamp_min(1e-30)
        codes[j] = (randn(v, rank) @ f - torch.log(-torch.log(u))).argmax(0)
    return x, codes, y


def null_table(x, codes, num_null, cat_null, schema):
    """A Table with the null cells' values zeroed and codes at 0."""
    from duckdb_imputation_tpu_torch import Table

    return Table(num_data=torch.where(num_null, 0.0, x),
                 cat_codes=torch.where(cat_null, 0, codes),
                 num_null=num_null, cat_null=cat_null, schema=schema)


def make_home_credit(n: int, seed: int):
    """The Home Credit schema at n rows, made on the device from `seed`:
    nulls in 61 numeric columns and HC_NULL_CATS, their shares spread
    geometrically over 0.1%-70% (an assumption: the file's columns span
    that range); TARGET 8% positive (`factor_table`). Returns (table,
    true x, true codes, TARGET)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    x, codes, y = factor_table(n, 104, HC_VOCABS, seed, 0.08)
    schema = FeatureSchema(num_cols=104, cat_keys=tuple(
        tuple(range(v)) for v in HC_VOCABS))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    shares = torch.logspace(-3, float(np.log10(0.7)), 67)[
        torch.randperm(67, generator=torch.Generator().manual_seed(seed))]
    num_null = torch.zeros((104, n), dtype=torch.bool, device=DEVICE)
    cat_null = torch.zeros((16, n), dtype=torch.bool, device=DEVICE)
    for q, s in enumerate(shares.tolist()):
        row = (num_null[q] if q < 61 else cat_null[HC_NULL_CATS[q - 61]])
        row |= torch.rand(n, generator=g, device=DEVICE) < s
    return null_table(x, codes, num_null, cat_null, schema), x, codes, y


def make_secom(n: int, seed: int):
    """The SECOM schema at n rows, made on the device from `seed`: nulls at
    4.5% in every column (an assumption), pass/fail with the file's share
    of fails (104 of 1,567). Returns (table, true x, pass/fail)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    x, codes, y = factor_table(n, 590, (), seed, SECOM_FAILS / SECOM_ROWS)
    schema = FeatureSchema(num_cols=590)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1)
    num_null = torch.rand(590, n, generator=g, device=DEVICE) < 0.045
    cat_null = torch.zeros((0, n), dtype=torch.bool, device=DEVICE)
    return null_table(x, codes, num_null, cat_null, schema), x, y


def plan_seconds(schema, ext=None, groups: int = 2) -> dict:
    """Host seconds of the plans a schema's kernels run (made on the CPU
    once a schema, then cached): K7/K8's, NB's, QDA's and NB's scorer's,
    and with `ext` (the stream fold's extended schema) its whole plan or,
    past P = 1,024, each window's keyed plan."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    out = {}
    for name, fn in (("wide_plan", lambda: _build.wide_plan(schema)),
                     ("nb_plan", lambda: _build.nb_plan(schema, groups)),
                     ("qda_plan", lambda: _build.qda_plan(schema)),
                     ("nb_scorer_plan",
                      lambda: _build.qda_plan(schema, cross=False))):
        t0 = time.perf_counter()
        fn()
        out[name] = time.perf_counter() - t0
    if ext is not None:
        p = ext.sigma_size
        t0 = time.perf_counter()
        if p <= _build.MAX_WIDE_SIGMA_SIZE:
            _build.wide_plan(ext)
        for lo in range(0, p, _build.WINDOW_WIDTH) if (
                p > _build.MAX_WIDE_SIGMA_SIZE) else ():
            _build.keyed_window_plan(ext, lo, min(lo + _build.WINDOW_WIDTH,
                                                  p))
        out["fold_plan"] = time.perf_counter() - t0
    return out


def many_kernel(tag: str, counter, kernel, plain, compare, bound_: dict,
                library_ms=None, plain_reps: int = 1) -> dict:
    """A kernel against its plain version at the phase's shapes: two calls
    (each one launch on `counter`, a (wrapper, attribute) pair), a rerun
    bit-identical, `compare(got, want)` → max abs error (raising on a
    failed check); ms of both by CUDA events."""
    obj, attr = counter
    before = getattr(obj, attr)
    t0 = time.perf_counter()
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    slow = time.perf_counter() - t0 > 0.2     # one timed call is enough
    launched = getattr(obj, attr) - before
    check(launched >= 2, f"{tag}: {launched} launches for two calls")
    pair = ((got, again) if isinstance(got, torch.Tensor)
            else (torch.cat([a.flatten().float() for a in got]),
                  torch.cat([a.flatten().float() for a in again])))
    check(torch.equal(*pair), f"{tag}: rerun not bit-identical")
    err = compare(got, plain())
    del got, again
    ms = cuda_ms(kernel, reps=1 if slow else 3, warmup=0)
    plain_ms = cuda_ms(plain, reps=plain_reps, warmup=0)
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound_,
               library_ms=library_ms, launches_a_call=launched // 2)
    log(f"{tag}: max abs err {err:.3e}, bit-identical rerun, "
        f"{launched // 2} launch(es) a call; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})"
        + ("" if library_ms is None else f", library {library_ms:.3f} ms"))
    return res


def gram_compare(tag, schema, binary: bool):
    def compare(got, want):
        check(torch.equal(got, got.transpose(-1, -2)),
              f"{tag}: S is not exactly symmetric")
        check(torch.isfinite(got).all(), f"{tag}: not finite")
        if binary:
            c = count_entries(schema)
            check(torch.equal(got[..., c], want[..., c]),
                  f"{tag}: counts differ from the plain version")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"{tag}: max abs err {err} > 1e-5 of "
              f"max|σ| {scale}")
        return err
    return compare


def fused_compare(tag, schema, kind: str):
    def compare(got, want):
        (new, sig), (wnew, wsig) = got, want
        if kind == "cat":
            check(torch.equal(new, wnew), f"{tag}: codes differ")
        else:
            d = float((new - wnew).abs().max())
            check(d <= 1e-5 * max(1.0, float(wnew.abs().max())),
                  f"{tag}: values differ by {d}")
        return gram_compare(tag, schema, True)(sig, wsig)
    return compare


def nb_compare(tag, schema):
    def compare(got, want):
        d = schema.num_cols
        check(torch.equal(got[:, 0], want[:, 0])
              and torch.equal(got[:, 1 + 2 * d:], want[:, 1 + 2 * d:]),
              f"{tag}: counts differ")
        err = float((got - want).abs().max())
        check(err <= 1e-5 * float(want.abs().max()), f"{tag}: err {err}")
        return err
    return compare


def many_kernels(tag: str, t, y, seed: int, fused_cases) -> dict:
    """Every kernel of a schema's path at its rows: K7 (or K1), K2w (or K2)
    for each (kind, column) of `fused_cases`, the sort then K8 (or K5) on
    the label, past the crossover the D kernel alone (`dense_kernel`),
    K6w, and K3w on seeded QDA tables (against its plain version on
    N_K3_MANY rows, timed at all of them)."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums, nb_grouped_sums_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_cols, masked_gram_cols_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram_presorted, grouped_gram_presorted_plain, sort_by_group)

    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram)

    schema, n = t.schema, t.n_rows
    p, wide = schema.sigma_size, schema.sigma_size > _build.MAX_SIGMA_SIZE
    xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    w = (torch.rand(n, generator=g, device=DEVICE) >= 0.2).float()
    # past the crossover with no categorical column K7 has no task: the
    # Gram is the D kernel's launch alone
    d_only = wide and not wide_launches(schema)
    out = {}
    out["gram"] = many_kernel(
        f"{tag} {'K7' if wide else 'K1'}"
        f"{' (D kernel alone)' if d_only else ''} P={p} n={n}",
        (dense_gram, "launches") if d_only else
        (masked_gram_cols, "wide_launches" if wide else "launches"),
        lambda: masked_gram_cols(xs, cs, w, schema=schema),
        lambda: masked_gram_cols_plain(xs, cs, w, schema=schema),
        gram_compare(tag, schema, True), gram_bound(t.cat_codes, schema, w),
        library_gram_ms(t.num_data, t.cat_codes, w, schema))
    for kind, col in fused_cases:
        r = schema.cat_sizes[col] if kind == "cat" else 1
        w_full = 0.05 * torch.randn(p, r, generator=g, device=DEVICE)
        icpt = torch.randn(r, generator=g, device=DEVICE)
        null = (t.cat_null[col] if kind == "cat" else t.num_null[col])
        args = (xs, cs, null, w, w_full, icpt)
        kw = dict(schema=schema, kind=kind, imp_col=col)
        out[f"fused_{kind}{col}"] = many_kernel(
            f"{tag} {'K2w' if wide else 'K2'} '{kind}' column {col} "
            f"(R = {r})",
            (fused_impute_aggregate,
             "wide_launches" if wide else "launches"),
            lambda: fused_impute_aggregate(*args, **kw),
            lambda: fused_impute_aggregate_plain(*args, **kw),
            fused_compare(tag, schema, kind),
            gram_bound(t.cat_codes, schema, w, extra=9, scores=p * r,
                       scored=int(null.sum())))
    ys = torch.where(y >= 0, y, 0).to(torch.int32)
    sorted_ = sort_by_group(t.num_data, t.cat_codes, ys, schema=schema,
                            num_groups=2, weights=w)
    out["grouped"] = many_kernel(
        f"{tag} sort + {'K8' if wide else 'K5'}"
        f"{' (D kernel alone)' if d_only else ''} on the label",
        (dense_gram, "launches") if d_only else
        (grouped_gram_presorted, "wide_launches" if wide else "launches"),
        lambda: grouped_gram_presorted(*sorted_, schema=schema),
        lambda: grouped_gram_presorted_plain(*sorted_, schema=schema),
        gram_compare(tag, schema, True),
        gram_bound(t.cat_codes, schema, w, groups=2))
    del sorted_
    if dense_launches(schema):
        out["dense"] = dense_kernel(tag, xs, w, schema, rows=N_DENSE_PLAIN)
    out["nb"] = many_kernel(
        f"{tag} {'K6w' if _build.nb_features(schema) > 256 else 'K6'} "
        f"F={_build.nb_features(schema)}", (nb_grouped_sums, "launches"),
        lambda: nb_grouped_sums(t.num_data, t.cat_codes, None, ys,
                                schema=schema, num_groups=2),
        lambda: nb_grouped_sums_plain(t.num_data, t.cat_codes, None, ys,
                                      schema=schema, num_groups=2),
        nb_compare(tag, schema), nb_bound(n, schema, 2),
        library_nb_ms(t.num_data, t.cat_codes, None, ys, schema, 2))
    tables, plan, _ = seeded_scorer("qda", schema, 2, seed + 1)
    # the plain scorer keeps every cell's f64 term of every row and walks
    # every slab: 5e7 cell-rows at most (SECOM: ~285 rows, ~3 s)
    k = min(n, N_K3_MANY, int(5e7 / tables.shape[1]))
    xk, ck = t.num_data[:, :k].contiguous(), t.cat_codes[:, :k].contiguous()

    def qda_compare(got, want):
        agree = float((got == want).float().mean())
        check(agree >= 0.9999, f"{tag}: K3 argmax agreement {agree}")
        check(len(torch.unique(got)) > 1, f"{tag}: one class wins every row")
        return float((got != want).sum())

    attr = "wide_launches" if plan.num_tasks > 1 else "launches"
    out["qda"] = many_kernel(
        f"{tag} {'K3w' if plan.num_tasks > 1 else 'K3'} "
        f"({plan.num_tasks} tasks, tile "
        f"{_build.qda_tile(schema, plan, 2)}) n={k}",
        (qda_predict_kernel, attr),
        lambda: qda_predict_kernel(tables, plan, xk, ck, schema=schema),
        lambda: qda_predict_plain(tables, plan, xk, ck, schema=schema),
        qda_compare, qda_bound(ck, schema, 2, tables.numel() * 4))
    out["qda"]["ms_at_n"] = cuda_ms(lambda: qda_predict_kernel(
        tables, plan, t.num_data, t.cat_codes, schema=schema), reps=1,
        warmup=0)
    out["qda"]["bound_ms_at_n"] = qda_bound(
        t.cat_codes, schema, 2, tables.numel() * 4)["bound_ms"]
    log(f"{tag} K3 at n={n}: {out['qda']['ms_at_n']:.3f} ms, bound "
        f"{out['qda']['bound_ms_at_n']:.4f} ms")
    return out


def many_quality(tag: str, t, truth_x, truth_c, out) -> dict:
    """The imputation checks of a run: finite, observed cells unchanged,
    the imputed numerics' squared error below a mean fill's (summed over
    the imputed columns), the imputed codes' accuracy above the columns'
    mode shares + 0.02 (pooled over their null cells)."""
    check(torch.isfinite(out.num_data).all(), f"{tag}: x not finite")
    check(torch.equal(out.num_data[~t.num_null], t.num_data[~t.num_null])
          and torch.equal(out.cat_codes[~t.cat_null],
                          t.cat_codes[~t.cat_null]),
          f"{tag}: observed cells changed")
    nn = t.num_null
    obs_mean = ((truth_x * ~nn).sum(1, keepdim=True)
                / (~nn).sum(1, keepdim=True).clamp_min(1))
    sse = float(((out.num_data - truth_x)[nn].double() ** 2).sum())
    sse_mean = float(((obs_mean.expand_as(truth_x) - truth_x)[nn]
                      .double() ** 2).sum())
    check(sse < sse_mean, f"{tag}: imputed SSE {sse} not below the mean "
          f"fill's {sse_mean}")
    res = dict(rmse=(sse / max(int(nn.sum()), 1)) ** 0.5,
               mean_fill_rmse=(sse_mean / max(int(nn.sum()), 1)) ** 0.5)
    if truth_c is not None and t.cat_null.any():
        hits = total = mode = 0
        for j in range(t.schema.cat_cols):
            m = t.cat_null[j]
            if not m.any():
                continue
            hits += int((out.cat_codes[j][m] == truth_c[j][m]).sum())
            total += int(m.sum())
            top = torch.bincount(truth_c[j][~m].long()).argmax()
            mode += int((truth_c[j][m] == top).sum())
        res.update(acc=hits / total, mode_share=mode / total)
        check(res["acc"] > res["mode_share"] + 0.02,
              f"{tag}: code accuracy {res['acc']} not above the mode "
              f"share {res['mode_share']} + 0.02")
    log(f"{tag}: quality {res}")
    return res


def classify_many(tag: str, x, codes, y, schema, classes: int = 2) -> dict:
    """The CLI's train --model qda|nb path on a label of `classes`
    classes: GROUP BY label (sort + K8 / K6w), device training, one-pass
    scoring (K3w); launches read around each pipeline and checked exactly
    (one aggregate: K8 where its plan has a task, a launch a window past P
    = 1,024 (`wide_launches`), past the crossover the D kernel once; one
    scoring launch), accuracy above the majority share + 0.02. Returns the
    predictions and the launches."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device, qda_predict_device,
        qda_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.sum import (
        sum_to_nb_agg_grouped, sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    n, p = y.shape[0], schema.sigma_size
    k8, dense = wide_launches(schema), dense_launches(schema)
    major = float(torch.bincount(y.long()).max()) / n
    out = {}
    for model in ("qda", "nb"):
        kernel_counts_reset()
        t0 = time.perf_counter()
        if model == "qda":
            sig = sigma_from_triple(sum_to_triple_grouped(
                x, codes, y, schema=schema, num_groups=classes,
                method="kernel"))
            pred = qda_predict_device(*qda_train_device(sig, float(n)), x,
                                      codes, schema=schema)
        else:
            agg = sum_to_nb_agg_grouped(x, codes, y, schema=schema,
                                        num_groups=classes)
            pred = nb_predict_device(*nb_train_device(
                agg.n, agg.lin, agg.quad_diag, agg.lin_cat), x, codes,
                schema=schema)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in kernel_counts().items() if v}
        want = ({"grouped_gram_presorted.wide_launches": k8,
                 "dense_gram.launches": dense}
                if model == "qda" else {"nb_grouped_sums.launches": 1})
        want = {k: v for k, v in want.items() if v}
        scored = sum(v for k, v in counts.items() if "qda_predict" in k)
        check(all(counts.get(k) == v for k, v in want.items())
              and scored == 1 and len(counts) == len(want) + 1,
              f"{tag} {model}: launches {counts}")
        acc = float((pred == y).float().mean())
        check(acc > major + 0.02, f"{tag} {model}: accuracy {acc} not above "
              f"the majority share {major} + 0.02")
        log(f"{tag} {model} n={n}: launches {counts}, accuracy {acc:.4f} "
            f"(majority {major:.4f}), {seconds:.3f} s")
        out[model] = dict(pred=pred, launches=counts, acc=acc,
                          seconds=seconds)
    return out


def phase_home_credit(seed: int) -> dict:
    """[home_credit]: the Home Credit schema (P = 245, 104 + 16 columns).
    The plans' host seconds; each kernel against its plain version at N
    rows (K7, K2w 'num' past the parameter's 88 columns and 'cat', sort +
    K8, K6w, K3w); then at the file's 307,511 rows run_mice_device 'gram'
    and 'fused' (2 rounds over the 67 null columns, launches exact,
    quality), run_mice_device_delta, scan_gram and run_mice_stream
    ('device') from host arrays in chunks (c + K = 83), and the QDA and NB
    pipelines on TARGET; the card against the CPU at N_MANY_CPU rows."""
    from duckdb_imputation_tpu_torch import Table, run_mice_device
    from duckdb_imputation_tpu_torch.mice.device_round import (
        run_mice_device_delta)
    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.ring import streaming
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols)

    t0 = time.perf_counter()
    t, x_true, c_true, y = make_home_credit(N, seed + 181)
    schema = t.schema
    ext = streaming.extended_schema(streaming.StreamSchema(
        schema=schema, nullable_num=tuple(range(61)),
        nullable_cat=HC_NULL_CATS, n_rows=N))
    plans = plan_seconds(schema, ext)
    log(f"[home_credit] P={schema.sigma_size}, fold P+K={ext.sigma_size} "
        f"(c+K={ext.cat_cols}); plans' host seconds {plans}")
    out = dict(plans=plans, kernels=many_kernels(
        "[home_credit]", t, y, seed + 182,
        (("num", 100), ("cat", 9))))
    del t, x_true, c_true, y
    torch.cuda.empty_cache()

    t, x_true, c_true, y = make_home_credit(HC_ROWS, seed + 183)
    steps = 67
    for kernel in ("gram", "fused"):
        masked_gram_cols.wide_launches = 0
        fused_impute_aggregate.wide_launches = 0
        t1 = time.perf_counter()
        res = run_mice_device(t, iters=2, kernel=kernel)
        torch.cuda.synchronize()
        got = (masked_gram_cols.wide_launches,
               fused_impute_aggregate.wide_launches)
        want = (2 * steps, 0) if kernel == "gram" else (1, 2 * steps)
        check(got == want, f"[home_credit] run_mice_device {kernel}: "
              f"launches (K7, K2w) {got}, not {want}")
        log(f"[home_credit] run_mice_device '{kernel}' n={HC_ROWS} 2 rounds "
            f"x {steps} columns: launches (K7, K2w) {got}, "
            f"{time.perf_counter() - t1:.2f} s")
        out[f"mice_{kernel}"] = many_quality(
            f"[home_credit] {kernel}", t, x_true, c_true, res)
    masked_gram_cols.wide_launches = 0
    t1 = time.perf_counter()
    res = run_mice_device_delta(t, iters=2, kernel="gram")
    torch.cuda.synchronize()
    log(f"[home_credit] run_mice_device_delta n={HC_ROWS} 2 rounds: K7 "
        f"launches {masked_gram_cols.wide_launches}, "
        f"{time.perf_counter() - t1:.2f} s")
    want = 1 + 2 * 2 * steps      # one full pass, two a column step
    check(masked_gram_cols.wide_launches == want,
          f"[home_credit] delta: {masked_gram_cols.wide_launches} K7 "
          f"launches, not {want}")
    out["mice_delta"] = many_quality("[home_credit] delta", t, x_true,
                                     c_true, res)
    del res

    num = torch.where(t.num_null, float("nan"), x_true).cpu().numpy()
    cat = torch.where(t.cat_null, -1, c_true).cpu().numpy().astype(np.int64)
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=100_000)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    check(streaming.extended_schema(ss).cat_cols == 83,
          "[home_credit] the fold's c + K is not 83")
    masked_gram.wide_launches = 0
    t1 = time.perf_counter()
    gram = streaming.scan_gram(src, ss, chunk_rows=100_000, device=DEVICE)
    torch.cuda.synchronize()
    chunks = -(-HC_ROWS // 100_000)
    check(masked_gram.wide_launches == chunks,
          f"[home_credit] scan_gram: {masked_gram.wide_launches} K7 "
          f"launches, not {chunks}")
    small = src_slice(num, cat, N_MANY_CPU)
    sss, _ = streaming.scan_schema(small, collect_dirty=False)
    cpu_gram = streaming.scan_gram(small, sss, chunk_rows=100_000,
                                   device="cpu")
    card_gram = streaming.scan_gram(small, sss, chunk_rows=100_000,
                                    device=DEVICE)
    err = float((card_gram.cpu() - cpu_gram).abs().max()
                / cpu_gram.abs().max())
    check(err <= 1e-6, f"[home_credit] fold card vs CPU rel err {err}")
    log(f"[home_credit] scan_gram P+K={gram.shape[0]} n={HC_ROWS}: {chunks} "
        f"K7 launches, {time.perf_counter() - t1:.2f} s; card vs CPU at "
        f"n={N_MANY_CPU}: max rel err {err:.2e}")
    t1 = time.perf_counter()
    streamed = run_mice_stream(src, iters=2, engine="device",
                               chunk_rows=100_000, noise=False,
                               device=DEVICE)
    log(f"[home_credit] run_mice_stream 'device' n={HC_ROWS} 2 rounds: "
        f"{time.perf_counter() - t1:.2f} s")
    out["stream"] = many_quality("[home_credit] stream", t, x_true, c_true,
                                 embed(t, streamed))

    cls = classify_many("[home_credit] TARGET", x_true, c_true, y, schema)
    cpu_slice = (x_true[:, :N_MANY_CPU].cpu(), c_true[:, :N_MANY_CPU].cpu(),
                 y[:N_MANY_CPU].cpu())
    agree = classify_cpu_agreement(cls, cpu_slice, schema)
    tc = null_table(x_true[:, :N_MANY_CPU], c_true[:, :N_MANY_CPU],
                    t.num_null[:, :N_MANY_CPU], t.cat_null[:, :N_MANY_CPU],
                    schema)
    card = run_mice_device(tc, iters=1, kernel="gram")
    cpu = run_mice_device(Table(*(a.cpu() for a in (
        tc.num_data, tc.cat_codes, tc.num_null, tc.cat_null)),
        schema=schema), iters=1, kernel="plain")
    m = tc.cat_null.cpu()
    codes_agree = float((card.cat_codes.cpu() == cpu.cat_codes)[m]
                        .float().mean())
    dx = float((card.num_data.cpu() - cpu.num_data).abs().max())
    check(codes_agree >= 0.999, f"[home_credit] MICE card vs CPU code "
          f"agreement {codes_agree}")
    log(f"[home_credit] n={N_MANY_CPU} card vs CPU: MICE codes "
        f"{codes_agree:.6f}, x max diff {dx:.3e}; classifiers {agree}")
    out.update(classify={k: dict(acc=v["acc"], launches=v["launches"],
                                 seconds=v["seconds"])
                         for k, v in cls.items()},
               cpu=dict(mice_codes=codes_agree, x_max_diff=dx, **agree),
               seconds=time.perf_counter() - t0)
    log(f"[home_credit] {out['seconds']:.1f} s in all")
    del t, x_true, c_true, y, cls
    torch.cuda.empty_cache()
    return out


def src_slice(num, cat, n: int):
    """A chunk source over the first n rows of host arrays."""
    from duckdb_imputation_tpu_torch.ring import streaming

    return streaming.chunks_from_arrays(num[:, :n], cat[:, :n],
                                        chunk_rows=100_000)


def classify_cpu_agreement(cls, cpu_slice, schema) -> dict:
    """Each pipeline of `cls` (QDA, NB) run on the card and on the CPU
    (its plain versions) over the rows of `cpu_slice`: their predictions
    agree on ≥ 0.999 of the rows."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device, qda_predict_device,
        qda_train_device)
    from duckdb_imputation_tpu_torch.ring.sum import (
        sum_to_nb_agg_grouped, sum_to_triple_grouped)
    from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

    x, codes, y = cpu_slice
    n = y.shape[0]
    out = {}
    for model in cls:
        preds = []
        for dev in (DEVICE, torch.device("cpu")):
            a = (x.to(dev), codes.to(dev), y.to(dev))
            if model == "qda":
                sig = sigma_from_triple(sum_to_triple_grouped(
                    *a, schema=schema, num_groups=2))
                pred = qda_predict_device(*qda_train_device(sig, float(n)),
                                          a[0], a[1], schema=schema)
            else:
                agg = sum_to_nb_agg_grouped(*a, schema=schema, num_groups=2)
                pred = nb_predict_device(*nb_train_device(
                    agg.n, agg.lin, agg.quad_diag, agg.lin_cat), a[0], a[1],
                    schema=schema)
            preds.append(pred.cpu())
        agree = float((preds[0] == preds[1]).float().mean())
        check(agree >= 0.999, f"{model} card vs CPU agreement {agree}")
        out[model] = agree
    return out


def phase_secom(seed: int) -> dict:
    """[secom]: the SECOM schema (P = 591, 590 numeric columns). The plans'
    host seconds (its fold's two windows of 590 one-level flags among
    them); each kernel against its plain version at N_SECOM rows (K7, K2w
    'num' past the parameter's 88 columns, sort + K8, K6w, K3w); the fold
    at the file's 1,567 rows (scan_gram over K7's windows, card vs CPU;
    run_mice_stream 'device', one round over the 590 columns); the QDA and
    NB pipelines on pass/fail at N_SECOM rows (QDA's fail class needs more
    rows than columns) and card vs CPU at N_MANY_CPU rows."""
    from duckdb_imputation_tpu_torch.mice.streaming import run_mice_stream
    from duckdb_imputation_tpu_torch.ring import streaming
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram)

    t0 = time.perf_counter()
    t, x_true, y = make_secom(N_SECOM, seed + 191)
    schema = t.schema
    ext = streaming.extended_schema(streaming.StreamSchema(
        schema=schema, nullable_num=tuple(range(590)), nullable_cat=(),
        n_rows=SECOM_ROWS))
    plans = plan_seconds(schema, ext)
    log(f"[secom] P={schema.sigma_size}, fold P+K={ext.sigma_size} "
        f"(K={ext.cat_cols} flags); plans' host seconds {plans}")
    out = dict(plans=plans, kernels=many_kernels(
        "[secom]", t, y, seed + 192, (("num", 589),)))
    cls = classify_many("[secom] pass/fail", x_true, t.cat_codes, y, schema)
    agree = classify_cpu_agreement(
        {"nb": None}, (x_true[:, :N_MANY_CPU].cpu(),
                       t.cat_codes[:, :N_MANY_CPU].cpu(),
                       y[:N_MANY_CPU].cpu()), schema)
    del t, x_true, y
    torch.cuda.empty_cache()

    t, x_true, _ = make_secom(SECOM_ROWS, seed + 193)
    num = torch.where(t.num_null, float("nan"), x_true).cpu().numpy()
    cat = np.zeros((0, SECOM_ROWS), np.int64)
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=500)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    check(streaming.extended_schema(ss).sigma_size == 1181,
          "[secom] the fold's P + K is not 1,181")
    masked_gram.wide_launches = 0
    t1 = time.perf_counter()
    gram = streaming.scan_gram(src, ss, chunk_rows=500, device=DEVICE)
    torch.cuda.synchronize()
    want = 4 * 2                   # four chunks, two windows each
    check(masked_gram.wide_launches == want,
          f"[secom] scan_gram: {masked_gram.wide_launches} K7 window "
          f"launches, not {want}")
    fold_s = time.perf_counter() - t1
    cpu_gram = streaming.scan_gram(src, ss, chunk_rows=500, device="cpu")
    err = float((gram.cpu() - cpu_gram).abs().max() / cpu_gram.abs().max())
    check(err <= 1e-6, f"[secom] fold card vs CPU rel err {err}")
    log(f"[secom] scan_gram P+K={gram.shape[0]} n={SECOM_ROWS}: {want} K7 "
        f"window launches, {fold_s:.2f} s; card vs CPU max rel err "
        f"{err:.2e}")
    out["fold"] = dict(launches=want, seconds=fold_s, max_rel_err=err)
    t1 = time.perf_counter()
    streamed = run_mice_stream(src, iters=1, engine="device",
                               chunk_rows=500, noise=False, device=DEVICE)
    log(f"[secom] run_mice_stream 'device' n={SECOM_ROWS} 1 round x 590 "
        f"columns: {time.perf_counter() - t1:.2f} s")
    out["stream"] = many_quality("[secom] stream", t, x_true, None,
                                 embed(t, streamed))
    out.update(classify={k: dict(acc=v["acc"], launches=v["launches"],
                                 seconds=v["seconds"])
                         for k, v in cls.items()},
               cpu=dict(fold_rel_err=err, **agree),
               seconds=time.perf_counter() - t0)
    log(f"[secom] {out['seconds']:.1f} s in all")
    return out


def phase_narrow_many(seed: int) -> dict:
    """[narrow80]: the narrow route past 64 columns of a kind, P ≤ 88: d =
    80 (P = 81) and d = 70 with two categorical columns of 8 levels (P =
    87), at N_NARROW rows: K1, K2 ('num' and 'cat'), sort + K5, K4 (≤ 8
    groups, unsorted), K6 and K3 against their plain versions."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
        grouped_gram, grouped_gram_plain)

    out = {}
    for d, vocabs in ((80, ()), (70, (8, 8))):
        x, codes, y = factor_table(N_NARROW, d, vocabs, seed + d, 0.3)
        schema = FeatureSchema(num_cols=d, cat_keys=tuple(
            tuple(range(v)) for v in vocabs))
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed + d + 1)
        num_null = torch.rand(d, N_NARROW, generator=g, device=DEVICE) < 0.1
        cat_null = torch.rand(len(vocabs), N_NARROW, generator=g,
                              device=DEVICE) < 0.1
        t = null_table(x, codes, num_null, cat_null, schema)
        tag = f"[narrow{d}] P={schema.sigma_size}"
        cases = (("num", d - 1),) + ((("cat", 1),) if vocabs else ())
        res = many_kernels(tag, t, y, seed + d + 2, cases)
        ids = (y * (1 + (x[0] > 0).int())).to(torch.int32)     # 3 groups
        w = (torch.rand(N_NARROW, generator=g, device=DEVICE) >= 0.2).float()
        res["k4"] = many_kernel(
            f"{tag} K4 (3 groups, unsorted)", (grouped_gram, "launches"),
            lambda: grouped_gram(t.num_data, t.cat_codes, w, ids,
                                 schema=schema, num_groups=3),
            lambda: grouped_gram_plain(t.num_data, t.cat_codes, w, ids,
                                       schema=schema, num_groups=3),
            gram_compare(tag, schema, True),
            gram_bound(t.cat_codes, schema, w, groups=3, extra=8))
        out[f"d{d}"] = res
        del t, x, codes
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [criteo] and [zip5]: a categorical column past a task's cells beside
# others, and codes past 32,768 in the scorers
# ---------------------------------------------------------------------------

# criteo_c18: the schema of Criteo's Display Advertising Challenge (Kaggle
# 2014, train.txt, 45,840,617 rows): I1-I13 as log1p of counts, as DLRM
# feeds them, and the 18 categorical columns of at most 15,000 levels, at
# the level counts of the DLRM repository's Kaggle preprocessing: the
# largest Criteo schema whose dense f32 S (9.0 GB) fits the card. Cut: C3,
# C4, C10, C12, C16, C21, C24 and C26 (93k to 10M levels; C10 alone would
# make S 79 GB); the rows, to N_CRITEO.
CRITEO_COLS = ("C1", "C2", "C5", "C6", "C7", "C8", "C9", "C11", "C13", "C14",
               "C15", "C17", "C18", "C19", "C20", "C22", "C23", "C25")
CRITEO_VOCABS = (1460, 583, 305, 24, 12517, 633, 3, 5683, 3194, 27, 14992,
                 10, 5652, 2173, 4, 18, 15, 105)    # P = 47,412
CRITEO_PAIR = (12517, 14992)   # criteo_pair: C7 and C15 alone, P = 27,523
CRITEO_C20 = 14                # C20's index among the codes
# null shares as commonly reported for train.txt (an assumption):
# (column, index among its kind, share)
CRITEO_NULLS = (("I1", 0, 0.45), ("I3", 2, 0.22), ("C20", CRITEO_C20, 0.44))
CRITEO_CLICK = 0.256           # train.txt's share of clicks
N_CRITEO = 10_000_000
N_CRITEO_SLICE = 1_000_000     # rows the plain versions, scan_gram and the
                               # scorers at criteo_pair and zip5 take
N_CRITEO_MICE = 2_000_000      # rows of [criteo]'s run_mice_wide
N_CRITEO_PLAIN_QDA = 20_000    # rows the plain scorer takes at criteo_pair
                               # (its ~30,000 slabs a row)
N_CRITEO_LIBRARY = 20_000      # rows of the dense cuBLAS Gram at criteo_c18
ZIP5_VOCABS = (33791, 5)       # 2020 census ZCTAs, and a 5-level column


def zipf_codes(n: int, v: int, g, shift=None) -> torch.Tensor:
    """n codes of a column of v levels, Zipf (level r drawn with weight
    1 / (r + 1)^1.05) by the inverse CDF of uniform draws on the device;
    `shift` i64[n] or None: each row's code rotated by it (mod v)."""
    cdf = torch.cumsum(1.0 / torch.arange(1, v + 1, device=DEVICE,
                                          dtype=torch.float64) ** 1.05, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand(n, generator=g, device=DEVICE, dtype=torch.float64)
    c = torch.searchsorted(cdf, u).clamp_(max=v - 1)
    if shift is not None:
        c = (c + shift) % v
    return c.to(torch.int32)


def make_criteo(n: int, seed: int, vocabs=CRITEO_VOCABS):
    """criteo_c18 (or, with vocabs=CRITEO_PAIR, criteo_pair) at n rows,
    made on the device from `seed`: the label click at 25.6%; I1-I13 the
    log1p of counts exp(a + b·z1 + c·z2 + 0.4·ε) of two row factors,
    click moving I1, I3 and I6; codes Zipf within each column, click
    rotating C7's and C15's by a third of their levels; C20 the quartile
    band of z1 + 0.5·ε (so the numerics predict it). criteo_c18's nulls:
    I1 45%, I3 22%, C20 44% (`CRITEO_NULLS`). Returns (table, true x, true
    codes, click)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    rng = np.random.default_rng(seed)
    a, b, c = (rng.uniform(0.5, 3.0, 13), rng.uniform(0.4, 1.0, 13),
               rng.uniform(-0.5, 0.5, 13))

    def randn():
        return torch.randn(n, generator=g, device=DEVICE)

    click = torch.rand(n, generator=g, device=DEVICE) < CRITEO_CLICK
    z1, z2 = randn(), randn()
    x = torch.empty((13, n), device=DEVICE)
    for j in range(13):
        lam = a[j] + b[j] * z1 + c[j] * z2 + 0.4 * randn()
        if j in (0, 2, 5):
            lam = lam + 0.6 * click
        x[j] = torch.log1p(torch.floor(torch.exp(lam)))
    codes = torch.empty((len(vocabs), n), dtype=torch.int32, device=DEVICE)
    for j, v in enumerate(vocabs):
        codes[j] = zipf_codes(n, v, g, click.long() * (v // 3)
                              if v in CRITEO_PAIR else None)
    full = tuple(vocabs) == CRITEO_VOCABS
    if full:
        codes[CRITEO_C20] = torch.bucketize(
            z1 + 0.5 * randn(), torch.tensor([-0.6, 0.0, 0.6],
                                             device=DEVICE)).to(torch.int32)
    schema = FeatureSchema(num_cols=13, cat_keys=tuple(
        tuple(range(v)) for v in vocabs))
    num_null = torch.zeros((13, n), dtype=torch.bool, device=DEVICE)
    cat_null = torch.zeros((len(vocabs), n), dtype=torch.bool, device=DEVICE)
    for name, j, share in CRITEO_NULLS if full else ():
        row = cat_null[j] if name.startswith("C") else num_null[j]
        row |= torch.rand(n, generator=g, device=DEVICE) < share
    return null_table(x, codes, num_null, cat_null, schema), x, codes, click


def made_qda_tables(schema, classes: int, seed: int, chunk: int = 1 << 24):
    """QDA's tables made straight into the scorer's plan's cells
    (`_build.qda_plan`), in f64 rounded to f32 once: per class an
    intercept, a linear term and quad = −(I + B·Bᵀ) of a rank-4 B
    (negative definite), each cell the sum of A[i, j] + A[j, i] over its
    map's pairs i < j and A[i, i] on the diagonal, as `qda_tables` packs
    them, with no dense A (2 × 27,523² f64 at criteo_pair). Returns
    (tables f32[C, cells], plan)."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build

    plan = _build.qda_plan(schema)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    f64, p = torch.float64, schema.sigma_size
    b = 0.3 * torch.randn(classes, p, 4, generator=g, device=DEVICE,
                          dtype=f64)
    lin = torch.randn(classes, p, generator=g, device=DEVICE, dtype=f64)
    icpt = torch.randn(classes, generator=g, device=DEVICE, dtype=f64)
    base = plan.task_base.to(DEVICE)
    cells = torch.zeros((classes, int(plan.task_base[-1])), dtype=f64,
                        device=DEVICE)
    for a0 in range(0, plan.entries.shape[0], chunk):
        e = plan.entries[a0:a0 + chunk].to(DEVICE).long()
        i, j = e[:, 2], e[:, 3]
        quad = -(b[:, i] * b[:, j]).sum(-1) - (i == j).to(f64)
        val = torch.where(i == j, quad, 2 * quad)
        val = torch.where(i == 0, lin[:, j], val)
        val = torch.where((i == 0) & (j == 0), icpt[:, None], val)
        cells.index_add_(1, base[e[:, 0]] + e[:, 1], val)
    return cells.float(), plan


def slice_kernel(tag: str, counters, kernel, plain, compare, bound_: dict,
                 library_ms=None, full=None, plain_device=None) -> dict:
    """`many_kernel` for kernels whose plain version takes seconds: two
    calls, the rerun bit-identical, each with every counter of `counters`
    ((wrapper, attribute, launches a call)) zeroed just before it and
    checked just after; the plain version called and timed once. full:
    the kernel at all the phase's rows (what `bound_` counts), timed in
    place of `kernel` (on a slice of them); plain_device: where the plain
    version runs (the CPU: timed by the host's clock, the kernel's output
    moved there to compare)."""
    runs = []
    for _ in range(2):
        for obj, attr, _n in counters:
            setattr(obj, attr, 0)
        runs.append(kernel())
        torch.cuda.synchronize()
        for obj, attr, want_n in counters:
            check(getattr(obj, attr) == want_n,
                  f"{tag}: {getattr(obj, attr)} {obj.__name__}.{attr} a "
                  f"call, not {want_n}")
    launched = {f"{obj.__name__}.{attr}": want_n
                for obj, attr, want_n in counters}
    got, again = runs
    del runs
    pair = ((got, again) if isinstance(got, torch.Tensor)
            else (torch.cat([a.flatten().float() for a in got]),
                  torch.cat([a.flatten().float() for a in again])))
    check(torch.equal(*pair), f"{tag}: rerun not bit-identical")
    del again, pair
    ms = cuda_ms(full or kernel, reps=1, warmup=0)
    want = []
    if plain_device is None:
        plain_ms = cuda_ms(lambda: want.append(plain()), reps=1, warmup=0)
    else:
        t0 = time.perf_counter()
        want.append(plain())
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = (got.to(plain_device) if isinstance(got, torch.Tensor)
               else tuple(a.to(plain_device) for a in got))
    err = compare(got, want[0])
    del got, want
    torch.cuda.empty_cache()
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound_,
               library_ms=library_ms, launches_a_call=launched)
    log(f"{tag}: max abs err {err:.3e}, bit-identical rerun, launches a "
        f"call {launched}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
        + ("" if library_ms is None else f", library {library_ms:.3f} ms"))
    return res


def lean_gram_compare(tag, schema, rows: int = 2048):
    """`gram_compare` (binary weights) a block of `rows` rows at a time:
    criteo_c18's S is 9.0 GB, and its K8 two of them."""
    def compare(got, want):
        d, p = schema.num_cols, schema.sigma_size
        counted = torch.ones(p, dtype=torch.bool, device=got.device)
        counted[1:1 + d] = False
        err = 0.0
        for r0 in range(0, p, rows):
            g, w_ = got[r0:r0 + rows], want[r0:r0 + rows]
            check(torch.equal(g, got[:, r0:r0 + rows].T),
                  f"{tag}: S is not exactly symmetric")
            check(torch.isfinite(g).all(), f"{tag}: not finite")
            cm = counted[r0:r0 + rows, None] & counted[None]
            check(torch.equal(g[cm], w_[cm]),
                  f"{tag}: counts differ from the plain version")
            err = max(err, float((g - w_).abs().max()))
        scale = float(want.abs().max())
        check(err <= 1e-5 * scale, f"{tag}: max abs err {err} > 1e-5 of "
              f"max|σ| {scale}")
        return err
    return compare


def peak_host_gib() -> float:
    """This process's peak resident memory, GiB (getrusage)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def phase_criteo(seed: int) -> dict:
    """[criteo]: criteo_c18 (13 numerics, 18 categorical columns, P =
    47,412, past the 46,340 of a P² int map, 47 windows; C7's 12,517 and
    C15's 14,992 levels both past a K7 task's 8,192 cells, their cross
    table cut by row code). At N_CRITEO rows: the windows' plans (host
    seconds with their copy to the card, places, device bytes, peak
    memory on both sides; the plans made again on the card by a later
    call, `plans_remade`, when they no longer fit beside its data);
    masked_gram_cols over all
    of S (one order pass, a launch a window: symmetric, rerun
    bit-identical) and its time, bound and library; the first window, the
    one inside C15 (C_{15,7} row-cut) and the last alone (equal to the
    pass's columns), each against masked_gram_window_plain on an
    N_CRITEO_SLICE-row slice; sort + K8 by click (G = 2) and K2w ('num'
    on I1, 'cat' on C20) against their plain versions on the slice;
    scan_gram over the slice's complete rows against masked_gram; then
    run_mice_wide on a grid of one rank over N_CRITEO_MICE rows, imputing
    I1, I3 and C20, against mean and mode fill."""
    from types import SimpleNamespace

    from duckdb_imputation_tpu_torch.parallel import (make_mesh_2d,
                                                      run_mice_wide)
    from duckdb_imputation_tpu_torch.parallel import wide as pwide
    from duckdb_imputation_tpu_torch.ring import streaming
    from duckdb_imputation_tpu_torch.ring.kernels import _build, sigma_pallas
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram, masked_gram_cols, masked_gram_window,
        masked_gram_window_plain, window_columns, window_order,
        window_plans)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped \
        import (grouped_gram_presorted, grouped_gram_presorted_plain,
                sort_by_group)

    t_phase = time.perf_counter()
    _build.plan_cache.clear()            # earlier phases' plans: the card
    sigma_pallas._device_plan.cache_clear()   # holds criteo_c18's beside
    torch.cuda.empty_cache()                  # two 9.0 GB S in K8
    t, x_true, c_true, click = make_criteo(N_CRITEO, seed + 191)
    schema, n = t.schema, N_CRITEO
    p, d, sizes = schema.sigma_size, schema.num_cols, tuple(schema.cat_sizes)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 192)
    w = (torch.rand(n, generator=g, device=DEVICE) >= 0.25).float()
    xs, cs = list(t.num_data), list(t.cat_codes)
    lows = list(range(0, p, _build.WINDOW_WIDTH))
    out = dict(sigma_size=p, rows=n, windows=len(lows))

    # the plans: made on the host a window at a time, copied to the card
    # and kept there (DEVICE_PLAN_SHARE); the host keeps PLAN_CACHE_BYTES
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    for lo in lows:
        window_plans(schema, lo, min(lo + _build.WINDOW_WIDTH, p), DEVICE)
    torch.cuda.synchronize()
    out["plans"] = dict(
        seconds=time.perf_counter() - t1,
        places=sum(_build.window_places(d, sizes, lo, min(
            lo + _build.WINDOW_WIDTH, p)) for lo in lows),
        device_gib=(torch.cuda.memory_allocated() - mem0) / 2 ** 30,
        host_peak_gib=peak_host_gib(),
        keyed_columns=[CRITEO_COLS[j] for j in _build.keyed_columns(
            d, sizes)])
    log(f"[criteo] criteo_c18 P={p} n={n}: plans of {len(lows)} windows "
        f"{out['plans']}")

    # from here on, each plan copied to the card again (evicted to keep
    # DEVICE_PLAN_SHARE of the spare memory, then asked for) is counted
    made_again = []
    device_plan = sigma_pallas.device_plan

    def counted_device_plan(*args, **kwargs):
        made_again.append(1)
        return device_plan(*args, **kwargs)
    sigma_pallas.device_plan = counted_device_plan
    out["plans_remade"] = {}

    def remade(stage):
        out["plans_remade"][stage] = len(made_again)
        log(f"[criteo] plans made again on the card through {stage}: "
            f"{len(made_again)}")

    # a pass over all of S, counts zeroed just before it
    cols = window_columns(schema, lows, _build.WINDOW_WIDTH)
    masked_gram_cols.wide_launches = window_order.passes = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    s = masked_gram_cols(xs, cs, w, schema=schema)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    got = (masked_gram_cols.wide_launches, window_order.passes)
    check(got == (len(lows), 1), f"[criteo] pass: launches (K7, order) "
          f"{got}, not ({len(lows)}, 1)")
    check(torch.isfinite(s).all() and torch.equal(s, s.T),
          "[criteo] S not finite or not exactly symmetric")
    again = masked_gram_cols(xs, cs, w, schema=schema)
    check(torch.equal(s, again), "[criteo] pass rerun not bit-identical")
    del again
    out.update(
        ms=cuda_ms(lambda: masked_gram_cols(xs, cs, w, schema=schema),
                   reps=1, warmup=0),
        first_call_s=first_s, launches=got[0], order_passes=got[1],
        device_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        **gram_bound(t.cat_codes, schema, w))
    order_ms = cuda_ms(lambda: window_order(xs, cs, w, schema=schema,
                                            columns=cols), reps=1, warmup=0)
    out["order"] = dict(ms=order_ms, columns=[CRITEO_COLS[j] for j in cols],
                        rows_copied=len(cols) * n, **bound(
                            len(cols) * n * (4 + 4 * _build.order_stride(
                                1 + d + schema.cat_cols)), 0))
    ls = N_CRITEO_LIBRARY
    out["library_ms"] = library_gram_ms(t.num_data[:, :ls],
                                        t.cat_codes[:, :ls], w[:ls], schema)
    out["library_rows"] = ls
    log(f"[criteo] masked_gram_cols n={n}: {got[0]} K7 launches and "
        f"{got[1]} order pass, first call {first_s:.2f} s, {out['ms']:.1f} "
        f"ms, bound {out['bound_ms']:.3f} ms ({out['bound_by']}); order "
        f"{order_ms:.1f} ms over {out['order']['columns']}; cuBLAS dense "
        f"Gram at {ls} rows {out['library_ms']:.1f} ms; device peak "
        f"{out['device_peak_gib']:.2f} GiB")
    remade("the pass")

    # three windows alone: equal to the pass's columns at N_CRITEO rows,
    # against the plain version on the slice
    m = N_CRITEO_SLICE
    sx, sc, sw = [x[:m] for x in xs], [c[:m] for c in cs], w[:m]
    c15 = 1 + d + sum(sizes[:CRITEO_COLS.index("C15")])
    out["per_window"] = []
    worst = 0.0
    for lo in (0, c15 // 1024 * 1024 + 1024, lows[-1]):
        wd = min(_build.WINDOW_WIDTH, p - lo)
        masked_gram_window.launches = 0
        win = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=wd)
        torch.cuda.synchronize()
        check(masked_gram_window.launches == 1 and torch.equal(
            win, s[:, lo:lo + wd]), f"[criteo] window {lo}: not one launch "
              f"equal to the pass's columns")
        ms = cuda_ms(lambda: masked_gram_window(xs, cs, w, schema=schema,
                                                lo=lo, width=wd),
                     reps=1, warmup=0)
        del win
        got = masked_gram_window(sx, sc, sw, schema=schema, lo=lo, width=wd)
        again = masked_gram_window(sx, sc, sw, schema=schema, lo=lo,
                                   width=wd)
        want = []
        plain_ms = cuda_ms(lambda: want.append(masked_gram_window_plain(
            sx, sc, sw, schema=schema, lo=lo, width=wd)), reps=1, warmup=0)
        err = _window_check(f"[criteo] window {lo}", got, again, want[0],
                            schema, lo)
        worst = max(worst, err)
        residual, keyed = _build.keyed_window_plan(schema, lo, lo + wd)
        kinds = sorted({k for pl in (residual, keyed and keyed.plan) if pl
                        for k in pl.slabs[:, 0].tolist()})
        rec = dict(lo=lo, width=wd, ms=ms, plain_ms=plain_ms,
                   plain_rows=m, max_abs_err=err, slab_kinds=kinds,
                   residual_tasks=residual.num_tasks if residual else 0,
                   keyed_tasks=keyed.num_tasks if keyed else 0,
                   **window_bound(cs, w, schema, lo, lo + wd))
        out["per_window"].append(rec)
        log(f"[criteo] window [{lo}, {lo + wd}): {rec}")
        del got, again, want
    check(_build.SLAB_CB in out["per_window"][1]["slab_kinds"],
          "[criteo] the window inside C15 holds no CB slab")
    out["max_abs_err"], out["plain_ms"] = worst, None
    del s
    torch.cuda.empty_cache()
    remade("the three windows")

    # K8 by click (G = 2): sort, then a launch a window; N_CRITEO rows
    # timed, the slice against the plain version
    def k8(x_, c_, w_, y_):
        xg, cg, wg, layout = sort_by_group(torch.stack(x_), torch.stack(c_),
                                           y_, schema=schema, num_groups=2,
                                           weights=w_)
        return grouped_gram_presorted(xg, cg, wg, layout, schema=schema)

    def k8_plain():
        xg, cg, wg, layout = sort_by_group(
            torch.stack(sx), torch.stack(sc), click[:m].int(), schema=schema,
            num_groups=2, weights=sw)
        return grouped_gram_presorted_plain(xg, cg, wg, layout,
                                            schema=schema)

    grouped_gram_presorted.wide_launches = 0
    t1 = time.perf_counter()
    full = k8(xs, cs, w, click.int())
    torch.cuda.synchronize()
    k8_s = time.perf_counter() - t1
    check(grouped_gram_presorted.wide_launches == len(lows),
          f"[criteo] K8: {grouped_gram_presorted.wide_launches} launches")
    for gg in range(2):   # a block of rows at a time: S_g is 9.0 GB
        for r0 in range(0, p, 2048):
            blk = full[gg, r0:r0 + 2048]
            check(torch.isfinite(blk).all() and torch.equal(
                blk, full[gg, :, r0:r0 + 2048].T),
                f"[criteo] K8 group {gg}: not finite or not symmetric")
    del full, blk
    torch.cuda.empty_cache()
    def k8_compare(got, want):
        return max(lean_gram_compare(f"[criteo] K8 group {gg}", schema)(
            got[gg], want[gg]) for gg in range(2))

    def fused_lean(tag, kind):
        def compare(got, want):
            (new, sig), (wnew, wsig) = got, want
            if kind == "cat":
                check(torch.equal(new, wnew), f"{tag}: codes differ")
            else:
                dv = float((new - wnew).abs().max())
                check(dv <= 1e-5 * max(1.0, float(wnew.abs().max())),
                      f"{tag}: values differ by {dv}")
            return lean_gram_compare(tag, schema)(sig, wsig)
        return compare

    out["k8"] = slice_kernel(
        "[criteo] sort + K8 by click",
        [(grouped_gram_presorted, "wide_launches", len(lows)),
         (window_order, "passes", 1)],
        lambda: k8(sx, sc, sw, click[:m].int()), k8_plain, k8_compare,
        gram_bound(t.cat_codes[:, :m], schema, sw, groups=2, extra=8))
    out["k8"].update(rows=m, full_rows=n, full_s=k8_s, groups=2)
    torch.cuda.empty_cache()
    remade("K8")

    # K2w: its impute kernel, then K7's windows
    rng = np.random.default_rng(seed + 193)
    null = torch.zeros(m, dtype=torch.bool, device=DEVICE)
    out["k2w"] = {}
    for kind, col, r, mask in (("num", 0, 1, t.num_null[0, :m]),
                               ("cat", CRITEO_C20, 4, t.cat_null[
                                   CRITEO_C20, :m])):
        w_full = torch.tensor(rng.normal(size=(p, r)).astype(np.float32)
                              * 0.01, device=DEVICE)
        icpt = torch.tensor(rng.normal(size=r).astype(np.float32),
                            device=DEVICE)
        args = (sx, sc, mask | null, sw, w_full, icpt)
        kw = dict(schema=schema, kind=kind, imp_col=col)
        out["k2w"][kind] = slice_kernel(
            f"[criteo] K2w '{kind}' ({'I1' if kind == 'num' else 'C20'})",
            [(fused_impute_aggregate, "impute_launches", 1),
             (fused_impute_aggregate, "window_launches", len(lows)),
             (window_order, "passes", 1)],
            lambda: fused_impute_aggregate(*args, **kw),
            lambda: fused_impute_aggregate_plain(*args, **kw),
            fused_lean(f"[criteo] K2w {kind}", kind),
            gram_bound(t.cat_codes[:, :m], schema, sw, extra=5))
        torch.cuda.empty_cache()

    # scan_gram over the slice's complete rows (no nulls, so the fold's
    # schema is criteo_c18's own and shares its plans) against masked_gram
    num = x_true[:, :m].cpu().numpy()
    cat = c_true[:, :m].cpu().numpy().astype(np.int64)
    ss = streaming.StreamSchema(schema=schema, nullable_num=(),
                                nullable_cat=(), n_rows=m)
    masked_gram.wide_launches = 0
    t1 = time.perf_counter()
    gram = streaming.scan_gram(streaming.chunks_from_arrays(
        num, cat, chunk_rows=m), ss, chunk_rows=m, device=DEVICE)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    check(masked_gram.wide_launches == len(lows),
          f"[criteo] scan_gram: {masked_gram.wide_launches} K7 launches")
    ref = masked_gram(x_true[:, :m].contiguous(), c_true[:, :m].contiguous(),
                      None, schema=schema)
    check(torch.equal(gram.float(), ref), "[criteo] scan_gram's one "
          "chunk differs from masked_gram over the same rows")
    out["scan_gram"] = dict(rows=m, seconds=scan_s,
                            launches=len(lows), equal=True)
    remade("K2w and scan_gram")
    log(f"[criteo] scan_gram n={m}: {len(lows)} K7 launches, "
        f"{scan_s:.2f} s, equal to masked_gram over the same rows")
    del gram, ref, num, cat
    torch.cuda.empty_cache()

    # run_mice_wide on a grid of one rank
    mr = N_CRITEO_MICE
    sub = null_table(x_true[:, :mr], c_true[:, :mr], t.num_null[:, :mr],
                     t.cat_null[:, :mr], schema)
    masked_gram_window.launches = pwide._pcg.steps = 0
    t1 = time.perf_counter()
    xw, cw = run_mice_wide(
        sub.num_data, sub.cat_codes, sub.num_null, sub.cat_null,
        schema=schema, mesh=make_mesh_2d(1, 1, device=DEVICE), iters=1,
        num_cols_to_impute=(0, 2), cat_cols_to_impute=(CRITEO_C20,),
        ridge=1e-2, shrinkage=1e-1, cg_iters=150, tol=1e-6)
    torch.cuda.synchronize()
    mice_s = time.perf_counter() - t1
    passes = masked_gram_window.launches // len(lows)
    check(masked_gram_window.launches == 3 * len(lows),
          f"[criteo] run_mice_wide: {masked_gram_window.launches} K7 "
          f"window launches, not three passes of {len(lows)}")
    quality = many_quality("[criteo] run_mice_wide", sub, x_true[:, :mr],
                           c_true[:, :mr], SimpleNamespace(
                               num_data=xw, cat_codes=cw))
    out["run_mice_wide"] = dict(rows=mr, seconds=mice_s, passes=passes,
                                window_launches=masked_gram_window.launches,
                                cg_steps=pwide._pcg.steps, **quality)
    log(f"[criteo] run_mice_wide 1 x 1 n={mr} (I1, I3, C20): {mice_s:.2f} "
        f"s, {passes} passes over S, {pwide._pcg.steps} CG steps")
    remade("run_mice_wide")
    sigma_pallas.device_plan = device_plan
    del t, x_true, c_true, click, xs, cs, w, sub, xw, cw
    _build.plan_cache.clear()
    sigma_pallas._device_plan.cache_clear()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[criteo] {out['seconds']:.1f} s in all")
    return out


def phase_zip5(seed: int) -> dict:
    """[zip5] and criteo_pair's scorer: K3w QDA at criteo_pair (C7 × C15
    row-cut in the scorer's plan) and at zip5 (4 numerics, a ZIP5 column
    of 33,791 levels beside one of 5: codes staged as i32), C = 2 classes
    of tables made straight into the plan's cells, N_CRITEO_SLICE rows,
    argmax against the plain version (criteo_pair on N_CRITEO_PLAIN_QDA
    rows) on ≥ 0.9999 of rows; then the NB pipeline at zip5 over N rows
    (label the 5-level column): K6w, training, the NB scorer (K3w, i32
    codes), accuracy above the majority share + 0.02, argmax against the
    plain version (the CPU) on ≥ 0.9999 of N_MANY_CPU rows."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    t_phase = time.perf_counter()
    out = {}
    m = N_CRITEO_SLICE
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 201)
    zip5 = FeatureSchema(num_cols=4, cat_keys=tuple(
        tuple(range(v)) for v in ZIP5_VOCABS))
    pair = make_criteo(m, seed + 202, CRITEO_PAIR)
    zx = torch.randn((4, m), generator=g, device=DEVICE)
    zc = torch.stack([zipf_codes(m, ZIP5_VOCABS[0], g),
                      torch.randint(0, 5, (m,), generator=g, device=DEVICE,
                                    dtype=torch.int32)])
    for name, schema, x, codes, plain_rows in (
            ("criteo_pair", pair[0].schema, pair[0].num_data,
             pair[0].cat_codes, N_CRITEO_PLAIN_QDA),
            ("zip5", zip5, zx, zc, m)):
        t1 = time.perf_counter()
        tables, plan = made_qda_tables(schema, 2, seed + 203)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t1
        qda_predict_kernel.wide_launches = 0
        got = qda_predict_kernel(tables, plan, x, codes, schema=schema)
        again = qda_predict_kernel(tables, plan, x, codes, schema=schema)
        torch.cuda.synchronize()
        check(qda_predict_kernel.wide_launches == 2 and torch.equal(
            got, again), f"[{name}] K3w: launches or rerun")
        ms = cuda_ms(lambda: qda_predict_kernel(tables, plan, x, codes,
                                                schema=schema),
                     reps=1, warmup=0)
        k = plain_rows
        want = []
        plain_ms = cuda_ms(lambda: want.append(qda_predict_plain(
            tables, plan, x[:, :k].contiguous(), codes[:, :k].contiguous(),
            schema=schema)), reps=1, warmup=0)
        agree = float((got[:k] == want[0]).float().mean())
        check(agree >= 0.9999, f"[{name}] K3w agrees with the plain "
              f"version on {agree} of rows")
        check(len(torch.unique(got)) == 2, f"[{name}] K3w: one class")
        out[f"k3w_{name}"] = dict(
            max_abs_err=0.0 if agree == 1.0 else 1.0, ms=ms,
            plain_ms=plain_ms, plain_rows=k, agreement=agree, rows=m,
            tasks=plan.num_tasks, cells=int(plan.task_base[-1]),
            cb_slabs=int((plan.slabs[:, 0] == _build.SLAB_CB).sum()),
            code_bytes=_build.qda_code_bytes(schema), tables_s=made_s,
            tile=list(_build.qda_tile(schema, plan, 2)),
            launches=qda_predict_kernel.wide_launches, library_ms=None,
            **qda_bound(codes, schema, 2, tables.numel() * 4))
        log(f"[{name}] K3w QDA P={schema.sigma_size} n={m}: "
            f"{out[f'k3w_{name}']}")
        del tables, plan, got, again, want
        torch.cuda.empty_cache()
    del pair, zx, zc

    # the NB pipeline at zip5: label the 5-level column
    n = N
    y = torch.multinomial(torch.tensor([0.3, 0.25, 0.2, 0.15, 0.1],
                                       device=DEVICE), n, replacement=True,
                          generator=g).to(torch.int32)
    x = (torch.randn((4, n), generator=g, device=DEVICE)
         + 0.4 * y[None] * torch.arange(1, 5, device=DEVICE)[:, None])
    codes = zipf_codes(n, ZIP5_VOCABS[0], g, y.long() * 6000)[None]
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(
        ZIP5_VOCABS[0])),))
    nb_grouped_sums.launches = qda_predict_kernel.wide_launches = 0
    t1 = time.perf_counter()
    agg = sum_to_nb_agg_grouped(x, codes, y, schema=schema, num_groups=5)
    params = nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
    pred = nb_predict_device(*params, x, codes, schema=schema)
    torch.cuda.synchronize()
    nb_s = time.perf_counter() - t1
    launches = (nb_grouped_sums.launches,
                qda_predict_kernel.wide_launches)
    check(launches == (1, 1), f"[zip5] NB launches (K6w, K3w) {launches}")
    acc = float((pred == y).float().mean())
    major = float(torch.bincount(y).max()) / n
    check(acc > major + 0.02, f"[zip5] NB accuracy {acc} vs majority "
          f"{major}")
    k = N_MANY_CPU
    cpu = nb_predict_device(*[a.cpu() for a in params], x[:, :k].cpu(),
                            codes[:, :k].cpu(), schema=schema)
    agree = float((pred[:k].cpu() == cpu).float().mean())
    check(agree >= 0.9999, f"[zip5] NB scorer agrees with the plain "
          f"version on {agree}")
    sums_ms = cuda_ms(lambda: nb_grouped_sums(
        x, codes, None, y, schema=schema, num_groups=5), reps=3, warmup=1)
    score_ms = cuda_ms(lambda: nb_predict_device(*params, x, codes,
                                                 schema=schema), reps=3,
                       warmup=1)
    out["nb"] = dict(rows=n, seconds=nb_s, accuracy=acc, majority=major,
                     agreement=agree, plain_rows=k, k6w_ms=sums_ms,
                     scorer_ms=score_ms, launches=list(launches),
                     k6w_bound=nb_bound(n, schema, 5))
    log(f"[zip5] NB pipeline n={n}: {out['nb']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[zip5] {out['seconds']:.1f} s in all")
    return out


# ---------------------------------------------------------------------------
# [epsilon], [mnist] and [past_smem]: past the shared-memory column limits
# ---------------------------------------------------------------------------

# Epsilon: the PASCAL Large Scale Learning Challenge 2008's `epsilon` set
# as the LIBSVM binary collection gives it: 400,000 training rows (and
# 100,000 test rows) of 2,000 dense features, each row of unit L2 norm, a
# binary label. MICE takes the label as a categorical column (P = 2,003),
# QDA and NB as the class (P = 2,001)
EPSILON_D = 2000
N_EPSILON = 400_000        # the kernels' rows: the training split
N_EPSILON_MICE = 100_000   # rows of the MICE loops and the pipelines (a
                           # pass over 2,003 columns takes ~6 s at 400k)
N_EPSILON_SLICE = 20_000   # rows the plain versions take
N_SCORER_PLAIN = 256       # rows the plain scorer takes on the CPU at
                           # Epsilon, spread over all rows (it adds a row's
                           # 2M cells in order, TERMS_AT_ONCE a torch call)
EPSILON_NULL_COLS = (0, 1, 2, 3)
# MNIST (LeCun et al.): 60,000 + 10,000 images of 28 × 28 pixels of 0-255
# (784 columns, scaled to [0, 1]), 10 digit classes
N_MNIST = 70_000
N_MNIST_PLAIN = 256        # rows the plain scorer takes on the CPU
MNIST_BORDER = 3           # pixels from each edge that are 0 in every row
# past_smem: test schemas one past the old limits, not deployments
N_PAST_SMEM = 1_000_000


def make_epsilon(n: int, seed: int):
    """Epsilon's schema at n rows, made on the device from `seed`: 2,000
    columns of a rank-8 factor model plus noise, standardized per column,
    then each row scaled to unit L2 norm (as the LIBSVM set is); the label
    a logistic function of the factors, about balanced. Nulls (an
    assumption; the set has none): 20% MCAR in EPSILON_NULL_COLS and 10%
    in the label. Returns (table with the label as a categorical column of
    2 levels, true x, true label)."""
    from duckdb_imputation_tpu_torch import FeatureSchema

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE)

    f = randn(8, n)
    x = randn(EPSILON_D, 8) @ f
    x += randn(EPSILON_D, n)
    x -= x.mean(1, keepdim=True)
    x /= x.std(1, keepdim=True)
    x /= x.norm(dim=0, keepdim=True)
    beta = randn(8)
    y = (torch.rand(n, generator=g, device=DEVICE)
         < torch.sigmoid(3.0 * (beta / beta.norm()) @ f)).to(torch.int32)
    schema = FeatureSchema(num_cols=EPSILON_D, cat_keys=((0, 1),))
    num_null = torch.zeros((EPSILON_D, n), dtype=torch.bool, device=DEVICE)
    for j in EPSILON_NULL_COLS:
        num_null[j] = torch.rand(n, generator=g, device=DEVICE) < 0.2
    cat_null = (torch.rand(1, n, generator=g, device=DEVICE) < 0.1)
    return null_table(x, y[None], num_null, cat_null, schema), x, y


def make_mnist(n: int, seed: int):
    """MNIST's schema at n rows, made on the device from `seed`: 784
    pixels in [0, 1], a class template each (blobs of ink on the 22 × 22
    centre) plus noise, clipped, so most pixels are 0 and the
    MNIST_BORDER pixels at each edge are 0 in every row (as in MNIST:
    each class covariance is singular); 10 classes, about even. An
    assumption: the digits' images are not made. Returns (x f32[784, n],
    labels i32[n])."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    side, b = 28, MNIST_BORDER
    templ = torch.zeros((10, side, side), device=DEVICE)
    ink = torch.rand(10, side - 2 * b, side - 2 * b, generator=g,
                     device=DEVICE)
    templ[:, b:side - b, b:side - b] = torch.where(ink < 0.35, ink / 0.35,
                                                   0.0)
    templ = templ.reshape(10, side * side)
    y = torch.randint(0, 10, (n,), generator=g, device=DEVICE,
                      dtype=torch.int32)
    noise = 0.3 * torch.randn(side * side, n, generator=g, device=DEVICE)
    x = (templ.T[:, y.long()] + noise * (templ.T[:, y.long()] > 0)
         - 0.15).clamp(0.0, 1.0)
    return x.contiguous(), y


def scorer_compare(tag):
    def compare(got, want):
        agree = float((got == want).float().mean())
        check(agree >= 0.9999, f"{tag}: argmax agreement {agree}")
        return float((got != want).sum())
    return compare


def library_qda_ms(tables, plan, x, schema, codes=None) -> float:
    """ms of the cuBLAS f32 products that score the same quadratic forms
    from the dense operand: (Z·A_c ⊙ Z) summed over the columns, a class
    at a time (TF32 off), A_c the f32 form the tables' cells stand for
    (each cell at its places, halved off the diagonal); Z = [1 ‖ x], or
    with `codes` [1 ‖ x ‖ onehot(codes)]."""
    p = schema.sigma_size
    e = plan.entries.long().to(DEVICE)
    flat = plan.task_base.to(DEVICE)[e[:, 0]] + e[:, 1]
    vals = tables[:, flat]
    off = e[:, 2] != e[:, 3]
    a = torch.zeros((tables.shape[0], p, p), device=DEVICE)
    a[:, e[:, 2], e[:, 3]] = torch.where(off, vals / 2, vals)
    a[:, e[:, 3], e[:, 2]] = torch.where(off, vals / 2, vals)
    z = (torch.cat([torch.ones((1, x.shape[1]), device=DEVICE), x]).T
         if codes is None else dense_block(x, codes, schema).T).contiguous()

    def score():
        for c in range(a.shape[0]):
            (torch.mm(z, a[c]) * z).sum(1)
    ms = cuda_ms(score, reps=1, warmup=1)
    del a, z
    torch.cuda.empty_cache()
    return ms


def scorer_kernels(tag: str, x, schema, classes: int, seed: int,
                   plain_rows: int) -> dict:
    """K3w on seeded QDA and NB tables of the scorer's local plans
    (`_build.qda_local`: a task stages its own numeric columns), held
    against the plain scorer on the CPU on `plain_rows` rows spread evenly
    over all n (argmax ≥ 0.9999): the kernel on those rows alone (whole
    tiles; a rerun bit-identical, one launch a call), and the kernel's run
    at all n, timed, at the same rows; bound and the cuBLAS products of
    the same forms."""
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
        qda_predict_kernel, qda_predict_plain)

    n = x.shape[1]
    codes = torch.zeros((0, n), dtype=torch.int32, device=DEVICE)
    picked = torch.arange(plain_rows, device=DEVICE) * (n // plain_rows)
    xs, cs = x[:, picked].contiguous(), codes[:, picked]
    cpu = torch.device("cpu")
    out = {}
    for kind in ("qda", "nb"):
        tables, plan, shift = seeded_scorer(kind, schema, classes,
                                            seed + len(out))
        check(plan.local, f"{tag} {kind}: the scorer's plan is not local")
        tile = _build.qda_tile(schema, plan, classes)
        args = dict(schema=schema, shift=shift)
        full, want = [], []

        def plain():
            want.append(qda_predict_plain(
                tables.to(cpu), plan, xs.to(cpu), cs.to(cpu), schema=schema,
                shift=None if shift is None else shift.to(cpu)))
            return want[-1]

        out[kind] = slice_kernel(
            f"{tag} K3w {kind} ({plan.num_tasks} tasks, ≤ "
            f"{plan.max_stage_x} columns a task, tile {tile}) n={n}",
            [(qda_predict_kernel, "wide_launches", 1)],
            lambda: qda_predict_kernel(tables, plan, xs, cs, **args),
            plain, scorer_compare(f"{tag} K3w {kind}"),
            qda_bound(codes, schema, classes, tables.numel() * 4),
            library_qda_ms(tables, plan, x, schema),
            full=lambda: full.append(
                qda_predict_kernel(tables, plan, x, codes, **args)),
            plain_device=cpu)
        out[kind]["full_differs"] = scorer_compare(
            f"{tag} K3w {kind} at all n")(full[-1][picked].cpu(), want[-1])
        del full, want
        out[kind].update(tasks=plan.num_tasks, tile=list(tile),
                         max_stage_x=plan.max_stage_x, plain_rows=plain_rows,
                         rows=n)
        del tables, plan, shift
    return out


def phase_epsilon(seed: int) -> dict:
    """[epsilon]: Epsilon's 2,000 columns (MICE: P = 2,003 with the label
    as a column; QDA / NB: P = 2,001). The plans' host seconds; each
    kernel past the shared-memory limits against its plain version on an
    N_EPSILON_SLICE-row slice (K7's two windows with K_j as KB slabs, K2w
    'cat' on the label with x read from device memory and 'num', sort +
    K8 by the label, K6w) and K3w on the local plans against the plain
    scorer on N_SCORER_PLAIN rows on the CPU, each timed at N_EPSILON
    rows beside its bound and the cuBLAS product of the same work; then on
    its first N_EPSILON_MICE rows run_mice_device 'gram' and 'fused' and
    run_mice_wide, one round over the null columns (launches exact,
    imputed numerics below a mean fill's error, the label above its mode
    share + 0.02), scan_gram card against CPU on a slice (launches exact),
    and the QDA and NB pipelines (accuracy above the majority share +
    0.02)."""
    from types import SimpleNamespace

    from duckdb_imputation_tpu_torch import FeatureSchema, run_mice_device
    from duckdb_imputation_tpu_torch.parallel import (make_mesh_2d,
                                                      run_mice_wide)
    from duckdb_imputation_tpu_torch.ring import streaming
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums, nb_grouped_sums_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, masked_gram, masked_gram_cols, masked_gram_cols_plain,
        masked_gram_window)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped \
        import (grouped_gram_presorted, grouped_gram_presorted_plain,
                sort_by_group)

    t_phase = time.perf_counter()
    t, x_true, y = make_epsilon(N_EPSILON, seed + 201)
    schema, n = t.schema, N_EPSILON
    scorer = FeatureSchema(num_cols=EPSILON_D)
    p = schema.sigma_size
    lows = list(range(0, p, _build.WINDOW_WIDTH))
    plans = {}
    for name, fn in (
            ("windows", lambda: [_build.keyed_window_plan(
                schema, lo, min(lo + _build.WINDOW_WIDTH, p))
                for lo in lows]),
            ("qda_plan", lambda: _build.qda_plan(scorer)),
            ("nb_scorer_plan", lambda: _build.qda_plan(scorer, cross=False)),
            ("nb_plan", lambda: _build.nb_plan(scorer, 2))):
        t0 = time.perf_counter()
        fn()
        plans[name] = time.perf_counter() - t0
    log(f"[epsilon] P={p} (scorer {scorer.sigma_size}) n={n}; plans' host "
        f"seconds {plans}")
    out = dict(plans=plans, rows=n, sigma_size=p, mice_rows=N_EPSILON_MICE)

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 202)
    w = (torch.rand(n, generator=g, device=DEVICE) >= 0.2).float()
    xs, cs = list(t.num_data), list(t.cat_codes)
    m = N_EPSILON_SLICE
    sx, sc, sw = [x[:m] for x in xs], [c[:m] for c in cs], w[:m]
    out["dense"] = dense_kernel("[epsilon]", x_true, w, scorer, rows=m)
    out["k7"] = slice_kernel(
        f"[epsilon] K7 ({len(lows)} windows, K_j as KB slabs; D on the "
        f"tensor cores)",
        [(masked_gram_cols, "wide_launches", wide_launches(schema)),
         (dense_gram, "launches", 1)],
        lambda: masked_gram_cols(sx, sc, sw, schema=schema),
        lambda: masked_gram_cols_plain(sx, sc, sw, schema=schema),
        lean_gram_compare("[epsilon] K7", schema),
        gram_bound(t.cat_codes, schema, w),
        library_gram_ms(t.num_data, t.cat_codes, w, schema),
        full=lambda: masked_gram_cols(xs, cs, w, schema=schema))
    for kind, col, r in (("cat", 0, 2), ("num", EPSILON_NULL_COLS[0], 1)):
        w_full = 0.05 * torch.randn(p, r, generator=g, device=DEVICE)
        icpt = torch.randn(r, generator=g, device=DEVICE)
        null = t.cat_null[col] if kind == "cat" else t.num_null[col]
        kw = dict(schema=schema, kind=kind, imp_col=col)
        out[f"k2w_{kind}"] = slice_kernel(
            f"[epsilon] K2w '{kind}' (column {col}, R = {r})",
            [(fused_impute_aggregate, "impute_launches", 1),
             (fused_impute_aggregate, "window_launches",
              wide_launches(schema)), (dense_gram, "launches", 1)],
            lambda: fused_impute_aggregate(sx, sc, null[:m], sw, w_full,
                                           icpt, **kw),
            lambda: fused_impute_aggregate_plain(sx, sc, null[:m], sw,
                                                 w_full, icpt, **kw),
            fused_compare(f"[epsilon] K2w {kind}", schema, kind),
            gram_bound(t.cat_codes, schema, w, extra=9, scores=p * r,
                       scored=int(null.sum())),
            full=lambda: fused_impute_aggregate(xs, cs, null, w, w_full,
                                                icpt, **kw))
    xt, xm = x_true, x_true[:, :m].contiguous()
    none = torch.zeros((0, n), dtype=torch.int32, device=DEVICE)
    nm, ym = none[:, :m], y[:m]
    out["k8"] = slice_kernel(
        f"[epsilon] sort + K8 by the label (P = {scorer.sigma_size}; D on "
        f"the tensor cores, K8 no task)",
        [(grouped_gram_presorted, "wide_launches", wide_launches(scorer)),
         (dense_gram, "launches", 1)],
        lambda: grouped_gram_presorted(*sort_by_group(
            xm, nm, ym, schema=scorer, num_groups=2, weights=sw),
            schema=scorer),
        lambda: grouped_gram_presorted_plain(*sort_by_group(
            xm, nm, ym, schema=scorer, num_groups=2, weights=sw),
            schema=scorer),
        lambda got, want: max(lean_gram_compare(
            f"[epsilon] K8 group {gg}", scorer)(got[gg], want[gg])
            for gg in range(2)),
        gram_bound(none, scorer, w, groups=2, extra=8),
        full=lambda: grouped_gram_presorted(*sort_by_group(
            xt, none, y, schema=scorer, num_groups=2, weights=w),
            schema=scorer))
    out["k6w"] = slice_kernel(
        f"[epsilon] K6w F={_build.nb_features(scorer)}",
        [(nb_grouped_sums, "launches", 1)],
        lambda: nb_grouped_sums(xm, nm, None, ym, schema=scorer,
                                num_groups=2),
        lambda: nb_grouped_sums_plain(xm, nm, None, ym, schema=scorer,
                                      num_groups=2),
        nb_compare("[epsilon] K6w", scorer), nb_bound(n, scorer, 2),
        library_nb_ms(xt, none, None, y, scorer, 2),
        full=lambda: nb_grouped_sums(xt, none, None, y, schema=scorer,
                                     num_groups=2))
    out.update(scorer_kernels("[epsilon]", xt, scorer, 2, seed + 203,
                              N_SCORER_PLAIN))
    del sx, sc, sw, xs, cs, w, xm

    # the MICE loops, one round over the 5 null columns, and the
    # pipelines, on the first N_EPSILON_MICE rows
    k = N_EPSILON_MICE
    t = null_table(x_true[:, :k].contiguous(), y[None, :k].contiguous(),
                   t.num_null[:, :k].contiguous(),
                   t.cat_null[:, :k].contiguous(), schema)
    x_true, y = x_true[:, :k].contiguous(), y[:k].contiguous()
    torch.cuda.empty_cache()
    steps = len(EPSILON_NULL_COLS) + 1
    windows = wide_launches(schema)
    for kernel in ("gram", "fused"):
        kernel_counts_reset()
        t1 = time.perf_counter()
        res = run_mice_device(t, iters=1, kernel=kernel)
        torch.cuda.synchronize()
        counts = kernel_counts()
        # 'gram': S in its windows a column step; 'fused': S once, then
        # an impute launch and S's windows a column step; D by the D
        # kernel once a Gram
        want = ({"masked_gram_cols.wide_launches": steps * windows,
                 "dense_gram.launches": steps}
                if kernel == "gram" else
                {"masked_gram_cols.wide_launches": windows,
                 "fused_impute_aggregate.impute_launches": steps,
                 "fused_impute_aggregate.window_launches": steps * windows,
                 "dense_gram.launches": 1 + steps})
        check(counts == want, f"[epsilon] run_mice_device {kernel}: "
              f"launches {counts}, not {want}")
        log(f"[epsilon] run_mice_device '{kernel}' n={k} 1 round x {steps} "
            f"columns: launches {counts}, {time.perf_counter() - t1:.2f} s")
        out[f"mice_{kernel}"] = dict(
            seconds=time.perf_counter() - t1, launches=counts,
            **many_quality(f"[epsilon] {kernel}", t, x_true, y[None], res))
        del res
        torch.cuda.empty_cache()
    masked_gram_window.launches = 0
    t1 = time.perf_counter()
    xw, cw = run_mice_wide(
        t.num_data, t.cat_codes, t.num_null, t.cat_null, schema=schema,
        mesh=make_mesh_2d(1, 1, device=DEVICE), iters=1, ridge=1e-2,
        shrinkage=1e-1, cg_iters=150, tol=1e-6)
    torch.cuda.synchronize()
    check(masked_gram_window.launches == steps,
          f"[epsilon] run_mice_wide: {masked_gram_window.launches} K7 "
          f"window launches, not {steps} (one a column step)")
    out["run_mice_wide"] = dict(
        seconds=time.perf_counter() - t1,
        window_launches=masked_gram_window.launches,
        **many_quality("[epsilon] run_mice_wide", t, x_true, y[None],
                       SimpleNamespace(num_data=xw, cat_codes=cw)))
    log(f"[epsilon] run_mice_wide 1 x 1 n={k}: "
        f"{out['run_mice_wide']['seconds']:.2f} s, "
        f"{masked_gram_window.launches} K7 window launches")
    del xw, cw
    torch.cuda.empty_cache()

    # the stream fold on a slice's complete rows (no nulls, so the fold's
    # schema is Epsilon's own and shares its plans)
    f = N_EPSILON_SLICE // 4
    num = x_true[:, :f].cpu().numpy()
    cat = y[None, :f].cpu().numpy().astype(np.int64)
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=f // 2)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    masked_gram.wide_launches = 0
    t1 = time.perf_counter()
    gram = streaming.scan_gram(src, ss, chunk_rows=f // 2, device=DEVICE)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t1
    check(masked_gram.wide_launches == 2 * windows,
          f"[epsilon] scan_gram: {masked_gram.wide_launches} K7 launches, "
          f"not {2 * windows} (S's windows a chunk, 2 chunks)")
    cpu_gram = streaming.scan_gram(src, ss, chunk_rows=f // 2, device="cpu")
    err = float((gram.cpu() - cpu_gram).abs().max() / cpu_gram.abs().max())
    check(err <= 1e-6, f"[epsilon] fold card vs CPU rel err {err}")
    out["scan_gram"] = dict(rows=f, sigma_size=gram.shape[0],
                            launches=masked_gram.wide_launches,
                            seconds=scan_s, max_rel_err=err)
    log(f"[epsilon] scan_gram P+K={gram.shape[0]} n={f}: "
        f"{masked_gram.wide_launches} K7 window launches, {scan_s:.2f} s; "
        f"card vs CPU max rel err {err:.2e}")
    del gram, cpu_gram, num, cat

    cls = classify_many("[epsilon] label", x_true, none[:, :k], y, scorer)
    out["classify"] = {k_: dict(acc=v["acc"], launches=v["launches"],
                                seconds=v["seconds"], rows=k)
                       for k_, v in cls.items()}
    del t, x_true, y, cls, xt
    _build.plan_cache.clear()
    from duckdb_imputation_tpu_torch.ring.kernels import sigma_pallas
    sigma_pallas._device_plan.cache_clear()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[epsilon] {out['seconds']:.1f} s in all")
    return out


def phase_mnist(seed: int) -> dict:
    """[mnist]: MNIST's 784 pixels over 10 classes (P = 785) at its 70,000
    rows: K3w on the scorer's local plans (seeded QDA and NB tables)
    against the plain scorer on N_MNIST_PLAIN rows on the CPU, timed at all
    rows; K8's D, the D kernel over the rows sorted by digit (10 groups),
    against its plain version; the QDA and NB pipelines (sort + K8, which
    past the crossover is the D kernel alone here, K6w, K3w: launches
    exact, accuracy above the majority share + 0.02)."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped \
        import sort_by_group

    t0 = time.perf_counter()
    x, y = make_mnist(N_MNIST, seed + 211)
    schema = FeatureSchema(num_cols=784)
    t1 = time.perf_counter()
    _build.qda_plan(schema)
    _build.qda_plan(schema, cross=False)
    plans = time.perf_counter() - t1
    log(f"[mnist] P={schema.sigma_size} n={N_MNIST}: zero pixels "
        f"{float((x == 0).float().mean()):.3f}; scorer plans' host seconds "
        f"{plans:.2f}")
    out = dict(rows=N_MNIST, plans=plans)
    out.update(scorer_kernels("[mnist]", x, schema, 10, seed + 212,
                              N_MNIST_PLAIN))
    none = torch.zeros((0, N_MNIST), dtype=torch.int32, device=DEVICE)
    # K8's D: the D kernel over the rows sorted by digit, 10 groups
    xs_, _, ws_, layout = sort_by_group(x, none, y, schema=schema,
                                        num_groups=10)
    out["k8_dense"] = dense_kernel("[mnist] K8's", xs_, ws_, schema,
                                   offsets=layout.offsets)
    del xs_, ws_, layout
    cls = classify_many("[mnist] digit", x, none, y, schema, classes=10)
    out["classify"] = {k: dict(acc=v["acc"], launches=v["launches"],
                               seconds=v["seconds"])
                       for k, v in cls.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"[mnist] {out['seconds']:.1f} s in all")
    return out


def phase_past_smem(seed: int) -> dict:
    """[past_smem]: two test schemas at N_PAST_SMEM rows, one past the old
    limits each. d900_r33 (900 numeric columns, one of 33 levels, P =
    934): K7's whole plan with K_j as KB slabs, and K2w 'cat' on the
    33-level column (W whole in shared memory, each row's x read from
    device memory); d1000_v5000 (1,000 numeric columns, one of 5,000
    levels, P = 6,001): the order pass of the keyed column (rows of 1,008
    ints copied in pieces) and K7's six windows over it. Each against its
    plain version on the card."""
    from duckdb_imputation_tpu_torch import FeatureSchema
    from duckdb_imputation_tpu_torch.ring.kernels import _build
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
        fused_impute_aggregate, fused_impute_aggregate_plain)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, masked_gram_cols, masked_gram_cols_plain, window_order)

    t0 = time.perf_counter()
    n, out = N_PAST_SMEM, {}
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 221)
    w = (torch.rand(n, generator=g, device=DEVICE) >= 0.2).float()
    for name, d, v in (("d900_r33", 900, 33), ("d1000_v5000", 1000, 5000)):
        # d1000_v5000's codes uniform (a factor model's argmax over 5,000
        # levels would hold 5,000 × n floats), a tenth of them one hot key
        x, codes, _ = factor_table(n, d, (v,) if v < 100 else (),
                                   seed + 222 + d, 0.3)
        if v >= 100:
            codes = torch.randint(0, v, (1, n), generator=g, device=DEVICE,
                                  dtype=torch.int32)
            codes[0, torch.rand(n, generator=g, device=DEVICE) < 0.1] = 7
        schema = FeatureSchema(num_cols=d, cat_keys=(tuple(range(v)),))
        xs, cs = list(x), list(codes)
        p = schema.sigma_size
        windows = (1 if p <= _build.MAX_WIDE_SIGMA_SIZE
                   else -(-p // _build.WINDOW_WIDTH))
        t1 = time.perf_counter()
        if windows == 1:
            _build.wide_plan(schema)
        else:
            for lo in range(0, p, _build.WINDOW_WIDTH):
                _build.keyed_window_plan(schema, lo,
                                         min(lo + _build.WINDOW_WIDTH, p))
        plans = time.perf_counter() - t1
        log(f"[past_smem] {name} P={p} n={n}: plans' host seconds "
            f"{plans:.2f}")
        res = dict(plans=plans, sigma_size=p)
        counters = [(masked_gram_cols, "wide_launches",
                     wide_launches(schema))]
        if windows > 1:
            counters.append((window_order, "passes", 1))
            stride = _build.order_stride(1 + d + 1)
            piece = _build.order_piece(v, stride)
            check(piece < stride, f"[past_smem] {name}: rows of {stride} "
                  f"ints are not copied in pieces")
            res["order"] = order_check(f"[past_smem] {name} order", xs, cs,
                                       w, schema, (0,))
            res["order"].update(stride=stride, piece=piece)
        counters.append((dense_gram, "launches", 1))
        res["dense"] = dense_kernel(f"[past_smem] {name}", xs, w, schema)
        res["k7"] = slice_kernel(
            f"[past_smem] {name} K7 ({windows} launch(es); D on the tensor "
            f"cores)", counters,
            lambda: masked_gram_cols(xs, cs, w, schema=schema),
            lambda: masked_gram_cols_plain(xs, cs, w, schema=schema),
            lean_gram_compare(f"[past_smem] {name} K7", schema),
            gram_bound(codes, schema, w),
            library_gram_ms(x, codes, w, schema) if windows == 1 else None)
        if windows == 1:
            null = torch.rand(n, generator=g, device=DEVICE) < 0.2
            w_full = 0.05 * torch.randn(p, v, generator=g, device=DEVICE)
            icpt = torch.randn(v, generator=g, device=DEVICE)
            ld, _, batch = _build.impute_plan(schema, v)
            check(not _build.impute_x_terms(schema, ld, batch),
                  f"[past_smem] {name}: K2w keeps x in shared memory")
            kw = dict(schema=schema, kind="cat", imp_col=0)
            res["k2w"] = slice_kernel(
                f"[past_smem] {name} K2w 'cat' (R = {v}, plan {ld}, "
                f"{batch} rows a batch, x from device memory)",
                [(fused_impute_aggregate, "wide_launches", 1),
                 (dense_gram, "launches", 1)],
                lambda: fused_impute_aggregate(xs, cs, null, w, w_full,
                                               icpt, **kw),
                lambda: fused_impute_aggregate_plain(xs, cs, null, w, w_full,
                                                     icpt, **kw),
                fused_compare(f"[past_smem] {name} K2w", schema, "cat"),
                gram_bound(codes, schema, w, extra=5, scores=p * v,
                           scored=int(null.sum())))
        out[name] = res
        del x, codes, xs, cs
        _build.plan_cache.clear()
        from duckdb_imputation_tpu_torch.ring.kernels import sigma_pallas
        sigma_pallas._device_plan.cache_clear()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[past_smem] {out['seconds']:.1f} s in all")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # a rank of [sharded2], spawned by phase_sharded2 itself
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-dir", help=argparse.SUPPRESS)
    # a rank of [wide_v2], spawned by phase_wide_v2 (with --sharded-dir)
    ap.add_argument("--wide-rank", type=int, help=argparse.SUPPRESS)
    # a rank of [overlap]'s two-rank cell (with --sharded-dir)
    ap.add_argument("--overlap-rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sharded_rank is not None:
        return sharded_rank(args.sharded_rank, 2, args.sharded_dir,
                            args.seed)
    if args.wide_rank is not None:
        return wide_rank(args.wide_rank, args.sharded_dir, args.seed)
    if args.overlap_rank is not None:
        return overlap_rank(args.overlap_rank, args.sharded_dir, args.seed)

    card = phase_device()
    phase_build()
    device_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    k1 = phase_k1(args.seed)
    k1s, k1s_launches = phase_k1_stacked(args.seed)
    k2 = phase_k2(args.seed)
    k4 = phase_k4(args.seed)
    k5 = phase_k5(args.seed)
    k6 = phase_k6(args.seed)
    k3 = phase_k3(args.seed)
    phase_reference(args.seed)
    launches = phase_main_path(args.seed)
    launches.update(phase_classify(args.seed))
    phase_noise(args.seed)
    phase_tf32(args.seed)
    phase_deploy(args.seed)
    k7 = phase_k7(args.seed)
    k2w = phase_k2w(args.seed)
    wide = phase_wide(args.seed)
    delta = phase_delta(args.seed)
    host = phase_host_mice(args.seed)
    host_wide = phase_host_mice_wide(args.seed)
    gd = phase_gd(args.seed)
    k8 = phase_k8(args.seed)
    k6w = phase_k6w(args.seed)
    k3w = phase_k3w(args.seed)
    classify_wide = phase_classify_wide(args.seed)
    factorized = phase_factorized(args.seed)
    star = phase_star(args.seed)
    sharded = phase_sharded_all(args.seed)
    stream = phase_stream(args.seed)
    for phase in (phase_stream_csv, phase_stream_spill, phase_stream_ckpt):
        stream = add_counts(stream, phase(args.seed))
    k7win = phase_k7win(args.seed)
    items = phase_items(args.seed)
    items_fused = phase_items_fused(items["run"])
    sharded_items = phase_sharded_items(items["run"], items_fused)
    del items["run"], items_fused["out"]
    k2w_items = phase_k2w_items(args.seed)
    k8win = phase_k8win(args.seed)
    k3items = phase_k3items(args.seed)
    classify_items = phase_classify_items(args.seed)
    wide_v = phase_wide_v(args.seed, k7win["wide16k"]["rows"])
    sql_mice = phase_sql(args.seed, card)
    sql_classify = phase_sql_classify(args.seed, card)
    overlap = phase_overlap(args.seed)
    narrow_many = phase_narrow_many(args.seed)
    home_credit = phase_home_credit(args.seed)
    secom = phase_secom(args.seed)
    criteo = phase_criteo(args.seed)
    zip5 = phase_zip5(args.seed)
    epsilon = phase_epsilon(args.seed)
    mnist = phase_mnist(args.seed)
    past_smem = phase_past_smem(args.seed)
    hck, sek = home_credit["kernels"], secom["kernels"]
    v5000, d900 = past_smem["d1000_v5000"], past_smem["d900_r33"]
    criteo_c18 = {k: v for k, v in criteo.items()
                  if k not in ("k8", "k2w", "order")}
    n80, n70 = narrow_many["d80"], narrow_many["d70"]

    src = "duckdb_imputation_tpu_torch/csrc/"
    ref = "duckdb_imputation_tpu/ring/kernels/"
    kernels = [
        dict(name="masked_gram_cols", route="cuda",
             source=src + "masked_gram.cu",
             replaces=ref + "sigma_pallas.py:888",
             launches=launches["masked_gram_cols"],
             delta_launches=delta["masked_gram_cols"],
             gd_launches=gd["masked_gram_cols"],
             sharded_launches=sharded["masked_gram_cols"],
             stream_launches=stream["masked_gram_cols"],
             narrow80=n80["gram"], narrow70c2=n70["gram"], **k1),
        dict(name="masked_gram", route="cuda",
             source=src + "masked_gram.cu",
             replaces=ref + "sigma_pallas.py:109",
             launches=k1s_launches, host_launches=host,
             star_launches=star["masked_gram"],
             sharded_launches=sharded["masked_gram"],
             stream_launches=stream["masked_gram"],
             sql_launches=sql_mice["launches"]
             + sql_classify["qda"]["launches"].get("masked_gram.launches", 0),
             **k1s),
        dict(name="fused_impute_aggregate", route="cuda",
             source=src + "fused_impute_aggregate.cu",
             replaces=ref + "sigma_fused.py:413",
             launches=launches["fused_impute_aggregate"],
             sharded_launches=sharded["fused_impute_aggregate"],
             narrow80=n80["fused_num79"], narrow70c2=n70["fused_cat1"],
             **k2),
        dict(name="qda_predict_kernel", route="cuda",
             source=src + "qda_predict.cu",
             replaces=ref + "qda_pallas.py:148",
             launches=launches["qda_predict_kernel"],
             narrow80=n80["qda"], narrow70c2=n70["qda"], **k3),
        dict(name="grouped_gram", route="cuda",
             source=src + "grouped_gram.cu",
             replaces=ref + "sigma_pallas_grouped.py:121",
             launches=launches["grouped_gram"],
             factorized_launches=factorized["grouped_gram"],
             sharded_launches=sharded["grouped_gram"],
             narrow80=n80["k4"], narrow70c2=n70["k4"], **k4),
        dict(name="grouped_gram_presorted", route="cuda",
             source=src + "grouped_gram.cu",
             replaces=ref + "sigma_pallas_grouped.py:568",
             launches=launches["grouped_gram_presorted"],
             factorized_launches=factorized["grouped_gram_presorted"],
             sharded_launches=sharded["grouped_gram_presorted"],
             g4100=factorized["alone"]["k5"], narrow80=n80["grouped"],
             narrow70c2=n70["grouped"], **k5),
        dict(name="nb_grouped_sums", route="cuda",
             source=src + "nb_grouped_sums.cu",
             replaces=ref + "nb_pallas.py:126",
             launches=launches["nb_grouped_sums"],
             star_launches=star["nb_grouped_sums"],
             sql_launches=sql_classify["nb"]["launches"].get(
                 "nb_grouped_sums.launches", 0), narrow80=n80["nb"],
             narrow70c2=n70["nb"], **k6),
        dict(name="wide_gram", route="cuda", source=src + "wide_gram.cu",
             replaces=ref + "sigma_pallas.py:501",
             launches=wide["wide_gram"], delta_launches=delta["wide_gram"],
             host_launches=host_wide, gd_launches=gd["wide_gram"],
             star_launches=star["wide_gram"],
             sharded_launches=sharded["wide_gram"],
             stream_launches=stream["wide_gram"],
             home_credit=dict(hck["gram"], plans=home_credit["plans"]),
             secom=dict(sek["gram"], plans=secom["plans"]),
             d900_r33=dict(d900["k7"], plans=d900["plans"]), **k7),
        # K7 over column windows past P = 1,024 (favorita_items): the
        # residual plan over all rows and the keyed tasks over the rows in
        # their column's order; wide16k's windows and the hot key beside
        dict(name="wide_gram_window", route="cuda",
             source=src + "wide_gram.cu",
             replaces=ref + "sigma_pallas.py:911",
             launches=items["launches"],
             order_passes=items["order_passes"],
             wide_v_launches=wide_v["wide_v_launches"],
             window_launches=wide_v["window_launches"],
             overlap_launches=overlap["launches"],
             also_replaces=[ref + "sigma_pallas.py:520",
                            ref + "sigma_pallas.py:129"],
             secom_fold=dict(secom["fold"], plans=secom["plans"]),
             criteo_c18=criteo_c18,
             epsilon=dict(epsilon["k7"], plans=epsilon["plans"],
                          mice={k: epsilon[k] for k in (
                              "mice_gram", "mice_fused", "run_mice_wide",
                              "scan_gram")}),
             d1000_v5000=dict(v5000["k7"], plans=v5000["plans"]),
             wide16k=k7win["wide16k"], hot_key=k7win["hot_key"],
             **k7win["favorita_items"]),
        # the windows' row order, favorita_items' pass; wide16k's beside.
        # It replaces no TPU kernel: it serves the keyed tasks of the
        # window kernel above
        dict(name="window_order", route="cuda",
             source=src + "window_order.cu",
             replaces=None, serves="wide_gram_window",
             launches=items["order_launches"],
             passes=items["order_passes"],
             wide16k=k7win["wide16k"]["order"], criteo_c18=criteo["order"],
             d1000_v5000=v5000["order"],
             **k7win["favorita_items"]["order"]),
        dict(name="fused_impute_aggregate_wide", route="cuda",
             source=src + "fused_impute_aggregate.cu",
             replaces=ref + "sigma_fused.py:509",
             launches=wide["fused_impute_aggregate_wide"],
             sharded_launches=sharded["fused_impute_aggregate_wide"],
             home_credit={k: v for k, v in hck.items()
                          if k.startswith("fused")},
             secom=sek["fused_num589"], d900_r33=d900["k2w"], **k2w),
        dict(name="grouped_wide_gram", route="cuda",
             source=src + "grouped_wide_gram.cu",
             replaces=ref + "sigma_pallas_grouped.py:540",
             launches=classify_wide["grouped_wide_gram"],
             factorized_launches=factorized["grouped_wide_gram"],
             g4100=factorized["alone"]["k8"], home_credit=hck["grouped"],
             secom=sek["grouped"], mnist_launches=mnist["classify"]["qda"][
                 "launches"], **k8),
        dict(name="nb_grouped_sums_wide", route="cuda",
             source=src + "nb_grouped_sums.cu",
             replaces=ref + "nb_pallas.py:126",
             launches=classify_wide["nb_grouped_sums_wide"],
             home_credit=hck["nb"], secom=sek["nb"],
             zip5=dict(ms=zip5["nb"]["k6w_ms"], launches=zip5["nb"][
                 "launches"][0], rows=zip5["nb"]["rows"],
                 **zip5["nb"]["k6w_bound"]), epsilon=epsilon["k6w"],
             mnist_launches=mnist["classify"]["nb"]["launches"], **k6w),
        dict(name="qda_predict_wide", route="cuda",
             source=src + "qda_predict.cu",
             replaces=ref + "qda_pallas.py:148",
             launches=classify_wide["qda_predict_wide"],
             home_credit=hck["qda"], secom=sek["qda"],
             epsilon=epsilon["qda"], epsilon_nb=epsilon["nb"],
             mnist=mnist["qda"], mnist_nb=mnist["nb"],
             classify={"epsilon": epsilon["classify"],
                       "mnist": mnist["classify"]}, **k3w),
        # past P = 1,024 (favorita_items): K2w's impute kernel with W in
        # device memory and K7's windows, K8 a window, K3w on the plans
        # whose item cross tables are keyed on the item
        dict(name="fused_impute_aggregate_window", route="cuda",
             source=src + "fused_impute_aggregate.cu",
             replaces=ref + "sigma_fused.py:447",
             launches=items_fused["launches"][
                 "fused_impute_aggregate.impute_launches"],
             window_launches=items_fused["launches"][
                 "fused_impute_aggregate.window_launches"],
             sharded_launches=sharded_items["launches"][
                 "fused_impute_aggregate.impute_launches"],
             criteo_c18=criteo["k2w"], epsilon=epsilon["k2w_cat"],
             epsilon_num=epsilon["k2w_num"], **k2w_items),
        dict(name="grouped_wide_gram_window", route="cuda",
             source=src + "grouped_wide_gram.cu",
             replaces=ref + "sigma_pallas_grouped.py:568",
             launches=classify_items["qda"]["aggregate_launches"][
                 "grouped_gram_presorted.wide_launches"],
             criteo_c18=criteo["k8"], epsilon=epsilon["k8"], **k8win),
        dict(name="qda_predict_items", route="cuda",
             source=src + "qda_predict.cu",
             replaces=ref + "qda_pallas.py:173",
             launches=sum(p.get("launches", {}).get(
                 "qda_predict_kernel.wide_launches", 0)
                 for p in classify_items.values()),
             criteo_pair=zip5["k3w_criteo_pair"], zip5=zip5["k3w_zip5"],
             zip5_nb={k: v for k, v in zip5["nb"].items()
                      if k != "k6w_bound"}, **k3items),
        # D of K7, K8 and K2w past the crossover (_build.dense_route) on the
        # tensor cores: the D block of the Pallas kernels' bf16 splits;
        # launches from [epsilon]'s run_mice_device 'gram' and 'fused'
        dict(name="dense_gram", route="cuda", source=src + "dense_gram.cu",
             replaces=ref + "sigma_pallas.py:247",
             also_replaces=[ref + "sigma_pallas.py:520",
                            ref + "sigma_pallas.py:911"],
             launches=sum(epsilon[k]["launches"].get("dense_gram.launches",
                                                     0)
                          for k in ("mice_gram", "mice_fused")),
             home_credit=hck["dense"], secom=sek["dense"],
             d900_r33=d900["dense"], d1000_v5000=v5000["dense"],
             mnist_k8=mnist["k8_dense"], **epsilon["dense"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
