"""duckdb_imputation_tpu_torch — the PyTorch/CUDA port of duckdb_imputation_tpu.

The JAX package `duckdb_imputation_tpu` stays the reference; this package
re-implements it slice by slice in PyTorch, with a hand-written CUDA kernel
for Hopper (sm_90a) wherever the JAX package has a Pallas kernel. It
imports torch and never jax. Ported so far:

- the single-device MICE loops (`mice.device_round`: unfused, fused and
  the compact delta loop) with the masked-Gram kernels (K1, and K7 for
  P > 88, `ring.kernels.sigma_pallas`) and the fused impute+aggregate
  kernels (K2, and K2w for P > 88, `ring.kernels.sigma_fused`); the
  numeric trainer is the direct solve or, in the unfused and delta loops,
  the reference's GD loop on the device (`models.device`);
- the paper's three host MICE algorithms (`mice.baseline`, `mice.low`,
  `mice.high`: full rescan, full − delta, static + delta), aggregating
  through `ring.sum.sum_to_triple` (K1's stacked entry point on a CUDA
  table) and training on the host in f64;
- the host trainers and predictors (`models.linear_regression`, `lda`,
  `qda`, `naive_bayes`, `sigma`), whose flat f32 parameter vectors are
  the JAX package's, and the model bundles (`models.io`) in its `.npz`
  layout;
- the classifier path: triples (`ring.triple`), grouped and NB
  aggregation (`ring.sum`) over the grouped Gram kernels (K4 unsorted, K5
  sorted, `ring.kernels.sigma_pallas_grouped`) and the NB sums kernel (K6,
  `ring.kernels.nb_pallas`), device QDA/NB training and one-pass QDA
  scoring (`models.device`, K3 in `ring.kernels.qda_pallas`);
- the table (`table`: `from_numpy`, `from_pandas`, the write-backs) and
  `utils` (`PhaseTimer`, `device_trace`, triple validation);
- factorized learning over joins: the ring products (`ring.triple`:
  `triple_multiply`, `nb_multiply`, `factorized_join_sum[_nb]`), the
  reference's dict format (`ring.serialize`), star joins over several
  keys (`ring.star`), MICE over a join without materializing it
  (`mice.factorized`: `run_mice_factorized`, `run_mice_star`), and the
  SQL-shaped surface of every ring, model and MICE function (`api`);
- data parallelism over `torch.distributed` (`parallel`: the process
  mesh, `initialize`, `union_vocab`, the row-sharded aggregates and
  `parallel.sum_to_triple_overlapped`, sigma in column stripes of K7
  windows with each stripe's all-reduce issued asynchronously behind the
  next) and the row-sharded MICE loops with checkpoints
  (`mice.sharded_round`: `run_mice_sharded`, `run_mice_sharded_delta`;
  `utils.checkpoint`);
- out-of-core imputation and its front door: the native CSV reader and
  formatter (`table.native`, over `native/columnar.cpp`, built with g++
  into `build/native/`), the streaming fold of the extended Gram on K1 or
  K7 (`ring.streaming`), `run_mice_stream` / `impute_csv_stream` with
  fingerprinted stream checkpoints (`mice.streaming`,
  `utils.checkpoint.StreamCheckpointer`), the command line
  (`python -m duckdb_imputation_tpu_torch.cli`) and the build directories
  and default device (`config`);
- the wide-V path past P = 1,024 (K7 over column windows, `ring.striped`,
  `parallel.sharded2d`, `parallel.wide`), where the fused pass (K2w), the
  grouped Gram (K8) and the scorers (K3/K3w) run too, over K7's window
  plans;
- the SQL front end (`sql`: `sql.connect(device=…)`, the reference's
  statements evaluated in numpy on the host, every aggregate, trainer
  input and predictor on the connection's device).
"""

from .schema import FeatureSchema
from .ring import (
    NBAgg,
    Triple,
    lift,
    nb_lift,
    nb_multiply,
    sigma_from_triple,
    sum_nb_aggs,
    sum_to_nb_agg,
    sum_to_nb_agg_grouped,
    sum_to_triple,
    sum_to_triple_grouped,
    sum_triples,
    triple_add,
    triple_multiply,
    triple_sub,
)
from .table import Table, from_numpy, from_pandas, from_reference, read_csv
from .mice import (
    init_fill,
    run_mice_baseline,
    run_mice_device,
    run_mice_device_delta,
    run_mice_factorized,
    run_mice_high,
    run_mice_low,
    run_mice_sharded,
    run_mice_sharded_delta,
    run_mice_star,
    run_mice_stream,
    impute_csv_stream,
)
from . import parallel, sql

__version__ = "0.1.0"

__all__ = ["FeatureSchema", "NBAgg", "Triple", "lift", "nb_lift",
           "nb_multiply", "sigma_from_triple", "sum_nb_aggs", "sum_to_nb_agg",
           "sum_to_nb_agg_grouped", "sum_to_triple", "sum_to_triple_grouped",
           "sum_triples", "triple_add", "triple_multiply", "triple_sub",
           "Table", "from_numpy", "from_pandas", "from_reference",
           "read_csv", "run_mice_stream", "impute_csv_stream",
           "init_fill", "run_mice_baseline", "run_mice_device",
           "run_mice_device_delta", "run_mice_factorized", "run_mice_high",
           "run_mice_low", "run_mice_sharded", "run_mice_sharded_delta",
           "run_mice_star", "parallel", "sql"]
