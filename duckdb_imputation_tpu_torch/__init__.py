"""duckdb_imputation_tpu_torch — the PyTorch/CUDA port of duckdb_imputation_tpu.

The JAX package `duckdb_imputation_tpu` stays the reference; this package
re-implements it slice by slice in PyTorch, with a hand-written CUDA kernel
for Hopper (sm_90a) wherever the JAX package has a Pallas kernel. It
imports torch and never jax. Ported so far:

- the single-device MICE loops (`mice.device_round`: unfused, fused and
  the compact delta loop) with the masked-Gram kernels (K1, and K7 for
  P > 88, `ring.kernels.sigma_pallas`) and the fused impute+aggregate
  kernels (K2, and K2w for P > 88, `ring.kernels.sigma_fused`);
- the classifier path: triples (`ring.triple`), grouped and NB
  aggregation (`ring.sum`) over the grouped Gram kernels (K4 unsorted, K5
  sorted, `ring.kernels.sigma_pallas_grouped`) and the NB sums kernel (K6,
  `ring.kernels.nb_pallas`), device QDA/NB training and one-pass QDA
  scoring (`models.device`, K3 in `ring.kernels.qda_pallas`).
"""

from .schema import FeatureSchema
from .table import Table, from_numpy, from_reference
from .mice import init_fill, run_mice_device, run_mice_device_delta

__version__ = "0.1.0"

__all__ = ["FeatureSchema", "Table", "from_numpy", "from_reference",
           "init_fill", "run_mice_device", "run_mice_device_delta"]
