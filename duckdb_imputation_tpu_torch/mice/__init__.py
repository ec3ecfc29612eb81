from .baseline import run_mice_baseline
from .factorized import run_mice_factorized, run_mice_star
from .low import run_delta_rounds, run_mice_low
from .high import run_mice_high
from .partition import (
    Partitions,
    build_partitions,
    gather_rows,
    init_fill,
    observed_weights,
)
from .sharded_round import run_mice_sharded, run_mice_sharded_delta
from .streaming import (
    StreamImputation,
    impute_csv_stream,
    run_delta_rounds_spill,
    run_mice_stream,
)
from .device_round import (
    build_union_gather,
    mice_loop_device,
    mice_loop_device_delta,
    mice_loop_device_fused,
    mice_round_device,
    run_mice_device,
    run_mice_device_delta,
)

__all__ = ["run_mice_baseline", "run_mice_factorized", "run_mice_star",
           "run_mice_low", "run_mice_high",
           "run_delta_rounds", "Partitions", "build_partitions",
           "build_union_gather", "gather_rows", "init_fill",
           "mice_loop_device", "mice_loop_device_delta",
           "mice_loop_device_fused", "mice_round_device", "observed_weights",
           "run_mice_device", "run_mice_device_delta", "run_mice_sharded",
           "run_mice_sharded_delta", "StreamImputation", "impute_csv_stream",
           "run_delta_rounds_spill", "run_mice_stream"]
