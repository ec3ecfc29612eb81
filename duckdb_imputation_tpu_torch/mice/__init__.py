from .partition import (
    Partitions,
    build_partitions,
    gather_rows,
    init_fill,
    observed_weights,
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

__all__ = ["Partitions", "build_partitions", "build_union_gather",
           "gather_rows", "init_fill", "mice_loop_device",
           "mice_loop_device_delta", "mice_loop_device_fused",
           "mice_round_device", "observed_weights", "run_mice_device",
           "run_mice_device_delta"]
