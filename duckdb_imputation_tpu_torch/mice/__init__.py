from .partition import init_fill
from .device_round import (
    mice_loop_device,
    mice_loop_device_fused,
    mice_round_device,
    run_mice_device,
)

__all__ = ["init_fill", "mice_loop_device", "mice_loop_device_fused",
           "mice_round_device", "run_mice_device"]
