"""Timing, precision, checkpoints and validation.

`precision` and `profiling` import torch alone; the modules that import
other parts of the package (`checkpoint`, `validate`) load when one of
their names is first read, so that any module of the package can take
`ieee_f32` from here while the package is still being imported."""
import importlib

from .precision import ieee_f32
from .profiling import PhaseTimer, device_trace

_LAZY = {"MiceCheckpointer": "checkpoint", "StreamCheckpointer": "checkpoint",
         "load_table": "checkpoint", "load_table_arrays": "checkpoint",
         "run_fingerprint": "checkpoint", "save_table": "checkpoint",
         "table_checksum": "checkpoint",
         "TripleValidationError": "validate", "validate_nb": "validate",
         "validate_triple": "validate"}


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["PhaseTimer", "device_trace", "ieee_f32", *_LAZY]
