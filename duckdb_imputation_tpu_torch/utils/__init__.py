from .profiling import PhaseTimer, device_trace
from .checkpoint import (
    MiceCheckpointer,
    StreamCheckpointer,
    load_table,
    load_table_arrays,
    run_fingerprint,
    save_table,
    table_checksum,
)
from .validate import TripleValidationError, validate_nb, validate_triple

__all__ = ["PhaseTimer", "device_trace", "MiceCheckpointer",
           "StreamCheckpointer", "load_table", "load_table_arrays", "run_fingerprint", "save_table",
           "table_checksum", "TripleValidationError", "validate_nb",
           "validate_triple"]
