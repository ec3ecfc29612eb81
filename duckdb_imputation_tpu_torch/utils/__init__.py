from .profiling import PhaseTimer, device_trace
from .validate import TripleValidationError, validate_nb, validate_triple

__all__ = ["PhaseTimer", "device_trace", "TripleValidationError",
           "validate_nb", "validate_triple"]
