from .device import linreg_solve_device, lstsq_min_norm

__all__ = ["linreg_solve_device", "lstsq_min_norm"]
