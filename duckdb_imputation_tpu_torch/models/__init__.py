from .device import (
    linreg_solve_device,
    lstsq_min_norm,
    nb_predict_device,
    nb_train_device,
    qda_predict_device,
    qda_train_device,
)

__all__ = ["linreg_solve_device", "lstsq_min_norm", "nb_predict_device",
           "nb_train_device", "qda_predict_device", "qda_train_device"]
