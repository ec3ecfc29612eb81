from .linear_regression import LinregParams, linreg_predict, linreg_train
from .lda import LDAParams, lda_predict, lda_train
from .qda import QDAParams, qda_predict, qda_train
from .naive_bayes import NBParams, nb_predict, nb_train
from .sigma import build_sigma, class_sums, select_vocab, standardize_sigma
from .io import ModelBundle, load_model, save_model
from .device import (
    linreg_predict_device,
    linreg_solve_device,
    linreg_train_device,
    lstsq_min_norm,
    mice_column_step_device,
    nb_predict_device,
    nb_train_device,
    qda_predict_device,
    qda_train_device,
)

__all__ = [
    "LinregParams", "linreg_predict", "linreg_train",
    "LDAParams", "lda_predict", "lda_train",
    "QDAParams", "qda_predict", "qda_train",
    "NBParams", "nb_predict", "nb_train",
    "build_sigma", "class_sums", "select_vocab", "standardize_sigma",
    "ModelBundle", "load_model", "save_model",
    "linreg_predict_device", "linreg_solve_device", "linreg_train_device",
    "lstsq_min_norm", "mice_column_step_device", "nb_predict_device",
    "nb_train_device", "qda_predict_device", "qda_train_device",
]
