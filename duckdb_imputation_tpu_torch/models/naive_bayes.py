"""Gaussian + categorical Naive Bayes trained from per-class NB aggregates.

Counterpart of `duckdb_imputation_tpu.models.naive_bayes`. Train follows
`ML::nb_train` (naive_bayes.cpp:10-143), in f64 on the host: per class
prior N_c/N; per numeric column mean lin/N_c and variance quad/N_c − mean²
(:111-117), clamped at 0; per categorical column the per-category
frequency count/N_c scattered through the dictionary (:121-136).

The clamp is a divergence that fixes a reference fault: Σx²/N_c − mean²
of a column constant within a class cancels to a small negative number
even from exact sums rounded once to the f32 NBAgg sections, and a
negative var + 1e-9 makes that class's probability NaN in predict (the
running maximum below never takes a NaN, so the class is never chosen).
`models.device.nb_train_device` clamps the same way.

Flat float32 layout:

  [ n_classes,
    size_idxs               (= n_cat+1 if cats else 0),
    (cat_vars_idxs — n_cat+1 values, cat_values — V,)?
    label values            (n_classes),
    priors                  (n_classes),
    { (mean, var) × num col, freqs × V } × class ]

NOTE on the per-class freq offset: the reference's train writes categorical
frequencies starting n_classes slots earlier (naive_bayes.cpp:122) than its
own predictor parses them (:190-211, 230-244). The layout follows the
PREDICT parser (freqs directly after each class's (mean, var) block), so
train and predict are self-consistent.

Predict (nb_impute, :153-263) batched on the device of the features:
product of prior × gaussian pdf (variance += 1e-9, :222-227) × categorical
frequency; a category unseen in training zeroes the probability
(:236-243). The running maximum starts at 0 and is replaced only by a
strictly larger probability (:215-251), so a row whose probabilities are
all 0 gets class 0 and a tie goes to the lower class. Returns the actual
LABEL VALUE.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ring.triple import NBAgg
from ..schema import FeatureSchema


def nb_train(aggs: NBAgg, schema: FeatureSchema, labels) -> np.ndarray:
    """`nb_train(list_of_nb_aggs, labels)`: aggs batched over the class axis."""
    labels = np.asarray(labels)
    n_classes = int(labels.shape[0])

    def host(a):
        return a.detach().cpu().numpy().astype(np.float64)

    n, lin = host(aggs.n), host(aggs.lin)
    quad, lin_cat = host(aggs.quad_diag), host(aggs.lin_cat)
    tot = float(n.sum())

    out: list[float] = [float(n_classes)]
    if schema.cat_cols > 0:
        out.append(float(schema.cat_cols + 1))
        out.extend(float(x) for x in schema.offsets)
        out.extend(float(k) for k in schema.keys_flat())
    else:
        out.append(0.0)
    out.extend(float(x) for x in labels)
    out.extend(float(n[c] / tot) for c in range(n_classes))
    # Zero-count class guard: prior = 0 already makes the class
    # unpredictable (nb_impute multiplies probabilities, naive_bayes.cpp:
    # 215-251); clamp the divisor so mean/var/freqs are 0 instead of NaN.
    n_safe = np.maximum(n, 1.0)
    for c in range(n_classes):
        for j in range(schema.num_cols):
            mean = lin[c, j] / n_safe[c]
            var = max(quad[c, j] / n_safe[c] - mean * mean, 0.0)
            out.append(float(mean))
            out.append(float(var))
        out.extend(float(x / n_safe[c]) for x in lin_cat[c])
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True)
class NBParams:
    n_classes: int
    offsets: np.ndarray
    cat_keys: np.ndarray
    labels: np.ndarray
    priors: np.ndarray     # f64[C]
    mean: np.ndarray       # f64[C, d]
    var: np.ndarray        # f64[C, d]
    freqs: np.ndarray      # f64[C, V]

    @staticmethod
    def decode(params: np.ndarray, num_cols: int) -> "NBParams":
        params = np.asarray(params, np.float64)
        n_classes = int(params[0])
        size_idxs = int(params[1])
        i = 2
        if size_idxs > 0:
            offsets = params[i:i + size_idxs].astype(np.int64)
            i += size_idxs
            v = int(offsets[-1])
            cat_keys = params[i:i + v].astype(np.int64)
            i += v
        else:
            offsets = np.zeros(1, np.int64)
            cat_keys = np.zeros(0, np.int64)
            v = 0
        labels = params[i:i + n_classes].astype(np.int64); i += n_classes
        priors = params[i:i + n_classes]; i += n_classes
        mean = np.zeros((n_classes, num_cols))
        var = np.zeros((n_classes, num_cols))
        freqs = np.zeros((n_classes, v))
        for c in range(n_classes):
            mv = params[i:i + 2 * num_cols].reshape(num_cols, 2)
            mean[c], var[c] = mv[:, 0], mv[:, 1]
            i += 2 * num_cols
            freqs[c] = params[i:i + v]; i += v
        return NBParams(n_classes, offsets, cat_keys, labels, priors,
                        mean, var, freqs)


def nb_predict(params: np.ndarray, x_num, codes=None) -> torch.Tensor:
    """Batched `nb_predict(params, normalize, cols…)` → i64[n] label VALUES
    on x_num's device.

    x_num f32[d, n] features-first; codes i32[c, n] LOCAL codes against the
    training vocab; code == column size (unseen) zeroes the row's
    probability for every class."""
    x_num = torch.as_tensor(x_num, dtype=torch.float32)
    dev = x_num.device
    p = NBParams.decode(params, x_num.shape[0])
    v = len(p.cat_keys)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    mean = f32(p.mean)                               # [C, d]
    var = f32(p.var) + 1e-9
    # gaussian pdf product over numeric cols, classes × rows
    x = x_num[None, :, :]                            # [1, d, n]
    pdf = (1.0 / torch.sqrt(2.0 * math.pi * var)[:, :, None]
           * torch.exp(-(x - mean[:, :, None]) ** 2
                       / (2.0 * var)[:, :, None]))   # [C, d, n]
    prob = f32(p.priors)[:, None] * torch.prod(pdf, dim=1)   # [C, n]
    if v > 0 and codes is not None:
        codes = torch.as_tensor(codes, device=dev)
        # one zero column past the table takes every miss
        freq_pad = f32(np.concatenate([p.freqs, np.zeros((p.n_classes, 1))],
                                      axis=1))
        for j in range(len(p.offsets) - 1):
            start, end = int(p.offsets[j]), int(p.offsets[j + 1])
            pos = torch.where(codes[j] < end - start, codes[j] + start, v)
            prob = prob * freq_pad[:, pos.long()]
    # the reference's running maximum: starts at 0, replaced on a strictly
    # larger probability
    best_p = torch.zeros_like(prob[0])
    best = torch.zeros(prob.shape[1], dtype=torch.int64, device=dev)
    for c in range(p.n_classes):
        upd = prob[c] > best_p
        best_p = torch.where(upd, prob[c], best_p)
        best = torch.where(upd, c, best)
    return torch.tensor(p.labels, device=dev)[best]
