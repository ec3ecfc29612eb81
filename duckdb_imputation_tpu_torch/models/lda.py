"""Linear Discriminant Analysis trained from a single cofactor triple.

Counterpart of `duckdb_imputation_tpu.models.lda`. Train follows
`lda_train` (lda.cpp:154-416): build sigma excluding the label's
categorical column, per-class sum vectors straight from the triple's own
categorical sections (build_sum_vector, lda.cpp:58-144, the factorized
GROUP BY label), pooled within-class scatter by subtracting class-mean
outer products (:242-251), shrinkage toward μI (:259-273), /N (:275-279),
least-squares solve cov·W = M (LAPACK dgelsd, numpy's lstsq with
rcond=-1, a machine-precision cutoff, :284-297), intercepts
−½ μ_cᵀw_c + log(N_c/N) (:311-320). Solver precision float64, on the host.

Flat float32 parameter layout (lda.cpp:335-386):

  [ n_classes,
    size_idxs                (= n_cat_vars, but 0 when the label is the only cat),
    (adjusted cat_vars_idxs — n_cat values (label slot skipped),
     cat_values of non-label columns,)?          # if non-label cats exist
    label category values    (n_classes values),
    coef                     (class-major: class c's m values contiguous),
    intercepts               (n_classes),
    (means[1:] — m values)?  ]                   # if normalize

Predict (LDA_impute, lda.cpp:421-590) is batched on the device of the
features: one matmul and the first argmax over all rows; it returns the
0-based CLASS INDEX, not the label value (lda.cpp:575), a reference quirk
kept for parity (QDA/NB return the value).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ring.triple import Triple
from ..schema import FeatureSchema
from ..utils.precision import ieee_f32
from .sigma import (class_sums_host, host_sigma, select_sigma, select_vocab,
                    standardize_sigma)


def lda_train(t: Triple, schema: FeatureSchema, label: int,
              shrinkage: float = 0.0, normalize: bool = False) -> np.ndarray:
    """`lda_train(triple, label, shrinkage, normalize)`; `label` indexes the
    CATEGORICAL columns from 0."""
    full = host_sigma(t)
    sel = select_vocab(schema, exclude_cat=label)
    sigma = select_sigma(full, schema, sel)
    p = sigma.shape[0]
    n_total = full[0, 0]
    sums = class_sums_host(full, schema, label, sel)   # [C, p]
    n_classes = sums.shape[0]

    means = std = None
    if normalize:
        means, std = standardize_sigma(sigma)
        # standardize the class sums too (lda.cpp:206-212)
        for c in range(n_classes):
            sums[c, 1:] = (sums[c, 1:] - means[1:] * sums[c, 0]) / std[1:]

    m = p - 1
    cov = sigma[1:, 1:].copy()
    class_mean = np.zeros((n_classes, m))
    # Zero-count class guard: a class absent under the observed mask keeps
    # a zero mean, adds no scatter and gets log(0) = -inf as its intercept,
    # so argmax never predicts it (the reference builds its class list from
    # the triple, so such a class never exists there, lda.cpp:58-144).
    cnt = np.maximum(sums[:, 0], 1.0)
    for c in range(n_classes):
        cov -= np.outer(sums[c, 1:], sums[c, 1:]) / cnt[c]
        class_mean[c] = sums[c, 1:] / cnt[c]

    mu = np.trace(cov) / m
    cov *= (1.0 - shrinkage)
    cov[np.diag_indices(m)] += shrinkage * mu
    cov /= n_total

    # dgelsd least-squares: cov · W = Mᵀ  (lda.cpp:294-297)
    w, *_ = np.linalg.lstsq(cov, class_mean.T, rcond=-1)   # [m, C]
    with np.errstate(divide="ignore"):
        log_prior = np.log(sums[:, 0] / n_total)
    intercept = (-0.5 * np.einsum("cm,mc->c", class_mean, w) + log_prior)

    if normalize:
        w = w / std[1:, None]

    out: list[float] = [float(n_classes)]
    size_idxs = schema.cat_cols if schema.cat_cols != 1 else 0
    out.append(float(size_idxs))
    offs = schema.offsets
    label_size = offs[label + 1] - offs[label]
    if sel.schema.vocab_size > 0:      # non-label categorical columns exist
        remove = 0
        for i in range(schema.cat_cols + 1):
            if i == label:
                remove = label_size
                continue
            out.append(float(offs[i] - remove))
        for j in sel.kept_cols:
            out.extend(float(k) for k in schema.cat_keys[j])
    out.extend(float(k) for k in schema.cat_keys[label])
    out.extend(float(x) for x in w.T.flatten())            # class-major
    out.extend(float(x) for x in intercept)
    if normalize:
        out.extend(float(x) for x in means[1:])
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True)
class LDAParams:
    n_classes: int
    offsets: np.ndarray     # i64[size_idxs] (or [1] if none)
    cat_keys: np.ndarray    # i64[V'] non-label vocab
    labels: np.ndarray      # i64[C] label category values
    coef: np.ndarray        # f64[m, C]
    intercept: np.ndarray   # f64[C]
    num_means: np.ndarray | None
    cat_means: np.ndarray | None

    @staticmethod
    def decode(params: np.ndarray, num_cols: int, normalize: bool) -> "LDAParams":
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
        labels = params[i:i + n_classes].astype(np.int64)
        i += n_classes
        m = num_cols + v
        coef = params[i:i + m * n_classes].reshape(n_classes, m).T
        i += m * n_classes
        intercept = params[i:i + n_classes]
        i += n_classes
        num_means = cat_means = None
        if normalize:
            num_means = params[i:i + num_cols]
            cat_means = params[i + num_cols:i + m]
        return LDAParams(n_classes, offsets, cat_keys, labels, coef,
                         intercept, num_means, cat_means)


def onehot_features_t(x_num: torch.Tensor, codes, offsets,
                      means=None) -> torch.Tensor:
    """Features-first [m, n] f32 feature block on x_num's device: the
    numeric rows, then one one-hot block per categorical column of the
    boundaries `offsets` (a code outside the column's block is an all-zero
    column), minus `means` f64[m] when given (LDA_impute :511-549,
    batched column-major)."""
    feats = [x_num]
    if len(offsets) > 1:
        codes = torch.as_tensor(codes, device=x_num.device)
        for j in range(len(offsets) - 1):
            size = int(offsets[j + 1] - offsets[j])
            iota = torch.arange(size, dtype=codes.dtype, device=x_num.device)
            feats.append((codes[j][None, :] == iota[:, None])
                         .to(torch.float32))
    f = torch.cat(feats, dim=0)
    if means is not None:
        f = f - torch.tensor(means, dtype=torch.float32,
                             device=x_num.device)[:, None]
    return f


@ieee_f32()
def lda_predict(params: np.ndarray, x_num, codes=None, *,
                normalize: bool = False) -> torch.Tensor:
    """Batched `lda_predict(params, normalize, cols…)` → i32[n] 0-based class
    indices (lda.cpp:575), the first maximum's on a tie, on x_num's device.
    x_num f32[dn, n] features-first; codes i32[c, n] LOCAL codes of the
    non-label categorical columns."""
    x_num = torch.as_tensor(x_num, dtype=torch.float32)
    p = LDAParams.decode(params, x_num.shape[0], normalize)
    v = len(p.cat_keys)
    # the stored idxs are the full boundary list of the remaining (non-label)
    # columns: n_cat values = (n_cat-1)+1 boundaries, first always 0
    means = (np.concatenate([p.num_means, p.cat_means]) if normalize
             else None)
    feats = onehot_features_t(x_num, codes, p.offsets if v > 0 else [0],
                              means)
    dev = x_num.device
    scores = (torch.tensor(p.coef.T, dtype=torch.float32, device=dev) @ feats
              + torch.tensor(p.intercept, dtype=torch.float32,
                             device=dev)[:, None])
    return torch.argmax(scores, dim=0).to(torch.int32)
