"""Quadratic Discriminant Analysis trained from per-class cofactor triples.

Counterpart of `duckdb_imputation_tpu.models.qda`. Train follows
`ML::qda_train` (qda.cpp:27-328): the input is one triple per class (GROUP
BY label) plus the class label values; `drop_first` is hardwired on (:47)
so the one-hot blocks are invertible; per class the sigma becomes a
covariance (mean outer-product subtraction :184-191, /count :195-199),
inverted by an f64 SVD on the host with the reference's quirks kept:
singular values ≤ 1e-9 are multiplied by THEMSELVES rather than inverted
(:224-232), determinant = Π singular values (:233-235, over those past the
cutoff, see below). Per class the output stores −½·cov⁻¹ (m² floats),
cov⁻¹μ (m), and intercept −½ μᵀcov⁻¹μ − ½ log det + log(N_c/N)
(:283-293).

Flat float32 layout (qda.cpp:85-112,245-303):

  [ n_classes,
    size_idxs               (= n_cat+1 if cats else 0 — note: differs from LDA),
    (cat_vars_idxs — n_cat+1 values (drop-first adjusted), cat_values — V',)?
    label values             (n_classes),
    { quad (m² row-major), lin (m), intercept } × class,
    (means[1:] — m values)? ]                        # if normalize

Predict (qda_impute, :338-498) batched on the device of the features:
scores = xᵀQx + Lx + b per class, first argmax; returns the actual LABEL
VALUE (:483-486), unlike LDA.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ring.triple import Triple
from ..schema import FeatureSchema
from ..utils.precision import ieee_f32
from .lda import onehot_features_t
from .sigma import host_sigma, select_sigma, select_vocab


def qda_train(triples: Triple, schema: FeatureSchema, labels,
              normalize: bool = False) -> np.ndarray:
    """`qda_train(list_of_triples, labels, normalize)`.

    triples: batched Triple with leading class axis [C] (from
    sum_to_triple_grouped); labels: the raw label value per class."""
    labels = np.asarray(labels)
    n_classes = int(labels.shape[0])
    sel = select_vocab(schema, drop_first=True)
    all_sigmas = select_sigma(host_sigma(triples), schema, sel)   # [C, p, p]
    sigmas = [all_sigmas[c] for c in range(n_classes)]
    p = sigmas[0].shape[0]
    tot = float(sum(s[0, 0] for s in sigmas))

    means = std = None
    if normalize:
        means = np.zeros(p)
        std = np.zeros(p)
        for s in sigmas:
            means += s[0, :]
            std += np.diag(s)
        means /= tot
        std = np.sqrt(std / tot - means ** 2)
        for s in sigmas:
            # standardize exactly as qda.cpp:148-168
            for i in range(1, p):
                for j in range(1, p):
                    s[i, j] = (s[i, j] - means[i] * s[0, j]
                               - means[j] * s[i, 0]
                               + s[0, 0] * means[j] * means[i]) / (std[i] * std[j])
            for i in range(1, p):
                s[0, i] = (s[0, i] - means[i] * s[0, 0]) / std[i]
                s[i, 0] = (s[i, 0] - means[i] * s[0, 0]) / std[i]

    out: list[float] = [float(n_classes)]
    if schema.cat_cols > 0:
        sel_offs = [0]
        for k in sel.schema.cat_sizes:
            sel_offs.append(sel_offs[-1] + k)
        out.append(float(schema.cat_cols + 1))
        out.extend(float(x) for x in sel_offs)
        for keys in sel.schema.cat_keys:
            out.extend(float(k) for k in keys)
    else:
        out.append(0.0)
    out.extend(float(x) for x in labels)

    blocks: list[float] = []
    for s in sigmas:
        n_c = s[0, 0]
        # Zero-count class guard: clamp the divisor (mu = 0, cov = 0 ⇒
        # inva = 0) and let log(N_c/N) = -inf make the class unpredictable;
        # the reference builds its class list from the GROUP BY result, so
        # an empty class never reaches qda_train (qda.cpp:27-47).
        n_c_safe = max(n_c, 1.0)
        sum_vec = s[0, 1:].copy()
        cov = (s[1:, 1:] - np.outer(sum_vec, sum_vec) / n_c_safe) / n_c_safe
        mu = sum_vec / n_c_safe

        u, sv, vt = np.linalg.svd(cov)
        ss = np.where(sv > 1e-9, 1.0 / np.where(sv > 1e-9, sv, 1.0), sv)
        # pseudo-determinant: the product of the singular values past the
        # 1e-9 cutoff. The reference takes Π over ALL of them
        # (qda.cpp:233-235): identical for a full-rank covariance, log(0) =
        # -inf intercepts when a category is absent within a class.
        det = float(np.prod(np.where(sv > 1e-9, sv, 1.0)))
        inva = (vt.T * ss) @ u.T

        if normalize:
            denom = np.outer(std[1:], std[1:])
            blocks.extend(float(x) for x in (-0.5 * inva / denom).flatten())
        else:
            blocks.extend(float(x) for x in (-0.5 * inva).flatten())
        lin = inva @ mu
        if normalize:
            blocks.extend(float(x) for x in (lin / std[1:]))
        else:
            blocks.extend(float(x) for x in lin)
        intercept = (-0.5 * float(mu @ lin) - 0.5 * float(np.log(det))
                     + (math.log(n_c / tot) if n_c > 0 else -math.inf))
        blocks.append(float(intercept))
    out.extend(blocks)
    if normalize:
        out.extend(float(x) for x in means[1:])
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True)
class QDAParams:
    n_classes: int
    offsets: np.ndarray    # i64[n_cat+1] drop-first boundaries (or [1] none)
    cat_keys: np.ndarray   # i64[V']
    labels: np.ndarray     # i64[C]
    quad: np.ndarray       # f64[C, m, m]
    lin: np.ndarray        # f64[C, m]
    intercept: np.ndarray  # f64[C]
    num_means: np.ndarray | None
    cat_means: np.ndarray | None

    @staticmethod
    def decode(params: np.ndarray, num_cols: int, normalize: bool) -> "QDAParams":
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
        quad = np.zeros((n_classes, m, m))
        lin = np.zeros((n_classes, m))
        intercept = np.zeros(n_classes)
        for c in range(n_classes):
            quad[c] = params[i:i + m * m].reshape(m, m); i += m * m
            lin[c] = params[i:i + m]; i += m
            intercept[c] = params[i]; i += 1
        num_means = cat_means = None
        if normalize:
            num_means = params[i:i + num_cols]
            cat_means = params[i + num_cols:i + m]
        return QDAParams(n_classes, offsets, cat_keys, labels, quad, lin,
                         intercept, num_means, cat_means)


@ieee_f32()
def qda_predict(params: np.ndarray, x_num, codes=None, *,
                normalize: bool = False) -> torch.Tensor:
    """Batched `qda_predict(params, normalize, cols…)` → i64[n] label VALUES
    on x_num's device.

    x_num f32[dn, n] features-first; codes i32[c, n] LOCAL per-column codes
    against the DROP-FIRST vocab (code == size for the dropped/unseen
    category ⇒ all-zero block; encode raw values with
    schema.drop_first().encode — misses map to size ⇒ zeros, matching
    qda.cpp:419-424)."""
    x_num = torch.as_tensor(x_num, dtype=torch.float32)
    dev = x_num.device
    p = QDAParams.decode(params, x_num.shape[0], normalize)
    v = len(p.cat_keys)
    means = (np.concatenate([p.num_means, p.cat_means if v > 0
                             else np.zeros(0)]) if normalize else None)
    f = onehot_features_t(x_num, codes, p.offsets if v > 0 else [0],
                          means).T                            # [n, m]

    # The reference evaluates the EXPANDED form xᵀQx + Lx + b in double
    # (qda.cpp:459-474). In f32 that cancels catastrophically (Q = −½Σ⁻¹
    # has large entries), so each class is re-centred on the host in f64:
    #   L = Σ⁻¹μ = −2Qμ  ⇒  μ_c = solve(−2Q_c, L_c)
    #   score = (x−μ)ᵀQ(x−μ) + [b − μᵀQμ]
    # the same value, well conditioned in f32.
    n_cls, m = p.quad.shape[0], p.quad.shape[1]
    mus = np.zeros((n_cls, m))
    const = np.zeros(n_cls)
    for c in range(n_cls):
        try:
            mu = np.linalg.solve(-2.0 * p.quad[c], p.lin[c])
        except np.linalg.LinAlgError:
            mu = np.linalg.lstsq(-2.0 * p.quad[c], p.lin[c], rcond=None)[0]
        mus[c] = mu
        const[c] = p.intercept[c] - mu @ p.quad[c] @ mu
    q = torch.tensor(p.quad, dtype=torch.float32, device=dev)
    mu_t = torch.tensor(mus, dtype=torch.float32, device=dev)
    cst = torch.tensor(const, dtype=torch.float32, device=dev)
    scores = torch.stack([((f - mu_t[c]) @ q[c] * (f - mu_t[c])).sum(-1)
                          for c in range(n_cls)], dim=1) + cst   # [n, C]
    best = torch.argmax(scores, dim=1)
    return torch.tensor(p.labels, device=dev)[best]
