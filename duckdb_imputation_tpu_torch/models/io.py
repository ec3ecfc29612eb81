"""Model parameter bundles: save/load the flat float32 parameter vectors
with enough schema metadata to serve predictions later.

Counterpart of `duckdb_imputation_tpu.models.io`, in the same `.npz`
layout, so a bundle that either package writes loads in the other. The
reference has no persistence at all: a trained model lives only as a
FLOAT[] SQL value inside one connection (imputation_base.cpp:46-49 trains
and predicts in the same statement sequence). The flat vector, whose
layout is the reference's serialization contract (lda.cpp:335-415 /
regression.cpp:313-348 / qda.cpp:85-112 / naive_bayes.cpp:44-97), is
stored beside the feature schema: column names in training order,
per-column category vocabularies, the label binding, and the flags
(normalize / variance) that change the parse of the vector. The vector
is the same in both packages, so a model trained by one predicts in the
other.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..schema import FeatureSchema

MODELS = ("linreg", "lda", "qda", "nb")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    model: str                   # linreg | lda | qda | nb
    params: np.ndarray           # flat f32 — the reference layout
    schema: FeatureSchema        # FEATURE schema (what the triple ran over)
    num_names: tuple[str, ...]   # numeric feature cols, training order
    cat_names: tuple[str, ...]   # categorical feature cols, training order
    label_name: str
    label_kind: str              # 'num' (linreg) | 'cat'
    label_keys: tuple[int, ...]  # label vocab (class values; () for linreg)
    normalize: bool = False
    has_variance: bool = False   # linreg: params carry the noise std
    # String-categorical dictionaries, persisted so a test CSV whose label
    # sets differ from the training CSV's re-encodes through the TRAINING
    # vocabulary (raw codes are per-file sorted-label indices otherwise —
    # silently wrong across files). Per feature cat column: None for
    # native-integer categories, else the training label tuple.
    cat_labels: tuple = ()
    # Training label strings of a string-typed label column (() = integer).
    label_labels: tuple = ()


def save_model(path: str, bundle: ModelBundle) -> None:
    keys = bundle.schema.cat_keys
    cat_labels = bundle.cat_labels or (None,) * len(bundle.cat_names)
    label_sizes = np.array([-1 if lb is None else len(lb)
                            for lb in cat_labels], np.int64)
    labels_flat = [s for lb in cat_labels if lb is not None for s in lb]
    np.savez(
        path,
        model=np.array(bundle.model),
        params=np.asarray(bundle.params, np.float32),
        num_cols=np.array(bundle.schema.num_cols),
        cat_sizes=np.array([len(k) for k in keys], np.int64),
        cat_keys_flat=(np.concatenate([np.asarray(k, np.int64)
                                       for k in keys])
                       if keys else np.zeros(0, np.int64)),
        num_names=np.array(bundle.num_names),
        cat_names=np.array(bundle.cat_names),
        label_name=np.array(bundle.label_name),
        label_kind=np.array(bundle.label_kind),
        label_keys=np.asarray(bundle.label_keys, np.int64),
        normalize=np.array(bundle.normalize),
        has_variance=np.array(bundle.has_variance),
        cat_label_sizes=label_sizes,
        cat_labels_flat=np.array(labels_flat, dtype=np.str_),
        label_labels=np.array(list(bundle.label_labels), dtype=np.str_),
    )


def load_model(path: str) -> ModelBundle:
    z = np.load(path, allow_pickle=False)
    sizes = z["cat_sizes"]
    flat = z["cat_keys_flat"]
    keys, off = [], 0
    for s in sizes:
        keys.append(tuple(int(v) for v in flat[off:off + int(s)]))
        off += int(s)
    schema = FeatureSchema(num_cols=int(z["num_cols"]),
                           cat_keys=tuple(keys))
    cat_labels: tuple = ()
    label_labels: tuple = ()
    if "cat_label_sizes" in z.files:  # absent in pre-round-4 bundles
        lbs, off = [], 0
        flat = [str(s) for s in z["cat_labels_flat"]]
        for s in z["cat_label_sizes"]:
            if int(s) < 0:
                lbs.append(None)
            else:
                lbs.append(tuple(flat[off:off + int(s)]))
                off += int(s)
        cat_labels = tuple(lbs)
        label_labels = tuple(str(s) for s in z["label_labels"])
    return ModelBundle(
        model=str(z["model"]),
        params=np.asarray(z["params"], np.float32),
        schema=schema,
        num_names=tuple(str(s) for s in z["num_names"]),
        cat_names=tuple(str(s) for s in z["cat_names"]),
        label_name=str(z["label_name"]),
        label_kind=str(z["label_kind"]),
        label_keys=tuple(int(v) for v in z["label_keys"]),
        normalize=bool(z["normalize"]),
        has_variance=bool(z["has_variance"]),
        cat_labels=cat_labels,
        label_labels=label_labels,
    )
