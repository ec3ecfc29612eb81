"""Serialization between the dense Triple/NBAgg tensors and the
reference's nested key/value dict format.

Counterpart of `duckdb_imputation_tpu.ring.serialize`. The reference
emits triples as nested LIST/STRUCT values (SumStateFinalize,
duckdb_extension/src/triple/sum/sum_state.cpp:116-464) whose Python shape
(via duckdb fetchall) is

  {'N': int,
   'lin_agg'|'lin_num': [f32]*d,
   'quad_agg'|'quad_num': packed upper triangle, index row*d - row(row+1)/2 + col
                          (ML/utils.cpp:192-199),
   'lin_cat':      [[{'key','value'}] per cat col]          (sorted by key),
   'quad_num_cat': [[{'key','value'}] per (num i, cat j)]   num-major order,
   'quad_cat':     [[{'key1','key2','value'}] per pair i<=j] sorted (key1,key2)}

Aggregate results (sum_to_triple / sum_triple) use the field names lin_agg
/ quad_agg; scalar ops (to_cofactor lift, multiply_triple) use lin_num /
quad_num, chosen by `style`.

A key appears in a section map iff it was ever touched for the group: with
a table-wide vocab, lin_cat / quad_num_cat entries appear iff the
category's count is nonzero, quad_cat entries iff the pair value is
nonzero.

A host-side boundary: tensors go to the host (`.detach().cpu()`) before
numpy; `dict_to_triple` / `dict_to_nb` build their tensors on the device
asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from ..schema import FeatureSchema
from .triple import NBAgg, Triple


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack_upper(quad) -> list[float]:
    """Dense symmetric [d, d] -> packed upper triangle (row-major,
    row <= col)."""
    quad = _np(quad)
    return [float(v) for v in quad[np.triu_indices(quad.shape[-1])]]


def unpack_upper(packed, d: int) -> np.ndarray:
    """Packed upper triangle -> dense symmetric f32[d, d]."""
    quad = np.zeros((d, d), np.float32)
    r, c = np.triu_indices(d)
    quad[r, c] = packed
    quad[c, r] = packed
    return quad


def _check_style(style: str) -> tuple[str, str]:
    if style not in ("agg", "num"):
        raise ValueError(f"style must be 'agg' or 'num', got {style!r}")
    return ("lin_agg", "quad_agg") if style == "agg" else ("lin_num",
                                                           "quad_num")


def _key_sections(values: np.ndarray, present: np.ndarray,
                  schema: FeatureSchema) -> list[list[dict]]:
    """Per categorical column, the {'key', 'value'} entries of the present
    vocab slots, in key order."""
    offs = schema.offsets
    out = []
    for j, keys in enumerate(schema.cat_keys):
        out.append([{"key": int(key), "value": float(values[offs[j] + k])}
                    for k, key in enumerate(keys) if present[offs[j] + k]])
    return out


def triple_to_dict(t: Triple, schema: FeatureSchema,
                   style: str = "agg") -> dict:
    """Dense triple -> reference nested dict. style: 'agg' (sum results)
    or 'num' (lift / multiply results)."""
    lin_name, quad_name = _check_style(style)
    d, c = schema.num_cols, schema.cat_cols
    offs = schema.offsets
    lin_cat, num_cat, cat_cat = _np(t.lin_cat), _np(t.num_cat), _np(t.cat_cat)
    # the vocab slots "present" in this aggregate (count != 0)
    present = lin_cat != 0

    num_cat_out = []
    for i in range(d):          # num-major (lift.cpp / finalize emit order)
        num_cat_out.extend(_key_sections(num_cat[i], present, schema))

    cat_cat_out = []
    for j1 in range(c):
        for j2 in range(j1, c):
            block = cat_cat[offs[j1]:offs[j1 + 1], offs[j2]:offs[j2 + 1]]
            entries = sorted(      # std::map<pair> order
                (int(schema.cat_keys[j1][a]), int(schema.cat_keys[j2][b]),
                 float(block[a, b]))
                for a, b in zip(*np.nonzero(block)))
            cat_cat_out.append([{"key1": k1, "key2": k2, "value": v}
                                for k1, k2, v in entries])

    return {
        "N": int(round(float(_np(t.n)))),
        lin_name: [float(x) for x in _np(t.lin)],
        quad_name: pack_upper(t.quad),
        "lin_cat": _key_sections(lin_cat, present, schema),
        "quad_num_cat": num_cat_out,
        "quad_cat": cat_cat_out,
    }


def nb_to_dict(t: NBAgg, schema: FeatureSchema, style: str = "agg") -> dict:
    """Dense NB aggregate -> reference 4-field dict
    (sum_to_nb_agg.cpp:18-35 / lift_to_nb_agg.cpp:101-118)."""
    lin_name, quad_name = _check_style(style)
    lin_cat = _np(t.lin_cat)
    return {
        "N": int(round(float(_np(t.n)))),
        lin_name: [float(x) for x in _np(t.lin)],
        quad_name: [float(x) for x in _np(t.quad_diag)],
        "lin_cat": _key_sections(lin_cat, lin_cat != 0, schema),
    }


def _schema_of(d: dict, nd: int,
               schema: FeatureSchema | None) -> FeatureSchema:
    """The given schema, or one built from the keys present in the dict's
    own lin_cat maps (sorted, like n_cols_1hot_expansion)."""
    if schema is not None:
        return schema
    cat_keys = tuple(tuple(sorted(int(e["key"]) for e in sec))
                     for sec in d["lin_cat"])
    return FeatureSchema(num_cols=nd, cat_keys=cat_keys)


def dict_to_triple(d: dict, schema: FeatureSchema | None = None,
                   device="cuda") -> tuple[Triple, FeatureSchema]:
    """Reference nested dict -> dense triple on `device` (the extract_data
    analogue, ML/utils.cpp:6-150). With no schema, one is built from the
    keys present in the dict's own maps."""
    lin = d.get("lin_agg", d.get("lin_num"))
    quad = d.get("quad_agg", d.get("quad_num"))
    nd = len(lin)
    schema = _schema_of(d, nd, schema)
    offs = schema.offsets
    v = schema.vocab_size
    lin_cat = np.zeros((v,), np.float32)
    num_cat = np.zeros((nd, v), np.float32)
    cat_cat = np.zeros((v, v), np.float32)

    def slot(j, key):
        return offs[j] + schema.cat_keys[j].index(int(key))

    for j, sec in enumerate(d["lin_cat"]):
        for e in sec:
            lin_cat[slot(j, e["key"])] = e["value"]
    k = 0
    for i in range(nd):
        for j in range(schema.cat_cols):
            for e in d["quad_num_cat"][k]:
                num_cat[i, slot(j, e["key"])] = e["value"]
            k += 1
    k = 0
    for j1 in range(schema.cat_cols):
        for j2 in range(j1, schema.cat_cols):
            for e in d["quad_cat"][k]:
                a, b = slot(j1, e["key1"]), slot(j2, e["key2"])
                cat_cat[a, b] = e["value"]
                cat_cat[b, a] = e["value"]
            k += 1

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    t = Triple(n=tensor(d["N"]), lin=tensor(lin),
               quad=tensor(unpack_upper(quad, nd)), lin_cat=tensor(lin_cat),
               num_cat=tensor(num_cat), cat_cat=tensor(cat_cat))
    return t, schema


def dict_to_nb(d: dict, schema: FeatureSchema | None = None,
               device="cuda") -> tuple[NBAgg, FeatureSchema]:
    """Reference 4-field dict -> dense NB aggregate on `device`."""
    lin = d.get("lin_agg", d.get("lin_num"))
    quad = d.get("quad_agg", d.get("quad_num"))
    schema = _schema_of(d, len(lin), schema)
    offs = schema.offsets
    lin_cat = np.zeros((schema.vocab_size,), np.float32)
    for j, sec in enumerate(d["lin_cat"]):
        for e in sec:
            lin_cat[offs[j] + schema.cat_keys[j].index(int(e["key"]))] = \
                e["value"]

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    t = NBAgg(n=tensor(d["N"]), lin=tensor(lin), quad_diag=tensor(quad),
              lin_cat=tensor(lin_cat))
    return t, schema


def align_triple(t: Triple, schema: FeatureSchema,
                 target: FeatureSchema) -> Triple:
    """Re-embed a dense triple into a superset vocabulary layout.

    The reference's ring sums merge hash maps, so triples with different
    key sets combine implicitly (SumStateCombine, sum_state.cpp:37-96);
    dense triples are scattered into a common (union) schema before an
    elementwise combination. Batched triples keep their leading axes."""
    if target == schema:
        return t
    m = torch.as_tensor(schema.vocab_map(target), device=t.n.device)
    vn = target.vocab_size
    batch = tuple(t.n.shape)
    lin_cat = t.lin_cat.new_zeros(batch + (vn,))
    lin_cat[..., m] = t.lin_cat
    num_cat = t.num_cat.new_zeros(batch + (schema.num_cols, vn))
    num_cat[..., m] = t.num_cat
    cat_cat = t.cat_cat.new_zeros(batch + (vn, vn))
    cat_cat[..., m[:, None], m[None, :]] = t.cat_cat
    return Triple(n=t.n, lin=t.lin, quad=t.quad, lin_cat=lin_cat,
                  num_cat=num_cat, cat_cat=cat_cat)


def align_nb(t: NBAgg, schema: FeatureSchema, target: FeatureSchema) -> NBAgg:
    """NB-aggregate version of `align_triple`."""
    if target == schema:
        return t
    m = torch.as_tensor(schema.vocab_map(target), device=t.n.device)
    lin_cat = t.lin_cat.new_zeros(tuple(t.n.shape) + (target.vocab_size,))
    lin_cat[..., m] = t.lin_cat
    return NBAgg(n=t.n, lin=t.lin, quad_diag=t.quad_diag, lin_cat=lin_cat)
