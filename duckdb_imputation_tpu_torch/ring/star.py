"""Multi-dimension star-join factorized aggregation.

Counterpart of `duckdb_imputation_tpu.ring.star`. The cofactor triple of

    fact ⋈_{k1} dim_1 ⋈_{k2} dim_2 ⋈ …      (FK → unique-PK joins)

comes from per-key aggregates and a few products, never from the join
itself. Let E_i = [num_i ‖ onehot(cat_i)] be dimension i's per-key feature
matrix (K_i × m_i), w the row weights, and

    R_i[k]    = Σ_{rows r with k_i(r) = k} w_r · [1, x_f(r), onehot(c_f(r))]
    C_ij[k,l] = Σ_r w_r · 1[k_i(r) = k] · 1[k_j(r) = l]

then every block of the joined sigma matrix is

    fact  × fact   = the masked fact sigma
    fact  × dim_i  = R_iᵀ E_i
    dim_i × dim_i  = E_iᵀ diag(R_i[:, 0]) E_i
    dim_i × dim_j  = E_iᵀ C_ij E_j

at O(n) of aggregation plus O(K²·m) of products, whatever the join's
fan-out.

How the port computes the aggregates (its own design; the JAX package's
one-hot key matrices on the MXU, with a segment-sum path past
ONEHOT_KEY_LIMIT = 8,192 keys, are a TPU dispatch the port does not have):

- the fact block is `ring.sum.sum_to_triple`'s Gram: K1's stacked entry
  point on a CUDA table (K7 above P = 88), the exact plain sums on the CPU;
- R_i is the n, lin and lin_cat of `sum_to_nb_agg_grouped` over the fact
  rows grouped by k_i: the NB sums kernel (K6) on a CUDA table, the plain
  sums on the CPU (its quad_diag goes unused). No [K, rows] one-hot is
  built: at K = 4,100 a chunk of 2¹⁷ rows of one would be 2.1 GB of f32;
- C_ij is one `torch.bincount` of k_i·K_j + k_j with the weights in f64,
  rounded to f32 once, so counts are exact for any weights (the JAX
  package rounds non-binary weights to bf16 on its one-hot path);
- the blocks are assembled in f64 and the sigma rounded to f32 once.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..schema import FeatureSchema
from .sum import (onehot_block_t, sum_to_nb_agg_grouped, sum_to_triple)
from .triple import Triple, sigma_from_triple, triple_from_sigma


def _dim_features(x_num: torch.Tensor, codes: torch.Tensor,
                  schema: FeatureSchema) -> torch.Tensor:
    """E = [num ‖ onehot(cats)] per key, f32[K, d + V], from x_num f32[d,
    K] and codes i32[c, K] ordered by key."""
    return torch.cat([x_num.to(torch.float32).T,
                      onehot_block_t(codes, schema).T], dim=1)


def star_schema(fact_schema: FeatureSchema,
                dim_schemas: Sequence[FeatureSchema]) -> FeatureSchema:
    """Joined schema: [fact nums ‖ dim nums…], [fact cats ‖ dim cats…]
    (the multiply concatenation order, mul.cpp:97-107, extended n-way)."""
    s = fact_schema
    for ds in dim_schemas:
        s = s.concat(ds)
    return s


def _star_permutation(fs: FeatureSchema,
                      dss: Sequence[FeatureSchema]) -> np.ndarray:
    """Index map from the assembled block order [1, f-num, f-cat, d1-num,
    d1-cat, …] to the joined-schema sigma order [1 | all nums | all
    vocabs]."""
    blocks = [(1, fs.num_cols, fs.vocab_size)]
    blocks += [(0, ds.num_cols, ds.vocab_size) for ds in dss]
    const_idx, num_idx, cat_idx = [], [], []
    off = 0
    for c, d, v in blocks:
        if c:
            const_idx.append(off)
        num_idx.extend(range(off + c, off + c + d))
        cat_idx.extend(range(off + c + d, off + c + d + v))
        off += c + d + v
    return np.asarray(const_idx + num_idx + cat_idx, dtype=np.int64)


def _key_rows(x_f, c_f, weights, keys, *, num_keys: int,
              schema: FeatureSchema) -> torch.Tensor:
    """R[k] = the per-key weighted sums of the fact sigma row [1 ‖ x ‖
    onehot(cats)], f64[K, 1 + d + V]: the NB sums grouped by key (K6 on
    a CUDA table)."""
    agg = sum_to_nb_agg_grouped(x_f, c_f, keys, schema=schema,
                                num_groups=num_keys, weights=weights)
    return torch.cat([agg.n[:, None], agg.lin, agg.lin_cat],
                     dim=1).double()


def _cooccurrence(weights, ki, kj, num_i: int, num_j: int) -> torch.Tensor:
    """C[k, l] = Σ w over the rows with (k_i, k_j) = (k, l), f64[K_i, K_j]:
    one bincount of the combined key, its weights summed in f64 and
    rounded to f32 once."""
    flat = ki.long() * num_j + kj.long()
    w = None if weights is None else weights.double()
    c = torch.bincount(flat, weights=w, minlength=num_i * num_j)
    return c.to(torch.float32).double().reshape(num_i, num_j)


def star_join_sigma(x_f, c_f, weights, keys, dim_num, dim_codes, *,
                    fact_schema: FeatureSchema,
                    dim_schemas: Sequence[FeatureSchema],
                    num_keys: Sequence[int]) -> torch.Tensor:
    """Dense sigma matrix of the star join, f32[P, P] with P = 1 + D + V
    over the joined schema.

    x_f f32[d_f, n]; c_f i32[c_f, n]; weights f32[n] or None (all ones);
    keys: per dimension, the FK codes [n] into [0, K_i);
    dim_num[i] f32[d_i, K_i] and dim_codes[i] i32[c_i, K_i] ordered by key.
    """
    nd = len(dim_schemas)
    ff = sigma_from_triple(sum_to_triple(x_f, c_f, weights,
                                         schema=fact_schema)).double()
    E = [_dim_features(dim_num[i], dim_codes[i], dim_schemas[i]).double()
         for i in range(nd)]
    R = [_key_rows(x_f, c_f, weights, keys[i], num_keys=num_keys[i],
                   schema=fact_schema) for i in range(nd)]
    C = {(i, j): _cooccurrence(weights, keys[i], keys[j], num_keys[i],
                               num_keys[j])
         for i in range(nd) for j in range(i + 1, nd)}

    fd = [R[i].T @ E[i] for i in range(nd)]            # fact × dim_i
    rows = [torch.cat([ff] + fd, dim=1)]
    for i in range(nd):
        blocks = [fd[i].T]
        for j in range(nd):
            if j == i:
                blocks.append((E[i].T * R[i][:, 0]) @ E[i])
            elif j > i:
                blocks.append(E[i].T @ C[(i, j)] @ E[j])
            else:
                blocks.append(E[i].T @ C[(j, i)].T @ E[j])
        rows.append(torch.cat(blocks, dim=1))
    big = torch.cat(rows, dim=0)
    perm = torch.as_tensor(_star_permutation(fact_schema, dim_schemas),
                           device=big.device)
    return big[perm][:, perm].to(torch.float32)


def star_join_triple(x_f=None, c_f=None, weights=None, keys=(), dims=(), *,
                     fact_schema: FeatureSchema,
                     dim_schemas: Sequence[FeatureSchema],
                     num_keys: Sequence[int] | None = None) -> Triple:
    """Cofactor triple of `fact ⋈ dim_1 ⋈ …` (see the module docstring),
    over `star_schema(fact_schema, dim_schemas)`, on the fact's device.

    keys: per dimension, the FK codes [n] into [0, K_i).
    dims: per dimension, (x_num f32[d_i, K_i] or None, codes i32[c_i, K_i]
      or None) ordered by key (row k <-> key k).
    weights: f32[n] row weights or None (all ones); any weights give exact
      co-occurrence sums (f64, rounded once)."""
    dim_schemas = tuple(dim_schemas)
    ref = x_f if x_f is not None else c_f
    n, dev = ref.shape[-1], ref.device
    if x_f is None:
        x_f = torch.zeros((0, n), dtype=torch.float32, device=dev)
    if c_f is None:
        c_f = torch.zeros((0, n), dtype=torch.int32, device=dev)
    if num_keys is None:
        num_keys = tuple(d[0].shape[-1] if d[0] is not None
                         else d[1].shape[-1] for d in dims)
    num_keys = tuple(int(k) for k in num_keys)
    dim_num = tuple(
        d[0] if d[0] is not None
        else torch.zeros((0, k), dtype=torch.float32, device=dev)
        for d, k in zip(dims, num_keys))
    dim_codes = tuple(
        d[1] if d[1] is not None
        else torch.zeros((0, k), dtype=torch.int32, device=dev)
        for d, k in zip(dims, num_keys))
    sigma = star_join_sigma(x_f, c_f, weights, keys, dim_num, dim_codes,
                            fact_schema=fact_schema, dim_schemas=dim_schemas,
                            num_keys=num_keys)
    return triple_from_sigma(sigma, star_schema(fact_schema,
                                                dim_schemas).num_cols)
