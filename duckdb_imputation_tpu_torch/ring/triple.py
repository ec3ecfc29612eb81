"""Dense cofactor triples and NB aggregates, as tensors.

Counterpart of `duckdb_imputation_tpu.ring.triple` for the classifier
path. Against a `FeatureSchema` every triple is the block structure of the
sigma matrix (S = Zᵀ·diag(w)·Z, Z = [1 ‖ x ‖ onehot]):

  n        f32[]      row count (sum of weights)
  lin      f32[d]     Σ x
  quad     f32[d, d]  Σ x xᵀ
  lin_cat  f32[V]     per category: count
  num_cat  f32[d, V]  per (numeric column, category): Σ x
  cat_cat  f32[V, V]  per category pair: co-occurrence count

An NB aggregate keeps n, lin, the diagonal of quad and lin_cat. Grouped
aggregates carry a leading group axis on every field, as the JAX ones do.

The join product (`triple_multiply`, `factorized_join_sum`, `nb_multiply`)
is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..schema import FeatureSchema


def _map(fn, *aggs):
    """Apply fn field by field over aggregates of one class."""
    cls = type(aggs[0])
    return cls(**{f.name: fn(*(getattr(a, f.name) for a in aggs))
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class Triple:
    n: torch.Tensor        # f32[] (or [G] when grouped)
    lin: torch.Tensor      # f32[d]
    quad: torch.Tensor     # f32[d, d]
    lin_cat: torch.Tensor  # f32[V]
    num_cat: torch.Tensor  # f32[d, V]
    cat_cat: torch.Tensor  # f32[V, V]

    @property
    def d(self) -> int:
        return self.lin.shape[-1]

    @property
    def v(self) -> int:
        return self.lin_cat.shape[-1]

    @staticmethod
    def zeros(schema: FeatureSchema, batch: tuple[int, ...] = (),
              dtype=torch.float32, device="cuda") -> "Triple":
        d, v = schema.num_cols, schema.vocab_size

        def z(*shape):
            return torch.zeros(batch + shape, dtype=dtype, device=device)
        return Triple(n=z(), lin=z(d), quad=z(d, d), lin_cat=z(v),
                      num_cat=z(d, v), cat_cat=z(v, v))

    def __add__(self, other: "Triple") -> "Triple":
        return triple_add(self, other)

    def __sub__(self, other: "Triple") -> "Triple":
        return triple_sub(self, other)


@dataclasses.dataclass(frozen=True)
class NBAgg:
    """Naive-Bayes aggregate: the diagonal of quad, counts only for the
    categorical sections."""
    n: torch.Tensor          # f32[] (or [G])
    lin: torch.Tensor        # f32[d]
    quad_diag: torch.Tensor  # f32[d]  Σ x² per numeric column
    lin_cat: torch.Tensor    # f32[V]

    @property
    def d(self) -> int:
        return self.lin.shape[-1]

    @staticmethod
    def zeros(schema: FeatureSchema, batch: tuple[int, ...] = (),
              dtype=torch.float32, device="cuda") -> "NBAgg":
        d, v = schema.num_cols, schema.vocab_size

        def z(*shape):
            return torch.zeros(batch + shape, dtype=dtype, device=device)
        return NBAgg(n=z(), lin=z(d), quad_diag=z(d), lin_cat=z(v))

    def __add__(self, other: "NBAgg") -> "NBAgg":
        return triple_add(self, other)

    def __sub__(self, other: "NBAgg") -> "NBAgg":
        return triple_sub(self, other)


def triple_add(a, b):
    """Ring sum, elementwise on the dense sections (Triple or NBAgg)."""
    return _map(torch.add, a, b)


def triple_sub(a, b):
    """Ring subtract, the MICE delta operator."""
    return _map(torch.sub, a, b)


def triple_scale(a, s):
    """Every section times the scalar s."""
    return _map(lambda x: x * s, a)


def sigma_from_triple(t: Triple) -> torch.Tensor:
    """The dense sigma [[N, lin, lin_cat], [lin, quad, num_cat],
    [lin_cat, num_catᵀ, cat_cat]] as a block concat of the triple."""
    top = torch.cat([t.n[..., None, None], t.lin[..., None, :],
                     t.lin_cat[..., None, :]], dim=-1)
    mid = torch.cat([t.lin[..., :, None], t.quad, t.num_cat], dim=-1)
    bot = torch.cat([t.lin_cat[..., :, None], t.num_cat.transpose(-1, -2),
                     t.cat_cat], dim=-1)
    return torch.cat([top, mid, bot], dim=-2)


def triple_from_sigma(sigma: torch.Tensor, d: int) -> Triple:
    """Inverse of sigma_from_triple: the blocks sliced back out."""
    return Triple(
        n=sigma[..., 0, 0],
        lin=sigma[..., 0, 1:1 + d],
        quad=sigma[..., 1:1 + d, 1:1 + d],
        lin_cat=sigma[..., 0, 1 + d:],
        num_cat=sigma[..., 1:1 + d, 1 + d:],
        cat_cat=sigma[..., 1 + d:, 1 + d:],
    )


def _from_reference(cls, agg, device):
    """A JAX aggregate (fields readable by np.asarray) as `cls` on device.
    Duck-typed, so this module never imports the JAX package."""
    return cls(**{f.name: torch.tensor(np.asarray(getattr(agg, f.name),
                                                  np.float32), device=device)
                  for f in dataclasses.fields(cls)})


def triple_from_reference(t, device="cuda") -> Triple:
    """Carry a `duckdb_imputation_tpu.ring.triple.Triple` over through
    numpy onto `device` (the card unless asked otherwise), fields and
    batch axes unchanged."""
    return _from_reference(Triple, t, device)


def nb_agg_from_reference(a, device="cuda") -> NBAgg:
    """Carry a `duckdb_imputation_tpu.ring.triple.NBAgg` over through
    numpy onto `device` (the card unless asked otherwise)."""
    return _from_reference(NBAgg, a, device)
