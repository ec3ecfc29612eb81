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

The ring product of factorized joins, `triple_multiply` / `nb_multiply`,
and its sum over the keys of a join, `factorized_join_sum[_nb]`: the
latter contracts per-key aggregates over the key axis in f64 and rounds to
f32 once (the JAX package contracts in f32), so counts·sums over millions
of fact rows keep the digits that the exact plain sums of `ring.sum` keep.
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


def _block(rows) -> torch.Tensor:
    """A block matrix from rows of blocks (jnp.block over the last two
    axes)."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def triple_multiply(a: Triple, b: Triple) -> Triple:
    """Ring product for factorized joins (Triple::MultiplyFunction,
    mul.cpp:19-611) of two unbatched triples. Result columns are [num_a ‖
    num_b], [cat_a ‖ cat_b], the schema `schema_a.concat(schema_b)`:

      N        = Na·Nb
      lin      = [lin_a·Nb ‖ lin_b·Na]
      quad     = [[quad_a·Nb, lin_a⊗lin_b], [lin_b⊗lin_a, quad_b·Na]]
      lin_cat  = [lin_cat_a·Nb ‖ lin_cat_b·Na]
      num_cat  = [[num_cat_a·Nb, lin_a⊗lin_cat_b],
                  [lin_b⊗lin_cat_a, num_cat_b·Na]]
      cat_cat  = [[cat_cat_a·Nb, lin_cat_a⊗lin_cat_b],
                  [(lin_cat_a⊗lin_cat_b)ᵀ, cat_cat_b·Na]]

    Each entry is one product of the operands' dtype, as in the JAX
    package."""
    na, nb = a.n, b.n
    cross = torch.outer(a.lin_cat, b.lin_cat)
    return Triple(
        n=na * nb,
        lin=torch.cat([a.lin * nb, b.lin * na], dim=-1),
        quad=_block([[a.quad * nb, torch.outer(a.lin, b.lin)],
                     [torch.outer(b.lin, a.lin), b.quad * na]]),
        lin_cat=torch.cat([a.lin_cat * nb, b.lin_cat * na], dim=-1),
        num_cat=_block([[a.num_cat * nb, torch.outer(a.lin, b.lin_cat)],
                        [torch.outer(b.lin, a.lin_cat), b.num_cat * na]]),
        cat_cat=_block([[a.cat_cat * nb, cross],
                        [cross.T, b.cat_cat * na]]))


def nb_multiply(a: NBAgg, b: NBAgg) -> NBAgg:
    """Ring product of NB aggregates (Triple::multiply_nb, mul_nb.cpp:
    20-268): the diagonal sections scaled by the other side's count, no
    cross sections."""
    na, nb = a.n, b.n
    return NBAgg(
        n=na * nb,
        lin=torch.cat([a.lin * nb, b.lin * na], dim=-1),
        quad_diag=torch.cat([a.quad_diag * nb, b.quad_diag * na], dim=-1),
        lin_cat=torch.cat([a.lin_cat * nb, b.lin_cat * na], dim=-1))


# Keys a step of `_key_sum`: bounds its f64 copy of a section (256 keys of
# a 372 × 372 cat_cat block are 283 MB).
KEY_CHUNK = 256


def _key_sum(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Σ_g s[g]·x[g] over the leading key axis, f64: one [1, g] @ [g, …]
    product a chunk of keys, chunks added in f64."""
    g = x.shape[0]
    flat = torch.zeros(x[0].numel(), dtype=torch.float64, device=x.device)
    for lo in range(0, g, KEY_CHUNK):
        hi = min(lo + KEY_CHUNK, g)
        flat += (s[lo:hi].double()
                 @ x[lo:hi].reshape(hi - lo, flat.numel()).double())
    return flat.reshape(x.shape[1:])


def _key_cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_g x[g] ⊗ y[g] = xᵀ·y over the key axis, f64."""
    return x.double().T @ y.double()


def factorized_join_sum(a: Triple, b: Triple) -> Triple:
    """Fused `sum_triple(multiply_triple(A, B))` over aligned per-key
    triples, the reference's factorized-join aggregation (README.md:
    163-174): `a` and `b` are batched on the join key g = 0..G−1 (a key
    missing on one side has N = 0 there and vanishes, since every block of
    a product is scaled by the other side's count). Each block of the sum
    is a contraction over the key axis, Σ_g lin_a[g] ⊗ lin_b[g] = lin_aᵀ·
    lin_b and Σ_g quad_a[g]·N_b[g], so the [G, m, m] products are never
    formed. The contractions run in f64 and the result is rounded to f32
    once."""
    na, nb = a.n, b.n
    w = _key_sum
    cross = _key_cross(a.lin_cat, b.lin_cat)
    t = Triple(
        n=na.double() @ nb.double(),
        lin=torch.cat([w(a.lin, nb), w(b.lin, na)], dim=-1),
        quad=_block([[w(a.quad, nb), _key_cross(a.lin, b.lin)],
                     [_key_cross(b.lin, a.lin), w(b.quad, na)]]),
        lin_cat=torch.cat([w(a.lin_cat, nb), w(b.lin_cat, na)], dim=-1),
        num_cat=_block([[w(a.num_cat, nb), _key_cross(a.lin, b.lin_cat)],
                        [_key_cross(b.lin, a.lin_cat), w(b.num_cat, na)]]),
        cat_cat=_block([[w(a.cat_cat, nb), cross],
                        [cross.T, w(b.cat_cat, na)]]))
    return _map(lambda x: x.to(torch.float32), t)


def factorized_join_sum_nb(a: NBAgg, b: NBAgg) -> NBAgg:
    """NB-aggregate version of `factorized_join_sum` (sum_nb_agg over
    multiply_nb_agg products, mul_nb.cpp:20-268), in f64, rounded once."""
    na, nb = a.n, b.n
    w = _key_sum
    t = NBAgg(
        n=na.double() @ nb.double(),
        lin=torch.cat([w(a.lin, nb), w(b.lin, na)], dim=-1),
        quad_diag=torch.cat([w(a.quad_diag, nb), w(b.quad_diag, na)],
                            dim=-1),
        lin_cat=torch.cat([w(a.lin_cat, nb), w(b.lin_cat, na)], dim=-1))
    return _map(lambda x: x.to(torch.float32), t)


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
