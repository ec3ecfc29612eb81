"""The device LDA of the MICE loops at a schema where an item column fixes
the label, the port against the JAX package, on the CPU.

At favorita_items each of 4,100 items fixes its family, so a perfect
classifier of family exists, yet `run_mice_device`'s LDA imputes family
with an accuracy of 0.671 there, while `run_mice_wide`'s ridge CG solves
reach 1.000. This holds the two packages' `_lda_device` on one f32 sigma,
made with numpy from a seed, at a small schema of the same shape: 3
numerics (favorita's unit_sales, transactions and oil price), a store
column of 8 levels, a family label of 8 levels and an item column of 300
levels that fixes the family (Zipf item shares), P = 320, 100k rows, 20%
nulls in the label. Both solve the shared-covariance system by a
minimum-norm SVD solve that drops singular values below eps·max(m, k)·
s_max (the port: `models.device.lstsq_min_norm`; JAX:
`jnp.linalg.lstsq`). They keep the same rank and impute the same codes,
and both fall short of the perfect fit; a larger numeric scale (s_max)
cuts more of the item directions and costs both the same accuracy. So
the shortfall is the reference's LDA, not a fault of the port's solve.

The device QDA at a label independent of the item column (onpromotion, as
at favorita_items) is held the same way: both packages' `qda_train_device`
and scorer on one f32 sigma per class, beside an f64 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.mice import device_round as ref_round
from duckdb_imputation_tpu.models import device as ref_device

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.mice import device_round as port_round
from duckdb_imputation_tpu_torch.models import device as port_device
from duckdb_imputation_tpu_torch.models.device import lstsq_min_norm

torch.set_num_threads(2)

N_ROWS = 100_000
STORES, FAMILIES, ITEMS = 8, 8, 300
SIZES = (STORES, FAMILIES, ITEMS)
LABEL = 1                                   # family


def items_table(scale: float, seed: int = 0):
    """x f32[3, n], codes i32[3, n] (store, family, item), the label's
    null mask: each item fixes its family (every family has an item),
    items drawn by Zipf shares, stores uniform; unit_sales = item level +
    0.5·N(0, 1), transactions = scale·(2·store level + N(0, 1)), oil
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    family_of_item = rng.permutation(np.concatenate(
        [np.arange(FAMILIES), rng.integers(0, FAMILIES, ITEMS - FAMILIES)]))
    share = 1.0 / rng.permutation(np.arange(1, ITEMS + 1))
    item = rng.choice(ITEMS, n, p=share / share.sum())
    store = rng.integers(0, STORES, n)
    level = 0.5 * rng.normal(size=ITEMS)
    x = np.stack([level[item] + 0.5 * rng.normal(size=n),
                  scale * (2.0 * rng.normal(size=STORES)[store]
                           + rng.normal(size=n)),
                  rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([store, family_of_item[item], item]).astype(np.int32)
    return x, codes, rng.random(n) < 0.2


def sigma_f32(x, codes, w):
    """The masked sigma Zᵀ·diag(w)·Z in f64 by row chunks, rounded to f32
    once, as the loop hands it to the solve."""
    p = 1 + x.shape[0] + sum(SIZES)
    out = np.zeros((p, p))
    for lo in range(0, x.shape[1], 20_000):
        sl = slice(lo, lo + 20_000)
        z = [np.ones((1, x[:, sl].shape[1])), x[:, sl].astype(np.float64)]
        z += [(c[sl][None] == np.arange(v)[:, None]) * 1.0
              for c, v in zip(codes, SIZES)]
        z = np.concatenate(z)
        out += (z * w[sl]) @ z.T
    return out.astype(np.float32)


def accuracy(w, intercept, keep, x, codes, null):
    """The imputed label's accuracy on its null cells: each null row's
    first argmax of intercept + [x ‖ non-label one-hot]·W, in f64."""
    d = x.shape[0]
    full = np.zeros((1 + d + sum(SIZES), w.shape[1]))
    full[np.asarray(keep)[1:]] = np.asarray(w, np.float64)
    score = (np.asarray(intercept, np.float64)[None]
             + x[:, null].T.astype(np.float64) @ full[1:1 + d])
    base = 1 + d
    for j, size in enumerate(SIZES):
        if j != LABEL:
            score += full[base + codes[j][null]]
        base += size
    return float((score.argmax(1) == codes[LABEL][null]).mean())


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_lda_device_shares_the_reference_limit(scale, monkeypatch):
    """The two `_lda_device`s on one sigma: each solve keeps the same rank
    of the covariance (the port's cut eps·max(m, k)·s_max against
    `jnp.linalg.lstsq`'s rank), and the imputed family agrees with JAX's
    on ≥ 0.999 of the null cells, with accuracies within 1e-3. Neither
    reaches the perfect fit the item column allows (accuracy < 0.95), and
    at 4× the numeric scale both lose the same accuracy."""
    x, codes, null = items_table(scale)
    sig = sigma_f32(x, codes, (~null).astype(np.float32))
    keys = tuple(tuple(range(v)) for v in SIZES)
    ranks = {}

    def port_solve(a, b):
        s = torch.linalg.svdvals(a)
        cut = torch.finfo(a.dtype).eps * max(a.shape) * s[0]
        ranks["port"] = int((s >= cut).sum())
        return lstsq_min_norm(a, b)

    lstsq = jnp.linalg.lstsq

    def ref_solve(a, b, *args, **kw):
        out = lstsq(a, b, *args, **kw)
        ranks["jax"] = int(out[2])
        ranks["m"] = a.shape[0]
        return out

    monkeypatch.setattr(port_round, "lstsq_min_norm", port_solve)
    monkeypatch.setattr(jnp.linalg, "lstsq", ref_solve)
    w, icpt, keep = port_round._lda_device(
        torch.tensor(sig), FeatureSchema(3, keys), LABEL, 0.0)
    rw, ricpt, rkeep = ref_round._lda_device(
        jnp.asarray(sig), RefSchema(3, keys), LABEL, 0.0)
    assert ranks["port"] == ranks["jax"]
    # the exact null space: the stores' and the items' one-hot sums, and
    # the sum of each family's items, constant within a class
    assert ranks["port"] <= ranks["m"] - FAMILIES - 1
    acc = accuracy(w.numpy(), icpt.numpy(), keep.numpy(), x, codes, null)
    ref_acc = accuracy(np.asarray(rw), np.asarray(ricpt), rkeep, x, codes,
                       null)
    assert abs(acc - ref_acc) <= 1e-3, (acc, ref_acc)
    assert acc < 0.95, acc
    full = np.zeros((sig.shape[0], w.shape[1]), np.float64)
    full[keep.numpy()[1:]] = w.numpy()
    rfull = np.zeros_like(full)
    rfull[np.asarray(rkeep)[1:]] = np.asarray(rw)
    d = x.shape[0]
    ours = (full[1:1 + d].T @ x[:, null].astype(np.float64)
            + icpt.numpy()[:, None].astype(np.float64))
    theirs = (rfull[1:1 + d].T @ x[:, null].astype(np.float64)
              + np.asarray(ricpt)[:, None].astype(np.float64))
    base = 1 + d
    for j, size in enumerate(SIZES):
        if j != LABEL:
            ours += full[base + codes[j][null]].T
            theirs += rfull[base + codes[j][null]].T
        base += size
    assert (ours.argmax(0) == theirs.argmax(0)).mean() >= 0.999
    if scale > 1.0:
        x1, codes1, null1 = items_table(1.0)
        sig1 = sigma_f32(x1, codes1, (~null1).astype(np.float32))
        w1, icpt1, keep1 = port_round._lda_device(
            torch.tensor(sig1), FeatureSchema(3, keys), LABEL, 0.0)
        assert acc < accuracy(w1.numpy(), icpt1.numpy(), keep1.numpy(), x1,
                              codes1, null1) - 0.05


def promo_table(n: int, seed: int = 0):
    """x f32[3, n], codes i32[3, n] (store, family, item) and the label
    onpromotion i32[n], ~20% positive and independent of the item: each of
    300 items (Zipf shares) fixes its family, stores uniform; unit_sales =
    family level + item level + 1.5·onpromotion + 0.5·N(0, 1),
    transactions = 2·(store level) + N(0, 1), oil N(0, 1), as chip_smoke.py's
    favorita_items makes them."""
    rng = np.random.default_rng(seed)
    family_of_item = rng.permutation(np.concatenate(
        [np.arange(FAMILIES), rng.integers(0, FAMILIES, ITEMS - FAMILIES)]))
    share = 1.0 / rng.permutation(np.arange(1, ITEMS + 1))
    item = rng.choice(ITEMS, n, p=share / share.sum())
    store = rng.integers(0, STORES, n)
    promo = (rng.random(n) < 0.2).astype(np.int32)
    level = (0.5 * rng.normal(size=ITEMS)
             + rng.normal(size=FAMILIES)[family_of_item])
    x = np.stack([level[item] + 1.5 * promo + 0.5 * rng.normal(size=n),
                  2.0 * rng.normal(size=STORES)[store]
                  + rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    codes = np.stack([store, family_of_item[item], item]).astype(np.int32)
    return x, codes, promo


def dense_z(x, codes):
    """[x ‖ onehot(codes)] f64[P − 1, n]."""
    return np.concatenate(
        [x.astype(np.float64)]
        + [(c[None] == np.arange(v)[:, None]) * 1.0
           for c, v in zip(codes, SIZES)])


def qda_oracle(sig, total, x, codes):
    """QDA in f64 from the f32 sigmas: each class's covariance, its
    pseudo-inverse and log-pseudo-determinant by a symmetric
    eigendecomposition (eigenvalues ≤ 1e-9 cut), scored by the centred
    quadratic form of each row's dense features. Returns (first-max class
    per row, each class's rank)."""
    z = dense_z(x, codes)
    scores, ranks = [], []
    for s in sig.astype(np.float64):
        n_c = s[0, 0]
        mu = s[0, 1:] / n_c
        cov = (s[1:, 1:] - np.outer(s[0, 1:], s[0, 1:]) / n_c) / n_c
        ev, vec = np.linalg.eigh(cov)
        keep = ev > 1e-9
        half = vec[:, keep] / np.sqrt(ev[keep])
        q = ((half.T @ (z - mu[:, None])) ** 2).sum(0)
        scores.append(-0.5 * q - 0.5 * np.log(ev[keep]).sum()
                      + np.log(n_c / total))
        ranks.append(int(keep.sum()))
    return np.stack(scores).argmax(0), ranks


@pytest.mark.parametrize("n_rows", [100_000, 1_000_000])
def test_qda_device_against_both_references(n_rows):
    """Both packages' `qda_train_device` and scorer on one f32 sigma per
    class, onpromotion against the features, P = 320, scored on 50k rows.

    The port trains in f64 (SVD, singular values ≤ 1e-9 cut) and its
    predictions agree on ≥ 0.999 of the rows with an f64 oracle (the
    eigendecomposition, the dense centred form). JAX's trainer takes the
    SVD in f32 with the same 1e-9 cut, keeps singular values of the exact
    null space (the one-hot blocks' sums, the items' families) that are
    f32 rounding, and its scorer's Cholesky of −quad + 1e-12·I turns NaN:
    every score is NaN and class 0 wins every row, which is the majority
    class here. So the reference's majority-class answer is that NaN, not
    a model the port departs from. Exact QDA's own accuracy depends on the
    rows a class has against the ~309² covariance entries it estimates:
    below the majority share at 100k rows (20k in the minority class),
    above it + 0.02 at 1M rows."""
    x, codes, y = promo_table(n_rows)
    p = 1 + x.shape[0] + sum(SIZES)
    sig = np.zeros((2, p, p))
    for g in range(2):
        sig[g] = sigma_f32(x, codes, (y == g).astype(np.float32))
    sig = sig.astype(np.float32)
    rows = 50_000
    xs, cs, ys = x[:, :rows], codes[:, :rows], y[:rows]
    keys = tuple(tuple(range(v)) for v in SIZES)

    params = port_device.qda_train_device(torch.tensor(sig), float(n_rows))
    pred = port_device.qda_predict_device(
        *params, torch.tensor(xs), torch.tensor(cs),
        schema=FeatureSchema(3, keys)).numpy()
    oracle, ranks = qda_oracle(sig, float(n_rows), xs, cs)
    assert (pred == oracle).mean() >= 0.999

    rq, rl, rb = ref_device.qda_train_device(jnp.asarray(sig),
                                             jnp.float32(n_rows), 1)
    ref = np.asarray(ref_device.qda_predict_device(
        rq, rl, rb, jnp.asarray(xs), jnp.asarray(cs),
        schema=RefSchema(3, keys), method="xla"))
    kept = []
    for s in jnp.asarray(sig):           # the JAX trainer's arithmetic
        cov = (s[1:, 1:] - jnp.outer(s[0, 1:], s[0, 1:]) / s[0, 0]) / s[0, 0]
        kept.append(int((jnp.linalg.svd(cov, compute_uv=False)
                         > 1e-9).sum()))
    assert max(k - r for k, r in zip(kept, ranks)) >= 1, (kept, ranks)
    chol = jnp.linalg.cholesky(-rq + 1e-12 * jnp.eye(p - 1))
    assert np.isnan(np.asarray(chol)).any()
    assert (ref == 0).all()

    prior = float(np.bincount(ys).max()) / rows
    assert np.bincount(ys).argmax() == 0
    acc = float((pred == ys).mean())
    assert abs(acc - float((oracle == ys).mean())) <= 1e-3
    if n_rows < 500_000:
        assert acc < prior, (acc, prior)
    else:
        assert acc > prior + 0.02, (acc, prior)


def test_host_qda_determinant_underflows_in_both_packages():
    """The host QDA trainers (`models/qda.py`, drop-first, f64) of both
    packages take the pseudo-determinant as the product of the kept
    singular values, as the reference C++ does: at this schema ~300 of
    them are ~1e-4 and the product underflows to 0, so every class's
    intercept is +inf and class 0 wins every row. Both packages do so on
    the same table; the device trainer, which sums their logarithms, is
    the one `test_qda_device_against_both_references` holds."""
    from duckdb_imputation_tpu.models import qda as ref_qda
    from duckdb_imputation_tpu.ring.sum import sum_to_triple_grouped as ref_sum

    from duckdb_imputation_tpu_torch.models import qda as port_qda
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_triple_grouped

    x, codes, y = promo_table(100_000)
    keys = tuple(tuple(range(v)) for v in SIZES)
    port = port_qda.qda_train(sum_to_triple_grouped(
        torch.tensor(x), torch.tensor(codes), torch.tensor(y),
        schema=FeatureSchema(3, keys), num_groups=2), FeatureSchema(3, keys),
        np.arange(2))
    ref = np.asarray(ref_qda.qda_train(ref_sum(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(y),
        schema=RefSchema(3, keys), num_groups=2), RefSchema(3, keys),
        np.arange(2)))
    for flat in (port, ref):
        assert np.isposinf(flat).sum() == 2 and not np.isnan(flat).any()
    drop_first = np.where(codes == 0, np.array(SIZES)[:, None] - 1,
                          codes - 1)[:, :20_000]
    pred = np.asarray(port_qda.qda_predict(port, x[:, :20_000], drop_first))
    assert (pred == 0).all()
