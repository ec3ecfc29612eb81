"""The arithmetic of the port's redesigned grouped Grams K4 and K5 on the CPU.

K5 (csrc/grouped_gram.cu) runs K1's tensor-core body over group-aligned
steps of 128 rows, a block a contiguous run of them, one f64 slot per
(block, group) it meets; `presorted_steps_plain` gives its steps and
`presorted_gram_split_plain` repeats its arithmetic (each step's Gram of
three-way bf16 parts, folded in f64 into its slot, the slots summed per
group). K4 is a stable group order made on the device, then K5 over the
rows through it; `group_order_plain` repeats the order's arithmetic
(per-block counts, their scan in (group, block) order, ranks within a
block) and `grouped_gram_split_plain` the whole. They are held against
numpy's stable argsort, the JAX package's grouped Pallas kernels in
interpret mode (as tests/test_grouped_sorted.py runs them) and the f64
sigma of each group's rows (tests/reference_oracle.py for binary weights,
f64 numpy for general ones), on inputs made from a numpy seed. On the
card, tests/test_torch_cuda.py holds the kernels against these and the
plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.kernels import sigma_pallas_grouped as ref_g
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import (
    sigma_pallas_grouped as port_g,
)

from reference_oracle import _exact_triple_dict, build_sigma_from_dict

torch.set_num_threads(2)

# (d, vocabularies, groups): BASELINE config 4 (P = 21, 8 classes) and the
# 7-group fixture of tests/test_grouped_sorted.py (P = 14); both are
# K1's one tensor-core tile (`_build.tc_fits`)
SCHEMAS = {"config4": (4, (8, 8), 8), "fixture7": (3, (5, 5), 7)}


def _schemas(name):
    d, sizes, groups = SCHEMAS[name]
    keys = tuple(tuple(range(s)) for s in sizes)
    return (FeatureSchema(num_cols=d, cat_keys=keys),
            RefSchema(num_cols=d, cat_keys=keys), groups)


def _inputs(name, n, seed, general):
    """Rows of `name`'s schema: group 0 hot (~85% of the rows), group 1
    shorter than a step (3 rows), the last group empty, the others
    uniform; ~2% of the ids out of range (above G and negative); ~5% of
    the codes out of vocabulary (the size and -1); binary or general
    weights."""
    schema, ref_schema, groups = _schemas(name)
    d, sizes = schema.num_cols, schema.cat_sizes
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(d, n)) * 2 + 0.5).astype(np.float32)
    codes = np.stack([rng.integers(0, s, n) for s in sizes]).astype(np.int32)
    oov = rng.random((len(sizes), n)) < 0.05
    codes[oov] = np.where(rng.random(oov.sum()) < 0.5, -1,
                          np.repeat(np.array(sizes)[:, None], n, 1)[oov])
    g = np.where(rng.random(n) < 0.85, 0,
                 rng.integers(2, groups - 1, n)).astype(np.int32)
    g[rng.choice(n, min(3, n), replace=False)] = 1
    bad = rng.random(n) < 0.02
    g[bad] = np.where(rng.random(bad.sum()) < 0.5, groups + 3, -1)
    w = (rng.random(n).astype(np.float32) if general
         else (rng.random(n) > 0.25).astype(np.float32))
    return num, codes, g, w, schema, ref_schema, groups


def _count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def _oracle(num, codes, g, w, schema, groups, general):
    """f64 sigma of each group's rows: tests/reference_oracle.py
    (_exact_triple_dict, then build_sigma_from_dict) for binary weights,
    f64 numpy for general ones; a code out of vocabulary adds nothing, as
    in the kernels."""
    p = schema.sigma_size
    out = np.zeros((groups, p, p))
    for k in range(groups):
        rows = (g == k) & (w != 0)
        if not rows.any():
            continue
        x, c, wk = num[:, rows], codes[:, rows], w[rows]
        if general:
            zt = [np.ones((1, x.shape[1])), x.astype(np.float64)]
            zt += [(c[j][None] == np.arange(s)[:, None]) * 1.0
                   for j, s in enumerate(schema.cat_sizes)]
            zt = np.concatenate(zt)
            out[k] = (zt * wk.astype(np.float64)) @ zt.T
        else:
            sig, kept = build_sigma_from_dict(_exact_triple_dict(x.T, c.T,
                                                                 wk))
            out[k] = _in_vocab(sig, kept, schema)
    return out


def _in_vocab(sig, kept, schema):
    """The oracle's sigma over the keys it saw, its in-vocabulary keys
    placed in the schema's layout (a key out of vocabulary dropped, a
    code never seen a zero row and column)."""
    d, p = schema.num_cols, schema.sigma_size
    src, dst = list(range(1 + d)), list(range(1 + d))
    at = 1 + d
    for j, vals in enumerate(kept):
        for v in map(int, vals):
            if 0 <= v < schema.cat_sizes[j]:
                src.append(at)
                dst.append(1 + d + schema.offsets[j] + v)
            at += 1
    out = np.zeros((p, p))
    out[np.ix_(dst, dst)] = sig[np.ix_(src, src)]
    return out


def _assert_close(got, want, scale_of, tol, exact_counts, schema):
    """Counts exact (binary weights); the rest within tol of each group's
    max|σ| (of `scale_of`)."""
    cm = _count_mask(schema)
    for k in range(got.shape[0]):
        if exact_counts:
            assert np.array_equal(got[k][cm], want[k][cm])
        scale = max(float(np.abs(scale_of[k]).max()), 1.0)
        assert np.abs(got[k] - want[k]).max() <= tol * scale


def t(a):
    return torch.tensor(a)


# ---------------------------------------------------------------------------
# K4's group order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 3001, 20_011, 70_000])
@pytest.mark.parametrize("groups", [1, 7])
def test_group_order_plain_is_the_stable_order(n, groups):
    """Offsets are the cumulated counts of the ids in range; the list is
    numpy's stable argsort of those rows by id (rows in order within a
    group, across every order block: n = 20,011 and 70,000 take 10 and 35
    blocks); ids out of range never enter it."""
    rng = np.random.default_rng(n + groups)
    g = np.where(rng.random(n) < 0.8, 0, rng.integers(-2, groups + 2, n))
    offsets, order = port_g.group_order_plain(t(g.astype(np.int32)), groups)
    ok = (g >= 0) & (g < groups)
    counts = np.bincount(g[ok], minlength=groups)
    assert offsets.tolist() == [0] + np.cumsum(counts).tolist()
    key = np.where(ok, g, groups)
    assert np.array_equal(order.numpy(),
                          np.argsort(key, kind="stable")[:ok.sum()])


@pytest.mark.parametrize("n", [0, 1, 2048, 2049, 10_000_000, 2 ** 31 - 1])
def test_order_geometry(n):
    """B slices of `per` rows (a multiple of 256) cover the n rows, none
    empty, at most 1,024 of them and at most one for each 8 chunks of 256
    rows (rounded up), so that a slice's loop over its chunks is long
    enough to keep loads in flight."""
    blocks, per = _build.order_geometry(n)
    chunks = -(-n // _build.CHUNK_ROWS)
    assert per % _build.CHUNK_ROWS == 0 and per >= _build.CHUNK_ROWS
    assert 1 <= blocks <= _build.ORDER_BLOCKS
    assert blocks * per >= n and (blocks - 1) * per < max(n, 1)
    assert blocks <= max(1, -(-chunks // _build.ORDER_MIN_CHUNKS))


# ---------------------------------------------------------------------------
# K5's steps and slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[5000, 0, 3, 130, 0], [128] * 9,
                                   [1] * 1000, [0, 0, 7], [100_000]])
@pytest.mark.parametrize("nblocks", [1, 7, 660, 1024])
def test_presorted_steps_and_slots(sizes, nblocks):
    """Steps of 128 rows never cross a group boundary (ceil(count / 128)
    a group, none for an empty one); each block's steps are a contiguous
    run meeting groups in order; the slot block + group of each (block,
    group) met is unique and below nblocks + G; the reduction's block
    range b0 .. b1 of a group is exactly the blocks that met it."""
    offsets = torch.tensor([0] + np.cumsum(sizes).tolist())
    group, block, first, cum = port_g.presorted_steps_plain(
        offsets, _build.TC_ROWS, nblocks)
    steps = [-(-s // 128) for s in sizes]
    assert cum.tolist() == [0] + np.cumsum(steps).tolist()
    assert torch.equal(torch.bincount(group, minlength=len(sizes)),
                       torch.tensor(steps))
    assert bool((first >= offsets[group]).all())
    assert bool((first < offsets[group + 1]).all())
    assert bool((block[1:] >= block[:-1]).all())
    assert bool((group[1:] >= group[:-1]).all())
    assert bool((block < nblocks).all())
    met = sorted(set(zip(block.tolist(), group.tolist())))
    slots = [b + g for b, g in met]
    assert len(set(slots)) == len(slots)
    assert max(slots, default=0) < nblocks + len(sizes)
    total = int(cum[-1])
    cpb = max(-(-total // nblocks), 1)
    for g in range(len(sizes)):
        blocks = sorted({b for b, gg in met if gg == g})
        lo, hi = int(cum[g]), int(cum[g + 1])
        want = list(range(lo // cpb, (hi - 1) // cpb + 1)) if hi > lo else []
        assert blocks == want


# ---------------------------------------------------------------------------
# K5 and K4 on the tensor cores: the split arithmetic against JAX and f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCHEMAS))
@pytest.mark.parametrize("general", [False, True])
def test_presorted_split_plain_matches_pallas_and_the_f64_oracle(name,
                                                                 general):
    """K5's arithmetic over sort_by_group's rows, a ragged n with a hot
    group, a group shorter than a step, an empty group, ids out of range
    and codes out of vocabulary, against the JAX sort_by_group +
    sum_to_triple_grouped_presorted (its split-precision sorted-slab
    kernel for binary weights, the f32 one for general; interpret mode)
    and the f64 oracle: counts exact; within 1e-6 of each group's max|σ|
    of the f64 sums (each product of parts exact, f64 sums, one rounding
    to f32: ~6e-8 a value); within 2e-4 of the Pallas kernels (their own
    bf16 split error, ~2⁻¹⁶ a term, as tests/test_torch_k1_nb.py
    holds K1)."""
    num, codes, g, w, schema, ref_schema, groups = _inputs(name, 6001, 11,
                                                           general)
    xs, cs, ws, layout = port_g.sort_by_group(
        t(num), t(codes), t(g), schema=schema, num_groups=groups,
        weights=t(w))
    got = port_g.presorted_gram_split_plain(
        list(xs), list(cs), ws, layout.offsets, schema=schema).numpy()
    with pltpu.force_tpu_interpret_mode():
        rx, rc, rw, rlayout = ref_g.sort_by_group(
            num, codes, g, schema=ref_schema, num_groups=groups, weights=w,
            fast=not general, chunk_cols=512)
        ref = np.asarray(ref_sft(ref_g.sum_to_triple_grouped_presorted(
            rx, rc, rw, rlayout, schema=ref_schema)))
    exact = _oracle(num, codes, g, w, schema, groups, general)
    _assert_close(got, exact, exact, 1e-6, not general, schema)
    _assert_close(got, ref, exact, 2e-4, not general, schema)
    assert not got[groups - 1].any()               # the empty group
    assert np.array_equal(got, np.swapaxes(got, 1, 2))


@pytest.mark.parametrize("name", list(SCHEMAS))
@pytest.mark.parametrize("general", [False, True])
def test_unsorted_split_plain_matches_pallas_and_the_f64_oracle(name,
                                                                general):
    """K4's arithmetic (the group order, then K5's over the rows through
    it) on the same kind of rows in any order, against the JAX
    sum_to_triple_grouped_unsorted (its split-precision kernel for binary
    weights, the f32 one for general; interpret mode) and the f64 oracle,
    with the tolerances of the presorted test; and bit for bit K5's
    arithmetic over sort_by_group's rows (the same steps in the same
    order)."""
    num, codes, g, w, schema, ref_schema, groups = _inputs(name, 5003, 12,
                                                           general)
    got = port_g.grouped_gram_split_plain(
        t(num), t(codes), t(w), t(g), schema=schema,
        num_groups=groups).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ref_sft(ref_g.sum_to_triple_grouped_unsorted(
            jnp.asarray(num), jnp.asarray(codes), jnp.asarray(g),
            schema=ref_schema, num_groups=groups, weights=jnp.asarray(w),
            fast=not general, chunk_cols=512)))
    exact = _oracle(num, codes, g, w, schema, groups, general)
    _assert_close(got, exact, exact, 1e-6, not general, schema)
    _assert_close(got, ref, exact, 2e-4, not general, schema)
    xs, cs, ws, layout = port_g.sort_by_group(
        t(num), t(codes), t(g), schema=schema, num_groups=groups,
        weights=t(w))
    sorted_ = port_g.presorted_gram_split_plain(
        list(xs), list(cs), ws, layout.offsets, schema=schema).numpy()
    assert np.array_equal(got, sorted_)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4097])
def test_split_plains_on_small_and_ragged_n(n):
    """Every group shorter than or near one step, at ragged n: K4's and
    K5's arithmetic against the plain grouped Gram (f64 sums, one
    rounding): counts exact, the rest within 1e-6 of each group's
    max|σ|."""
    num, codes, g, w, schema, _, groups = _inputs("config4", n, n, False)
    want = port_g.grouped_gram_plain(t(num), t(codes), t(w), t(g),
                                     schema=schema, num_groups=groups).numpy()
    got = port_g.grouped_gram_split_plain(
        t(num), t(codes), t(w), t(g), schema=schema,
        num_groups=groups).numpy()
    _assert_close(got, want, want, 1e-6, True, schema)


@pytest.mark.parametrize("d,sizes,route", [
    (4, (8, 8), "tensor"), (3, (5, 5), "tensor"),
    (24, (21, 21, 21), "cores"), (10, (), "tensor"), (8, (8,), "cores")])
def test_presorted_grid_takes_the_route_of_tc_fits(d, sizes, route):
    """K4 and K5 take the tensor cores (TC_ROWS rows a step, `tc_grid`
    blocks) exactly where K1 does, and the CUDA cores' steps and grid
    elsewhere: the steps the wrapper hands the kernel and the route it
    takes there agree."""
    p = 1 + d + sum(sizes)
    n = 1_000_000
    assert _build.tc_fits(d, p) == (route == "tensor")
    grid = _build.presorted_grid(d, p, n)
    if route == "tensor":
        assert grid == (_build.tc_grid(n), _build.TC_ROWS)
    else:
        assert grid == (_build.grid_blocks(n), _build.CHUNK_ROWS)
