"""The keyed column windows of K7 and K8, on the CPU.

A window's plan (`_build.keyed_window_plan`) splits its cells: past P =
1,024, the tables keyed on a categorical column J (K_J and every C_Jk keyed
on J's codes) that take more than one task are cut into tasks of one key
range of J, which walk only that range's rows of a copy of the columns
ordered by code_J (`window_order`; in K8 by (group, code_J)), cut into work
items (`keyed_items`); the rest of the window is the unkeyed cut, each
task over all rows. These tests hold, at small sizes with inputs made by
numpy from a seed:

- the keyed plan and the residual plan map every structurally nonzero
  place of a window exactly once (hypothesis over small schemas and
  windows), a keyed task's slabs lie in its key range, and no window of a
  schema of P ≤ 1,024 keys a column;
- S assembled from the keyed windows is exactly symmetric with weights
  whose sums depend on their order: both places of a cell come from one
  column's order and the same work items;
- the keyed arithmetic in plain torch (`masked_gram_window_keyed_plain`:
  the residual's cells over all rows, the keyed tasks' over the ordered
  rows, item after item) equals `masked_gram_window_plain`: counts exact,
  the rest within 1e-6 of max|σ|, with a hot key, empty keys, codes out of
  range and n not a multiple of 32;
- it matches the JAX package's `ring/striped.py:sigma_stripe` at the P =
  1,115 schema of tests/test_torch_past_1024.py and at two columns of
  2,048 levels with one code holding half the rows (counts exact, within
  1e-5 of max|σ|), and K8's (group, code) keying matches the JAX
  package's grouped sums there;
- the work items: each layer's tasks walk exactly the rows whose code lies
  in its key range (n where the range is every key and every code is in
  range), no item holds more than `_build.item_chunks(n)` chunks, their
  count stays within `_build.keyed_items_bound`, and the same inputs give
  the same order and items.

tests/test_torch_cuda.py holds the kernels against these plain versions on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring import sum as ref_sum
from duckdb_imputation_tpu.ring.striped import sigma_stripe as ref_stripe
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    keyed_items, keyed_tables_plain, keyed_work, masked_gram_window,
    masked_gram_window_keyed_plain, masked_gram_window_plain, window_columns,
    window_order)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    sort_by_group)

torch.set_num_threads(2)

CAP = _build.WIDE_TASK_BYTES // 8


def schema_of(d, sizes):
    return FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(range(v)) for v in sizes))


def structure(d, sizes) -> torch.Tensor:
    """bool[P, P]: the places of S that are not zero by construction."""
    p = 1 + d + sum(sizes)
    m = torch.ones((p, p), dtype=torch.bool)
    b = 1 + d
    for v in sizes:
        m[b:b + v, b:b + v] = torch.eye(v, dtype=torch.bool)
        b += v
    return m


def make_cols(d, sizes, n, seed, hot=None, used=None):
    """x N(0, 1); codes uniform over [−1, V] (−1 and V add nothing), or
    over the first `used[j]` levels of column j (the rest are empty keys);
    with `hot` = (column, share), that share of rows on code 7; binary
    weights. Returns (schema, x_cols, code_cols, w) as CPU tensors."""
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32))
          for _ in range(d)]
    cs = []
    for j, v in enumerate(sizes):
        hi = v + 1 if used is None else used[j]
        c = rng.integers(-1 if used is None else 0, hi, n)
        if hot is not None and hot[0] == j:
            c[rng.random(n) < hot[1]] = 7
        cs.append(torch.tensor(c.astype(np.int32)))
    w = torch.tensor((rng.random(n) > 0.25).astype(np.float32))
    return schema_of(d, sizes), xs, cs, w


def assert_window_close(got, want, d, lo, rel):
    """Counts exact (rows and columns of N and the one-hots), the rest
    within `rel` of max|σ|."""
    p = got.shape[-2]
    rows = torch.arange(p)[:, None]
    cols = torch.arange(lo, lo + got.shape[-1])[None]
    cm = ((rows == 0) | (rows > d)) & ((cols == 0) | (cols > d))
    assert torch.equal(got[..., cm], want[..., cm])
    scale = float(want.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= rel * scale


# ---------------------------------------------------------------------------
# The plans

@settings(max_examples=40, deadline=None)
@given(d=st.integers(0, 2),
       sizes=st.lists(st.integers(1, 700), min_size=1, max_size=3),
       lo_frac=st.floats(0.0, 1.0), width=st.integers(1, 700))
def test_keyed_and_residual_plans_cover_each_place_once(d, sizes, lo_frac,
                                                         width):
    """Between them the residual and the keyed plans map every
    structurally nonzero place of the window once, and nothing else; the
    keyed columns are none up to P = 1,024, else those whose tables take
    more than one task in all of S or in one of masked_gram's windows
    (one rule for every window); a keyed task's slabs key on its column
    within its key range (a CR slab over all of it), its cells fit a
    task, and the tasks of a layer have disjoint ranges; every table of a
    C_jk with a keyed column keys on one owner in every window."""
    sizes = tuple(sizes)
    p = 1 + d + sum(sizes)
    lo = min(int(lo_frac * p), p - 1)
    hi = min(lo + width, p)
    residual, keyed = _build._keyed_window_plan(d, sizes, lo, hi)
    entries = [pl.entries.long() for pl in (residual,
                                            keyed and keyed.plan) if pl]
    e = torch.cat(entries) if entries else torch.zeros((0, 4), dtype=int)
    assert bool(((e[:, 3] >= lo) & (e[:, 3] < hi)).all())
    hits = torch.bincount(e[:, 2] * (hi - lo) + e[:, 3] - lo,
                          minlength=p * (hi - lo)).reshape(p, hi - lo)
    assert int(hits.max()) <= 1
    assert torch.equal(hits.bool(), structure(d, sizes)[:, lo:hi])
    everywhere = _build.keyed_columns(d, sizes)
    if p <= _build.MAX_WIDE_SIGMA_SIZE:
        assert everywhere == () and keyed is None
    fill = {}                    # the most tasks a column's tables fill in
    for a, b in [(0, p)] + [(a, min(a + _build.WINDOW_WIDTH, p))
                            for a in range(0, p, _build.WINDOW_WIDTH)]:
        for j, t in _build._key_cells(_build._window_tables(
                d, sizes, a, b, everywhere)[1], CAP).items():
            fill[j] = max(fill.get(j, 0), t)
    assert all(fill[j] > 1 for j in everywhere)
    _, tables = _build._window_tables(d, sizes, lo, hi, everywhere)
    want_keyed = tuple(sorted({tb[1] for tb in tables} & set(everywhere)))
    for j in range(len(sizes)):         # a pair's owner, in every window
        for k in range(j + 1, len(sizes)):
            if j in everywhere or k in everywhere:
                own = {tb[1] for a in range(0, p, 97)
                       for tb in _build._window_tables(
                           d, sizes, a, min(a + 97, p), everywhere)[1]
                       if tb[0] != _build.SLAB_K and {tb[1], tb[2]} == {j, k}}
                assert len(own) == 1 and own <= set(everywhere)
    assert (keyed.columns if keyed else ()) == want_keyed
    if residual is not None:   # no slab of the residual keys on a keyed col
        rs = residual.slabs
        keyed_on = torch.where(rs[:, 0] == _build.SLAB_D, -1, rs[:, 1])
        assert not any(int(j) in want_keyed for j in keyed_on)
    if keyed is None:
        return
    plan = keyed.plan
    cells = plan.task_base[1:] - plan.task_base[:-1]
    assert int(cells.max()) <= CAP
    tk = keyed.task_keys.tolist()
    for sl in plan.slabs.tolist():
        j, u_lo, u_hi = tk[sl[6]]
        assert sl[1] == j
        if sl[0] == _build.SLAB_CR:          # rows [sl[3], sl[4]) of sl[2]
            assert 0 <= sl[3] < sl[4] <= sizes[sl[2]]
            continue
        assert sl[0] in (_build.SLAB_K, _build.SLAB_C)
        a, b = (sl[2], sl[3]) if sl[0] == _build.SLAB_K else (sl[3], sl[4])
        assert u_lo <= a < b <= u_hi
    for ly, (j, k_lo, k_hi) in enumerate(keyed.layer_keys):
        ranges = sorted((tk[t][1], tk[t][2]) for t in range(len(tk))
                        if keyed.layer_of[t] == ly)
        assert all(tk[t][0] == j for t in range(len(tk))
                   if keyed.layer_of[t] == ly)
        assert ranges[0][0] >= k_lo and ranges[-1][1] <= k_hi
        assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_favorita_items_keys_the_item_and_wide16k_both_columns():
    """At favorita_items every window keys item_nbr in one layer of all
    its tables, and window 0 also class, whose whole cross tables take 7
    tasks there; at wide16k window 0 keys column 0 in two layers (C_01
    fills a task a key, K_0 beside it) and column 1 in one, and a window
    of column 1's keys takes C_01 over column 0's order (its owner, CR
    slabs); favorita_wide (P = 492) keys no column in any window, so its
    windows keep the unkeyed plan."""
    items = schema_of(3, (54, 33, 337, 2, 2, 22, 16, 5, 17, 4100))
    p = items.sigma_size
    for lo in range(0, p, 1024):
        _, keyed = _build.keyed_window_plan(items, lo, min(lo + 1024, p))
        assert keyed.columns == ((2, 9) if lo == 0 else (9,))
        assert sum(1 for j, _, _ in keyed.layer_keys if j == 9) == 1
    wide = schema_of(2, (8192, 8192))
    _, keyed = _build.keyed_window_plan(wide, 0, 1024)
    assert keyed.columns == (0, 1)
    assert [j for j, _, _ in keyed.layer_keys] == [0, 0, 1]
    _, keyed = _build.keyed_window_plan(wide, 9 * 1024, 10 * 1024)
    assert keyed.columns == (0, 1)
    cr = keyed.plan.slabs[keyed.plan.slabs[:, 0] == _build.SLAB_CR]
    assert cr.shape[0] > 0 and bool((cr[:, 1] == 0).all())
    fav_wide = schema_of(3, (54, 33, 337, 2, 2, 22, 16, 5, 17))
    assert _build.keyed_columns(3, tuple(fav_wide.cat_sizes)) == ()
    for lo in range(0, fav_wide.sigma_size, 128):
        hi = min(lo + 128, fav_wide.sigma_size)
        residual, keyed = _build.keyed_window_plan(fav_wide, lo, hi)
        assert keyed is None
        assert torch.equal(residual.slabs,
                           _build.window_plan(fav_wide, lo, hi).slabs)


# ---------------------------------------------------------------------------
# The keyed arithmetic against the plain window

CASES = {
    # name: (d, sizes, n, hot, used)
    "past_1024": (3, (6, 5, 1100), 3001, None, None),
    "hot key": (1, (2048, 40), 4003, (0, 0.5), None),
    # column 0 keyed, its C_01 over its order in a window of column 1's
    # keys only (a CR slab), column 1 not keyed
    "empty keys": (2, (700, 330, 3), 2999, None, (90, 330, 3)),
    # K_0 alone takes more than a task (600 · 16 cells)
    "every column keyed": (15, (600, 700), 1000, (1, 0.3), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_keyed_plain_equals_window_plain(name):
    """Every window of 1,024 columns (and one of 37 across two one-hot
    blocks): the keyed arithmetic equals masked_gram_window_plain, counts
    exact, the rest within 1e-6 of max|σ|; the CPU wrapper takes the
    plain version."""
    d, sizes, n, hot, used = CASES[name]
    if name == "every column keyed":
        assert _build.keyed_columns(d, sizes) == (0, 1)
    schema, xs, cs, w = make_cols(d, sizes, n, seed=len(name), hot=hot,
                                  used=used)
    p = schema.sigma_size
    wins = [(lo, min(1024, p - lo)) for lo in range(0, p, 1024)]
    lo = max(0, 1 + d + sizes[0] - 20)
    wins.append((lo, min(37, p - lo)))
    keyed_any = False
    for lo, width in wins:
        keyed_any |= _build.keyed_window_plan(schema, lo, lo + width)[1] \
            is not None
        got = masked_gram_window_keyed_plain(xs, cs, w, schema=schema, lo=lo,
                                             width=width)
        want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                        width=width)
        assert_window_close(got, want, d, lo, 1e-6)
        assert torch.equal(masked_gram_window(xs, cs, w, schema=schema,
                                              lo=lo, width=width), want)
    assert keyed_any


def test_keyed_grouped_plain_equals_each_groups_window():
    """K8's keying by (group, code): each group's window from the keyed
    arithmetic over group-sorted rows (ids past G dropped) equals the
    plain window of that group's rows alone."""
    d, sizes = 3, (6, 5, 1100)
    schema, xs, cs, w = make_cols(d, sizes, 3001, seed=9, hot=(2, 0.4))
    rng = np.random.default_rng(10)
    g = torch.tensor(rng.integers(0, 4, 3001).astype(np.int32))  # 3 = past
    x_s, c_s, w_s, layout = sort_by_group(torch.stack(xs), torch.stack(cs),
                                          g, schema=schema, num_groups=3,
                                          weights=w)
    off = layout.offsets.tolist()
    for lo, width in ((0, 1024), (1024, schema.sigma_size - 1024)):
        got = masked_gram_window_keyed_plain(
            list(x_s), list(c_s), w_s, schema=schema, lo=lo, width=width,
            offsets=layout.offsets)
        assert got.shape == (3, schema.sigma_size, width)
        for gg in range(3):
            rows = slice(off[gg], off[gg + 1])
            want = masked_gram_window_plain(
                list(x_s[:, rows]), list(c_s[:, rows]), w_s[rows],
                schema=schema, lo=lo, width=width)
            assert_window_close(got[gg], want, d, lo, 1e-6)


@pytest.mark.parametrize("sizes", [(600, 700), (700, 330, 3)])
def test_keyed_windows_give_an_exactly_symmetric_sigma(sizes, monkeypatch):
    """S assembled from the keyed arithmetic of masked_gram's windows is
    exactly symmetric where a hot cell's rows span several work items and
    C_01's places lie in different windows: both columns keyed (600 ×
    700) or one (700 × 330). The hot cell's weights cycle through 2^60,
    −2^60 and 1, so its f64 sum depends on how its rows are grouped (a
    1 added to ±2^60 is lost). Each place of a C_jk cell comes from its
    owner's order and the same work items in both windows; summed in two
    orders, or in items cut from two task starts, the places differ."""
    monkeypatch.setattr(_build, "ITEM_MIN_CHUNKS", 4)
    d, n = 1, 6000
    rng = np.random.default_rng(19)
    schema = schema_of(d, sizes)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32))]
    cs = []
    for v in sizes:     # a hot code in the last window of each column
        c = rng.integers(0, v, n)
        c[rng.random(n) < 0.4] = v - 5
        cs.append(torch.tensor(c.astype(np.int32)))
    w = rng.choice([0.5, 1.0, 1.5], n)
    hot = np.flatnonzero((cs[0].numpy() == sizes[0] - 5)
                         & (cs[1].numpy() == sizes[1] - 5))
    w[hot] = np.resize([2.0 ** 60, -2.0 ** 60, 1.0], hot.size)
    w = torch.tensor(w.astype(np.float32))
    p = schema.sigma_size
    assert p > _build.MAX_WIDE_SIGMA_SIZE and _build.keyed_columns(
        d, sizes)
    sigma = torch.cat([masked_gram_window_keyed_plain(
        xs, cs, w, schema=schema, lo=lo, width=min(1024, p - lo))
        for lo in range(0, p, 1024)], 1)
    assert torch.equal(sigma, sigma.T)


# ---------------------------------------------------------------------------
# Against the JAX package

def jax_stripe(schema, xs, cs, w, lo, width):
    ref = RefSchema(num_cols=schema.num_cols, cat_keys=schema.cat_keys)
    x = np.stack([v.numpy() for v in xs]) if xs else np.zeros(
        (0, w.shape[0]), np.float32)
    return np.asarray(ref_stripe(jnp.asarray(x),
                                 jnp.asarray(np.stack([c.numpy()
                                                       for c in cs])),
                                 jnp.asarray(w.numpy()), schema=ref, lo=lo,
                                 width=width))


@pytest.mark.parametrize("name", ["past_1024", "two of 2,048"])
def test_keyed_windows_match_jax_sigma_stripe(name):
    """The keyed arithmetic of each window of 1,024 against the JAX
    package's sigma_stripe: counts exact, within 1e-5 of max|σ| (a column
    keyed where its tables fill more than one task)."""
    if name == "past_1024":
        schema, xs, cs, w = make_cols(3, (6, 5, 1100), 3000, seed=11)
    else:            # one code of column 0 holds half the rows
        schema, xs, cs, w = make_cols(1, (2048, 2048), 4000, seed=12,
                                      hot=(0, 0.5))
    p = schema.sigma_size
    keyed = 0
    for lo in range(0, p, 1024):
        width = min(1024, p - lo)
        keyed += _build.keyed_window_plan(schema, lo, lo + width)[1] \
            is not None
        got = masked_gram_window_keyed_plain(xs, cs, w, schema=schema, lo=lo,
                                             width=width)
        want = torch.tensor(jax_stripe(schema, xs, cs, w, lo, width))
        assert_window_close(got, want, schema.num_cols, lo, 1e-5)
    assert keyed >= 1


def test_k8_keying_matches_jax_grouped():
    """K8's windows by the keyed arithmetic over rows sorted by group (ids
    past G dropped) at P = 1,115, G = 3, against the JAX package's
    sum_to_triple_grouped: counts exact, within 1e-5 of max|σ| (the item
    column keyed)."""
    d, sizes = 3, (6, 5, 1100)
    schema, xs, cs, w = make_cols(d, sizes, 3000, seed=13, hot=(2, 0.3),
                                  used=sizes)
    rng = np.random.default_rng(14)
    g = rng.integers(0, 3, 3000).astype(np.int32)
    g[:17] = 4
    x, c = torch.stack(xs), torch.stack(cs)
    x_s, c_s, w_s, layout = sort_by_group(x, c, torch.tensor(g),
                                          schema=schema, num_groups=3,
                                          weights=w)
    p = schema.sigma_size
    got = torch.cat([masked_gram_window_keyed_plain(
        list(x_s), list(c_s), w_s, schema=schema, lo=lo,
        width=min(1024, p - lo), offsets=layout.offsets)
        for lo in range(0, p, 1024)], -1)
    ref = RefSchema(num_cols=d, cat_keys=schema.cat_keys)
    want = torch.tensor(np.asarray(ref_sft(ref_sum.sum_to_triple_grouped(
        jnp.asarray(x.numpy()), jnp.asarray(c.numpy()), jnp.asarray(g),
        schema=ref, num_groups=3, weights=jnp.asarray(w.numpy()),
        method="masked"))))
    for gg in range(3):
        assert_window_close(got[gg], want[gg], d, 0, 1e-5)


# ---------------------------------------------------------------------------
# The order and the work items

@pytest.mark.parametrize("groups", [None, 3])
def test_items_walk_each_row_of_their_range_once(groups, monkeypatch):
    """Per keyed layer, the work items' rows sum to the rows whose code
    lies in the layer's key range (once a group); a layer over every key
    of a column whose codes all lie in range walks exactly n rows. Each
    item holds at most item_chunks(n) chunks, the items stay within the
    bound the kernel's grid is sized by, and the rows of each (task,
    group) are the ordered rows of its keys."""
    monkeypatch.setattr(_build, "ITEM_MIN_CHUNKS", 2)  # several items a task
    d, sizes, n = 1, (2048, 40), 20_003
    schema, xs, cs, w = make_cols(d, sizes, n, seed=15, hot=(0, 0.5),
                                  used=(2048, 40))
    offsets = None
    if groups:
        g = torch.tensor(np.random.default_rng(16).integers(
            0, groups, n).astype(np.int32))
        x_s, c_s, w, layout = sort_by_group(torch.stack(xs), torch.stack(cs),
                                            g, schema=schema,
                                            num_groups=groups, weights=w)
        xs, cs, offsets = list(x_s), list(c_s), layout.offsets
    lo, hi = 0, 1024
    keyed = _build.keyed_window_plan(schema, lo, hi)[1]
    assert keyed.columns == (0,)
    order = window_order(xs, cs, w, schema=schema, columns=keyed.columns,
                         offsets=offsets)
    work = keyed_work(keyed, order, n, schema)
    assert work["rows"] == work["in_range"]
    full = [name for name, _ in work["rows"].items()
            if name.endswith("keys 0-2048")]
    assert full and all(work["rows"][name] == n for name in full)
    m = _build.item_chunks(n)
    item_cum, c0, r0, r1 = keyed_items(keyed, order, n, schema)
    # a key's chunks start at its first row
    per_key = (order.key_off[1:] - order.key_off[:-1]
               + _build.WIDE_CHUNK - 1) // _build.WIDE_CHUNK
    chunks = torch.tensor([[int(per_key[g * 2048 + u_lo:g * 2048 + u_hi]
                                .sum()) for g in range(order.groups)]
                           for _, u_lo, u_hi in keyed.task_keys.tolist()])
    assert torch.equal(order.key_chunks[1:] - order.key_chunks[:-1],
                       per_key)
    items = (item_cum[1:] - item_cum[:-1]).reshape(chunks.shape)
    # an item each block of m chunks of the copy that a task's chunks meet
    c1 = c0 + chunks
    assert torch.equal(items, torch.where(chunks > 0,
                                          (c1 + m - 1) // m - c0 // m, 0))
    assert int(items.max()) > 1               # the hot key's task is cut
    assert work["items"] <= _build.keyed_items_bound(keyed, n, groups or 1)
    # the rows of a task are its keys' rows, in the column's order
    codes = order.rows[0, :, 1 + d]
    for t, (j, u_lo, u_hi) in enumerate(keyed.task_keys.tolist()):
        for gg in range(order.groups):
            seg = codes[int(r0[t, gg]):int(r1[t, gg])]
            assert bool(((seg >= u_lo) & (seg < u_hi)).all())


def test_order_and_items_depend_only_on_the_inputs():
    """Two orders of the same inputs, and their work items, are equal; the
    order is stable (rows of one code keep their input order) and puts
    codes out of range last."""
    schema, xs, cs, w = make_cols(3, (6, 5, 1100), 3000, seed=17,
                                  hot=(2, 0.3))
    cols = window_columns(schema, range(0, schema.sigma_size, 1024), 1024)
    a = window_order(xs, cs, w, schema=schema, columns=cols)
    b = window_order(xs, cs, w, schema=schema, columns=cols)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.key_off, b.key_off)
    keyed = _build.keyed_window_plan(schema, 0, 1024)[1]
    for x, y in zip(keyed_items(keyed, a, 3000, schema),
                    keyed_items(keyed, b, 3000, schema)):
        assert torch.equal(x, y)
    j = cols[0]
    v = schema.cat_sizes[j]
    c = cs[j].long()
    key = torch.where((c >= 0) & (c < v), c, v)
    perm = torch.tensor(np.argsort(key.numpy(), kind="stable"))
    ordered = a.rows[0]
    assert ordered.shape == (3000, _build.order_stride(1 + 3 + 3))
    assert torch.equal(ordered[:, 1 + 3 + j], cs[j][perm])
    assert torch.equal(ordered[:, 0].view(torch.float32), w[perm])
    assert not bool(ordered[:, 1 + 3 + 3:].any())
    assert int(a.key_off[v]) == int(((c >= 0) & (c < v)).sum())


def test_window_order_raises_past_its_keys():
    """G·V_J ≥ 2³¹ keys cannot be ordered: ValueError before any copy."""
    schema = schema_of(0, (50_000,))
    cs = [torch.zeros(10, dtype=torch.int32)]
    w = torch.ones(10)
    offsets = torch.tensor([0] + [10] * 50_000, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        window_order([], cs, w, schema=schema, columns=(0,), offsets=offsets)


def test_keyed_tables_are_the_same_in_one_item_or_many(monkeypatch):
    """The keyed arithmetic of a window with many work items a task (the
    hot key's rows cut into items of 8 chunks) equals the same with one
    item a task: counts exactly, the rest within f64 rounding."""
    schema, xs, cs, w = make_cols(1, (2048, 40), 5000, seed=18,
                                  hot=(0, 0.5))
    keyed = _build.keyed_window_plan(schema, 0, 1024)[1]
    order = window_order(xs, cs, w, schema=schema, columns=keyed.columns)
    many = keyed_tables_plain(order, keyed, schema=schema, n=5000)
    assert int(keyed_items(keyed, order, 5000, schema)[0][-1]) > \
        keyed.num_tasks
    monkeypatch.setattr(_build, "ITEM_MIN_CHUNKS", 1 << 20)
    assert int(keyed_items(keyed, order, 5000, schema)[0][-1]) <= \
        keyed.num_tasks
    one = keyed_tables_plain(order, keyed, schema=schema, n=5000)
    assert one.shape == many.shape == (1, int(keyed.plan.task_base[-1]))
    assert float((one - many).abs().max()) <= 1e-12 * float(
        one.abs().max())
    got = masked_gram_window_keyed_plain(xs, cs, w, schema=schema, lo=0,
                                         width=1024)
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=0,
                                    width=1024)
    assert_window_close(got, want, 1, 0, 1e-6)
