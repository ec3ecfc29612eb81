"""The port's kernels on a CUDA card: K1 (masked_gram_cols, and its
stacked entry point masked_gram behind sum_to_triple), K2
(fused_impute_aggregate: on K1's tensor-core kernel at config 5, on the
CUDA cores past its tile), K3 and K3w (qda_predict_kernel), K4 (grouped_gram:
a group order, then K5's kernel through it), K5 (grouped_gram_presorted: on
K1's tensor-core body at config 4, on the CUDA cores past its tile), K6
(nb_grouped_sums), and for P > 88 K7 (the wide
masked Gram behind masked_gram_cols and masked_gram) and K2w (the wide
fused pass) against their plain versions, K7's and K8's keyed column
windows past P = 1,024 and their row order (the order kernels), the
plans that cut a cross table by row code (K7, K8 and K3w at a 64-cell
budget; criteo_pair's window inside C15) and K3w's i32 codes at a ZIP5
column, the routes past the shared-memory column limits (K_j as KB
slabs in K7 and K8, K2w's impute kernel reading x from device memory,
K3w's local plans at 784 and 2,000 columns, the order copying rows of
1,008 ints in pieces), the checks their wrappers make,
and run_mice_device, run_mice_device_delta (also with the GD trainer),
the host MICE drivers (run_mice_baseline / low / high, through
masked_gram) and the QDA pipeline on the card against the plain versions
on the CPU. Every test here needs the card
and skips without one.

This file imports neither jax nor sklearn, so it runs on a machine that
has only torch; tests/conftest.py imports jax, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import (
    run_mice_device,
    run_mice_device_delta,
)
from duckdb_imputation_tpu_torch.models.device import (
    qda_predict_device,
    qda_train_device,
)
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
    nb_grouped_sums,
    nb_grouped_sums_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import (
    nb_tables,
    qda_predict_kernel,
    qda_predict_plain,
    qda_tables,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
    fused_impute_aggregate_plain,
    fused_impute_aggregate_split_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram,
    masked_gram_cols,
    masked_gram_cols_plain,
    masked_gram_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped import (
    grouped_gram,
    grouped_gram_plain,
    grouped_gram_presorted,
    grouped_gram_presorted_plain,
    grouped_gram_split_plain,
    grouped_route,
    sort_by_group,
)
from duckdb_imputation_tpu_torch.ring.sum import (
    sum_to_triple,
    sum_to_triple_grouped,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

torch.set_num_threads(2)

SCHEMA = FeatureSchema(num_cols=4, cat_keys=(tuple(range(8)),) * 2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def count_mask(schema, device):
    p, d = schema.sigma_size, schema.num_cols
    m = torch.zeros((p, p), dtype=torch.bool, device=device)
    m[0, 0] = True
    m[0, 1 + d:] = True
    m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def make_cols(n, seed, device, oov=True):
    rng = np.random.default_rng(seed)
    num = (rng.normal(size=(4, n)) * 2 + 0.5).astype(np.float32)
    codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
    if oov:
        codes[0, :n // 10] = 8        # = size_0: the encode() miss code
        codes[1, n // 10:n // 5] = -1
    w = (rng.random(n) > 0.3).astype(np.float32)
    return ([torch.tensor(a, device=device) for a in num],
            [torch.tensor(a, device=device) for a in codes],
            torch.tensor(w, device=device))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70_001])
def test_masked_gram_cols_kernel_matches_plain(cuda, n):
    """Ragged n (one row, a partial chunk, exact chunks): counts exact, the
    rest within rtol 1e-5 (f32 accumulation in another order), and two
    launches bit-identical."""
    xs, cs, w = make_cols(n, seed=n, device=cuda)
    before = masked_gram_cols.launches
    got = masked_gram_cols(xs, cs, w, schema=SCHEMA)
    again = masked_gram_cols(xs, cs, w, schema=SCHEMA)
    assert masked_gram_cols.launches == before + 2
    want = masked_gram_cols_plain(xs, cs, w, schema=SCHEMA)
    assert torch.equal(got, again)
    cm = count_mask(SCHEMA, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("d,keys", [
    (1, ((0, 1, 2),) * 3), (1, (tuple(range(70)),)),
    (24, (tuple(range(21)),) * 3)])
def test_masked_gram_cols_kernel_other_schemas(cuda, d, keys):
    """A narrow schema (P = 11, on the tensor cores), one near the kernel's
    P limit (P = 72) and one at it with many numerics (P = 88, d = 24), both
    on the CUDA cores."""
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    assert _build.tc_fits(d, schema.sigma_size) == (schema.sigma_size == 11)
    rng = np.random.default_rng(2)
    n = 40_000
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(d)]
    cs = [torch.tensor(rng.integers(0, len(k) + 1, n).astype(np.int32),
                       device=cuda) for k in keys]
    got = masked_gram_cols(xs, cs, None, schema=schema)
    want = masked_gram_cols_plain(xs, cs, None, schema=schema)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[cm], want[cm])
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("binary", [True, False])
def test_sum_to_triple_kernel_on_the_card_matches_cpu(cuda, binary):
    """sum_to_triple on CUDA tensors launches K1 once through its stacked
    entry point, masked_gram (and not through masked_gram_cols), and gives
    the plain CPU triple: counts exact with binary weights, the rest within
    1e-5 of max|σ|; a rerun is bit-identical."""
    x, c, w, _ = grouped_inputs(70_001, 1, cuda, binary=binary)
    before, cols_before = masked_gram.launches, masked_gram_cols.launches
    got = sigma_from_triple(sum_to_triple(x, c, w, schema=SCHEMA))
    assert masked_gram.launches == before + 1
    assert masked_gram_cols.launches == cols_before
    again = sigma_from_triple(sum_to_triple(x, c, w, schema=SCHEMA,
                                            backend="kernel"))
    assert torch.equal(got, again)
    want = sigma_from_triple(sum_to_triple(x.cpu(), c.cpu(), w.cpu(),
                                           schema=SCHEMA))
    got = got.cpu()
    if binary:
        cm = count_mask(SCHEMA, "cpu")
        assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("d,keys", [(0, ((0, 1, 2, 3),) * 2), (3, ())])
def test_masked_gram_kernel_without_one_block(cuda, d, keys):
    """The stacked entry point with no numeric rows, or no categorical
    rows: the empty block is one of no column pointers."""
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    rng = np.random.default_rng(6)
    n = 30_001
    x = torch.tensor(rng.normal(size=(d, n)).astype(np.float32), device=cuda)
    c = torch.tensor(rng.integers(0, 5, size=(len(keys), n)).astype(
        np.int32), device=cuda)
    before = masked_gram.launches
    got = masked_gram(x, c, None, schema=schema)
    assert masked_gram.launches == before + 1
    want = masked_gram_plain(x.cpu(), c.cpu(), None, schema=schema)
    got = got.cpu()
    cm = count_mask(schema, "cpu")
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    strided = (x.T.contiguous().T, c) if d else (x, c.T.contiguous().T)
    with pytest.raises(ValueError):       # not contiguous
        masked_gram(*strided, None, schema=schema)


def fused_args(kind, n, device, seed=9):
    xs, cs, _ = make_cols(n, seed, device, oov=False)
    rng = np.random.default_rng(seed + 1)
    null = torch.tensor(rng.random(n) < 0.2, device=device)
    w_agg = torch.tensor((rng.random(n) > 0.2).astype(np.float32),
                         device=device)
    if kind == "cat":
        r = 8
        w_full = rng.normal(size=(21, r)).astype(np.float32)
        w_full[5:13] = 0.0
        icpt = rng.normal(size=r).astype(np.float32)
        icpt[3] = -np.inf                 # an empty class
    else:
        r = 1
        w_full = rng.normal(size=(21, r)).astype(np.float32)
        w_full[2] = 0.0
        icpt = np.zeros(r, np.float32)
    return (xs, cs, null, w_agg, torch.tensor(w_full, device=device),
            torch.tensor(icpt, device=device))


@pytest.mark.parametrize("kind,noise", [("cat", False), ("num", False),
                                        ("num", True)])
def test_fused_impute_aggregate_kernel_matches_plain(cuda, kind, noise):
    """The kernel scores in the plain version's f32 order: codes equal,
    numerics equal up to log/cos rounding of the noise; sigma as K1."""
    args = fused_args(kind, 100_003, cuda)
    col = 0 if kind == "cat" else 1
    kw = dict(schema=SCHEMA, kind=kind, imp_col=col,
              noise=(5, 1, torch.tensor(0.7, device=cuda)) if noise else None)
    before = fused_impute_aggregate.launches
    new, sig = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.launches == before + 1
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
        assert not torch.any(new[args[2]] == 3)      # empty class
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sig, want_sig, rtol=1e-5,
                               atol=1e-6 * float(want_sig.abs().max()))
    assert torch.isfinite(sig).all()


@pytest.mark.parametrize("kind,noise", [("cat", False), ("num", False),
                                        ("num", True)])
def test_fused_tensor_core_route(cuda, kind, noise):
    """K2 at config 5 takes K1's tensor-core kernel with its impute
    prologue: one launch a call, reruns bit-identical; the column as the
    plain version's (codes equal); sigma bit for bit K1's Gram of the
    updated columns (the same kernel on the same values), within 1e-5 of
    max|σ| of the plain split arithmetic, counts exact."""
    assert _build.tc_fits(SCHEMA.num_cols, SCHEMA.sigma_size)
    args = fused_args(kind, 100_003, cuda)
    col = 0 if kind == "cat" else 1
    kw = dict(schema=SCHEMA, kind=kind, imp_col=col,
              noise=(5, 1, torch.tensor(0.7, device=cuda)) if noise else None)
    before = fused_impute_aggregate.launches
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.launches == before + 2
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    want_new, want_sig = fused_impute_aggregate_split_plain(
        *(a.cpu() if torch.is_tensor(a) else [t.cpu() for t in a]
          for a in args), **{**kw, "noise": None if not noise else
                             (5, 1, torch.tensor(0.7))})
    xs, cs = list(args[0]), list(args[1])
    if kind == "cat":
        assert torch.equal(new.cpu(), want_new)
        cs[col] = new
    else:
        torch.testing.assert_close(new.cpu(), want_new, rtol=1e-6,
                                   atol=1e-6)
        xs[col] = new
    assert torch.equal(sig, masked_gram_cols(xs, cs, args[3], schema=SCHEMA))
    sig = sig.cpu()
    cm = count_mask(SCHEMA, "cpu")
    if kind == "cat":
        assert torch.equal(sig[cm], want_sig[cm])
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("kind,offset", [("cat", 1), ("num", 3)])
def test_fused_tensor_core_route_null_bytes_off_the_word(cuda, kind, offset):
    """A null mask that starts `offset` bytes into a 4-byte word and ends
    inside one (n = 1,001): its first and last rows, null, are read byte
    by byte and imputed as the plain version does."""
    n = 1001
    args = list(fused_args(kind, n, cuda))
    base = torch.zeros(n + offset, dtype=torch.bool, device=cuda)
    null = base[offset:]
    null.copy_(args[2])
    null[:4] = True
    null[-4:] = True
    assert null.data_ptr() % 4 == offset and null.is_contiguous()
    args[2] = null
    col = 0 if kind == "cat" else 1
    kw = dict(schema=SCHEMA, kind=kind, imp_col=col)
    before = fused_impute_aggregate.launches
    new, sig = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.launches == before + 1
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    assert not torch.equal(new, args[0][col] if kind == "num" else
                           args[1][col])
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("kind", ["cat", "num"])
def test_fused_cuda_core_route_past_the_tile(cuda, kind):
    """A schema past the tensor cores' one output tile (P = 88, 24
    numerics, three columns of 21) takes K2's CUDA-core route: codes equal
    to the plain version's, numerics within 1e-6, sigma within 1e-5 of
    max|σ|, reruns bit-identical."""
    schema = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    assert not _build.tc_fits(24, schema.sigma_size)
    rng = np.random.default_rng(12)
    n = 70_001
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(24)]
    cs = [torch.tensor(rng.integers(-1, 22, n).astype(np.int32),
                       device=cuda) for _ in range(3)]
    null = torch.tensor(rng.random(n) < 0.2, device=cuda)
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=cuda)
    r, col = (21, 0) if kind == "cat" else (1, 1)
    w_full = torch.tensor(rng.normal(size=(88, r)).astype(np.float32),
                          device=cuda)
    icpt = torch.tensor(rng.normal(size=r).astype(np.float32), device=cuda)
    args = (xs, cs, null, w, w_full, icpt)
    kw = dict(schema=schema, kind=kind, imp_col=col)
    before = fused_impute_aggregate.launches
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.launches == before + 2
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


def test_kernels_raise_on_inputs_they_do_not_take(cuda):
    xs, cs, w = make_cols(1000, seed=1, device=cuda)
    with pytest.raises(ValueError):       # mixed devices
        masked_gram_cols(xs, cs, w.cpu(), schema=SCHEMA)
    with pytest.raises(ValueError):       # wrong dtype
        masked_gram_cols([x.double() for x in xs], cs, None, schema=SCHEMA)
    with pytest.raises(ValueError):       # not contiguous
        masked_gram_cols([torch.stack([x, x], 1)[:, 0] for x in xs], cs,
                         None, schema=SCHEMA)
    wide = FeatureSchema(num_cols=4, cat_keys=(tuple(range(
        _build.MAX_WINDOW_SIGMA_SIZE)),))
    assert wide.sigma_size > _build.MAX_WINDOW_SIGMA_SIZE
    with pytest.raises(ValueError, match="sigma size"):   # above K7's windows
        masked_gram_cols(xs, cs[:1], None, schema=wide)
    # the scorer stops at MAX_SCORER_SIGMA_SIZE (a class's whole P² form):
    # P = 47,412 on CUDA tensors raises before any launch
    scorer_past = FeatureSchema(num_cols=4, cat_keys=(tuple(range(47407)),))
    assert scorer_past.sigma_size > _build.MAX_SCORER_SIGMA_SIZE
    before = qda_predict_kernel.wide_launches
    with pytest.raises(ValueError, match="sigma size"):
        qda_predict_kernel(
            torch.zeros((2, 8), device=cuda),
            _build.qda_plan(FeatureSchema(num_cols=4, cat_keys=(
                tuple(range(1020)),))),
            torch.stack(xs), torch.stack(cs[:1]), schema=scorer_past)
    assert qda_predict_kernel.wide_launches == before
    above = FeatureSchema(num_cols=4, cat_keys=(tuple(range(9000)),
                                                tuple(range(8))))
    assert above.sigma_size > _build.MAX_WIDE_SIGMA_SIZE
    # K2w past 1,024 is K7's windows, whose plans cut a cross table by row
    # code too: a column past a K7 task beside another is taken, and
    # equals the plain version
    fargs = (xs, cs, torch.arange(1000, device=cuda) % 5 == 0, w,
             torch.zeros((above.sigma_size, 8), device=cuda),
             torch.arange(8, dtype=torch.float32, device=cuda))
    new, sig = fused_impute_aggregate(*fargs, schema=above, kind="cat",
                                      imp_col=1)
    want_new, want_sig = fused_impute_aggregate_plain(
        *fargs, schema=above, kind="cat", imp_col=1)
    assert torch.equal(new, want_new)
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))
    args = fused_args("cat", 1000, cuda)
    with pytest.raises(ValueError):       # w_full of the wrong width
        fused_impute_aggregate(*args[:4], args[4][:, :3], args[5][:3],
                               schema=SCHEMA, kind="cat", imp_col=0)


def test_run_mice_device_on_the_card_matches_cpu(cuda):
    """On a CUDA table 'auto' takes K1 and 'fused' takes K1 and K2; both
    give the plain CPU loop's codes, and numerics within 1e-4."""
    rng = np.random.default_rng(4)
    n = 50_000
    z0, z1 = rng.normal(size=n), rng.normal(size=n)
    x = np.stack([z0, 2 * z0 + z1, z1 - z0, rng.normal(size=n)],
                 1).astype(np.float32)
    c = np.stack([np.clip(z0 + 4.0, 0, 7).astype(int),
                  rng.integers(0, 8, n)], 1)
    nn = np.zeros((n, 4), bool)
    nn[:, 1] = rng.random(n) < 0.2
    cn = np.zeros((n, 2), bool)
    cn[:, 0] = rng.random(n) < 0.2
    ref = run_mice_device(from_numpy(x, c, nn, cn, device="cpu"), iters=2,
                          kernel="plain")
    k1, k2 = masked_gram_cols.launches, fused_impute_aggregate.launches
    auto = run_mice_device(from_numpy(x, c, nn, cn, device=cuda), iters=2)
    assert masked_gram_cols.launches > k1
    fused = run_mice_device(from_numpy(x, c, nn, cn, device=cuda), iters=2,
                            kernel="fused")
    assert fused_impute_aggregate.launches > k2
    for out in (auto, fused):
        agree = (out.cat_codes.cpu() == ref.cat_codes).float().mean()
        assert float(agree) >= 0.999
        torch.testing.assert_close(out.num_data.cpu(), ref.num_data,
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The classifier path: K3 (qda_predict_kernel), K4 (grouped_gram), K5
# (grouped_gram_presorted), K6 (nb_grouped_sums)
# ---------------------------------------------------------------------------

def grouped_inputs(n, groups, device, seed=3, binary=True):
    xs, cs, w = make_cols(n, seed, device)
    rng = np.random.default_rng(seed + 1)
    g = np.where(rng.random(n) < 0.9, 0, rng.integers(0, groups, n))
    g[: n // 50] = groups + 2                      # out of range: dropped
    g[n // 50: n // 40] = -1
    if not binary:
        w = torch.tensor(rng.random(n).astype(np.float32), device=device)
    return (torch.stack(xs), torch.stack(cs), w,
            torch.tensor(g.astype(np.int32), device=device))


def assert_grouped_close(got, want):
    """Counts exact; the rest within 1e-5 of each group's max|σ|."""
    cm = count_mask(SCHEMA, got.device)
    for g in range(got.shape[0]):
        assert torch.equal(got[g][cm], want[g][cm])
        scale = max(float(want[g].abs().max()), 1.0)
        torch.testing.assert_close(got[g], want[g], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("n,groups,binary", [
    (1, 3, True), (257, 8, True), (70_001, 8, True), (70_001, 5, False),
    (100_003, 1, True), (100_003, 2, True), (300_007, 8, False)])
def test_grouped_gram_kernel_matches_plain(cuda, n, groups, binary):
    """K4 (the group order, then K5's tensor-core kernel through it) on
    ragged n, skew, dropped ids, G from 1 to 8."""
    x, c, w, g = grouped_inputs(n, groups, cuda, binary=binary)
    before = grouped_gram.launches
    got = grouped_gram(x, c, w, g, schema=SCHEMA, num_groups=groups)
    again = grouped_gram(x, c, w, g, schema=SCHEMA, num_groups=groups)
    assert grouped_gram.launches == before + 2
    want = grouped_gram_plain(x, c, w, g, schema=SCHEMA, num_groups=groups)
    assert torch.equal(got, again)
    if binary:
        assert_grouped_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
    with pytest.raises(ValueError):
        grouped_gram(x, c, w, g, schema=SCHEMA, num_groups=9)


@pytest.mark.parametrize("n,groups", [(1000, 3), (70_001, 8),
                                      (200_003, 1000), (2_000_003, 1000)])
def test_grouped_gram_presorted_kernel_matches_plain(cuda, n, groups):
    """K5 after sort_by_group: segments of every length (1000 groups:
    many shorter than a step, some empty, and at 2M rows ~16 steps a
    group, several groups a block and its reduction one lane a (group,
    entry))."""
    x, c, w, g = grouped_inputs(n, groups, cuda)
    if groups == 1000:
        g = torch.randint(0, groups, (n,), dtype=torch.int32, device=cuda)
    xs, cs, ws, layout = sort_by_group(x, c, g, schema=SCHEMA,
                                       num_groups=groups, weights=w)
    before = grouped_gram_presorted.launches
    got = grouped_gram_presorted(xs, cs, ws, layout, schema=SCHEMA)
    again = grouped_gram_presorted(xs, cs, ws, layout, schema=SCHEMA)
    assert grouped_gram_presorted.launches == before + 2
    assert torch.equal(got, again)
    want = grouped_gram_presorted_plain(xs, cs, ws, layout, schema=SCHEMA)
    assert_grouped_close(got, want)


@pytest.mark.parametrize("groups,hot", [(1, True), (2, True), (8, True),
                                        (8, False)])
def test_grouped_kernels_on_the_tensor_cores(cuda, groups, hot):
    """At config 4 (`_build.tc_fits`) K4 and K5 take the tensor cores:
    bit-identical reruns, counts exact and within 1e-5 of each group's
    max|σ| against the plain version and against their split arithmetic
    (`grouped_gram_split_plain`: the same bf16 parts, summed in f64; the
    kernel's f32 sums of 4 steps are the difference); K4 and K5 agree on
    the counts of the same rows."""
    assert grouped_route(SCHEMA) == "tensor_cores"
    n = 200_003
    x, c, w, g = grouped_inputs(n, groups, cuda)
    if not hot:
        g = torch.randint(-1, groups + 1, (n,), dtype=torch.int32,
                          device=cuda)
    kw = dict(schema=SCHEMA, num_groups=groups)
    got = grouped_gram(x, c, w, g, **kw)
    assert torch.equal(got, grouped_gram(x, c, w, g, **kw))
    assert_grouped_close(got, grouped_gram_plain(x, c, w, g, **kw))
    assert_grouped_close(got.cpu(), grouped_gram_split_plain(
        x.cpu(), c.cpu(), w.cpu(), g.cpu(), **kw))
    xs, cs, ws, layout = sort_by_group(x, c, g, weights=w, **kw)
    k5 = grouped_gram_presorted(xs, cs, ws, layout, schema=SCHEMA)
    assert torch.equal(k5, grouped_gram_presorted(xs, cs, ws, layout,
                                                  schema=SCHEMA))
    assert_grouped_close(k5, grouped_gram_presorted_plain(
        xs, cs, ws, layout, schema=SCHEMA))
    cm = count_mask(SCHEMA, cuda)
    assert torch.equal(k5[:, cm], got[:, cm])


@pytest.mark.parametrize("groups", [3, 8])
def test_grouped_kernels_on_the_cuda_cores_at_p88(cuda, groups):
    """Past the tensor cores' tile (P = 88: 24 numeric and three
    categorical columns of 21) K4 and K5 take the CUDA cores: reruns
    bit-identical, counts exact, within 1e-5 of each group's max|σ|
    against the plain versions, K4's counts equal to K5's."""
    schema = FeatureSchema(num_cols=24, cat_keys=(tuple(range(21)),) * 3)
    assert grouped_route(schema) == "cuda_cores"
    n = 30_011
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    x = torch.randn((24, n), generator=gen, device=cuda) * 2 + 0.5
    c = torch.randint(-1, 22, (3, n), generator=gen, device=cuda,
                      dtype=torch.int32)
    g = torch.randint(-1, groups + 1, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    w = (torch.rand(n, generator=gen, device=cuda) > 0.3).float()
    kw = dict(schema=schema, num_groups=groups)
    got = grouped_gram(x, c, w, g, **kw)
    assert torch.equal(got, grouped_gram(x, c, w, g, **kw))
    want = grouped_gram_plain(x, c, w, g, **kw)
    cm = count_mask(schema, cuda)
    xs, cs, ws, layout = sort_by_group(x, c, g, weights=w, **kw)
    k5 = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    assert torch.equal(k5, grouped_gram_presorted(xs, cs, ws, layout,
                                                  schema=schema))
    for out in (got, k5):
        assert torch.equal(out[:, cm], want[:, cm])
        for k in range(groups):
            scale = max(float(want[k].abs().max()), 1.0)
            torch.testing.assert_close(out[k], want[k], rtol=0,
                                       atol=1e-5 * scale)


def test_sum_to_triple_grouped_kernel_on_the_card_matches_cpu(cuda):
    x, c, w, g = grouped_inputs(50_000, 12, cuda)
    for groups in (6, 12):                       # K4, then sort + K5
        got = sum_to_triple_grouped(x, c, g, schema=SCHEMA,
                                    num_groups=groups, weights=w)
        ref = sum_to_triple_grouped(x.cpu(), c.cpu(), g.cpu(), schema=SCHEMA,
                                    num_groups=groups, weights=w.cpu())
        assert_grouped_close(sigma_from_triple(got).cpu(),
                             sigma_from_triple(ref))


@pytest.mark.parametrize("n,groups,binary", [
    (1, 1, True), (70_001, 5, True), (70_001, 5, False), (100_003, 40, True)])
def test_nb_grouped_sums_kernel_matches_plain(cuda, n, groups, binary):
    """K6: counts exact, sums within 1e-5 relative; one launch a call for
    any number of groups."""
    x, c, w, g = grouped_inputs(n, groups, cuda, binary=binary)
    before = nb_grouped_sums.launches
    got = nb_grouped_sums(x, c, w, g, schema=SCHEMA, num_groups=groups)
    again = nb_grouped_sums(x, c, w, g, schema=SCHEMA, num_groups=groups)
    assert nb_grouped_sums.launches == before + 2
    assert torch.equal(got, again)
    want = nb_grouped_sums_plain(x, c, w, g, schema=SCHEMA,
                                 num_groups=groups)
    if binary:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 9:], want[:, 9:])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("general", [False, True])
def test_nb_grouped_sums_kernel_with_a_split_table(cuda, general):
    """G = 100 over a column of 200 values: the 100 × 200 table of its
    counts is cut by group range over several tasks, each reading the rows;
    one launch; counts exact (no weights), sums within 1e-5 relative, two
    calls bit-identical."""
    schema = FeatureSchema(num_cols=2, cat_keys=(tuple(range(200)),
                                                 tuple(range(8))))
    groups, n = 100, 200_003
    assert _build.nb_plan(schema, groups).num_tasks > 1
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(2, n)).astype(np.float32) * 2 + 1,
                     device=cuda)
    c = torch.tensor(np.stack([rng.integers(-1, 201, n),
                               rng.integers(0, 9, n)]).astype(np.int32),
                     device=cuda)
    g = torch.tensor(rng.integers(-1, groups + 1, n).astype(np.int32),
                     device=cuda)
    w = torch.rand(n, device=cuda) if general else None
    before = nb_grouped_sums.launches
    got = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    again = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    assert nb_grouped_sums.launches == before + 2
    assert torch.equal(got, again)
    want = nb_grouped_sums_plain(x, c, w, g, schema=schema,
                                 num_groups=groups)
    if not general:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 5:], want[:, 5:])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("general", [False, True])
def test_nb_grouped_sums_kernel_with_a_long_row(cuda, general):
    """A column of 20,000 values, past a task's 8,192 cells: each of the 4
    groups' rows of its table is cut by code range into three slabs; one
    launch; counts exact (no weights), sums within 1e-5 relative, two calls
    bit-identical."""
    schema = FeatureSchema(num_cols=2, cat_keys=(tuple(range(20_000)),
                                                 tuple(range(8))))
    groups, n = 4, 300_007
    assert sum(s[0] == _build.NB_SLAB_CODES
               for s in _build.nb_plan(schema, groups).slabs.tolist()) == 12
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(size=(2, n)).astype(np.float32) * 2 + 1,
                     device=cuda)
    c = torch.tensor(np.stack([rng.integers(-1, 20_001, n),
                               rng.integers(0, 9, n)]).astype(np.int32),
                     device=cuda)
    g = torch.tensor(rng.integers(-1, groups + 1, n).astype(np.int32),
                     device=cuda)
    w = torch.rand(n, device=cuda) if general else None
    before = nb_grouped_sums.launches
    got = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    again = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    assert nb_grouped_sums.launches == before + 2
    assert torch.equal(got, again)
    want = nb_grouped_sums_plain(x, c, w, g, schema=schema,
                                 num_groups=groups)
    if not general:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 5:], want[:, 5:])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def qda_inputs(n, device, classes=8, seed=5):
    xs, cs, _ = make_cols(n, seed, device)
    rng = np.random.default_rng(seed)
    m = SCHEMA.sigma_size - 1
    a = rng.normal(size=(classes, m, m)) * 0.3
    quad = torch.tensor(-np.einsum("cij,ckj->cik", a, a), device=device)
    lin = torch.tensor(rng.normal(size=(classes, m)), device=device)
    b = torch.tensor(rng.normal(size=classes), device=device)
    return (qda_tables(quad, lin, b, schema=SCHEMA), torch.stack(xs),
            torch.stack(cs))


@pytest.mark.parametrize("n", [1, 255, 100_003])
def test_qda_predict_kernel_matches_plain(cuda, n):
    """K3 (a one-task plan) equals the plain scorer row for row (the same
    f64 terms in the same order), and reruns are bit-identical."""
    (tables, plan), x, c = qda_inputs(n, cuda)
    assert plan.num_tasks == 1
    before = qda_predict_kernel.launches
    got = qda_predict_kernel(tables, plan, x, c, schema=SCHEMA)
    again = qda_predict_kernel(tables, plan, x, c, schema=SCHEMA)
    assert qda_predict_kernel.launches == before + 2
    assert torch.equal(got, again)
    want = qda_predict_plain(tables, plan, x, c, schema=SCHEMA)
    assert torch.equal(got, want)


def test_qda_kernel_refuses_other_plans_and_unaligned_tables(cuda):
    """The kernel copies tables in 16-byte words: it takes only the
    scorer's plan (tasks padded to 4 cells) and 16-byte aligned tables."""
    (tables, plan), x, c = qda_inputs(1000, cuda)
    with pytest.raises(ValueError):
        qda_predict_kernel(tables, _build.wide_plan(SCHEMA), x, c,
                           schema=SCHEMA)
    shifted = torch.empty(tables.numel() + 1, device=cuda)[1:]
    shifted.copy_(tables.reshape(-1))
    with pytest.raises(ValueError):
        qda_predict_kernel(shifted.view(tables.shape), plan, x, c,
                           schema=SCHEMA)


def test_nb_tables_kernel_matches_plain(cuda):
    """NB's tables (no cross tables) through K3 on the card equal the
    plain scorer."""
    _, x, c = qda_inputs(100_003, cuda)
    rng = np.random.default_rng(4)
    d, v = SCHEMA.num_cols, SCHEMA.vocab_size
    freqs = torch.tensor(rng.random((5, v)), device=cuda)
    freqs[0, 3] = 0.0
    tables, plan = nb_tables(
        torch.log(torch.tensor(rng.random(5), device=cuda)),
        torch.tensor(rng.normal(size=(5, d)), device=cuda),
        torch.tensor(rng.random((5, d)) + 0.1, device=cuda),
        torch.where(freqs > 0, torch.log(freqs), -1e30), schema=SCHEMA)
    assert not plan.cross and plan.num_tasks == 1
    got = qda_predict_kernel(tables, plan, x, c, schema=SCHEMA)
    assert torch.equal(got, qda_predict_plain(tables, plan, x, c,
                                              schema=SCHEMA))


def test_qda_pipeline_on_the_card_matches_cpu(cuda):
    """Grouped aggregation, f64 training and K3 scoring on the card
    against the plain pipeline on the CPU."""
    x, c, _, g = grouped_inputs(60_000, 8, cuda)
    g = g.clamp(0, 7)

    def run(x, c, g):
        sig = sigma_from_triple(sum_to_triple_grouped(
            x, c, g, schema=SCHEMA, num_groups=8))
        q, l, b = qda_train_device(sig, float(x.shape[1]))
        return qda_predict_device(q, l, b, x, c, schema=SCHEMA)

    got = run(x, c, g).cpu()
    want = run(x.cpu(), c.cpu(), g.cpu())
    assert float((got == want).float().mean()) >= 0.999


# ---------------------------------------------------------------------------
# Wide schemas: K7 (masked_gram_cols, masked_gram for P > 88) and K2w
# (fused_impute_aggregate for P > 88)
# ---------------------------------------------------------------------------

FAVORITA = (3, tuple(tuple(range(v))
                     for v in (54, 33, 337, 2, 2, 22, 16, 5, 17)))  # P = 492
WIDE = {"P124": (3, (tuple(range(120)),)), "P492": FAVORITA}


def wide_cols(name, n, device, seed=0, oov=True):
    """Per-column inputs of a wide schema: codes uniform, with out-of-vocab
    and negative codes in the last column when `oov`; binary weights."""
    d, keys = WIDE[name]
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(d, n)) * 2 + 0.5).astype(np.float32)
    codes = np.stack([rng.integers(0, len(k), n) for k in keys]
                     ).astype(np.int32)
    if oov:
        codes[-1, :n // 10] = len(keys[-1])
        codes[-1, n // 10:n // 5] = -1
    w = (rng.random(n) > 0.3).astype(np.float32)
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    return (schema, [torch.tensor(a, device=device) for a in x],
            [torch.tensor(a, device=device) for a in codes],
            torch.tensor(w, device=device))


def wide_table(name, n, device, seed=0):
    """A Table of a wide schema with 20% nulls in numeric column 1 and in
    categorical column 0, x1 linear in x0."""
    schema, xs, cs, _ = wide_cols(name, n, "cpu", seed, oov=False)
    rng = np.random.default_rng(seed + 1)
    x = torch.stack(xs).numpy()
    x[1] = 2 * x[0] + 0.3 * rng.normal(size=n)
    nn = np.zeros(x.shape, bool)
    cn = np.zeros((len(cs), n), bool)
    nn[1] = rng.random(n) < 0.2
    cn[0] = rng.random(n) < 0.2
    return from_numpy(x.T, torch.stack(cs).numpy().T, nn.T, cn.T,
                      schema=schema, device=device)


@pytest.mark.parametrize("name", ["P124", "P492"])
def test_wide_schemas_go_through_the_wide_kernels(cuda, name):
    """Schemas with P > 88 on CUDA tensors: masked_gram_cols, masked_gram,
    fused_impute_aggregate and run_mice_device (gram and fused) run through
    K7 and K2w (their wide launch counts move; K1's and K2's do not)."""
    schema, xs, cs, w = wide_cols(name, 10_000, cuda)
    k1, k2 = masked_gram_cols.launches, fused_impute_aggregate.launches
    wc, ws = masked_gram_cols.wide_launches, masked_gram.wide_launches
    masked_gram_cols(xs, cs, w, schema=schema)
    masked_gram(torch.stack(xs), torch.stack(cs), w, schema=schema)
    assert masked_gram_cols.wide_launches == wc + 1
    assert masked_gram.wide_launches == ws + 1
    p = schema.sigma_size
    before = fused_impute_aggregate.wide_launches
    for kind, col, r in (("cat", 0, len(schema.cat_keys[0])),
                         ("num", 1, 1)):
        fused_impute_aggregate(
            xs, cs, w > 0, w, torch.zeros((p, r), device=cuda),
            torch.zeros(r, device=cuda), schema=schema, kind=kind,
            imp_col=col)
    assert fused_impute_aggregate.wide_launches == before + 2
    t = wide_table(name, 20_000, cuda)
    wc, before = masked_gram_cols.wide_launches, \
        fused_impute_aggregate.wide_launches
    run_mice_device(t, iters=1, kernel="gram")
    run_mice_device(t, iters=1, kernel="fused")
    assert masked_gram_cols.wide_launches > wc
    assert fused_impute_aggregate.wide_launches > before
    assert masked_gram_cols.launches == k1
    assert fused_impute_aggregate.launches == k2


@pytest.mark.parametrize("name", ["P124", "P492"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 70_001])
@pytest.mark.parametrize("binary", [True, False])
def test_wide_gram_kernel_matches_plain(cuda, name, n, binary):
    """K7 on ragged n (one row, one chunk either side of 128 rows, many
    slices): counts exact with binary weights, the rest within 1e-5 of
    max|σ|, two launches bit-identical, σ[0, 0] = Σw; the stacked entry
    point gives the same bits."""
    schema, xs, cs, w = wide_cols(name, n, cuda, seed=n)
    if not binary:
        w = torch.rand(n, device=cuda)
    got = masked_gram_cols(xs, cs, w, schema=schema)
    again = masked_gram_cols(xs, cs, w, schema=schema)
    stacked = masked_gram(torch.stack(xs), torch.stack(cs), w, schema=schema)
    want = masked_gram_cols_plain(xs, cs, w, schema=schema)
    assert torch.equal(got, again) and torch.equal(got, stacked)
    if binary:
        cm = count_mask(schema, cuda)
        assert torch.equal(got[cm], want[cm])
        assert float(got[0, 0]) == float(w.sum())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_wide_gram_at_its_limit(cuda):
    """P = MAX_WIDE_SIGMA_SIZE with 51 columns of 20: 1,275 cross tables
    in 64 tasks of the plan, one launch; one more numeric column (P =
    1,025) takes K7's windows, two launches of WINDOW_WIDTH columns."""
    keys = (tuple(range(20)),) * 51
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    assert schema.sigma_size == _build.MAX_WIDE_SIGMA_SIZE
    assert _build.wide_plan(schema).num_tasks == 64
    rng = np.random.default_rng(8)
    n = 5000
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(3)]
    cs = [torch.tensor(rng.integers(0, len(k), n).astype(np.int32),
                       device=cuda) for k in keys]
    got = masked_gram_cols(xs, cs, None, schema=schema)
    want = masked_gram_cols_plain(xs, cs, None, schema=schema)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[cm], want[cm])
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    over = FeatureSchema(num_cols=4, cat_keys=keys)
    before = masked_gram_cols.wide_launches
    got = masked_gram_cols(xs + xs[:1], cs, None, schema=over)
    assert masked_gram_cols.wide_launches == before + 2
    want = masked_gram_cols_plain(xs + xs[:1], cs, None, schema=over)
    assert torch.equal(got[count_mask(over, cuda)],
                       want[count_mask(over, cuda)])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", ["hot_key", "split_table", "cols64"])
def test_wide_gram_hot_key_and_split_table(cuda, case):
    """K7 where 90% of the rows share one code of class and one of store
    (the lanes of a warp meet on one cell), with two columns of 510
    levels (a cross table of 2 MB split by key range over 32 tasks), and
    at 64 numeric and 64 categorical columns (stages of 128 rows): counts
    exact, the rest within 1e-5 of max|σ|, reruns bit-identical, with
    binary and general weights."""
    n = 100_003
    if case == "cols64":
        schema = FeatureSchema(num_cols=64, cat_keys=(tuple(range(14)),) * 64)
        assert _build.wide_plan(schema).stage_rows == 128
        xs = [torch.randn(n, device=cuda) for _ in range(64)]
        cs = [torch.randint(-1, 15, (n,), dtype=torch.int32, device=cuda)
              for _ in range(64)]
        w = (torch.rand(n, device=cuda) > 0.3).float()
    elif case == "hot_key":
        schema, xs, cs, w = wide_cols("P492", n, cuda, seed=11)
        hot = torch.rand(n, device=cuda) < 0.9
        cs[0] = torch.where(hot, 7, cs[0]).to(torch.int32).contiguous()
        cs[2] = torch.where(hot, 5, cs[2]).to(torch.int32).contiguous()
    else:
        schema = FeatureSchema(num_cols=2, cat_keys=(tuple(range(510)),) * 2)
        assert _build.wide_plan(schema).num_tasks == 33
        xs = [torch.randn(n, device=cuda) for _ in range(2)]
        cs = [torch.randint(-1, 511, (n,), dtype=torch.int32, device=cuda)
              for _ in range(2)]
        w = (torch.rand(n, device=cuda) > 0.3).float()
    for binary, wt in ((True, w), (False, torch.rand(n, device=cuda))):
        got = masked_gram_cols(xs, cs, wt, schema=schema)
        again = masked_gram_cols(xs, cs, wt, schema=schema)
        want = masked_gram_cols_plain(xs, cs, wt, schema=schema)
        assert torch.equal(got, again)
        if binary:
            cm = count_mask(schema, cuda)
            assert torch.equal(got[cm], want[cm])
            assert float(got[0, 0]) == float(wt.sum())
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", ["cat33", "cat337", "num", "num_noise"])
def test_fused_impute_aggregate_wide_kernel_matches_plain(cuda, case):
    """K2w at P = 492 (out-of-vocab codes in another column, an empty
    class): the impute kernel scores in the plain version's f32 order, so
    codes are equal and numerics equal up to the noise's log/cos rounding;
    sigma as K7; a rerun is bit-identical."""
    schema, xs, cs, w = wide_cols("P492", 50_003, cuda, seed=4)
    rng = np.random.default_rng(5)
    p = schema.sigma_size
    kind = "cat" if case.startswith("cat") else "num"
    col = {"cat33": 1, "cat337": 2}.get(case, 1)
    r = len(schema.cat_keys[col]) if kind == "cat" else 1
    w_full = rng.normal(size=(p, r)).astype(np.float32)
    icpt = (rng.normal(size=r) if kind == "cat"
            else np.zeros(r)).astype(np.float32)
    if kind == "cat":
        icpt[3] = -np.inf                     # an empty class
    null = torch.tensor(rng.random(50_003) < 0.2, device=cuda)
    kw = dict(schema=schema, kind=kind, imp_col=col,
              noise=((7, 2, torch.tensor(0.6, device=cuda))
                     if case == "num_noise" else None))
    args = (xs, cs, null, w, torch.tensor(w_full, device=cuda),
            torch.tensor(icpt, device=cuda))
    before = fused_impute_aggregate.wide_launches
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.wide_launches == before + 2
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
        assert not torch.any(new[null] == 3)
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


# (d, vocabularies, imputed column): favorita_wide's family (R = 33, W
# whole in shared memory) and class (R = 337, class tiles), and R = 1,000
# at P = 1,024
K2W_SCHEMAS = {"R33": FAVORITA + (1,), "R337": FAVORITA + (2,),
               "R1000": (3, (tuple(range(1000)), tuple(range(20))), 0)}


@pytest.mark.parametrize("nulls", ["some", "all", "none"])
@pytest.mark.parametrize("n", [1, 33, 50_003])
@pytest.mark.parametrize("name", sorted(K2W_SCHEMAS))
def test_fused_wide_cat_impute_kernel(cuda, name, n, nulls):
    """K2w 'cat' over W's class tiles: codes equal to the plain version's
    (out-of-vocab codes in another column, an empty class, ties across a
    tile boundary), with some, all or no rows null and n not a multiple of
    a step; sigma within 1e-5 of max|σ|; reruns bit-identical; one wide
    launch a call."""
    d, keys, col = K2W_SCHEMAS[name]
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    rng = np.random.default_rng(n)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(d)]
    codes = [rng.integers(0, len(k), n).astype(np.int32) for k in keys]
    other = (col + 1) % len(keys)
    codes[other][: n // 10] = len(keys[other])        # out of vocab
    cs = [torch.tensor(a, device=cuda) for a in codes]
    r, p = len(keys[col]), schema.sigma_size
    w_full = rng.normal(size=(p, r)).astype(np.float32)
    icpt = rng.normal(size=r).astype(np.float32)
    icpt[3] = -np.inf                                  # an empty class
    w_full[:, 32] = w_full[:, 31]                      # a tie across tiles
    icpt[32] = icpt[31] = icpt.max() + 5.0
    frac = {"some": 0.2, "all": 1.0, "none": 0.0}[nulls]
    null = torch.tensor(rng.random(n) < frac, device=cuda)
    w = torch.tensor((rng.random(n) > 0.3).astype(np.float32), device=cuda)
    args = (xs, cs, null, w, torch.tensor(w_full, device=cuda),
            torch.tensor(icpt, device=cuda))
    kw = dict(schema=schema, kind="cat", imp_col=col)
    before = fused_impute_aggregate.wide_launches
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert fused_impute_aggregate.wide_launches == before + 2
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    assert torch.equal(new, want_new)
    assert not torch.any(new[null] == 3)
    if nulls == "none":
        assert torch.equal(new, cs[col])
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("name", ["P21", "P492"])
def test_run_mice_device_delta_on_the_card_matches_cpu(cuda, name):
    """The delta loop on a CUDA table ('auto' = K1, or K7 at P = 492)
    against the plain delta loop on the CPU: codes agree on ≥ 0.999 of the
    cells, numerics within 1e-3 of max|x| on the rows whose codes agree (a
    flipped code moves that row's prediction by its coefficient)."""
    if name == "P492":
        t_gpu = wide_table("P492", 30_000, cuda, seed=6)
    else:
        n = 30_000
        xs, cs, _ = make_cols(n, 7, "cpu", oov=False)
        x, c = torch.stack(xs).numpy(), torch.stack(cs).numpy()
        rng = np.random.default_rng(7)
        x[1] = 2 * x[0] + 0.3 * rng.normal(size=n)
        nn = np.zeros(x.shape, bool)
        cn = np.zeros(c.shape, bool)
        nn[1] = rng.random(n) < 0.05
        cn[0] = rng.random(n) < 0.05
        t_gpu = from_numpy(x.T, c.T, nn.T, cn.T, schema=SCHEMA, device=cuda)
    cpu = type(t_gpu)(*(a.cpu() for a in (t_gpu.num_data, t_gpu.cat_codes,
                                          t_gpu.num_null, t_gpu.cat_null)),
                      schema=t_gpu.schema)
    k1, k7 = masked_gram_cols.launches, masked_gram_cols.wide_launches
    got = run_mice_device_delta(t_gpu, iters=2)
    # one full aggregation, then 2 per column step: 2 columns, 2 rounds
    launched = (masked_gram_cols.launches - k1,
                masked_gram_cols.wide_launches - k7)
    assert launched == ((0, 9) if name == "P492" else (9, 0))
    ref = run_mice_device_delta(cpu, iters=2)
    same = (got.cat_codes.cpu() == ref.cat_codes).all(0)
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(got.num_data.cpu()[:, same],
                               ref.num_data[:, same], rtol=0,
                               atol=1e-3 * float(ref.num_data.abs().max()))


# ---------------------------------------------------------------------------
# The classifier path at wide schemas: K8 (grouped_gram and
# grouped_gram_presorted for P > 88), K6w (nb_grouped_sums for F > 256) and
# K3w (qda_predict_kernel for tables over several of the plan's tasks)
# ---------------------------------------------------------------------------

def wide_grouped_inputs(name, n, groups, device, seed=0, binary=True):
    """wide_cols' inputs (out-of-vocab and negative codes) with group ids,
    half the rows in group 0, some out of range."""
    schema, xs, cs, w = wide_cols(name, n, device, seed=seed)
    rng = np.random.default_rng(seed + 2)
    g = np.where(rng.random(n) < 0.5, 0, rng.integers(0, groups, n))
    g[: n // 50] = groups + 2
    g[n // 50: n // 40] = -1
    if not binary:
        w = torch.tensor(rng.random(n).astype(np.float32), device=device)
    return (schema, torch.stack(xs), torch.stack(cs), w,
            torch.tensor(g.astype(np.int32), device=device))


def assert_wide_grouped_close(got, want, schema, binary):
    """Counts exact (binary weights); the rest within 1e-5 of each
    group's max|σ|."""
    cm = count_mask(schema, got.device)
    for g in range(got.shape[0]):
        if binary:
            assert torch.equal(got[g][cm], want[g][cm])
        scale = max(float(want[g].abs().max()), 1.0)
        torch.testing.assert_close(got[g], want[g], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("name,n,groups,binary", [
    ("P124", 1, 3, True), ("P124", 129, 3, True), ("P124", 70_001, 33, True),
    ("P492", 70_001, 33, True), ("P492", 70_001, 5, False),
    ("P124", 200_003, 1000, True)])
def test_grouped_wide_gram_kernel_matches_plain(cuda, name, n, groups,
                                                binary):
    """K8 after sort_by_group on ragged n, skew, dropped ids, empty and
    short groups (1000 groups): counts exact with binary weights, the rest
    within 1e-5 of each group's max|σ|, two launches bit-identical."""
    schema, x, c, w, g = wide_grouped_inputs(name, n, groups, cuda,
                                             binary=binary)
    if groups == 1000:
        g = torch.randint(0, groups, (n,), dtype=torch.int32, device=cuda)
    xs, cs, ws, layout = sort_by_group(x, c, g, schema=schema,
                                       num_groups=groups, weights=w)
    narrow = grouped_gram_presorted.launches
    before = grouped_gram_presorted.wide_launches
    got = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    again = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    assert grouped_gram_presorted.wide_launches == before + 2
    assert grouped_gram_presorted.launches == narrow
    assert torch.equal(got, again)
    want = grouped_gram_presorted_plain(xs, cs, ws, layout, schema=schema)
    assert_wide_grouped_close(got, want, schema, binary)


@pytest.mark.parametrize("groups", [1, 2, 40])
def test_grouped_gram_unsorted_entry_at_wide_p(cuda, groups):
    """The unsorted entry at P = 492 sorts and runs K8, any number of
    groups: the same bits as sort_by_group + grouped_gram_presorted, and
    the plain grouped Gram's values."""
    schema, x, c, w, g = wide_grouped_inputs("P492", 50_001, groups, cuda)
    narrow = grouped_gram.launches
    before = grouped_gram_presorted.wide_launches
    got = grouped_gram(x, c, w, g, schema=schema, num_groups=groups)
    assert grouped_gram_presorted.wide_launches == before + 1
    assert grouped_gram.launches == narrow
    sorted_ = grouped_gram_presorted(
        *sort_by_group(x, c, g, schema=schema, num_groups=groups, weights=w),
        schema=schema)
    assert torch.equal(got, sorted_)
    want = grouped_gram_plain(x, c, w, g, schema=schema, num_groups=groups)
    assert_wide_grouped_close(got, want, schema, True)


def test_grouped_wide_gram_at_its_limit(cuda):
    """P = MAX_WIDE_SIGMA_SIZE (64 tasks of the plan) with 3 groups."""
    keys = (tuple(range(20)),) * 51
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    rng = np.random.default_rng(9)
    n = 5000
    x = torch.tensor(rng.normal(size=(3, n)).astype(np.float32), device=cuda)
    c = torch.tensor(rng.integers(0, 20, (51, n)).astype(np.int32),
                     device=cuda)
    g = torch.tensor(rng.integers(0, 3, n).astype(np.int32), device=cuda)
    args = sort_by_group(x, c, g, schema=schema, num_groups=3)
    got = grouped_gram_presorted(*args, schema=schema)
    want = grouped_gram_presorted_plain(*args, schema=schema)
    assert_wide_grouped_close(got, want, schema, True)


NB_WIDE = {"F267": (3, (tuple(range(200)), tuple(range(60)))),
           "F493": (3, tuple(tuple(range(v))
                             for v in (54, 33, 337, 2, 22, 16, 5, 17)))}


@pytest.mark.parametrize("name,n,groups,binary", [
    ("F267", 1, 1, True), ("F267", 70_001, 5, False),
    ("F493", 100_003, 2, True), ("F493", 100_003, 40, True)])
def test_nb_wide_sums_kernel_matches_plain(cuda, name, n, groups, binary):
    """K6w (F > 256): counts exact with binary weights, sums within 1e-5
    relative, two calls bit-identical; one launch a call for any number of
    groups."""
    d, keys = NB_WIDE[name]
    schema = FeatureSchema(num_cols=d, cat_keys=keys)
    assert _build.nb_features(schema) > 256
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.normal(size=(d, n)).astype(np.float32) * 3,
                     device=cuda)
    c = torch.tensor(np.stack([rng.integers(-1, len(k) + 1, n)
                               for k in keys]).astype(np.int32), device=cuda)
    g = torch.tensor(rng.integers(-1, groups + 1, n).astype(np.int32),
                     device=cuda)
    w = None if binary else torch.rand(n, device=cuda)
    before = nb_grouped_sums.launches
    got = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    again = nb_grouped_sums(x, c, w, g, schema=schema, num_groups=groups)
    assert nb_grouped_sums.launches == before + 2
    assert torch.equal(got, again)
    want = nb_grouped_sums_plain(x, c, w, g, schema=schema,
                                 num_groups=groups)
    if binary:
        assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got[:, 1 + 2 * d:], want[:, 1 + 2 * d:])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("n", [1, 255, 100_003])
@pytest.mark.parametrize("classes", [8, 33])
def test_qda_wide_kernel_matches_plain(cuda, n, classes):
    """K3w: tables over a plan of several tasks (d = 4, categorical columns
    of 200, 60 and 48: a cross table of 200 × 60 past one task), codes out
    of vocab and negative: equal to the plain scorer, two calls
    bit-identical, counted as wide launches."""
    keys = (tuple(range(200)), tuple(range(60)), tuple(range(48)))
    schema = FeatureSchema(num_cols=4, cat_keys=keys)
    rng = np.random.default_rng(classes)
    m = schema.sigma_size - 1
    a = rng.normal(size=(classes, m, m)) * 0.1
    quad = torch.tensor(-np.einsum("cij,ckj->cik", a, a) - 0.2 * np.eye(m),
                        device=cuda)
    lin = torch.tensor(rng.normal(size=(classes, m)), device=cuda)
    b = torch.tensor(rng.normal(size=classes) * 5, device=cuda)
    tables, plan = qda_tables(quad, lin, b, schema=schema)
    assert plan.num_tasks > 1
    x = torch.tensor(rng.normal(size=(4, n)).astype(np.float32), device=cuda)
    c = torch.tensor(np.stack([rng.integers(-1, len(k) + 2, n) for k in keys]
                              ).astype(np.int32), device=cuda)
    narrow = qda_predict_kernel.launches
    before = qda_predict_kernel.wide_launches
    got = qda_predict_kernel(tables, plan, x, c, schema=schema)
    again = qda_predict_kernel(tables, plan, x, c, schema=schema)
    assert qda_predict_kernel.wide_launches == before + 2
    assert qda_predict_kernel.launches == narrow
    assert torch.equal(got, again)
    want = qda_predict_plain(tables, plan, x, c, schema=schema)
    assert torch.equal(got, want)


def test_qda_kernel_at_the_schema_limit(cuda):
    """64 numeric and 64 categorical columns at P = 1,024 (a smaller tile)
    through one launch, equal to the plain scorer."""
    keys = tuple(tuple(range(14 if j < 63 else 1024 - 65 - 14 * 63))
                 for j in range(64))
    schema = FeatureSchema(num_cols=64, cat_keys=keys)
    rng = np.random.default_rng(3)
    m, n = schema.sigma_size - 1, 20_000
    quad = torch.tensor(-np.eye(m) * rng.random(m), device=cuda)
    lin = torch.tensor(rng.normal(size=(3, m)), device=cuda)
    tables, plan = qda_tables(quad.expand(3, m, m), lin,
                              torch.zeros(3, device=cuda), schema=schema)
    x = torch.tensor(rng.normal(size=(64, n)).astype(np.float32), device=cuda)
    c = torch.tensor(np.stack([rng.integers(0, len(k), n) for k in keys]
                              ).astype(np.int32), device=cuda)
    got = qda_predict_kernel(tables, plan, x, c, schema=schema)
    assert torch.equal(got, qda_predict_plain(tables, plan, x, c,
                                              schema=schema))


def test_wide_classifier_pipelines_on_the_card_match_cpu(cuda):
    """QDA and NB at P = 492 over 5 classes on the card (K8, K6w, K3 or
    K3w) against the plain pipelines on the CPU: agreement ≥ 0.999."""
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    schema, x, c, _, g = wide_grouped_inputs("P492", 30_000, 5, cuda)
    c = c.clamp(0)
    g = g.clamp(0, 4)
    x[0] += g.float()                      # the label moves x0

    def qda(x, c, g):
        sig = sigma_from_triple(sum_to_triple_grouped(
            x, c, g, schema=schema, num_groups=5))
        q, l, b = qda_train_device(sig, float(x.shape[1]))
        return qda_predict_device(q, l, b, x, c, schema=schema)

    def nb(x, c, g):
        agg = sum_to_nb_agg_grouped(x, c, g, schema=schema, num_groups=5)
        params = nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
        return nb_predict_device(*params, x, c, schema=schema)

    k8 = grouped_gram_presorted.wide_launches
    k6w = nb_grouped_sums.launches
    for pipe in (qda, nb):
        got = pipe(x, c, g).cpu()
        want = pipe(x.cpu(), c.cpu(), g.cpu())
        assert float((got == want).float().mean()) >= 0.999
    assert grouped_gram_presorted.wide_launches > k8
    assert nb_grouped_sums.launches > k6w


def _host_mice_table(n, seed, device):
    """The config-5 schema: x1 = 2·x0 + x2 + noise, c0 from x0, 20% MCAR
    nulls in x1 and c0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[:, 1] = 2 * x[:, 0] + x[:, 2] + 0.1 * rng.normal(size=n)
    c = np.stack([np.clip(x[:, 0] + 4, 0, 7), rng.integers(0, 8, n)],
                 1).astype(np.int64)
    nn = np.zeros((n, 4), bool)
    cn = np.zeros((n, 2), bool)
    nn[:, 1] = rng.random(n) < 0.2
    cn[:, 0] = rng.random(n) < 0.2
    return from_numpy(x, c, nn, cn, schema=SCHEMA, device=device)


@pytest.mark.parametrize("driver,launches", [
    ("baseline", 2 * 2), ("low", 1 + 2 * 2 * 2), ("high", 1 + 2 * 2)])
def test_host_drivers_on_the_card_match_cpu(cuda, driver, launches):
    """run_mice_baseline / low / high on a CUDA table aggregate through
    K1's stacked entry point (`masked_gram`), as many launches as the
    driver aggregates, and impute what they impute on the CPU: codes agree
    on ≥ 0.999 of the cells, numerics within 1e-3."""
    from duckdb_imputation_tpu_torch import mice

    fn = getattr(mice, f"run_mice_{driver}")
    kw = dict(iters=2, linreg_iters=300, noise=False)
    t = _host_mice_table(20_000, 5, cuda)
    before = masked_gram.launches
    got = fn(t, **kw)
    assert masked_gram.launches - before == launches
    assert got.num_data.device.type == "cuda"
    want = fn(_host_mice_table(20_000, 5, "cpu"), **kw)
    assert float((got.cat_codes.cpu() == want.cat_codes).float().mean()
                 ) >= 0.999
    torch.testing.assert_close(got.num_data.cpu(), want.num_data, rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("run", ["device", "delta"])
def test_gd_loops_on_the_card_match_cpu(cuda, run):
    """trainer='gd' on a CUDA table: every aggregate is K1
    (`masked_gram_cols`), as many as the solve run's; the card's imputation
    against the CPU's at the bounds of the solve-vs-GD test (numerics
    within 0.1, codes > 0.95)."""
    if run == "device":
        fn, card, cpu = run_mice_device, {"kernel": "gram"}, {"kernel": "plain"}
    else:
        fn, card, cpu = run_mice_device_delta, {}, {}
    t = _host_mice_table(20_000, 6, cuda)
    before = masked_gram_cols.launches
    fn(t, iters=2, trainer="solve", **card)
    solve = masked_gram_cols.launches - before
    got = fn(t, iters=2, trainer="gd", gd_iters=500, **card)
    assert masked_gram_cols.launches - before == 2 * solve > 0
    want = fn(_host_mice_table(20_000, 6, "cpu"), iters=2, trainer="gd",
              gd_iters=500, **cpu)
    m = t.num_null[1].cpu()
    torch.testing.assert_close(got.num_data[1].cpu()[m], want.num_data[1][m],
                               rtol=0, atol=0.1)
    cm = t.cat_null[0].cpu()
    assert float((got.cat_codes[0].cpu() == want.cat_codes[0])[cm].float()
                 .mean()) > 0.95


def _star_tables(n, keys, dim_vocab, seed, device):
    """A small fact ⋈ two-dimension star: fact (x1, x2, c1 of 3) with FKs
    into dim A (`keys` rows: z, g of `dim_vocab`) and dim B (7 rows: a
    category of 4); x1 depends on A's z, c1 on B's category; 20% MCAR
    nulls in x1 and c1."""
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=keys) * 2).astype(np.float32)
    g = rng.integers(0, dim_vocab, keys)
    b = rng.integers(0, 4, 7)
    ka, kb = rng.integers(0, keys, n), rng.integers(0, 7, n)
    x2 = rng.normal(size=n).astype(np.float32)
    x1 = (1.5 * z[ka] + 0.3 * x2 + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    c1 = np.where(rng.random(n) < 0.9, b[kb] % 3, rng.integers(0, 3, n))
    nn = np.zeros((n, 2), bool)
    cn = np.zeros((n, 1), bool)
    nn[:, 0] = rng.random(n) < 0.2
    cn[:, 0] = rng.random(n) < 0.2
    fact = from_numpy(np.stack([x1, x2], 1), c1[:, None], nn, cn,
                      device=device)
    dim_a = from_numpy(z[:, None], g[:, None], device=device)
    dim_b = from_numpy(None, b[:, None], device=device)
    return fact, dim_a, dim_b, ka, kb


@pytest.mark.parametrize("dim_vocab", [20, 120], ids=["K5", "K8"])
def test_run_mice_factorized_on_the_card_matches_cpu(cuda, dim_vocab):
    """run_mice_factorized on CUDA tables: the dimension side one grouped
    Gram (K5 at P = 22, K8 at P = 122, after a sort), each fact column
    step one sort + K5 at 300 keys; no K4. The imputation is the CPU's:
    codes on ≥ 0.999 of the cells, numerics within 1e-3."""
    from duckdb_imputation_tpu_torch.mice import run_mice_factorized

    kw = dict(iters=2, linreg_iters=300, noise=False)
    fact, dim, _, ka, _ = _star_tables(20_000, 300, dim_vocab, 8, cuda)
    k4, k5 = grouped_gram.launches, grouped_gram_presorted.launches
    k8 = grouped_gram_presorted.wide_launches
    got = run_mice_factorized(fact, ka, dim, **kw)
    wide = dim.schema.sigma_size > _build.MAX_SIGMA_SIZE
    assert grouped_gram.launches == k4
    assert grouped_gram_presorted.launches - k5 == 2 * 2 + (not wide)
    assert grouped_gram_presorted.wide_launches - k8 == int(wide)
    assert got.num_data.device.type == "cuda"
    cf, cd, _, ka_c, _ = _star_tables(20_000, 300, dim_vocab, 8, "cpu")
    want = run_mice_factorized(cf, ka_c, cd, **kw)
    assert float((got.cat_codes.cpu() == want.cat_codes).float().mean()
                 ) >= 0.999
    torch.testing.assert_close(got.num_data.cpu(), want.num_data, rtol=0,
                               atol=1e-3)


def test_run_mice_star_on_the_card_matches_cpu(cuda):
    """run_mice_star over two dimensions on CUDA tables: each column step
    one K1 of the fact columns (masked_gram) and one NB-sums launch a
    dimension; the training triple equals the materialized join's, and
    the imputation the CPU's (codes ≥ 0.999, numerics within 1e-3)."""
    from duckdb_imputation_tpu_torch.mice import observed_weights, run_mice_star
    from duckdb_imputation_tpu_torch.ring.star import (star_join_triple,
                                                       star_schema)

    kw = dict(iters=2, linreg_iters=300, noise=False)
    fact, da, db, ka, kb = _star_tables(20_000, 300, 20, 9, cuda)
    k1, k6 = masked_gram.launches, nb_grouped_sums.launches
    got = run_mice_star(fact, [ka, kb], [da, db], **kw)
    assert masked_gram.launches - k1 == 2 * 2
    assert nb_grouped_sums.launches - k6 == 2 * 2 * 2
    cf, ca, cb, ka_c, kb_c = _star_tables(20_000, 300, 20, 9, "cpu")
    want = run_mice_star(cf, [ka_c, kb_c], [ca, cb], **kw)
    assert float((got.cat_codes.cpu() == want.cat_codes).float().mean()
                 ) >= 0.999
    torch.testing.assert_close(got.num_data.cpu(), want.num_data, rtol=0,
                               atol=1e-3)

    w = observed_weights(fact, "num", 0)
    keys = [torch.tensor(k, device=cuda) for k in (ka, kb)]
    trip = star_join_triple(fact.num_data, fact.cat_codes, w, keys=keys,
                            dims=[(da.num_data, da.cat_codes),
                                  (db.num_data, db.cat_codes)],
                            fact_schema=fact.schema,
                            dim_schemas=[da.schema, db.schema])
    js = star_schema(fact.schema, [da.schema, db.schema])
    jn = torch.cat([fact.num_data, da.num_data[:, keys[0]]])
    jc = torch.cat([fact.cat_codes, da.cat_codes[:, keys[0]],
                    db.cat_codes[:, keys[1]]])
    mat = sigma_from_triple(sum_to_triple(jn, jc, w, schema=js))
    got_s = sigma_from_triple(trip)
    counts = count_mask(js, cuda)
    assert torch.equal(got_s[counts], mat[counts])
    assert float((got_s - mat).abs().max() / mat.abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# The NB scorer's centred tables, K2's global row offset, and the sharded
# loops (a world of one on NCCL) with their checkpoints
# ---------------------------------------------------------------------------

def test_nb_centred_scorer_on_the_card_matches_host(cuda):
    """ROADMAP Queue 3's NB variance case (class 1's x1 exactly 1000.1):
    nb_predict_device through K3 and its x shift agrees with the host
    predictor on ≥ 0.999 of rows; the kernel with a shift equals its
    plain version."""
    from duckdb_imputation_tpu_torch import models
    from duckdb_imputation_tpu_torch.models.device import (nb_predict_device,
                                                           nb_train_device)
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import nb_center
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    rng = np.random.default_rng(0)
    n = 200_000
    y = (rng.random(n) < 0.5).astype(np.int32)
    x1 = np.where(y == 1, 1000.1, rng.normal(size=n) + 1000.1)
    num = np.stack([rng.normal(size=n) + 2 * y, x1]).astype(np.float32)
    schema = FeatureSchema(num_cols=2)
    x, yt = torch.tensor(num, device=cuda), torch.tensor(y, device=cuda)
    codes = torch.zeros((0, n), dtype=torch.int32, device=cuda)
    agg = sum_to_nb_agg_grouped(x, None, yt, schema=schema, num_groups=2)
    host = models.nb_predict(models.nb_train(agg, schema, labels=[0, 1]), x)
    priors, mean, var, freqs = nb_train_device(agg.n, agg.lin, agg.quad_diag,
                                               agg.lin_cat)
    before = qda_predict_kernel.launches
    got = nb_predict_device(priors, mean, var, freqs, x, codes, schema=schema)
    assert qda_predict_kernel.launches == before + 1
    assert float((got.long() == host).float().mean()) >= 0.999
    lp = torch.log(priors.double())
    center = nb_center(lp, mean)
    tables, plan = nb_tables(lp, mean, var.double() + 1e-9,
                             torch.zeros((2, 0), dtype=torch.float64,
                                         device=cuda),
                             schema=schema, center=center)
    assert torch.equal(
        qda_predict_kernel(tables, plan, x, codes, schema=schema,
                           shift=center),
        qda_predict_plain(tables, plan, x, codes, schema=schema,
                          shift=center))


@pytest.mark.parametrize("wide", [False, True])
def test_fused_noise_keyed_by_global_rows(cuda, wide):
    """K2 / K2w with a row offset draw each row's noise by its global id:
    a shard's pass from row lo equals rows [lo, hi) of the whole table's
    pass (and the plain version's, to log/cos rounding)."""
    if wide:
        t = wide_table("P492", 30_000, cuda)
        schema, col = t.schema, 1
        xs, cs = list(t.num_data.unbind(0)), list(t.cat_codes.unbind(0))
        n = t.n_rows
        rng = np.random.default_rng(4)
        null = torch.tensor(rng.random(n) < 0.2, device=cuda)
        w_agg = torch.ones(n, device=cuda)
        theta = torch.tensor(rng.normal(size=(schema.sigma_size, 1)),
                             dtype=torch.float32, device=cuda)
        theta[1 + col] = 0.0
        args = (xs, cs, null, w_agg, theta, torch.zeros(1, device=cuda))
    else:
        schema, col = SCHEMA, 1
        args = fused_args("num", 30_000, cuda)
        n = 30_000
    noise = (11, 3, torch.tensor(0.7, device=cuda))
    kw = dict(schema=schema, kind="num", imp_col=col, noise=noise)
    whole, _ = fused_impute_aggregate(*args, **kw)
    lo, hi = 12_345, n

    def cut(a):
        return ([c[lo:hi].contiguous() for c in a] if isinstance(a, list)
                else a[lo:hi].contiguous() if a.shape[-1] == n else a)

    part, _ = fused_impute_aggregate(*map(cut, args), row_offset=lo, **kw)
    assert torch.equal(part, whole[lo:hi])
    plain, _ = fused_impute_aggregate_plain(*map(cut, args), row_offset=lo,
                                            **kw)
    torch.testing.assert_close(part, plain, rtol=1e-6, atol=1e-6)


def _sharded_table(n, seed, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + 0.5 * z[:, 1],
                    rng.normal(size=n), rng.normal(size=n)],
                   1).astype(np.float32)
    cat = np.stack([np.clip(z[:, 0] + 4, 0, 7).astype(int),
                    rng.integers(0, 8, n)], 1)
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    nn[rng.random(n) < 0.2, 1] = True
    cn[rng.random(n) < 0.2, 0] = True
    return from_numpy(num, cat, nn, cn, device=device)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A process group of one rank on NCCL (FileStore in tmp_path),
    left after the test."""
    import datetime

    import torch.distributed as dist

    from duckdb_imputation_tpu_torch.parallel import initialize, shutdown

    mesh = initialize("nccl", store=dist.FileStore(str(tmp_path / "store"),
                                                   1),
                      world_size=1, rank=0, device=cuda,
                      timeout=datetime.timedelta(seconds=120))
    yield mesh
    shutdown()


def test_sharded_loops_at_world_one_on_nccl(nccl_mesh):
    """run_mice_sharded ('gram', 'fused' with and without noise) and
    run_mice_sharded_delta on a world of one over NCCL: bit-identical to
    run_mice_device / run_mice_device_delta with the same kernel, with the
    launches derived for them."""
    from duckdb_imputation_tpu_torch.mice import (run_mice_sharded,
                                                  run_mice_sharded_delta)

    t = _sharded_table(50_003, 1, nccl_mesh.device)
    for kw in (dict(kernel="gram"), dict(kernel="fused"),
               dict(kernel="fused", noise=True, seed=4)):
        k1, k2 = masked_gram_cols.launches, fused_impute_aggregate.launches
        got = run_mice_sharded(t, iters=2, mesh=nccl_mesh, **kw)
        fused = kw["kernel"] == "fused"
        assert masked_gram_cols.launches - k1 == (1 if fused else 4)
        assert fused_impute_aggregate.launches - k2 == (4 if fused else 0)
        want = run_mice_device(t, iters=2, **kw)
        assert torch.equal(got.num_data, want.num_data)
        assert torch.equal(got.cat_codes, want.cat_codes)
    got = run_mice_sharded_delta(t, iters=2, noise=True, seed=4,
                                 mesh=nccl_mesh)
    want = run_mice_device_delta(t, iters=2, noise=True, seed=4)
    assert torch.equal(got.num_data, want.num_data)
    assert torch.equal(got.cat_codes, want.cat_codes)


@pytest.mark.parametrize("kernel", ["fused", "gram", "delta"])
def test_sharded_checkpoint_resume_on_the_card(nccl_mesh, tmp_path, kernel):
    """Killed after 2 of 4 rounds (noise on) and resumed on the card:
    bit-identical to 4 rounds straight; another seed raises."""
    from duckdb_imputation_tpu_torch.mice import (run_mice_sharded,
                                                  run_mice_sharded_delta)

    fn, kw = ((run_mice_sharded_delta, {}) if kernel == "delta"
              else (run_mice_sharded, dict(kernel=kernel)))
    kw = dict(kw, noise=True, seed=6, mesh=nccl_mesh)
    t = _sharded_table(20_011, 2, nccl_mesh.device)
    path = str(tmp_path / "ckpt")
    straight = fn(t, iters=4, **kw)
    fn(t, iters=2, checkpoint_path=path, **kw)
    resumed = fn(t, iters=4, checkpoint_path=path, **kw)
    assert torch.equal(straight.num_data, resumed.num_data)
    assert torch.equal(straight.cat_codes, resumed.cat_codes)
    with pytest.raises(ValueError, match="field 'seed'"):
        fn(t, iters=4, checkpoint_path=path, **dict(kw, seed=7))


# ---------------------------------------------------------------------------
# The out-of-core path on the card: the fold over the extended schema, the
# native reader's Table on the card, impute_csv_stream
# ---------------------------------------------------------------------------

def _stream_arrays(n, seed, cat_sizes, d=3, all_null=False):
    """Host arrays of a stream: d numeric columns and one categorical a
    size; 10% nulls in numeric 1 and categorical 0, or with all_null 5%
    in every column."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(d, n)).astype(np.float32)
    cat = np.stack([rng.integers(0, s, n) for s in cat_sizes])
    if all_null:
        num[rng.random(num.shape) < 0.05] = np.nan
        cat[rng.random(cat.shape) < 0.05] = -1
    else:
        num[1, rng.random(n) < 0.1] = np.nan
        cat[0, rng.random(n) < 0.1] = -1
    return num, cat


@pytest.mark.parametrize("cat_sizes,d,all_null,wide", [
    ((8, 8), 3, False, False), ((54, 30), 3, False, False),
    ((54, 33, 337), 3, False, True), ((4,) * 10, 20, True, False)])
def test_scan_gram_on_the_card_matches_the_plain_fold(cuda, cat_sizes, d,
                                                      all_null, wide):
    """The fold on the card (one masked_gram a chunk: K1 at P + K ≤ 88, K7
    above; P = 88 with K = 2, and P = 61 with 30 nullable columns, cross
    to K7) against the same fold on the CPU: counts exact, the rest
    within 1e-5 of max|G|; one launch a chunk."""
    from duckdb_imputation_tpu_torch.ring import streaming

    num, cat = _stream_arrays(50_011, 3, cat_sizes, d, all_null)
    src = streaming.chunks_from_arrays(num, cat, chunk_rows=7_000)
    ss, _ = streaming.scan_schema(src, collect_dirty=False)
    ext = streaming.extended_schema(ss)
    assert (ext.sigma_size > _build.MAX_SIGMA_SIZE) == (
        wide or ss.schema.sigma_size in (61, 88))
    before = (masked_gram.launches, masked_gram.wide_launches)
    got = streaming.scan_gram(src, ss, chunk_rows=16_384, device=cuda)
    after = (masked_gram.launches, masked_gram.wide_launches)
    chunks = -(-50_011 // 16_384)
    k7 = ext.sigma_size > _build.MAX_SIGMA_SIZE
    assert (after[0] - before[0], after[1] - before[1]) == (
        (0, chunks) if k7 else (chunks, 0))
    want = streaming.scan_gram(src, ss, chunk_rows=16_384, device="cpu")
    assert got.dtype == torch.float64
    cm = count_mask(ext, "cpu")
    assert torch.equal(got.cpu()[cm], want[cm])
    assert float((got.cpu() - want).abs().max()) <= (
        1e-5 * float(want.abs().max()))


def test_read_csv_on_the_card(cuda, tmp_path):
    from duckdb_imputation_tpu_torch.table.native import read_csv

    path = tmp_path / "t.csv"
    path.write_text("a,b,c\n1.5,2,x\n,7,y\n3.25,,x\n")
    got = read_csv(str(path))
    want = read_csv(str(path), device="cpu")
    assert got.device.type == "cuda"
    for a, b in ((got.num_data, want.num_data),
                 (got.cat_codes, want.cat_codes),
                 (got.num_null, want.num_null),
                 (got.cat_null, want.cat_null)):
        assert torch.equal(a.cpu(), b)
    assert got.cat_labels == want.cat_labels == (None, ("x", "y"))


@pytest.mark.parametrize("engine", ["device", "host"])
def test_impute_csv_stream_on_the_card_matches_cpu(cuda, tmp_path, engine):
    """A small CSV imputed by impute_csv_stream on the card and on the
    CPU: the same header and observed cells; imputed x within 1e-3 of
    max|x| and codes agreeing on ≥ 0.99 of the imputed cells."""
    from duckdb_imputation_tpu_torch.mice.streaming import impute_csv_stream
    from duckdb_imputation_tpu_torch.table.native import (format_csv_block,
                                                          read_csv)

    rng = np.random.default_rng(7)
    n = 20_000
    z = rng.normal(size=n)
    x = np.stack([z, 3 * z + rng.normal(size=n) * 0.1,
                  rng.normal(size=n)]).astype(np.float32)
    g = (z > 0).astype(np.int64) * 5 + 1
    x[1, rng.random(n) < 0.1] = np.nan
    gf = np.where(rng.random(n) < 0.1, np.nan, g.astype(np.float64))
    src = tmp_path / "in.csv"
    with open(src, "wb") as f:
        f.write(b"a,b,c,g\n")
        f.write(format_csv_block([*x, gf], [0, 0, 0, 1]))
    kw = dict(iters=2, noise=False, block_bytes=1 << 16, engine=engine)
    impute_csv_stream(str(src), str(tmp_path / "card.csv"), **kw)
    impute_csv_stream(str(src), str(tmp_path / "cpu.csv"), device="cpu",
                      **kw)
    card = read_csv(str(tmp_path / "card.csv"), device="cpu")
    cpu = read_csv(str(tmp_path / "cpu.csv"), device="cpu")
    assert (tmp_path / "card.csv").read_text().splitlines()[0] == "a,b,c,g"
    obs = ~np.isnan(x)
    assert np.array_equal(card.num_data.numpy()[obs], x[obs])
    cx, px = card.num_data.numpy()[1], cpu.num_data.numpy()[1]
    assert np.abs(cx - px).max() <= 1e-3 * np.abs(px).max()
    cg, pg = card.cat_values()[0], cpu.cat_values()[0]
    null_g = np.isnan(gf)
    assert np.array_equal(cg[~null_g], g[~null_g])
    assert (cg[null_g] == pg[null_g]).mean() >= 0.99


# ---------------------------------------------------------------------------
# K7 over a column window past P = 1,024, and the wide-V path
# ---------------------------------------------------------------------------

# favorita_items: favorita_wide's columns and item_nbr's 4,100 (P = 4,592);
# wide16k: two columns of 8,192 (P = 16,387)
WINDOW_SCHEMAS = {
    "favorita_items": (3, (54, 33, 337, 2, 2, 22, 16, 5, 17, 4100)),
    "wide16k": (2, (8192, 8192)),
}


def window_cols(name, n, seed, device):
    d, sizes = WINDOW_SCHEMAS[name]
    schema = FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=device)
          for _ in range(d)]
    cs = [torch.tensor(rng.integers(-1, v + 1, n).astype(np.int32),
                       device=device) for v in sizes]
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32),
                     device=device)
    return schema, xs, cs, w


def window_count_mask(schema, lo, width, device):
    d = schema.num_cols
    rows = torch.arange(schema.sigma_size, device=device)
    cols = torch.arange(lo, lo + width, device=device)
    return (((rows[:, None] == 0) | (rows[:, None] > d))
            & ((cols[None] == 0) | (cols[None] > d)))


@pytest.mark.parametrize("name", WINDOW_SCHEMAS)
def test_k7_window_matches_plain(cuda, name):
    """K7 over column windows (the first; one across two one-hot blocks;
    the last, narrower; a wide one of 2,300 columns) against
    masked_gram_window_plain: counts exact, within 1e-5 of max|σ|, reruns
    bit-identical, one launch a call."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window, masked_gram_window_plain)

    schema, xs, cs, w = window_cols(name, 30_000, seed=3, device=cuda)
    p = schema.sigma_size
    for lo, width in ((0, 1024), (p - 4100 - 300, 1024),
                      (p - 1024 + 7, 1024 - 7), (1, 2300)):
        before = masked_gram_window.launches
        got = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                 width=width)
        again = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                   width=width)
        torch.cuda.synchronize()
        assert masked_gram_window.launches == before + 2
        want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                        width=width)
        assert got.shape == (p, width)
        assert torch.equal(got, again)
        cm = window_count_mask(schema, lo, width, cuda)
        assert torch.equal(got[cm], want[cm])
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_masked_gram_above_1024_is_its_windows(cuda):
    """masked_gram_cols and masked_gram at P = 4,592 launch K7 once a
    window of WINDOW_WIDTH columns, and S equals the windows side by side
    (bit for bit) and is symmetric."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)

    schema, xs, cs, w = window_cols("favorita_items", 20_000, seed=5,
                                    device=cuda)
    p, width = schema.sigma_size, _build.WINDOW_WIDTH
    before = masked_gram_cols.wide_launches
    got = masked_gram_cols(xs, cs, w, schema=schema)
    assert masked_gram_cols.wide_launches == before + -(-p // width)
    stacked = masked_gram(torch.stack(xs), torch.stack(cs), w,
                          schema=schema)
    parts = torch.cat([masked_gram_window(
        xs, cs, w, schema=schema, lo=lo, width=min(width, p - lo))
        for lo in range(0, p, width)], 1)
    assert torch.equal(got, parts) and torch.equal(stacked, parts)
    assert torch.equal(got, got.T)


# The keyed windows: schemas whose windows key a column (P past 1,024, its
# tables take more than one task): P = 1,115 (the CPU tests'), two
# columns of 2,048 levels, favorita_items
KEYED_SCHEMAS = {"P1115": (3, (6, 5, 1100)),
                 "two of 2,048": (1, (2048, 2048)),
                 "favorita_items": (3, (54, 33, 337, 2, 2, 22, 16, 5, 17,
                                        4100))}


def keyed_cols(name, n, seed, device, hot=0.5, empty=0.25):
    """Per-column inputs of KEYED_SCHEMAS[name]: x N(0, 1); codes uniform
    over [−1, V] (−1 and V add nothing) except the last column, whose top
    `empty` share of levels is never drawn (empty keys) and whose code 7
    holds a `hot` share of the rows; binary weights."""
    d, sizes = KEYED_SCHEMAS[name]
    schema = FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=device)
          for _ in range(d)]
    codes = [rng.integers(-1, v + 1, n) for v in sizes]
    last = rng.integers(0, int(sizes[-1] * (1 - empty)), n)
    last[rng.random(n) < hot] = 7
    codes[-1] = last
    cs = [torch.tensor(c.astype(np.int32), device=device) for c in codes]
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=device)
    return schema, xs, cs, w


@pytest.mark.parametrize("name", sorted(KEYED_SCHEMAS))
@pytest.mark.parametrize("n", [1, 31, 100_003])
def test_keyed_windows_match_plain(cuda, name, n):
    """K7 over every window of 1,024 columns, keyed tasks and residual
    (a column keyed where its tables fill more than one task), with a hot
    key (half the rows on one code), empty keys, codes out of range and n
    not a multiple of 32: against masked_gram_window_plain, counts exact,
    within 1e-5 of max|σ|; reruns bit-identical; one window launch and
    one order pass a call; a pass over S equals its windows side by side
    and is symmetric."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window, masked_gram_window_plain, window_order)

    schema, xs, cs, w = keyed_cols(name, n, seed=21, device=cuda)
    p = schema.sigma_size
    parts, keyed = [], 0
    for lo in range(0, p, _build.WINDOW_WIDTH):
        width = min(_build.WINDOW_WIDTH, p - lo)
        has = _build.keyed_window_plan(schema, lo, lo + width)[1] is not None
        keyed += has
        launches, orders = masked_gram_window.launches, window_order.passes
        got = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                 width=width)
        again = masked_gram_window(xs, cs, w, schema=schema, lo=lo,
                                   width=width)
        torch.cuda.synchronize()
        assert masked_gram_window.launches == launches + 2
        assert window_order.passes == orders + 2 * has
        assert torch.equal(got, again)
        want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                        width=width)
        cm = window_count_mask(schema, lo, width, cuda)
        assert torch.equal(got[cm], want[cm])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(
            float(want.abs().max()), 1e-30))
        parts.append(got)
    assert keyed >= 1
    full = masked_gram_cols(xs, cs, w, schema=schema)
    assert torch.equal(full, torch.cat(parts, 1))
    assert torch.equal(full, full.T)


@pytest.mark.parametrize("name", sorted(KEYED_SCHEMAS))
def test_keyed_pass_is_symmetric_with_real_weights(cuda, name):
    """A pass over S past P = 1,024 with lognormal weights, 300,007 rows
    and a hot key: S[i, j] and S[j, i] of every keyed C_jk cell lie in
    different windows and come from one owner's order and the same work
    items, so S equals its transpose exactly; within 1e-5 of max|σ| of
    the plain version."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window_plain)

    schema, xs, cs, _ = keyed_cols(name, 300_007, seed=24, device=cuda)
    rng = np.random.default_rng(25)
    w = torch.tensor(rng.lognormal(0.0, 1.0, 300_007).astype(np.float32),
                     device=cuda)
    full = masked_gram_cols(xs, cs, w, schema=schema)
    torch.cuda.synchronize()
    assert torch.equal(full, full.T)
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=0,
                                    width=schema.sigma_size)
    torch.testing.assert_close(full, want, rtol=0, atol=1e-5 * float(
        want.abs().max()))


@pytest.mark.parametrize("groups", [2, 33])
def test_keyed_k8_windows_match_plain(cuda, groups):
    """K8 past P = 1,024 at favorita_items, 200,003 rows with a hot item
    and empty keys, over rows sorted by group: its keyed tasks over the
    rows ordered by (group, code) and its residual, each group's S against
    the plain version (counts exact, within 1e-5 of max|σ|), reruns
    bit-identical, one order pass a call."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_order)

    n = 200_003
    schema, xs, cs, w = keyed_cols("favorita_items", n, seed=22,
                                   device=cuda)
    rng = np.random.default_rng(23)
    g = torch.tensor(rng.integers(0, groups + 1, n).astype(np.int32),
                     device=cuda)                  # id G: dropped
    x_s, c_s, w_s, layout = sort_by_group(torch.stack(xs), torch.stack(cs),
                                          g, schema=schema,
                                          num_groups=groups, weights=w)
    orders = window_order.passes
    got = grouped_gram_presorted(x_s, c_s, w_s, layout, schema=schema)
    again = grouped_gram_presorted(x_s, c_s, w_s, layout, schema=schema)
    torch.cuda.synchronize()
    assert window_order.passes == orders + 2
    assert torch.equal(got, again)
    cm = count_mask(schema, cuda)
    for gg in range(groups):
        want = grouped_gram_presorted_plain(
            x_s, c_s, w_s, _one_group(layout, gg), schema=schema)[0]
        assert torch.equal(got[gg][cm], want[cm])
        torch.testing.assert_close(got[gg], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        del want


@pytest.mark.parametrize("groups", [None, 3, 33])
def test_window_order_kernel_matches_plain(cuda, groups):
    """The order kernels (a stable counting sort of each keyed column,
    and the copy of every column in its order) against the plain version
    (a stable torch.sort and a gather) on the same rows, with codes out
    of range, a hot code and, for K8, group-sorted rows with some past G:
    the keys' offsets equal, and the copies equal bit for bit over every
    row with a key (the rest is not copied by the kernels); one kernel
    launch a column."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_order)

    n = 200_003
    schema, xs, cs, w = keyed_cols("favorita_items", n, seed=25,
                                   device=cuda)
    cs[-1] = torch.where(cs[-1] % 97 == 0, -1, cs[-1])   # out of range
    offsets = None
    if groups:
        rng = np.random.default_rng(26)
        g = torch.tensor(rng.integers(0, groups + 1, n).astype(np.int32),
                         device=cuda)
        x_s, c_s, w, layout = sort_by_group(torch.stack(xs),
                                            torch.stack(cs), g,
                                            schema=schema, num_groups=groups,
                                            weights=w)
        xs, cs, offsets = list(x_s), list(c_s), layout.offsets
    cols = (2, 9)
    before = window_order.launches
    got = window_order(xs, cs, w, schema=schema, columns=cols,
                       offsets=offsets)
    again = window_order(xs, cs, w, schema=schema, columns=cols,
                         offsets=offsets)
    assert window_order.launches == before + 2 * len(cols)
    want = window_order([x.cpu() for x in xs], [c.cpu() for c in cs],
                        w.cpu(), schema=schema, columns=cols,
                        offsets=None if offsets is None else offsets.cpu())
    assert torch.equal(got.key_off.cpu(), want.key_off)
    assert torch.equal(got.rows_of.cpu(), want.rows_of)
    assert torch.equal(got.off_of.cpu(), want.off_of)
    ncols = 1 + schema.num_cols + schema.cat_cols
    assert torch.equal(got.key_chunks.cpu(), want.key_chunks)
    for q, j in enumerate(cols):
        keys = (groups or 1) * schema.cat_sizes[j]
        last = int(want.key_off[int(want.off_of[j]) + keys])
        assert torch.equal(got.rows[q, :last, :ncols].cpu(),
                           want.rows[q, :last, :ncols])
        assert torch.equal(again.rows[q, :last, :ncols],
                           got.rows[q, :last, :ncols])


def test_keyed_work_items_walk_their_rows_once(cuda):
    """On the card, the keyed tasks' work items (the same arithmetic the
    kernel's blocks read) walk each layer's key range's rows once: n where
    the range is every key and every code is in range."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        keyed_work, window_columns, window_order)

    n = 1_000_003
    schema, xs, cs, w = keyed_cols("favorita_items", n, seed=24,
                                   device=cuda, empty=0.0)
    cs = [c.clamp(0, v - 1) for c, v in zip(cs, schema.cat_sizes)]
    keyed = _build.keyed_window_plan(schema, 0, 1024)[1]
    order = window_order(xs, cs, w, schema=schema,
                         columns=window_columns(schema, [0], 1024))
    work = keyed_work(keyed, order, n, schema)
    assert work["rows"] == work["in_range"]
    assert all(v == n for v in work["rows"].values())
    assert work["items"] <= _build.keyed_items_bound(keyed, n)


def test_run_mice_wide_on_the_card_matches_cpu(cuda):
    """run_mice_wide on a 1 × 1 grid on the card (K7 over the window of
    all columns, the CG solves in f32) against the same run on the CPU
    (its plain versions): codes agree on ≥ 99.9% of the null cells,
    numerics within 5e-3."""
    from duckdb_imputation_tpu_torch.parallel import (make_mesh_2d,
                                                      run_mice_wide)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)

    rng = np.random.default_rng(33)
    n = 20_000
    cls = rng.integers(0, 3, size=n)
    num = np.stack([cls - 1.0 + 0.3 * rng.normal(size=n),
                    0.7 * (cls - 1.0) + 0.2 * rng.normal(size=n)]
                   ).astype(np.float32)
    codes = np.stack([cls, rng.integers(0, 1500, size=n)]).astype(np.int32)
    schema = FeatureSchema(num_cols=2, cat_keys=(tuple(range(3)),
                                                 tuple(range(1500))))
    nn = np.zeros((2, n), bool)
    cn = np.zeros((2, n), bool)
    nn[1, rng.random(n) < 0.2] = True
    cn[0, rng.random(n) < 0.2] = True
    kw = dict(schema=schema, iters=2, ridge=1e-2, shrinkage=1e-2,
              cg_iters=2000, tol=1e-9)
    before = masked_gram_window.launches
    xg, cg = run_mice_wide(*(torch.tensor(a, device=cuda)
                             for a in (num, codes, nn, cn)),
                           mesh=make_mesh_2d(1, 1, device=cuda), **kw)
    assert masked_gram_window.launches == before + 4
    xc, cc = run_mice_wide(*(torch.tensor(a) for a in (num, codes, nn, cn)),
                           mesh=make_mesh_2d(1, 1, device="cpu"), **kw)
    assert (cg.cpu()[0][cn[0]] == cc[0][cn[0]]).float().mean() >= 0.999
    torch.testing.assert_close(xg.cpu(), xc, rtol=5e-3, atol=5e-3)


def _sql_table(con, n, seed):
    """A config-5-shaped table registered on `con`: 4 numeric columns
    (NaN for NULL in x1) and two categorical columns of 8 levels, cast
    back to INTEGER from float columns with NaN (c0 with NULLs)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, n))
    x = np.stack([z[0], 2 * z[0] + z[1], z[1] - z[0],
                  rng.normal(size=n)]).astype(np.float32)
    c = np.stack([np.clip(z[0] + 4, 0, 7).astype(int),
                  rng.integers(0, 8, n)]).astype(np.float64)
    x[1, rng.random(n) < 0.2] = np.nan
    c[0, rng.random(n) < 0.2] = np.nan
    con.register("raw", {"x0": x[0], "x1": x[1], "x2": x[2], "x3": x[3],
                         "c0f": c[0], "c1f": c[1]})
    con.execute("CREATE TABLE t AS SELECT x0, x1, x2, x3, c0f::INTEGER AS "
                "c0, c1f::INTEGER AS c1, x1 IS NULL AS x1_is_null, "
                "c0f IS NULL AS c0_is_null FROM raw")


def test_sql_aggregates_on_the_card_match_cpu(cuda):
    """The masked and grouped SQL aggregates on a card connection (K1
    through api.sum_to_triple, one launch a statement or a group; K6
    through sum_to_nb_agg) against a CPU connection: N and the counts
    equal, the sums within 1e-5 of the aggregate's max; a triple cast back
    from text lands on the card; the CASE-WHEN LDA predict equal."""
    from duckdb_imputation_tpu_torch import sql
    from duckdb_imputation_tpu_torch.ring import serialize
    from duckdb_imputation_tpu_torch.ring.kernels.nb_pallas import (
        nb_grouped_sums)

    card, host = sql.connect(device=cuda), sql.connect(device="cpu")
    for con in (card, host):
        _sql_table(con, 200_003, seed=4)
    # the aggregates see the NULL cells' placeholders (IgnoreNull() is
    # false, sum_state.h:54-56): the WHERE drops them
    observed = "WHERE x1_is_null IS FALSE AND c0_is_null IS FALSE"
    qs = [f"SELECT sum_to_triple_4_2(x0, x1, x2, x3, c0, c1) FROM t "
          f"{observed}",
          f"SELECT sum_to_triple_4_2(x0, x1, x2, x3, c0, c1), c1 FROM t "
          f"{observed} GROUP BY c1",
          f"SELECT sum_to_nb_agg_4_1(x0, x1, x2, x3, c0) FROM t {observed}"]
    before = (masked_gram.launches, nb_grouped_sums.launches)
    got = [card.execute(q).fetchall() for q in qs]
    assert (masked_gram.launches - before[0],
            nb_grouped_sums.launches - before[1]) == (1 + 8, 1)
    want = [host.execute(q).fetchall() for q in qs]
    for g_rows, w_rows in zip(got, want):
        assert len(g_rows) == len(w_rows)
        for g, w in zip(g_rows, w_rows):
            assert g[1:] == w[1:]
            if "quad_cat" in w[0]:
                gt, _ = serialize.dict_to_triple(g[0], device="cpu")
                wt, schema = serialize.dict_to_triple(w[0], device="cpu")
                gs, ws = sigma_from_triple(gt), sigma_from_triple(wt)
                d = schema.num_cols
                counts = torch.ones_like(ws, dtype=torch.bool)
                counts[1:1 + d] = False
                counts[:, 1:1 + d] = False
                assert torch.equal(gs[counts], ws[counts])
                torch.testing.assert_close(gs, ws, rtol=0, atol=1e-5 * float(
                    ws.abs().max()))
            else:
                gt, _ = serialize.dict_to_nb(g[0], device="cpu")
                wt, _ = serialize.dict_to_nb(w[0], device="cpu")
                assert torch.equal(gt.n, wt.n)
                assert torch.equal(gt.lin_cat, wt.lin_cat)
                for f in ("lin", "quad_diag"):
                    a, b = getattr(gt, f), getattr(wt, f)
                    torch.testing.assert_close(
                        a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    triple = got[0][0][0]
    cast = ("::STRUCT(N int, lin_agg FLOAT[], quad_agg FLOAT[], "
            "lin_cat STRUCT(key INT, value FLOAT)[][], "
            "quad_num_cat STRUCT(key INT, value FLOAT)[][], "
            "quad_cat STRUCT(key1 INT, key2 INT, value FLOAT)[][])")
    value = card._run_select(sql.parse(f"SELECT {triple!r}{cast}")
                             ).cols[0].data[0]
    assert value.triple.quad.device.type == "cuda"
    params = host.execute(f"SELECT lda_train({triple!r}{cast}, 0, 0.001)"
                          ).fetchone()[0]
    q = (f"SELECT CASE WHEN c0_is_null THEN lda_predict({params!r}::FLOAT[],"
         f" false, x0, x1, x2, x3, c1) ELSE c0 END FROM t")
    assert card.execute(q).fetchall() == host.execute(q).fetchall()


def test_overlapped_at_world_one_matches_sharded(nccl_mesh):
    """sum_to_triple_overlapped on a world of one over NCCL at a P = 1,107
    schema: one K7 window launch a stripe, against sum_to_triple_sharded
    (K7's window launches above P = 1,024): n, lin_cat and cat_cat exact,
    quad, lin and num_cat within rtol 1e-6, atol 1e-3 (tests/
    test_sharded.py's bounds)."""
    from duckdb_imputation_tpu_torch.parallel import (
        sum_to_triple_overlapped, sum_to_triple_sharded)
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window)

    dev = nccl_mesh.device
    schema = FeatureSchema(num_cols=3, cat_keys=(tuple(range(3)),
                                                 tuple(range(1100))))
    rng = np.random.default_rng(8)
    n = 100_001
    x = torch.tensor(rng.normal(size=(3, n)).astype(np.float32), device=dev)
    c = torch.tensor(np.stack([rng.integers(0, 3, n),
                               rng.integers(0, 1100, n)]).astype(np.int32),
                     device=dev)
    w = torch.tensor((rng.random(n) < 0.8).astype(np.float32), device=dev)
    before = masked_gram_window.launches
    got = sum_to_triple_overlapped(x, c, w, schema=schema, mesh=nccl_mesh,
                                   n_stripes=5)
    torch.cuda.synchronize()
    assert masked_gram_window.launches == before + 5
    want = sum_to_triple_sharded(x, c, w, schema=schema, mesh=nccl_mesh)
    for f in ("n", "lin_cat", "cat_cat"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("quad", "lin", "num_cat"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=1e-3)


# ---------------------------------------------------------------------------
# K2w, K8 and K3/K3w past P = 1,024
# ---------------------------------------------------------------------------

# P = 1,115 (the CPU tests' schema: 6, 5 and 1,100 levels) and
# favorita_items (P = 4,592)
PAST_SCHEMAS = {"P1115": (6, 5, 1100),
                "favorita_items": (54, 33, 337, 2, 2, 22, 16, 5, 17, 4100)}
PAST_ROWS = {"P1115": 30_000, "favorita_items": 1_000_000}


def past_table(name, n, seed, device):
    """x f32[3, n] and codes i32[c, n] of PAST_SCHEMAS[name]: column 1
    (family) fixed by the last column (the item), Zipf item shares, other
    columns uniform, 20% nulls in x1 and in column 1. Returns (schema,
    x, codes, num null, cat null)."""
    sizes = PAST_SCHEMAS[name]
    rng = np.random.default_rng(seed)
    items = sizes[-1]
    family_of_item = rng.permutation(np.arange(items) % sizes[1])
    share = 1.0 / rng.permutation(np.arange(1, items + 1))
    item = rng.choice(items, n, p=share / share.sum())
    fam = family_of_item[item]
    codes = np.stack([rng.integers(0, v, n) for v in sizes]).astype(np.int32)
    codes[1], codes[-1] = fam, item
    x0 = rng.normal(size=n)
    x = np.stack([x0, 2.0 * x0 + rng.normal(size=sizes[1])[fam]
                  + 0.3 * rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    nn = np.zeros((3, n), bool)
    cn = np.zeros((len(sizes), n), bool)
    nn[1] = rng.random(n) < 0.2
    cn[1] = rng.random(n) < 0.2
    schema = FeatureSchema(num_cols=3, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    dev = lambda a: torch.tensor(a, device=device)   # noqa: E731
    return schema, dev(x), dev(codes), dev(nn), dev(cn)


@pytest.mark.parametrize("kind", ["cat", "num"])
@pytest.mark.parametrize("name", sorted(PAST_SCHEMAS))
def test_k2w_past_1024_matches_plain(cuda, name, kind):
    """K2w past P = 1,024 (the impute kernel with W in device memory, then
    K7 a column window): 'cat' imputes column 1 (R = 5 or 33), 'num' x1
    with noise; new codes ≥ 0.9999 equal to the plain version's and
    numerics within 1e-6; sigma counts exact against the plain Gram of the
    kernel's own updated columns and within 1e-5 of max|σ| of the plain
    pass; one impute launch and one window launch a window of 1,024,
    counted exactly; reruns bit-identical."""
    schema, x, codes, nn, cn = past_table(name, PAST_ROWS[name], 3, cuda)
    p = schema.sigma_size
    rng = np.random.default_rng(4)
    if kind == "cat":
        r, col, null, w_agg = schema.cat_sizes[1], 1, cn[1], (~nn[1]).float()
        noise = None
    else:
        r, col, null, w_agg = 1, 1, nn[1], (~cn[1]).float()
        noise = (7, 2, torch.tensor([0.3], device=cuda))
    w_full = torch.tensor(rng.normal(size=(p, r)).astype(np.float32),
                          device=cuda)
    icpt = torch.tensor(rng.normal(size=r).astype(np.float32), device=cuda)
    args = (list(x), list(codes), null, w_agg, w_full, icpt)
    kw = dict(schema=schema, kind=kind, imp_col=col, noise=noise)
    imp, win = (fused_impute_aggregate.impute_launches,
                fused_impute_aggregate.window_launches)
    wide = fused_impute_aggregate.wide_launches
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    windows = -(-p // _build.WINDOW_WIDTH)
    assert fused_impute_aggregate.impute_launches - imp == 2
    assert fused_impute_aggregate.window_launches - win == 2 * windows
    assert fused_impute_aggregate.wide_launches == wide
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert float((new == want_new).float().mean()) >= 0.9999
        assert torch.equal(new[~null], codes[col][~null])
        cols = (list(x), [new if j == col else c
                          for j, c in enumerate(codes)])
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
        cols = ([new if j == col else v for j, v in enumerate(x)],
                list(codes))
    own = masked_gram_cols_plain(*cols, w_agg, schema=schema)
    cm = count_mask(schema, cuda)
    assert torch.equal(sig[cm], own[cm])
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("name,groups", [("P1115", 3),
                                         ("favorita_items", 2),
                                         ("favorita_items", 33)])
def test_k8_past_1024_matches_plain(cuda, name, groups):
    """K8 past P = 1,024: one launch a column window over group-sorted
    rows (300k rows at favorita_items), each group's S against the plain
    version (its tables, no dense Z): counts exact, within 1e-5 of
    max|σ|, reruns bit-identical; the unsorted entry and the 'auto' GROUP
    BY (a sort, then K8) give the same."""
    n = 30_000 if name == "P1115" else 300_000
    schema, x, codes, _, _ = past_table(name, n, 5, cuda)
    rng = np.random.default_rng(6)
    g = torch.tensor(rng.integers(0, groups, n).astype(np.int32),
                     device=cuda)
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=cuda)
    xs, cs, ws, layout = sort_by_group(x, codes, g, schema=schema,
                                       num_groups=groups, weights=w)
    before = grouped_gram_presorted.wide_launches
    got = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    again = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    windows = -(-schema.sigma_size // _build.WINDOW_WIDTH)
    assert grouped_gram_presorted.wide_launches - before == 2 * windows
    assert torch.equal(got, again)
    cm = count_mask(schema, cuda)
    for gg in range(groups):
        want = grouped_gram_presorted_plain(
            xs, cs, ws, _one_group(layout, gg), schema=schema)[0]
        assert torch.equal(got[gg][cm], want[cm])
        torch.testing.assert_close(got[gg], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        del want
    assert torch.equal(grouped_gram(x, codes, w, g, schema=schema,
                                    num_groups=groups), got)
    tri = sum_to_triple_grouped(x, codes, g, schema=schema,
                                num_groups=groups, weights=w)
    assert torch.equal(sigma_from_triple(tri), got)


def _one_group(layout, g):
    """The layout of group g alone, as group 0 of one."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas_grouped \
        import GroupLayout

    return GroupLayout(layout.offsets[g:g + 2].clone(), 1)


@pytest.mark.parametrize("scorer", ["nb_family", "qda_onpromotion"])
def test_k3_past_1024_matches_plain(cuda, scorer):
    """K3w at favorita_items without the label: NB's plan at 33 classes
    (family) and QDA's cross plan at 2 classes (onpromotion; its item
    cross tables keyed on the item), seeded tables, 100k rows with codes
    out of vocab: equal to the plain scorer, reruns bit-identical, one
    wide launch a call."""
    sizes = PAST_SCHEMAS["favorita_items"]
    label = 1 if scorer == "nb_family" else 4
    keys = tuple(tuple(range(v)) for j, v in enumerate(sizes) if j != label)
    schema = FeatureSchema(num_cols=3, cat_keys=keys)
    rng = np.random.default_rng(7)
    n, p = 100_000, schema.sigma_size
    x = torch.tensor(rng.normal(size=(3, n)).astype(np.float32), device=cuda)
    c = torch.tensor(np.stack([rng.integers(-1, len(k) + 1, n) for k in keys]
                              ).astype(np.int32), device=cuda)
    if scorer == "nb_family":
        classes = 33
        mean = torch.tensor(rng.normal(size=(classes, 3)), device=cuda)
        var = torch.tensor(rng.random((classes, 3)) + 0.1, device=cuda)
        log_freq = torch.tensor(np.log(rng.random((classes, p - 4)) + 1e-3),
                                device=cuda)
        log_prior = torch.tensor(np.log(rng.dirichlet(np.ones(classes))),
                                 device=cuda)
        tables, plan = nb_tables(log_prior, mean, var, log_freq,
                                 schema=schema)
        assert not plan.cross
    else:
        classes = 2
        b = rng.normal(size=(classes, p - 1, 4)) * 0.1
        quad = torch.tensor(-(b @ b.transpose(0, 2, 1)), device=cuda)
        lin = torch.tensor(rng.normal(size=(classes, p - 1)), device=cuda)
        tables, plan = qda_tables(quad, lin, torch.zeros(classes,
                                                         device=cuda),
                                  schema=schema)
        assert plan.cross
        del quad
    assert plan.num_tasks > 1
    before = qda_predict_kernel.wide_launches
    got = qda_predict_kernel(tables, plan, x, c, schema=schema)
    again = qda_predict_kernel(tables, plan, x, c, schema=schema)
    assert qda_predict_kernel.wide_launches - before == 2
    assert torch.equal(got, again)
    want = qda_predict_plain(tables, plan, x, c, schema=schema)
    assert float((got == want).float().mean()) >= 0.9999
    assert len(torch.unique(got)) > 1


def test_paths_past_1024_on_the_card_match_cpu(cuda):
    """At favorita_items, 200k rows: run_mice_device(kernel='fused') on
    the card (K2w past 1,024 after K7's windows) against the plain loop on
    the CPU (family codes ≥ 0.999 of the null cells), and the NB pipeline
    (label family: K6w, K3w) and the QDA aggregate (label onpromotion:
    sort + K8 windows) on the card against the CPU's, with the launches
    counted and no plain version on the card."""
    from duckdb_imputation_tpu_torch import Table
    from duckdb_imputation_tpu_torch.models.device import (
        nb_predict_device, nb_train_device)
    from duckdb_imputation_tpu_torch.ring.sum import sum_to_nb_agg_grouped

    schema, x, codes, nn, cn = past_table("favorita_items", 200_000, 8,
                                          cuda)
    x = torch.where(nn, 0.0, x)
    codes = torch.where(cn, 0, codes)
    t = Table(num_data=x, cat_codes=codes, num_null=nn, cat_null=cn,
              schema=schema)
    imp = fused_impute_aggregate.impute_launches
    got = run_mice_device(t, iters=1, kernel="fused")
    assert fused_impute_aggregate.impute_launches - imp == 2
    cpu = Table(*(a.cpu() for a in (x, codes, nn, cn)), schema=schema)
    want = run_mice_device(cpu, iters=1, kernel="fused")
    m = cn[1].cpu()
    agree = float((got.cat_codes[1].cpu() == want.cat_codes[1])[m]
                  .float().mean())
    assert agree >= 0.999
    # the classifiers over the table with no nulls: label family (NB) and
    # onpromotion (the grouped Gram of QDA's training)
    _, x, codes, _, _ = past_table("favorita_items", 200_000, 9, cuda)
    keep = [j for j in range(codes.shape[0]) if j != 1]
    nb_schema = FeatureSchema(3, tuple(schema.cat_keys[j] for j in keep))
    feats = codes[keep].contiguous()
    y = codes[1].contiguous()
    k3w = qda_predict_kernel.wide_launches

    def nb(x, feats, y):
        agg = sum_to_nb_agg_grouped(x, feats, y, schema=nb_schema,
                                    num_groups=33)
        params = nb_train_device(agg.n, agg.lin, agg.quad_diag, agg.lin_cat)
        return nb_predict_device(*params, x, feats, schema=nb_schema)

    pred = nb(x, feats, y).cpu()
    assert qda_predict_kernel.wide_launches - k3w == 1
    assert float((pred == nb(x.cpu(), feats.cpu(), y.cpu())).float()
                 .mean()) >= 0.999
    keep = [j for j in range(codes.shape[0]) if j != 4]
    q_schema = FeatureSchema(3, tuple(schema.cat_keys[j] for j in keep))
    k8 = grouped_gram_presorted.wide_launches
    tri = sum_to_triple_grouped(x, codes[keep].contiguous(),
                                codes[4].contiguous(), schema=q_schema,
                                num_groups=2)
    assert grouped_gram_presorted.wide_launches - k8 == -(
        -q_schema.sigma_size // _build.WINDOW_WIDTH)
    ref = sum_to_triple_grouped(x.cpu(), codes[keep].cpu(), codes[4].cpu(),
                                schema=q_schema, num_groups=2)
    assert torch.equal(tri.n.cpu(), ref.n)
    torch.testing.assert_close(sigma_from_triple(tri).cpu(),
                               sigma_from_triple(ref), rtol=0,
                               atol=1e-5 * float(sigma_from_triple(ref)
                                                 .abs().max()))


def test_sharded_fused_past_1024_at_world_one_on_nccl(nccl_mesh):
    """run_mice_sharded with its defaults ('auto' = 'fused' on a CUDA
    table) at favorita_items, 200k rows, on a world of one over NCCL:
    bit-identical to run_mice_device(kernel='fused')."""
    from duckdb_imputation_tpu_torch import Table
    from duckdb_imputation_tpu_torch.mice import run_mice_sharded

    schema, x, codes, nn, cn = past_table("favorita_items", 200_000, 10,
                                          nccl_mesh.device)
    t = Table(num_data=torch.where(nn, 0.0, x),
              cat_codes=torch.where(cn, 0, codes), num_null=nn, cat_null=cn,
              schema=schema)
    imp = fused_impute_aggregate.impute_launches
    got = run_mice_sharded(t, iters=1, mesh=nccl_mesh)
    assert fused_impute_aggregate.impute_launches - imp == 2
    want = run_mice_device(t, iters=1, kernel="fused")
    assert torch.equal(got.num_data, want.num_data)
    assert torch.equal(got.cat_codes, want.cat_codes)


# ---------------------------------------------------------------------------
# Schemas of any column count: every kernel past 64 numeric and 64
# categorical columns, and past the 88 of each kind its parameter holds
# (the columns' device table, _build.far_table)
# ---------------------------------------------------------------------------

# Kaggle "Home Credit Default Risk" application_train.csv: 104 numeric
# columns, 16 categorical (P = 245); UCI SECOM: 590 numeric (P = 591)
HOME_CREDIT = (2, 3, 2, 2, 7, 8, 5, 6, 6, 18, 7, 58, 4, 3, 7, 2)
MANY_COLS = {"d80": (80, ()), "d70c2": (70, (8, 8)),
             "home_credit": (104, HOME_CREDIT), "secom": (590, ()),
             "past1024": (100, (4100,) + (3,) * 89),
             "secom_fold": (590, (1,) * 590)}
MANY_ROWS = {"secom": 20_000, "past1024": 20_000, "secom_fold": 3_000}


def many_cols_inputs(name, cuda, n=None, seed=0, binary=True):
    """A table of MANY_COLS[name] (`cols_inputs`)."""
    return cols_inputs(*MANY_COLS[name], n or MANY_ROWS.get(name, 50_003),
                       cuda, seed, binary)


def cols_inputs(d, sizes, n, cuda, seed=0, binary=True):
    """A table of d numeric columns and categorical ones of `sizes`
    levels: normal numerics, codes with 5% out of vocabulary, weights of
    0/1 (or uniform)."""
    schema = FeatureSchema(num_cols=d, cat_keys=tuple(tuple(range(v))
                                                      for v in sizes))
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(d)]
    cs = []
    for v in sizes:
        c = rng.integers(0, v, n).astype(np.int32)
        c[rng.random(n) < 0.05] = v
        cs.append(torch.tensor(c, device=cuda))
    w = torch.tensor((rng.random(n) > 0.3).astype(np.float32) if binary
                     else rng.random(n).astype(np.float32), device=cuda)
    return schema, xs, cs, w


@pytest.mark.parametrize("name", sorted(MANY_COLS))
def test_many_cols_gram_matches_plain(cuda, name):
    """K1 (P ≤ 88), K7 (up to P = 1,024) and K7's windows (past it; the
    SECOM fold's 590 one-level flags as CM slabs): S = Sᵀ exactly, counts
    exact, a rerun bit-identical, the rest within 1e-5 of max|σ|."""
    schema, xs, cs, w = many_cols_inputs(name, cuda)
    got = masked_gram_cols(xs, cs, w, schema=schema)
    again = masked_gram_cols(xs, cs, w, schema=schema)
    want = masked_gram_cols_plain(xs, cs, w, schema=schema)
    assert torch.equal(got, again)
    assert torch.equal(got, got.T)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name,kind,col", [
    ("d80", "num", 79), ("d70c2", "cat", 1), ("d70c2", "num", 3),
    ("home_credit", "num", 100), ("home_credit", "num", 7),
    ("home_credit", "cat", 11), ("secom", "num", 589),
    ("past1024", "num", 95), ("past1024", "cat", 89)])
def test_many_cols_fused_matches_plain(cuda, name, kind, col):
    """K2 (P ≤ 88) and K2w (past it; a numeric column past the parameter's
    88, whose Gram reads the output through the device table): codes equal
    to the plain version's, numerics within 1e-6, sigma within 1e-5 of
    max|σ|, a rerun bit-identical."""
    schema, xs, cs, w = many_cols_inputs(name, cuda, seed=3)
    n, p = w.shape[0], schema.sigma_size
    rng = np.random.default_rng(4)
    r = schema.cat_sizes[col] if kind == "cat" else 1
    w_full = torch.tensor(rng.normal(size=(p, r)).astype(np.float32) * 0.1,
                          device=cuda)
    icpt = torch.tensor(rng.normal(size=r).astype(np.float32), device=cuda)
    null = torch.tensor(rng.random(n) < 0.2, device=cuda)
    args = (xs, cs, null, w, w_full, icpt)
    kw = dict(schema=schema, kind=kind, imp_col=col)
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    assert torch.equal(sig, sig.T)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("name,groups", [
    ("d80", 3), ("d70c2", 8), ("home_credit", 2), ("secom", 2),
    ("past1024", 2)])
def test_many_cols_grouped_matches_plain(cuda, name, groups):
    """K4 (≤ 8 groups at P ≤ 88, unsorted), K5 and K8 (after
    sort_by_group; K8 a launch a window past P = 1,024): each group's S
    symmetric, counts exact, a rerun bit-identical, within 1e-5 of each
    group's max|σ|."""
    schema, x, c, w = many_cols_inputs(name, cuda, seed=5)
    n = w.shape[0]
    g = torch.randint(-1, groups + 1, (n,), dtype=torch.int32, device=cuda)
    xt, ct = torch.stack(x), (torch.stack(c) if c else
                              torch.zeros((0, n), dtype=torch.int32,
                                          device=cuda))
    got = grouped_gram(xt, ct, w, g, schema=schema, num_groups=groups)
    again = grouped_gram(xt, ct, w, g, schema=schema, num_groups=groups)
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(1, 2))
    want = grouped_gram_plain(xt, ct, w, g, schema=schema, num_groups=groups)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[:, cm], want[:, cm])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    xs, cs, ws, layout = sort_by_group(xt, ct, g, schema=schema,
                                       num_groups=groups, weights=w)
    pre = grouped_gram_presorted(xs, cs, ws, layout, schema=schema)
    torch.testing.assert_close(pre, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["d80", "d70c2", "home_credit", "secom",
                                  "past1024"])
def test_many_cols_nb_matches_plain(cuda, name):
    """K6 / K6w over 2 groups: counts exact, sums within 1e-5 relative, a
    rerun bit-identical."""
    schema, x, c, w = many_cols_inputs(name, cuda, seed=6)
    n = w.shape[0]
    g = torch.randint(-1, 3, (n,), dtype=torch.int32, device=cuda)
    xt = torch.stack(x)
    ct = (torch.stack(c) if c else
          torch.zeros((0, n), dtype=torch.int32, device=cuda))
    got = nb_grouped_sums(xt, ct, None, g, schema=schema, num_groups=2)
    again = nb_grouped_sums(xt, ct, None, g, schema=schema, num_groups=2)
    assert torch.equal(got, again)
    want = nb_grouped_sums_plain(xt, ct, None, g, schema=schema,
                                 num_groups=2)
    d = schema.num_cols
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, 1 + 2 * d:], want[:, 1 + 2 * d:])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["d80", "d70c2", "home_credit", "secom",
                                  "past1024"])
def test_many_cols_qda_matches_plain(cuda, name):
    """K3 / K3w over 3 classes (diagonal quadratic forms, random linear
    terms): equal to the plain scorer, a rerun bit-identical."""
    schema, x, c, _ = many_cols_inputs(name, cuda, n=20_000, seed=7)
    rng = np.random.default_rng(8)
    m = schema.sigma_size - 1
    quad = torch.tensor(-np.eye(m) * rng.random(m), device=cuda)
    lin = torch.tensor(rng.normal(size=(3, m)), device=cuda)
    tables, plan = qda_tables(quad.expand(3, m, m), lin,
                              torch.zeros(3, device=cuda), schema=schema)
    xt = torch.stack(x)
    ct = (torch.stack(c) if c else
          torch.zeros((0, 20_000), dtype=torch.int32, device=cuda))
    got = qda_predict_kernel(tables, plan, xt, ct, schema=schema)
    again = qda_predict_kernel(tables, plan, xt, ct, schema=schema)
    assert torch.equal(got, again)
    assert torch.equal(got, qda_predict_plain(tables, plan, xt, ct,
                                              schema=schema))


# ---------------------------------------------------------------------------
# A categorical column past a task's cells beside others; codes past 32,768
# ---------------------------------------------------------------------------

ROW_CUT, ROW_CUT_CAP = (2, (100, 90, 3)), 64   # at tasks of 64 cells both
                                               # wide columns pass a task


def row_cut_cols(n, seed, device):
    d, sizes = ROW_CUT
    schema = FeatureSchema(num_cols=d, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    rng = np.random.default_rng(seed)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=device)
          for _ in range(d)]
    cs = [torch.tensor(rng.integers(-1, v + 1, n).astype(np.int32),
                       device=device) for v in sizes]
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=device)
    return schema, xs, cs, w


def _k7_on(plan, schema, xs, cs, w, device, off=None):
    """K7 (or, with group offsets `off`, K8) over a given whole plan."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        device_plan)

    lib, n, p = _build.load(), w.shape[0], schema.sigma_size
    dp = device_plan(plan, device)
    groups = 1 if off is None else off.shape[0] - 1
    slices = plan.slices(n)
    partial = torch.empty(dp.cells * (slices + groups - 1),
                          dtype=torch.float64, device=device)
    out = torch.zeros((groups, p, p), device=device)
    cols = _build.column_args(xs, cs, schema.cat_sizes, device)
    args = (*(t.data_ptr() for t in dp.tensors),
            _build.int_array(dp.shape_ints(slices)), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if off is None:
        rc = lib.lib.dit_wide_gram(*cols, w.data_ptr(), n, p, *args)
    else:
        cum = _build.group_chunks(off, _build.WIDE_CHUNK)
        rc = lib.lib.dit_grouped_wide_gram(*cols, w.data_ptr(),
                                           off.data_ptr(), cum.data_ptr(),
                                           groups, n, p, *args)
    _build.raise_on_error(lib, rc, "row-cut plan")
    return out if off is not None else out[0]


@pytest.mark.parametrize("groups", [None, 3])
def test_k7_k8_on_row_cut_plans_match_plain(cuda, groups):
    """K7 (and K8 at G = 3, rows sorted by group) over the whole plan at
    tasks of 64 cells, whose C_01 is cut by row code into CB slabs,
    against the plan's plain arithmetic (`wide_tables_plain` +
    `wide_assemble`, each group's rows): counts exact, within 1e-5 of
    max|σ|, reruns bit-identical, S exactly symmetric."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        wide_assemble, wide_tables_plain)

    d, sizes = ROW_CUT
    plan = _build._wide_plan(d, sizes, True, False, ROW_CUT_CAP)
    assert _build.SLAB_CB in plan.slabs[:, 0].tolist()
    schema, xs, cs, w = row_cut_cols(100_003, seed=31, device=cuda)
    off = None
    bounds = [0, w.shape[0]]
    if groups:
        rng = np.random.default_rng(32)
        g = torch.tensor(rng.integers(0, groups, w.shape[0]).astype(
            np.int32), device=cuda)
        x_s, c_s, w, layout = sort_by_group(torch.stack(xs),
                                            torch.stack(cs), g,
                                            schema=schema, num_groups=groups,
                                            weights=w)
        xs, cs, off = list(x_s), list(c_s), layout.offsets
        bounds = off.tolist()
    got = _k7_on(plan, schema, xs, cs, w, cuda, off)
    again = _k7_on(plan, schema, xs, cs, w, cuda, off)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got = got if groups else got[None]
    cm = count_mask(schema, cuda)
    for gg in range(len(bounds) - 1):
        r = slice(bounds[gg], bounds[gg + 1])
        want = wide_assemble(wide_tables_plain(
            [x[r] for x in xs], [c[r] for c in cs], w[r], schema=schema,
            plan=plan), schema=schema, plan=plan)
        assert torch.equal(got[gg][cm], want[cm])
        assert torch.equal(got[gg], got[gg].T)
        torch.testing.assert_close(got[gg], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_keyed_windows_on_row_cut_plans_match_plain(cuda):
    """K7 over every window of 64 columns of the plans at tasks of 64
    cells, both wide columns keyed (their C_01 cut into CB slabs keyed on
    the wider column in every window), residual and keyed tasks over the
    columns' order: against masked_gram_window_plain, counts exact, within
    1e-5 of max|σ|; S assembled from the windows exactly symmetric."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        _launch_window, device_plan, masked_gram_window_plain,
        window_order)

    d, sizes = ROW_CUT
    schema, xs, cs, w = row_cut_cols(70_001, seed=33, device=cuda)
    p, n = schema.sigma_size, w.shape[0]
    order = window_order(xs, cs, w, schema=schema, columns=_build.
                         keyed_columns(d, sizes, ROW_CUT_CAP, 0))
    full = torch.zeros((p, p), device=cuda)
    kinds = set()
    for lo in range(0, p, 64):
        hi = min(lo + 64, p)
        residual, keyed = _build._keyed_window_plan(d, sizes, lo, hi,
                                                    ROW_CUT_CAP, 0)
        if keyed is not None:
            kinds.update(keyed.plan.slabs[:, 0].tolist())
        plans = (residual and device_plan(residual, cuda),
                 keyed and device_plan(keyed.plan, cuda, keyed))
        _launch_window(xs, cs, w, n, cuda, schema, lo, hi - lo,
                       full[:, lo:], _build.load(), "row-cut window", order,
                       plans)
    torch.cuda.synchronize()
    assert _build.SLAB_CB in kinds
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=0, width=p)
    cm = count_mask(schema, cuda)
    assert torch.equal(full[cm], want[cm])
    assert torch.equal(full, full.T)
    torch.testing.assert_close(full, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_k3w_on_a_row_cut_plan_matches_plain(cuda):
    """K3w over the scorer's plan at tasks of 64 cells (C_01 cut into CB
    slabs: a row reads a CB cell only where its code lies in the slab's
    rows), seeded tables, 3 classes, 50,003 rows: argmax bit-equal to the
    plain version's."""
    from duckdb_imputation_tpu_torch.ring.kernels.qda_pallas import _pack

    d, sizes = ROW_CUT
    schema, xs, cs, _ = row_cut_cols(50_003, seed=34, device=cuda)
    p = schema.sigma_size
    plan = _build._wide_plan(d, sizes, True, True, ROW_CUT_CAP)
    assert _build.SLAB_CB in plan.slabs[:, 0].tolist()
    rng = np.random.default_rng(35)
    a = torch.tensor(rng.normal(size=(3, p, p)), device=cuda)
    tables = _pack(a, plan).float()
    x, codes = torch.stack(xs), torch.stack(cs)
    before = qda_predict_kernel.wide_launches
    got = qda_predict_kernel(tables, plan, x, codes, schema=schema)
    torch.cuda.synchronize()
    assert qda_predict_kernel.wide_launches == before + 1
    want = qda_predict_plain(tables, plan, x, codes, schema=schema)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) == 3


@pytest.mark.parametrize("cross", [True, False])
def test_k3w_wide_codes_at_zip5_match_plain(cuda, cross):
    """K3w at zip5 (4 numerics, a column of 33,791 levels beside one of
    5: codes staged as i32), QDA's plan and NB's, random f32 cells, 2
    classes, 100,003 rows with codes past 32,768 and out of range: argmax
    bit-equal to the plain version's."""
    schema = FeatureSchema(num_cols=4, cat_keys=(tuple(range(33791)),
                                                 tuple(range(5))))
    assert _build.qda_code_bytes(schema) == 4
    n = 100_003
    rng = np.random.default_rng(36)
    x = torch.tensor(rng.normal(size=(4, n)).astype(np.float32),
                     device=cuda)
    codes = torch.tensor(np.stack([rng.integers(-1, 33792, n),
                                   rng.integers(0, 5, n)]).astype(np.int32),
                         device=cuda)
    plan = _build.qda_plan(schema, cross)
    tables = torch.tensor(rng.normal(size=(2, int(plan.task_base[-1])))
                          .astype(np.float32), device=cuda)
    got = qda_predict_kernel(tables, plan, x, codes, schema=schema)
    want = qda_predict_plain(tables, plan, x, codes, schema=schema)
    assert torch.equal(got, want)
    assert set(torch.unique(got).tolist()) == {0, 1}


def test_criteo_pair_window_of_the_row_cut_table_matches_plain(cuda):
    """At the default budget, criteo_pair (13 numerics, C7's 12,517 and
    C15's 14,992 levels: P = 27,523): the window of 1,024 columns inside
    C15's one-hot block, whose C_{15,7} keyed on C15 is cut by row code
    into CB slabs, 200,003 Zipf rows, against masked_gram_window_plain:
    counts exact, within 1e-5 of max|σ|."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window, masked_gram_window_plain)

    sizes = (12517, 14992)
    schema = FeatureSchema(num_cols=13, cat_keys=tuple(
        tuple(range(v)) for v in sizes))
    lo = 14 + 12517 + 4096
    keyed = _build.keyed_window_plan(schema, lo, lo + 1024)[1]
    assert _build.SLAB_CB in keyed.plan.slabs[:, 0].tolist()
    n = 200_003
    rng = np.random.default_rng(37)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(13)]
    cs = []
    for v in sizes:
        share = 1.0 / np.arange(1, v + 1) ** 1.05
        cs.append(torch.tensor(rng.choice(v, n, p=share / share.sum())
                               .astype(np.int32), device=cuda))
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=cuda)
    got = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=1024)
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                    width=1024)
    cm = window_count_mask(schema, lo, 1024, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# Past the shared-memory column limits: K_j cut by column range (KB slabs)
# in K7/K8, K3/K3w's local plans, K2w's impute kernel with x read from
# device memory, and the order pass copying wide rows in pieces
# ---------------------------------------------------------------------------

# (numeric columns, levels of each categorical column) and rows
PAST_SMEM = {"d835_c3": ((835, (3,)), 20_000),
             "d900_r33": ((900, (33,)), 20_000),
             "d1100_c2": ((1100, (2,)), 20_000),
             "epsilon": ((2000, (2,)), 8_000),
             "d1000_v5000": ((1000, (5000,)), 30_000)}


def past_smem_inputs(name, cuda, seed=0):
    """A table of PAST_SMEM[name] (`cols_inputs`)."""
    (d, sizes), n = PAST_SMEM[name]
    return cols_inputs(d, sizes, n, cuda, seed)


@pytest.mark.parametrize("name", ["d835_c3", "d1100_c2", "epsilon",
                                  "d1000_v5000"])
def test_past_smem_gram_matches_plain(cuda, name):
    """K7 past 834 numeric columns beside a code column: its whole plan
    (P ≤ 1,024) and its windows (past it; at d1000_v5000 a keyed column
    whose order copies rows of 1,008 ints) with K_j as KB slabs: S = Sᵀ
    exactly, counts exact, a rerun bit-identical, within 1e-5 of
    max|σ|."""
    schema, xs, cs, w = past_smem_inputs(name, cuda)
    plans = ([_build.wide_plan(schema)]
             if schema.sigma_size <= _build.MAX_WIDE_SIGMA_SIZE else
             [pl for lo in range(0, schema.sigma_size, _build.WINDOW_WIDTH)
              for pl in _build.keyed_window_plan(
                  schema, lo, min(lo + _build.WINDOW_WIDTH,
                                  schema.sigma_size))
              if pl is not None])
    kinds = {k for pl in plans
             for k in getattr(pl, "plan", pl).slabs[:, 0].tolist()}
    assert _build.SLAB_KB in kinds and _build.SLAB_K not in kinds
    got = masked_gram_cols(xs, cs, w, schema=schema)
    again = masked_gram_cols(xs, cs, w, schema=schema)
    want = masked_gram_cols_plain(xs, cs, w, schema=schema)
    assert torch.equal(got, again)
    assert torch.equal(got, got.T)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["d835_c3", "d1100_c2"])
def test_past_smem_grouped_matches_plain(cuda, name):
    """K8 over KB slabs (its whole plan at P = 839, a launch a window at P
    = 1,103), 3 groups after sort_by_group: each group's S symmetric,
    counts exact, a rerun bit-identical, within 1e-5 of max|σ|."""
    schema, x, c, w = past_smem_inputs(name, cuda, seed=5)
    n = w.shape[0]
    g = torch.randint(-1, 4, (n,), dtype=torch.int32, device=cuda)
    xt, ct = torch.stack(x), torch.stack(c)
    got = grouped_gram(xt, ct, w, g, schema=schema, num_groups=3)
    again = grouped_gram(xt, ct, w, g, schema=schema, num_groups=3)
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(1, 2))
    want = grouped_gram_plain(xt, ct, w, g, schema=schema, num_groups=3)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[:, cm], want[:, cm])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("name,kind,col,r", [
    ("d900_r33", "cat", 0, 33), ("epsilon", "cat", 0, 2),
    ("epsilon", "num", 1999, 1)])
def test_past_smem_fused_matches_plain(cuda, name, kind, col, r):
    """K2w's impute kernel where a batch of 32 rows' x does not fit shared
    memory beside the class tile (W whole at P = 934, R = 33; W in device
    memory at P = 2,003): x read from device memory, codes equal to the
    plain version's; 'num' within 1e-6; sigma within 1e-5 of max|σ|; a
    rerun bit-identical."""
    schema, xs, cs, w = past_smem_inputs(name, cuda, seed=3)
    if name == "d900_r33":
        assert not _build.impute_x_terms(
            schema, *_build.impute_plan(schema, 33)[::2])
    n, p = w.shape[0], schema.sigma_size
    rng = np.random.default_rng(4)
    w_full = torch.tensor(rng.normal(size=(p, r)).astype(np.float32) * 0.1,
                          device=cuda)
    icpt = torch.tensor(rng.normal(size=r).astype(np.float32), device=cuda)
    null = torch.tensor(rng.random(n) < 0.2, device=cuda)
    args = (xs, cs, null, w, w_full, icpt)
    kw = dict(schema=schema, kind=kind, imp_col=col)
    new, sig = fused_impute_aggregate(*args, **kw)
    new2, sig2 = fused_impute_aggregate(*args, **kw)
    assert torch.equal(new, new2) and torch.equal(sig, sig2)
    assert torch.equal(sig, sig.T)
    want_new, want_sig = fused_impute_aggregate_plain(*args, **kw)
    if kind == "cat":
        assert torch.equal(new, want_new)
    else:
        torch.testing.assert_close(new, want_new, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sig, want_sig, rtol=0,
                               atol=1e-5 * float(want_sig.abs().max()))


@pytest.mark.parametrize("d,classes", [(784, 10), (2000, 2)])
def test_past_smem_qda_matches_plain(cuda, d, classes):
    """K3w on a local plan (MNIST's 784 pixels over 10 classes, Epsilon's
    2,000 columns over 2): a task's columns staged a step; QDA's and NB's
    predictions equal to the plain scorer's (run on the CPU: it adds a
    row's 2M cells one at a time), a rerun too."""
    schema = FeatureSchema(num_cols=d)
    assert _build.qda_plan(schema).local
    rng = np.random.default_rng(9)
    n = 512
    quad = rng.normal(size=(classes, d, d)) * 0.01
    quad = torch.tensor((quad + quad.transpose(0, 2, 1)) / 2, device=cuda)
    lin = torch.tensor(rng.normal(size=(classes, d)), device=cuda)
    tables, plan = qda_tables(quad, lin, torch.zeros(classes, device=cuda),
                              schema=schema)
    x = torch.tensor(rng.normal(size=(d, n)).astype(np.float32), device=cuda)
    ct = torch.zeros((0, n), dtype=torch.int32, device=cuda)
    got = qda_predict_kernel(tables, plan, x, ct, schema=schema)
    assert torch.equal(got, qda_predict_kernel(tables, plan, x, ct,
                                               schema=schema))
    assert torch.equal(got.cpu(), qda_predict_plain(
        tables.cpu(), plan, x.cpu(), ct.cpu(), schema=schema))
    mean = torch.tensor(rng.normal(size=(classes, d)), device=cuda)
    var = torch.tensor(rng.random((classes, d)) + 0.5, device=cuda)
    lp = torch.log(torch.full((classes,), 1.0 / classes, device=cuda))
    centre = mean.mean(0).float()
    nbt, nbp = nb_tables(lp, mean, var, torch.zeros((classes, 0),
                                                    device=cuda),
                         schema=schema, center=centre)
    assert nbp.local
    got = qda_predict_kernel(nbt, nbp, x, ct, schema=schema, shift=centre)
    assert torch.equal(got, qda_predict_plain(nbt, nbp, x, ct, schema=schema,
                                              shift=centre))


def test_past_smem_window_order_matches_plain(cuda):
    """The order pass at d1000_v5000 (rows of 1,008 ints beside 5,000
    counters: copied in pieces, `_build.order_piece`): the keys' offsets
    and the copies over every row with a key equal to the plain version's
    bit for bit."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        window_order)

    schema, xs, cs, w = past_smem_inputs("d1000_v5000", cuda, seed=11)
    stride = _build.order_stride(1 + schema.num_cols + schema.cat_cols)
    assert stride == 1008 and _build.order_piece(5000, stride) < stride
    got = window_order(xs, cs, w, schema=schema, columns=(0,))
    want = window_order([x.cpu() for x in xs], [c.cpu() for c in cs],
                        w.cpu(), schema=schema, columns=(0,))
    assert torch.equal(got.key_off.cpu(), want.key_off)
    last = int(want.key_off[-1])
    ncols = 1 + schema.num_cols + schema.cat_cols
    assert torch.equal(got.rows[0, :last, :ncols].cpu(),
                       want.rows[0, :last, :ncols])


# ---------------------------------------------------------------------------
# IEEE f32 whatever the caller set, and P past 46,340
# ---------------------------------------------------------------------------

def _tf32_runs(device) -> dict:
    """run_mice_device 'gram' and 'fused' (with noise) and the GD trainer
    at config 5, and run_mice_wide on a 1 × 1 grid at P = 1,505: their
    outputs on the card."""
    from duckdb_imputation_tpu_torch.models.device import linreg_train_device
    from duckdb_imputation_tpu_torch.parallel import (make_mesh_2d,
                                                      run_mice_wide)

    rng = np.random.default_rng(21)
    n = 50_000
    z0, z1 = rng.normal(size=n), rng.normal(size=n)
    x = np.stack([z0, 2 * z0 + z1, z1 - z0, rng.normal(size=n)],
                 1).astype(np.float32)
    c = np.stack([np.clip(z0 + 4.0, 0, 7).astype(int),
                  rng.integers(0, 8, n)], 1)
    nn = np.zeros((n, 4), bool)
    nn[:, 1] = rng.random(n) < 0.2
    cn = np.zeros((n, 2), bool)
    cn[:, 0] = rng.random(n) < 0.2
    t = from_numpy(x, c, nn, cn, device=device)
    out = {}
    for name, kw in (("gram", dict(kernel="gram", noise=True)),
                     ("fused", dict(kernel="fused", noise=True)),
                     ("gd", dict(kernel="gram", trainer="gd",
                                 gd_iters=200))):
        r = run_mice_device(t, iters=2, **kw)
        out[name] = (r.num_data, r.cat_codes)
    sigma = masked_gram_cols(list(t.num_data), list(t.cat_codes), None,
                             schema=t.schema)
    out["train"] = (linreg_train_device(sigma, label=2, max_iters=300),)
    cls = rng.integers(0, 3, size=20_000)
    num = np.stack([cls - 1.0 + 0.3 * rng.normal(size=20_000),
                    0.7 * (cls - 1.0) + 0.2 * rng.normal(size=20_000)]
                   ).astype(np.float32)
    codes = np.stack([cls, rng.integers(0, 1500, size=20_000)]
                     ).astype(np.int32)
    wide = FeatureSchema(num_cols=2, cat_keys=(tuple(range(3)),
                                               tuple(range(1500))))
    wn = np.zeros((2, 20_000), bool)
    wc = np.zeros((2, 20_000), bool)
    wn[1, rng.random(20_000) < 0.2] = True
    wc[0, rng.random(20_000) < 0.2] = True
    out["wide"] = run_mice_wide(
        *(torch.tensor(a, device=device) for a in (num, codes, wn, wc)),
        schema=wide, mesh=make_mesh_2d(1, 1, device=device), iters=2,
        ridge=1e-2, shrinkage=1e-2, cg_iters=500, tol=1e-9)
    return out


@pytest.mark.parametrize("way", ["set_float32_matmul_precision_high",
                                 "fp32_precision_tf32"])
def test_tf32_on_leaves_the_outputs_bit_identical(cuda, way):
    """With TF32 turned on by the caller (`torch.set_float32_matmul_
    precision("high")`, or `torch.backends.cuda.matmul.fp32_precision =
    "tf32"`), run_mice_device 'gram' and 'fused', the GD trainer and
    run_mice_wide give the default setting's outputs bit for bit (their
    f32 products run under `utils.precision.ieee_f32`), and the caller's
    setting reads back unchanged; a product outside the port does take
    TF32 there."""
    matmul = torch.backends.cuda.matmul
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(1000, 900, device=cuda, generator=g)
    b = torch.randn(900, 800, device=cuda, generator=g)
    ieee = a @ b
    default = _tf32_runs(cuda)
    try:
        if way == "fp32_precision_tf32":
            matmul.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("high")
        before = (matmul.fp32_precision,
                  torch.backends.mkldnn.matmul.fp32_precision)
        assert not torch.equal(a @ b, ieee)        # TF32 is on out here
        got = _tf32_runs(cuda)
        assert (matmul.fp32_precision,
                torch.backends.mkldnn.matmul.fp32_precision) == before
    finally:
        torch.set_float32_matmul_precision("highest")
    for name, arrays in default.items():
        for want, have in zip(arrays, got[name]):
            assert torch.equal(want, have), name


# criteo_c18 (chip_smoke.py's CRITEO_VOCABS): Criteo's Kaggle schema with
# C18, 13 numerics and 18 categorical columns, P = 47,412
CRITEO_C18 = (1460, 583, 305, 24, 12517, 633, 3, 5683, 3194, 27, 14992, 10,
              5652, 2173, 4, 18, 15, 105)


def test_criteo_c18_window_past_46340_matches_plain(cuda):
    """One window of criteo_c18 (P = 47,412, past the 46,340 of a P² int
    map), the one inside C18 (its tables keyed, a window order pass),
    through K7 at 100k rows against masked_gram_window_plain: one launch
    and one order pass a call, rerun bit-identical, counts exact, within
    1e-5 of max|σ|."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        masked_gram_window, masked_gram_window_plain, window_order)

    schema = FeatureSchema(num_cols=13, cat_keys=tuple(
        tuple(range(v)) for v in CRITEO_C18))
    p, n = schema.sigma_size, 100_000
    assert p == 47412
    rng = np.random.default_rng(47412)
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
          for _ in range(13)]
    cs = [torch.tensor(rng.integers(0, v, n).astype(np.int32), device=cuda)
          for v in CRITEO_C18]
    w = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=cuda)
    lo = (1 + 13 + schema.offsets[12]) // 1024 * 1024 + 1024
    launches, passes = masked_gram_window.launches, window_order.passes
    got = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=1024)
    torch.cuda.synchronize()
    assert masked_gram_window.launches == launches + 1
    assert window_order.passes == passes + 1
    again = masked_gram_window(xs, cs, w, schema=schema, lo=lo, width=1024)
    assert torch.equal(got, again)
    want = masked_gram_window_plain(xs, cs, w, schema=schema, lo=lo,
                                    width=1024)
    assert got.shape == (p, 1024) and bool(torch.isfinite(got).all())
    cm = window_count_mask(schema, lo, 1024, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# D on the tensor cores (csrc/dense_gram.cu): the dense block of [1 ‖ x]
# of K7, K8 and K2w past the crossover (_build.dense_route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,n", [(300, 20_003), (2000, 6_001)])
def test_dense_gram_matches_plain(cuda, d, n):
    """The D kernel alone over columns whose first rows are not on
    16-byte boundaries: within 1e-5 of max|σ| of its plain version (f64
    sums of the same products), D[0, 0] = Σw exactly (binary weights), S
    exactly symmetric, a rerun bit-identical, one launch a call; a window
    across tiles bit-identical to S's columns; three groups over
    group-sorted rows, each as its rows' S."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, dense_gram_plain)

    schema = FeatureSchema(num_cols=d)
    rng = np.random.default_rng(d)
    block = torch.tensor(rng.normal(size=(d, n + 1)).astype(np.float32),
                         device=cuda)
    xs = list(block[:, 1:])
    w = torch.tensor((rng.random(n) > 0.3).astype(np.float32), device=cuda)
    before = dense_gram.launches
    got = dense_gram(xs, w, schema=schema)
    again = dense_gram(xs, w, schema=schema)
    torch.cuda.synchronize()
    assert dense_gram.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, got.T)
    want = dense_gram_plain(xs, w, schema=schema)
    assert float(got[0, 0]) == float(want[0, 0]) == float(w.double().sum())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    lo, width = 100, d - 150
    win = dense_gram(xs, w, schema=schema, lo=lo, width=width)
    assert torch.equal(win, got[:, lo:lo + width])
    off = torch.tensor([0, n // 3, n // 3 + 17, n], device=cuda)
    gg = dense_gram(xs, w, schema=schema, offsets=off)
    gw = dense_gram_plain(xs, w, schema=schema, offsets=off)
    for k in range(3):
        assert torch.equal(gg[k], gg[k].T)
        assert float(gg[k, 0, 0]) == float(gw[k, 0, 0])
        torch.testing.assert_close(gg[k], gw[k], rtol=0,
                                   atol=1e-5 * float(gw[k].abs().max()))


def test_dense_gram_ignores_tf32(cuda):
    """With TF32 turned on by the caller the D kernel's output, and K7's
    past the crossover, are the default setting's bit for bit: its
    products are bf16 parts on the tensor cores, never TF32."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram)

    schema, xs, cs, w = cols_inputs(300, (5,), 20_003, cuda, seed=3)
    d_only = FeatureSchema(num_cols=300)
    want = (dense_gram(xs, w, schema=d_only),
            masked_gram_cols(xs, cs, w, schema=schema))
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [m.fp32_precision for m in backends]
    try:
        torch.set_float32_matmul_precision("high")
        backends[0].allow_tf32 = True
        got = (dense_gram(xs, w, schema=d_only),
               masked_gram_cols(xs, cs, w, schema=schema))
    finally:
        for m, value in zip(backends, saved):
            m.fp32_precision = value
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["home_credit", "secom"])
def test_dense_route_launches(cuda, name):
    """Past the crossover K7 launches where its plan has a task (Home
    Credit's K_j and C_jk) and not where D is all of S (SECOM), and the D
    kernel once a call: masked_gram_cols, K8 and K2w each against its
    plain version."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram)

    schema, xs, cs, w = many_cols_inputs(name, cuda, n=20_003)
    assert _build.dense_route(schema.num_cols)
    tasks = _build.wide_plan(schema).num_tasks
    assert (tasks > 0) == (name == "home_credit")
    k7, dg = masked_gram_cols.wide_launches, dense_gram.launches
    got = masked_gram_cols(xs, cs, w, schema=schema)
    torch.cuda.synchronize()
    assert masked_gram_cols.wide_launches - k7 == int(tasks > 0)
    assert dense_gram.launches - dg == 1
    want = masked_gram_cols_plain(xs, cs, w, schema=schema)
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    k8, dg = grouped_gram_presorted.wide_launches, dense_gram.launches
    g = torch.randint(0, 3, (w.shape[0],), dtype=torch.int32, device=cuda)
    sorted_ = sort_by_group(torch.stack(xs), torch.stack(cs) if cs else
                            torch.zeros((0, w.shape[0]), dtype=torch.int32,
                                        device=cuda), g, schema=schema,
                            num_groups=3, weights=w)
    got = grouped_gram_presorted(*sorted_, schema=schema)
    torch.cuda.synchronize()
    assert grouped_gram_presorted.wide_launches - k8 == int(tasks > 0)
    assert dense_gram.launches - dg == 1
    want = grouped_gram_presorted_plain(*sorted_, schema=schema)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    null = torch.rand(w.shape[0], device=cuda) < 0.2
    p = schema.sigma_size
    w_full = 0.05 * torch.randn(p, 1, device=cuda)
    icpt = torch.randn(1, device=cuda)
    k2w, dg = fused_impute_aggregate.wide_launches, dense_gram.launches
    args = (xs, cs, null, w, w_full, icpt)
    kw = dict(schema=schema, kind="num", imp_col=schema.num_cols - 1)
    new, sig = fused_impute_aggregate(*args, **kw)
    torch.cuda.synchronize()
    assert fused_impute_aggregate.wide_launches - k2w == 1
    assert dense_gram.launches - dg == 1
    wnew, wsig = fused_impute_aggregate_plain(*args, **kw)
    torch.testing.assert_close(new, wnew, rtol=0, atol=1e-5)
    torch.testing.assert_close(sig, wsig, rtol=0,
                               atol=1e-5 * float(wsig.abs().max()))


def test_dense_gram_small_n_and_many_groups(cuda):
    """The D kernel at 1, 2, 33 and 257 rows (copies past a column's ends
    taken 4 bytes at a time) against its plain version, D[0, 0] = n
    exactly; and over 70,000 groups of 2 rows (more groups than a grid
    dimension holds: the grid is one dimension), three groups against
    their rows' plain version."""
    from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
        dense_gram, dense_gram_plain)

    schema = FeatureSchema(num_cols=20)
    rng = np.random.default_rng(7)
    for n in (1, 2, 33, 257):
        block = torch.tensor(rng.normal(size=(20, n + 1)).astype(np.float32),
                             device=cuda)
        xs = list(block[:, 1:])
        w = torch.ones(n, device=cuda)
        got = dense_gram(xs, w, schema=schema)
        want = dense_gram_plain(xs, w, schema=schema)
        assert torch.equal(got, got.T)
        assert float(got[0, 0]) == float(n)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    groups, n = 70_000, 140_000
    x = torch.tensor(rng.normal(size=(20, n)).astype(np.float32),
                     device=cuda)
    w = torch.ones(n, device=cuda)
    off = torch.arange(0, n + 1, 2, device=cuda)
    got = dense_gram(list(x), w, schema=schema, offsets=off)
    for g in (0, 33_333, groups - 1):
        want = dense_gram_plain([r[2 * g:2 * g + 2] for r in x],
                                w[2 * g:2 * g + 2], schema=schema)
        assert float(got[g, 0, 0]) == 2.0
        torch.testing.assert_close(got[g], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
