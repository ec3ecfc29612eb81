"""The port's kernels on a CUDA card: K1 (masked_gram_cols) and K2
(fused_impute_aggregate) against their plain versions, the checks their
wrappers make, and run_mice_device on a CUDA table against the plain loop
on the CPU. Every test here needs the card and skips without one.

This file imports neither jax nor sklearn, so it runs on a machine that
has only torch; tests/conftest.py imports jax, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice.device_round import run_mice_device
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels.sigma_fused import (
    fused_impute_aggregate,
    fused_impute_aggregate_plain,
)
from duckdb_imputation_tpu_torch.ring.kernels.sigma_pallas import (
    masked_gram_cols,
    masked_gram_cols_plain,
)

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


@pytest.mark.parametrize("keys", [((0, 1, 2),) * 3, (tuple(range(70)),)])
def test_masked_gram_cols_kernel_other_schemas(cuda, keys):
    """A narrow schema (P = 11) and one near the kernel's P limit (P = 75,
    one row group per tile)."""
    schema = FeatureSchema(num_cols=1, cat_keys=keys)
    rng = np.random.default_rng(2)
    n = 40_000
    xs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)]
    cs = [torch.tensor(rng.integers(0, len(k) + 1, n).astype(np.int32),
                       device=cuda) for k in keys]
    got = masked_gram_cols(xs, cs, None, schema=schema)
    want = masked_gram_cols_plain(xs, cs, None, schema=schema)
    cm = count_mask(schema, cuda)
    assert torch.equal(got[cm], want[cm])
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


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


def test_kernels_raise_on_inputs_they_do_not_take(cuda):
    xs, cs, w = make_cols(1000, seed=1, device=cuda)
    with pytest.raises(ValueError):       # mixed devices
        masked_gram_cols(xs, cs, w.cpu(), schema=SCHEMA)
    with pytest.raises(ValueError):       # wrong dtype
        masked_gram_cols([x.double() for x in xs], cs, None, schema=SCHEMA)
    with pytest.raises(ValueError):       # not contiguous
        masked_gram_cols([torch.stack([x, x], 1)[:, 0] for x in xs], cs,
                         None, schema=SCHEMA)
    wide = FeatureSchema(num_cols=4, cat_keys=(tuple(range(90)),))
    assert wide.sigma_size > _build.MAX_SIGMA_SIZE
    with pytest.raises(ValueError):       # sigma size above the kernel's
        masked_gram_cols(xs, cs[:1], None, schema=wide)
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
    ref = run_mice_device(from_numpy(x, c, nn, cn), iters=2, kernel="plain")
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
