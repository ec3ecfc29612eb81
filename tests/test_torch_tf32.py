"""The port's f32 products stay IEEE f32 whatever the caller set
(`utils.precision.ieee_f32`), on CPU tensors.

A caller turns reduced-precision f32 products on in one of several ways:
`torch.set_float32_matmul_precision("high")` (or "medium", which on a CPU
with bf16 units makes oneDNN's f32 products bf16), the legacy
`torch.backends.cuda.matmul.allow_tf32 = True`, the newer
`torch.backends.cuda.matmul.fp32_precision = "tf32"`, or the generic
`torch.backends.fp32_precision = "tf32"`. Under each, the MICE entry
points and loops (`run_mice_device` 'plain' and 'fused', with noise and
with the GD trainer, `mice_loop_device`, `linreg_train_device`,
`run_mice_wide` on a gloo group of one rank, the host drivers'
predictors) give outputs bit-identical to the default setting; every f32
matrix product they take runs with both backends' precision "ieee"
(recorded by a TorchFunctionMode); and the caller's setting reads back as
it was after each call, and after a call that raises inside the guard.
The JAX package pins Precision.HIGHEST on the same products; its outputs
are held against the port's by the other tests of these entry points."""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy
from duckdb_imputation_tpu_torch.mice import run_mice_baseline
from duckdb_imputation_tpu_torch.mice.device_round import (
    mice_loop_device, run_mice_device)
from duckdb_imputation_tpu_torch.mice.partition import init_fill
from duckdb_imputation_tpu_torch.models.device import (
    linreg_predict_device, linreg_train_device, lstsq_min_norm)
from duckdb_imputation_tpu_torch.parallel import make_mesh_2d, run_mice_wide
from duckdb_imputation_tpu_torch.ring.sum import lift
from duckdb_imputation_tpu_torch.utils import ieee_f32

MATMUL = torch.backends.cuda.matmul
ONEDNN = torch.backends.mkldnn.matmul

WAYS = {
    "set_float32_matmul_precision_high":
        lambda: torch.set_float32_matmul_precision("high"),
    "set_float32_matmul_precision_medium":
        lambda: torch.set_float32_matmul_precision("medium"),
    "allow_tf32": lambda: setattr(MATMUL, "allow_tf32", True),
    "fp32_precision": lambda: setattr(MATMUL, "fp32_precision", "tf32"),
    "generic_fp32_precision":
        lambda: setattr(torch.backends, "fp32_precision", "tf32"),
}

# the names under which a TorchFunctionMode sees an f32 matrix product
PRODUCTS = {"__matmul__", "__rmatmul__", "matmul", "mm", "bmm", "einsum",
            "mv", "dot", "addmm", "baddbmm", "addmv", "addbmm", "vdot",
            "inner", "tensordot", "linear"}


def _read(fn):
    try:
        return fn()
    except RuntimeError:     # torch refuses a legacy read after a mix
        return "raises"


def setting():
    """Every reading of the matmul precision a caller can make."""
    return dict(
        legacy=_read(torch.get_float32_matmul_precision),
        allow_tf32=_read(lambda: MATMUL.allow_tf32),
        cuda=MATMUL.fp32_precision, onednn=ONEDNN.fp32_precision,
        generic=torch.backends.fp32_precision)


def default_setting():
    torch.backends.fp32_precision = "none"
    torch.set_float32_matmul_precision("highest")
    MATMUL.fp32_precision = "none"
    ONEDNN.fp32_precision = "none"


@pytest.fixture(autouse=True)
def restore_default():
    default_setting()
    yield
    default_setting()


class Products(TorchFunctionMode):
    """Records, for each f32 matrix product, the precision of the two
    backends at the time it ran."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in PRODUCTS:
            flat = list(args) + list(kwargs.values())
            flat += [a for x in args if isinstance(x, (list, tuple))
                     for a in x]
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                   for t in flat):
                self.seen[(MATMUL.fp32_precision,
                           ONEDNN.fp32_precision)] += 1
        return func(*args, **kwargs)


def _table():
    """A config-5-shaped table (x1 = 2·x0 + x2 − x0, a class moved by x0)
    with 20% nulls in x1, x3 and the class, 600 rows."""
    rng = np.random.default_rng(0)
    n = 600
    z = rng.normal(size=(n, 2))
    num = np.stack([z[:, 0], 2 * z[:, 0] + z[:, 1], z[:, 1] - z[:, 0],
                    rng.normal(size=n)], 1).astype(np.float32)
    cat = np.stack([(z[:, 0] > 0) * 3 + 2, rng.integers(0, 5, n)], 1)
    nn = np.zeros_like(num, bool)
    cn = np.zeros_like(cat, bool)
    for j in (1, 3):
        nn[rng.choice(n, n // 5, False), j] = True
    cn[rng.choice(n, n // 5, False), 0] = True
    return num, cat, nn, cn


def _outputs(tmp_path) -> dict:
    """Each entry point's outputs on the CPU, as numpy arrays."""
    num, cat, nn, cn = _table()
    t = from_numpy(num, cat, nn, cn, device="cpu")
    out = {}
    for name, kw in (("plain", dict(kernel="plain", noise=True)),
                     ("fused", dict(kernel="fused", noise=True)),
                     ("gd", dict(kernel="plain", trainer="gd",
                                 gd_iters=60))):
        r = run_mice_device(t, iters=2, **kw)
        out[name] = (r.num_data.numpy(), r.cat_codes.numpy())
    f = init_fill(t)
    gen = torch.Generator().manual_seed(3)
    x, c = mice_loop_device(
        f.num_data, f.cat_codes, f.num_null, f.cat_null, gen,
        schema=t.schema, num_cols_to_impute=(1, 3), cat_cols_to_impute=(0,),
        iters=2, noise=True, trainer="gd", gd_iters=40)
    out["loop"] = (x.numpy(), c.numpy())
    sigma = lift(f.num_data, f.cat_codes, schema=t.schema)
    z = torch.cat([torch.ones(1, f.num_data.shape[1]), f.num_data])
    s = (z.double() @ z.double().T).float()     # the test's own: f64
    coeff = linreg_train_device(s, label=2, max_iters=80)
    out["train"] = (coeff.numpy(),
                    linreg_predict_device(coeff, z, 2).numpy(),
                    sigma.quad.numpy())
    base = run_mice_baseline(t, iters=1)
    out["baseline"] = (base.num_data.numpy(), base.cat_codes.numpy())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        xw, cw = run_mice_wide(
            f.num_data, f.cat_codes, f.num_null, f.cat_null,
            schema=t.schema, mesh=make_mesh_2d(1, 1, device="cpu"), iters=1,
            ridge=1e-2, shrinkage=1e-2, cg_iters=60)
    finally:
        dist.destroy_process_group()
    out["wide"] = (xw.numpy(), cw.numpy())
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    default_setting()
    return _outputs(tmp_path_factory.mktemp("default"))


@pytest.mark.parametrize("way", sorted(WAYS))
def test_entry_points_bit_identical_under_reduced_precision(way, reference,
                                                            tmp_path):
    """Under each way of turning reduced precision on, every entry point's
    outputs equal the default setting's bit for bit, every f32 product
    they take runs under IEEE f32, and the setting reads back unchanged."""
    WAYS[way]()
    before = setting()
    rec = Products()
    with rec:
        got = _outputs(tmp_path)
    assert setting() == before
    assert sum(rec.seen.values()) > 100
    assert set(rec.seen) == {("ieee", "ieee")}, rec.seen
    for name, arrays in reference.items():
        for a, b in zip(arrays, got[name]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("way", sorted(WAYS))
def test_setting_restored_after_a_call_that_raises(way):
    """A guarded function that raises inside the guard leaves the caller's
    setting as it was; so does the guard itself around a raising block,
    nested or not."""
    WAYS[way]()
    before = setting()
    with pytest.raises(ValueError):
        lstsq_min_norm(torch.zeros(3), torch.zeros(3))
    assert setting() == before
    with pytest.raises(IndexError):
        linreg_train_device(torch.eye(4), label=9)
    assert setting() == before
    with pytest.raises(KeyError):
        with ieee_f32():
            with ieee_f32():
                assert (MATMUL.fp32_precision, ONEDNN.fp32_precision) == (
                    "ieee", "ieee")
                raise KeyError("inside")
    assert setting() == before


def test_guard_as_decorator_and_default_unchanged():
    """Under the default setting the guard changes nothing a caller reads
    back, and as a decorator it guards each call anew."""
    before = setting()

    @ieee_f32()
    def inside():
        return MATMUL.fp32_precision, ONEDNN.fp32_precision

    assert inside() == inside() == ("ieee", "ieee")
    assert setting() == before
    schema = FeatureSchema(num_cols=2, cat_keys=((0, 1, 2),))
    x = torch.tensor([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]])
    codes = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    assert torch.equal(lift(x, codes, schema=schema).quad,
                       torch.einsum("ni,nj->nij", x.T, x.T))
