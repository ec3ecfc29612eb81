"""The port's grouped aggregation: `grouped_gram` (K4) and
`grouped_gram_presorted` (K5) through their plain versions, and
`sum_to_triple_grouped` with every method, held against the JAX package's
grouped Pallas kernels (interpret mode, as tests/test_grouped_sorted.py
runs them) and its masked path. The kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py)."""
import contextlib
import types

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from duckdb_imputation_tpu import FeatureSchema as RefSchema
from duckdb_imputation_tpu.ring.kernels import sigma_pallas_grouped as ref_g
from duckdb_imputation_tpu.ring.sum import (
    _grouped_sigma,
    sum_to_triple_grouped as ref_sum_grouped,
)
from duckdb_imputation_tpu.ring.triple import sigma_from_triple as ref_sft

from duckdb_imputation_tpu_torch import FeatureSchema
from duckdb_imputation_tpu_torch.ring import sum as port_sum
from duckdb_imputation_tpu_torch.ring.kernels import _build
from duckdb_imputation_tpu_torch.ring.kernels import nb_pallas as port_nb
from duckdb_imputation_tpu_torch.ring.kernels import qda_pallas as port_qda
from duckdb_imputation_tpu_torch.ring.kernels import sigma_pallas as port_k1
from duckdb_imputation_tpu_torch.ring.kernels import (
    sigma_pallas_grouped as port_g,
)
from duckdb_imputation_tpu_torch.ring.triple import sigma_from_triple

torch.set_num_threads(2)

KEYS = (tuple(range(5)), tuple(range(5)))
SCHEMA = FeatureSchema(num_cols=3, cat_keys=KEYS)
REF_SCHEMA = RefSchema(num_cols=3, cat_keys=KEYS)


def _data(n=6000, seed=0, skew=False):
    """tests/test_grouped_sorted.py's fixture: 3 numeric columns, two
    categorical columns of 5, 7 groups (optionally one hot group)."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(3, n)).astype(np.float32)
    codes = rng.integers(0, 5, size=(2, n)).astype(np.int32)
    g = rng.integers(0, 7, size=n).astype(np.int32)
    if skew:
        g = np.where(np.arange(n) % 50 == 0, g, 2).astype(np.int32)
    return num, codes, g


def count_mask(schema):
    p, d = schema.sigma_size, schema.num_cols
    m = np.zeros((p, p), bool)
    m[0, 0] = True
    m[0, 1 + d:] = m[1 + d:, 0] = True
    m[1 + d:, 1 + d:] = True
    return m


def assert_sigmas_close(got, want, exact_counts=True, rtol=1e-5):
    """Counts exact; the rest within rtol of each group's max|σ|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    cm = count_mask(SCHEMA)
    for g in range(got.shape[0]):
        if exact_counts:
            np.testing.assert_array_equal(got[g][cm], want[g][cm])
        scale = max(float(np.abs(want[g]).max()), 1.0)
        np.testing.assert_allclose(got[g], want[g], rtol=0,
                                   atol=rtol * scale)


def t(a):
    return torch.tensor(a)


def test_grouped_gram_plain_matches_unsorted_f32_kernel():
    """The f32 unsorted Pallas kernel (general weights): out-of-range ids
    dropped, an empty group all zeros, non-binary weights."""
    rng = np.random.default_rng(9)
    num, codes, g = _data()
    g = np.where(g == 3, 99, g).astype(np.int32)        # group 3 empty
    g[:50] = -4
    w = rng.random(len(g)).astype(np.float32)
    got = port_g.grouped_gram(t(num), t(codes), t(w), t(g), schema=SCHEMA,
                              num_groups=7).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = ref_g.sum_to_triple_grouped_unsorted(
            num, codes, g, schema=REF_SCHEMA, num_groups=7, weights=w,
            fast=False, chunk_cols=512)
    # general weights: the "counts" are weighted sums, not exact integers
    assert_sigmas_close(got, ref_sft(ref), exact_counts=False)
    assert not got[3].any()
    masked = np.asarray(_grouped_sigma(num, codes, w, g, schema=REF_SCHEMA,
                                       num_groups=7, row_chunk=1 << 17))
    assert_sigmas_close(got, masked, exact_counts=False)


@pytest.mark.parametrize("n", [6000, 6001])
def test_grouped_gram_plain_matches_unsorted_fast3_kernel(n):
    """The v3 split-precision unsorted kernel (the JAX 'pallas' choice at
    small G, binary weights) on a skewed grouping and a ragged n: counts
    exact, the rest within the split-precision tolerance."""
    num, codes, g = _data(n=n, skew=True)
    got = port_g.grouped_gram(t(num), t(codes), None, t(g), schema=SCHEMA,
                              num_groups=7).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = ref_g.sum_to_triple_grouped_unsorted(
            num, codes, g, schema=REF_SCHEMA, num_groups=7, fast=True,
            chunk_cols=512)
    assert_sigmas_close(got, ref_sft(ref), rtol=1e-4)
    exact = np.asarray(_grouped_sigma(num, codes, np.ones(n, np.float32), g,
                                      schema=REF_SCHEMA, num_groups=7,
                                      row_chunk=1 << 17))
    assert_sigmas_close(got, exact)


def test_presorted_plain_matches_presorted_kernel():
    """sort_by_group + grouped_gram_presorted (plain) against the JAX
    sort_by_group + sum_to_triple_grouped_presorted (the v3 sorted-slab
    kernel): an empty group, out-of-range ids, binary weights, skew."""
    num, codes, g = _data(n=4000, skew=True)
    g = np.where(g == 5, 99, g).astype(np.int32)
    w = (np.arange(len(g)) % 3 != 0).astype(np.float32)
    x_s, c_s, w_s, layout = port_g.sort_by_group(
        t(num), t(codes), t(g), schema=SCHEMA, num_groups=7, weights=t(w))
    assert layout.offsets.tolist()[-1] == int((g < 7).sum())
    assert x_s.is_contiguous() and c_s.is_contiguous()
    got = port_g.grouped_gram_presorted(x_s, c_s, w_s, layout,
                                        schema=SCHEMA).numpy()
    with pltpu.force_tpu_interpret_mode():
        rx, rc, rw, rlayout = ref_g.sort_by_group(
            num, codes, g, schema=REF_SCHEMA, num_groups=7, weights=w,
            fast=True, chunk_cols=512)
        ref = ref_g.sum_to_triple_grouped_presorted(rx, rc, rw, rlayout,
                                                    schema=REF_SCHEMA)
    assert_sigmas_close(got, ref_sft(ref), rtol=1e-4)
    assert not got[5].any()
    masked = ref_sum_grouped(num, codes, g, schema=REF_SCHEMA, num_groups=7,
                             weights=w, method="masked")
    assert_sigmas_close(got, ref_sft(masked))


def test_presorted_reuse_with_new_weights():
    """Sort once, aggregate with other weights in sorted row order."""
    num, codes, g = _data(n=3000, seed=4)
    x_s, c_s, w_s, layout = port_g.sort_by_group(
        t(num), t(codes), t(g), schema=SCHEMA, num_groups=7)
    order = torch.sort(t(g).long(), stable=True).indices
    w2 = (np.arange(3000) % 2).astype(np.float32)
    got = port_g.sum_to_triple_grouped_presorted(
        x_s, c_s, t(w2)[order], layout, schema=SCHEMA)
    ref = ref_sum_grouped(num, codes, g, schema=REF_SCHEMA, num_groups=7,
                          weights=w2, method="masked")
    assert_sigmas_close(sigma_from_triple(got).numpy(), ref_sft(ref))


@pytest.mark.parametrize("method", ["auto", "masked", "sorted", "kernel"])
@pytest.mark.parametrize("num_groups", [7, 12])
def test_sum_to_triple_grouped_methods(method, num_groups):
    """Every method against JAX's masked path, on a ragged n with empty
    groups and out-of-range ids; 12 groups take K5's route under
    'kernel' (above K4's limit of 8)."""
    num, codes, g = _data(n=5003, seed=7)
    g = np.where(g == 1, num_groups + 3, g).astype(np.int32)
    w = (np.random.default_rng(8).random(5003) > 0.25).astype(np.float32)
    got = port_sum.sum_to_triple_grouped(
        t(num), t(codes), t(g), schema=SCHEMA, num_groups=num_groups,
        weights=t(w), method=method)
    ref = ref_sum_grouped(num, codes, g, schema=REF_SCHEMA,
                          num_groups=num_groups, weights=w, method="masked")
    assert got.n.shape == (num_groups,)
    assert_sigmas_close(sigma_from_triple(got).numpy(), ref_sft(ref))
    assert float(got.n[1]) == 0.0


def test_grouped_kernel_dispatch_and_limits():
    """K4 up to unsorted_group_limit, K5 above; the limits raise."""
    assert port_g.unsorted_group_limit(SCHEMA) == _build.MAX_UNSORTED_GROUPS
    with pytest.raises(ValueError):
        _build.check_groups(_build.MAX_UNSORTED_GROUPS + 1,
                            _build.MAX_UNSORTED_GROUPS)
    with pytest.raises(ValueError):
        _build.check_groups(0)
    _build.check_groups(1000)
    with pytest.raises(ValueError):
        port_sum.sum_to_triple_grouped(t(np.zeros((3, 4), np.float32)), None,
                                       t(np.zeros(4, np.int32)),
                                       schema=FeatureSchema(num_cols=3),
                                       num_groups=2, method="pallas")


# ---------------------------------------------------------------------------
# A CUDA tensor reaches the kernel or raises: no quiet fallback
# ---------------------------------------------------------------------------

class _FailingLib:
    """Stands for the kernel library: every launch returns CUDA error 719
    (cudaErrorLaunchFailure)."""
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name == "dit_gram_entries":
            return lambda p: 16 * ((p + 3) // 4) * ((p + 3) // 4 + 1) // 2
        if name == "dit_error_string":
            return lambda rc: b"unspecified launch failure"

        def launch(*args):
            self.calls.append(name)
            return 719
        return launch


def _wrapper_calls():
    """(wrapper, counter, call) for every kernel wrapper of the slice."""
    num, codes, g = _data(n=600)
    x, c, gt = t(num), t(codes), t(g)
    nb_schema = SCHEMA
    layout = port_g.GroupLayout(torch.tensor([0, 300, 600]), 2)
    tables, plan = port_qda.qda_tables(torch.zeros((3, 13, 13)),
                                       torch.zeros((3, 13)), torch.zeros(3),
                                       schema=SCHEMA)
    return [
        (port_k1.masked_gram, "dit_masked_gram",
         lambda: port_k1.masked_gram(x, c, None, schema=SCHEMA)),
        (port_k1.masked_gram_cols, "dit_masked_gram",
         lambda: port_k1.masked_gram_cols(list(x), list(c), None,
                                          schema=SCHEMA)),
        (port_g.grouped_gram, "dit_grouped_gram",
         lambda: port_g.grouped_gram(x, c, None, gt, schema=SCHEMA,
                                     num_groups=7)),
        (port_g.grouped_gram_presorted, "dit_presorted_gram",
         lambda: port_g.grouped_gram_presorted(x, c, torch.ones(600), layout,
                                               schema=SCHEMA)),
        (port_nb.nb_grouped_sums, "dit_nb_grouped_sums",
         lambda: port_nb.nb_grouped_sums(x, c, None, gt, schema=nb_schema,
                                         num_groups=7)),
        (port_qda.qda_predict_kernel, "dit_qda_predict",
         lambda: port_qda.qda_predict_kernel(tables, plan, x, c,
                                             schema=SCHEMA)),
    ]


@pytest.mark.parametrize("which", range(6))
def test_launch_failure_propagates(monkeypatch, which):
    """With the launch made to fail, each wrapper raises and counts no
    launch; it never falls back to its plain version. The device checks
    and the stream are stubbed so that the kernel route runs here."""
    lib = _FailingLib()
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "check_cuda",
                        lambda tensors, checks: torch.device("cpu"))
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    wrapper, entry, call = _wrapper_calls()[which]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="launch failure"):
        call()
    assert lib.calls == [entry]
    assert wrapper.launches == before


@pytest.mark.parametrize("which", range(6))
def test_build_failure_propagates(monkeypatch, which):
    """A kernel that does not build raises out of the wrapper."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "check_cuda",
                        lambda tensors, checks: torch.device("cpu"))
    monkeypatch.setattr(_build, "load", no_nvcc)
    wrapper, _, call = _wrapper_calls()[which]
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
