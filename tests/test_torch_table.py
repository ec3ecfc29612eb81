"""The torch port's Table, from_numpy/from_reference and init_fill, held
against the JAX package on the same numpy inputs."""
import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.mice.partition import init_fill as ref_init_fill
from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy

from duckdb_imputation_tpu_torch import FeatureSchema, from_numpy, \
    from_reference
from duckdb_imputation_tpu_torch.mice.partition import init_fill

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def raw():
    """Row-major host data: 3 numeric columns, 2 categorical columns with
    non-contiguous raw values, 15-20% nulls."""
    rng = np.random.default_rng(11)
    n = 3000
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.choice([3, 7, 11, 20], n),
                    rng.integers(0, 5, n)], 1).astype(np.int64)
    num_null = rng.random((n, 3)) < 0.2
    cat_null = rng.random((n, 2)) < 0.15
    return num, cat, num_null, cat_null


def _assert_same_table(t, ref):
    np.testing.assert_array_equal(t.num_data.numpy(), np.asarray(ref.num_data))
    np.testing.assert_array_equal(t.cat_codes.numpy(),
                                  np.asarray(ref.cat_codes))
    np.testing.assert_array_equal(t.num_null.numpy(), np.asarray(ref.num_null))
    np.testing.assert_array_equal(t.cat_null.numpy(), np.asarray(ref.cat_null))
    assert t.schema.cat_keys == ref.schema.cat_keys
    assert t.schema.offsets == ref.schema.offsets
    assert t.schema.sigma_size == ref.schema.sigma_size
    assert t.cat_codes.dtype == torch.int32
    assert t.num_data.dtype == torch.float32
    # the kernels take contiguous columns: rows of a contiguous [d, n]
    assert all(a.is_contiguous() for a in (t.num_data, t.cat_codes,
                                           t.num_null, t.cat_null))


def test_from_numpy_matches_reference(raw):
    t = from_numpy(*raw, device="cpu")
    _assert_same_table(t, ref_from_numpy(*raw))
    assert t.device == torch.device("cpu")
    assert t.n_rows == raw[0].shape[0]


def test_from_reference_carries_the_table(raw):
    ref = ref_from_numpy(*raw)
    t = from_reference(ref, device="cpu")
    _assert_same_table(t, ref)
    assert isinstance(t.schema, FeatureSchema)
    assert t.num_names == ref.num_names and t.cat_names == ref.cat_names


def test_from_numpy_masks_from_nan_and_negative():
    """Without explicit masks, NaN numerics and negative categories are
    the missing cells, as in the JAX package."""
    num = np.array([[1.0, np.nan], [2.0, 3.0], [np.nan, 4.0]], np.float32)
    cat = np.array([[5], [-1], [6]])
    t = from_numpy(num, cat, device="cpu")
    ref = ref_from_numpy(num, cat)
    _assert_same_table(t, ref)
    assert t.num_null.tolist() == [[False, False, True], [True, False, False]]
    assert t.cat_null.tolist() == [[False, True, False]]


def test_features_first_input_and_to_numpy(raw):
    num, cat, num_null, cat_null = raw
    t = from_numpy(num.T, cat.T, num_null.T, cat_null.T, rows_first=False,
                   device="cpu")
    got = t.to_numpy()
    want = ref_from_numpy(*raw)
    for a, b in zip(got, (want.num_data, want.cat_codes, want.num_null,
                          want.cat_null)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(t.cat_values(), want.cat_values())


def test_init_fill_matches_reference(raw):
    ref = ref_init_fill(ref_from_numpy(*raw))
    got = init_fill(from_numpy(*raw, device="cpu"))
    # means are accumulated in f64 on both sides and rounded to f32
    np.testing.assert_allclose(got.num_data.numpy(), np.asarray(ref.num_data),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(ref.cat_codes))
    num_null = raw[2].T
    for j in range(3):
        vals = got.num_data[j].numpy()[num_null[j]]
        assert np.all(vals == vals[0])            # one mean per column
        obs = raw[0][~raw[2][:, j], j].astype(np.float64)
        assert abs(vals[0] - obs.mean()) <= 1e-6


def test_init_fill_mode_tie_goes_to_lowest_code():
    """Codes 1 and 2 are both observed twice: the mode is the lower one,
    as np.argmax picks in the JAX package."""
    cat = np.array([[2], [1], [2], [1], [0], [-1], [-1]])
    num = np.zeros((7, 1), np.float32)
    got = init_fill(from_numpy(num, cat, device="cpu"))
    ref = ref_init_fill(ref_from_numpy(num, cat))
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(ref.cat_codes))
    assert got.cat_codes[0, 5:].tolist() == [1, 1]


def test_init_fill_leaves_observed_cells(raw):
    t = from_numpy(*raw, device="cpu")
    got = init_fill(t)
    obs = ~t.num_null
    assert torch.equal(got.num_data[obs], t.num_data[obs])
    assert torch.equal(got.cat_codes[~t.cat_null], t.cat_codes[~t.cat_null])


@pytest.mark.parametrize("entry", ["from_numpy", "from_reference",
                                   "triple_from_reference",
                                   "nb_agg_from_reference", "Triple.zeros",
                                   "NBAgg.zeros"])
def test_entry_points_default_to_the_card(raw, entry):
    """Asked for no device, the entry points put their tensors on CUDA:
    with a card they land there, without one the call raises. They never
    fall back to the CPU, whose plain versions a caller must ask for."""
    from types import SimpleNamespace

    from duckdb_imputation_tpu_torch.ring.triple import (
        NBAgg, Triple, nb_agg_from_reference, triple_from_reference)

    agg = SimpleNamespace(n=np.ones(2), lin=np.zeros((2, 3)),
                          quad=np.zeros((2, 3, 3)),
                          quad_diag=np.zeros((2, 3)),
                          lin_cat=np.zeros((2, 5)),
                          num_cat=np.zeros((2, 3, 5)),
                          cat_cat=np.zeros((2, 5, 5)))
    schema = FeatureSchema(num_cols=3, cat_keys=(tuple(range(5)),))
    call = {"from_numpy": lambda: from_numpy(*raw),
            "from_reference": lambda: from_reference(ref_from_numpy(*raw)),
            "triple_from_reference": lambda: triple_from_reference(agg),
            "nb_agg_from_reference": lambda: nb_agg_from_reference(agg),
            "Triple.zeros": lambda: Triple.zeros(schema, batch=(2,)),
            "NBAgg.zeros": lambda: NBAgg.zeros(schema),
            }[entry]
    if torch.cuda.is_available():
        out = call()
        device = out.device if entry.startswith("from_") else out.n.device
        assert device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
