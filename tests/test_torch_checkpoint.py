"""The port's checkpoints (`utils.checkpoint`): the npz layout shared with
the JAX package (a file either package writes loads in the other), the
host MICE drivers resumed through `MiceCheckpointer`, and the run
fingerprint: a resume against another run's file, or one that completed
more rounds than asked for, raises ValueError naming why."""
import dataclasses

import numpy as np
import pytest
import torch

from duckdb_imputation_tpu.table import from_numpy as ref_from_numpy
from duckdb_imputation_tpu.utils import load_table as ref_load_table
from duckdb_imputation_tpu.utils import save_table as ref_save_table

from duckdb_imputation_tpu_torch import from_numpy
from duckdb_imputation_tpu_torch.mice import (run_mice_baseline,
                                              run_mice_high, run_mice_low)
from duckdb_imputation_tpu_torch.utils import (MiceCheckpointer, load_table,
                                               load_table_arrays,
                                               run_fingerprint, save_table,
                                               table_checksum)

torch.set_num_threads(2)


def _arrays(n=200, seed=0):
    """tests/test_aux.py's table: 3 numeric columns, 20% nulls in the
    first, one categorical column of 4."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 4, size=(n, 1))
    nn = np.zeros_like(num, bool)
    nn[rng.choice(n, n // 5, False), 0] = True
    return num, cat, nn, np.zeros_like(cat, bool)


def _table(**kw):
    return from_numpy(*_arrays(**kw), device="cpu")


def assert_tables_equal(a, b):
    for f in ("num_data", "cat_codes", "num_null", "cat_null"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert tuple(a.schema.cat_keys) == tuple(b.schema.cat_keys)
    assert a.schema.num_cols == b.schema.num_cols
    assert tuple(a.num_names) == tuple(b.num_names)
    assert tuple(a.cat_names) == tuple(b.cat_names)


def test_table_round_trip(tmp_path):
    t = _table()
    path = str(tmp_path / "t.npz")
    save_table(path, t, extra={"completed_iters": 3},
               arrays={"sigma": torch.arange(6.0).reshape(2, 3)})
    got, extra, arrays = load_table_arrays(path, device="cpu")
    assert extra == {"completed_iters": 3}
    assert_tables_equal(got, t)
    np.testing.assert_array_equal(arrays["sigma"],
                                  np.arange(6.0).reshape(2, 3))
    assert got.num_data.dtype == torch.float32
    assert got.cat_codes.dtype == torch.int32
    assert not list(tmp_path.glob("*.tmp*"))     # moved into place


def test_category_labels_round_trip(tmp_path):
    t = dataclasses.replace(_table(), cat_labels=(("a", "b", "c", "d"),))
    save_table(str(tmp_path / "t.npz"), t)
    got, _ = load_table(str(tmp_path / "t.npz"), device="cpu")
    assert got.cat_labels == (("a", "b", "c", "d"),)


def test_jax_written_files_load_in_the_port(tmp_path):
    ref = ref_from_numpy(*_arrays())
    path = str(tmp_path / "jax.npz")
    ref_save_table(path, ref, extra={"completed_iters": 2})
    got, extra = load_table(path, device="cpu")
    assert extra == {"completed_iters": 2}
    assert_tables_equal(got, ref)


def test_port_written_files_load_in_jax(tmp_path):
    t = _table()
    path = str(tmp_path / "port.npz")
    save_table(path, t, extra={"completed_iters": 5})
    got, extra = ref_load_table(path)
    assert extra == {"completed_iters": 5}
    assert_tables_equal(got, t)


def test_load_defaults_to_the_card(tmp_path):
    """Like every entry point, load_table places the table on the card
    unless asked for the CPU (so here, without one, it raises)."""
    path = str(tmp_path / "t.npz")
    save_table(path, _table())
    if torch.cuda.is_available():
        assert load_table(path)[0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            load_table(path)


@pytest.mark.parametrize("driver", [run_mice_baseline, run_mice_low,
                                    run_mice_high])
def test_host_drivers_resume_through_the_checkpointer(tmp_path, driver):
    """Kill a host driver after round 1, resume from its checkpoint, and
    land on the uninterrupted run's table (noise off): test_aux.py's
    case, to its tolerance."""
    kw = dict(linreg_iters=200, noise=False)
    full = driver(_table(), iters=3, **kw)
    t = _table()
    ck = MiceCheckpointer(str(tmp_path / "mice.npz"),
                          fingerprint=run_fingerprint(t, n_rows=t.n_rows,
                                                      driver="host"))

    class Stop(Exception):
        pass

    def stop_after_1(table, it):
        ck(table, it)
        if it == 0:
            raise Stop

    with pytest.raises(Stop):
        driver(t, iters=3, on_iteration=stop_after_1, **kw)
    resumed, done = ck.resume(iters=3, device="cpu")
    assert done == 1
    out = driver(resumed, iters=3, start_iter=done, **kw)
    np.testing.assert_allclose(out.num_data.numpy(), full.num_data.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_resume_refuses_another_run(tmp_path):
    """A checkpointer whose fingerprint differs from the file's raises
    ValueError naming the field; one without a fingerprint, or a file
    without one, is the JAX package's behaviour or refused."""
    t = _table()
    fp = run_fingerprint(t, n_rows=t.n_rows, seed=1, noise=True)
    path = str(tmp_path / "mice.npz")
    MiceCheckpointer(path, fingerprint=fp)(t, 1)
    assert MiceCheckpointer(path, fp).resume(device="cpu")[1] == 2
    other = dict(fp, seed=2)
    with pytest.raises(ValueError, match="field 'seed' is 1 in the file"):
        MiceCheckpointer(path, other).resume(device="cpu")
    changed = _table(seed=1)
    with pytest.raises(ValueError, match="field 'checksum'"):
        MiceCheckpointer(path, run_fingerprint(
            changed, n_rows=t.n_rows, seed=1, noise=True)).resume(
                device="cpu")
    assert MiceCheckpointer(path).resume(device="cpu")[1] == 2
    MiceCheckpointer(path)(t, 0)
    with pytest.raises(ValueError, match="no run fingerprint"):
        MiceCheckpointer(path, fp).resume(device="cpu")


def test_resume_refuses_more_rounds_than_asked(tmp_path):
    t = _table()
    ck = MiceCheckpointer(str(tmp_path / "mice.npz"))
    ck(t, 3)
    assert ck.resume(iters=4, device="cpu")[1] == 4
    with pytest.raises(ValueError, match="completed 4 rounds, more than "
                                         "the 3 asked for"):
        ck.resume(iters=3, device="cpu")


def test_fingerprint_fields():
    """The fingerprint holds the schema, the global row count, the
    checksum, the world size and the settings, as JSON values; the
    checksum ignores what lies under a null and sees every observed
    value."""
    t = _table()
    fp = run_fingerprint(t, n_rows=1000, world_size=2, seed=3,
                         trainer="solve", kernel="gram", lda_shrinkage=0.001,
                         gd_iters=500, noise=False, num_null_cols=(0,))
    assert fp["n_rows"] == 1000 and fp["world_size"] == 2
    assert fp["num_cols"] == 3 and fp["cat_keys"] == [[0, 1, 2, 3]]
    assert fp["num_null_cols"] == [0]
    assert fp["checksum"] == table_checksum(t)
    under = t.num_data.clone()
    under[t.num_null] = 123.0
    assert table_checksum(dataclasses.replace(t, num_data=under)) == \
        fp["checksum"]
    seen = t.num_data.clone()
    seen[1, 0] = -seen[1, 0] + 1.0
    assert table_checksum(dataclasses.replace(t, num_data=seen)) != \
        fp["checksum"]
