"""The port's SQL front end (`duckdb_imputation_tpu_torch.sql`) against the
JAX package's (`duckdb_imputation_tpu.sql`), device="cpu": every statement
of tests/test_sql.py and tests/test_sql_partition.py through both
connections, the sqlite differential fuzz of tests/test_sql_differential.py
(its generators imported) against the port, the vectorised GROUP BY key
pass against the JAX module's tuple loop, the device carried through every
call, and the `to_table` handoff into MICE.

Tolerances: relational rows are equal (both evaluators are the same numpy
code); in triple / NB dicts N and the count sections (lin_cat, quad_cat)
are equal and the sums within rtol 1e-6; model parameter vectors within
rtol 1e-6 (the host trainers are f64 in both packages); predicted labels
equal; regression predictions within rtol 1e-5, atol 1e-5 (tests/test_sql.py
holds the SQL path against the api at rtol 1e-5); linreg_predict with noise
by its moments (ROADMAP: the PRNG streams differ); MICE through the
handoff within atol 1e-4 (tests/test_torch_host_mice.py's bound).
"""
import math
import random
import sqlite3

import numpy as np
import pytest
import torch

from duckdb_imputation_tpu import api as ref_api
from duckdb_imputation_tpu import sql as ref_sql

from duckdb_imputation_tpu_torch import api, sql
from duckdb_imputation_tpu_torch.ring import serialize

import test_sql_differential as diff

torch.set_num_threads(2)

STRUCT = ("::STRUCT(N int, lin_agg FLOAT[], quad_agg FLOAT[], "
          "lin_cat STRUCT(key INT, value FLOAT)[][], "
          "quad_num_cat STRUCT(key INT, value FLOAT)[][], "
          "quad_cat STRUCT(key1 INT, key2 INT, value FLOAT)[][])")
NB_STRUCT = ("::STRUCT(N int, lin_agg FLOAT[], quad_agg FLOAT[], "
             "lin_cat STRUCT(key INT, value FLOAT)[][])")
EXACT_KEYS = ("N", "lin_cat", "quad_cat", "key", "key1", "key2")


def port_connect():
    return sql.connect(device="cpu")


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _same(got, want, where, *, exact: bool, rtol: float, atol: float = 0.0):
    """got equals want: dicts key by key (N and the counts exact, the rest
    within rtol), lists and tuples item by item, floats exactly where
    `exact` else within rtol/atol, everything else by ==."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}",
                  exact=exact or k in EXACT_KEYS, rtol=rtol, atol=atol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want), (
            where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]", exact=exact, rtol=rtol, atol=atol)
    elif isinstance(want, float) and not exact:
        assert isinstance(got, float) and math.isclose(
            got, want, rel_tol=rtol, abs_tol=atol), (where, got, want)
    else:
        assert type(got) is type(want) and (
            got == want or (isinstance(want, float) and math.isnan(want)
                            and math.isnan(got))), (where, got, want)


def same_rows(got, want, where, predictions: bool = False):
    """Rows of one statement: relational values equal, dicts and lists
    (triples, parameter vectors) at the dict and parameter tolerances;
    with `predictions`, float row values within rtol 1e-5, atol 1e-5."""
    assert len(got) == len(want), (where, got, want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, tuple) and len(g) == len(w), (where, g, w)
        for i, (gv, wv) in enumerate(zip(g, w)):
            if isinstance(wv, (dict, list)):
                _same(gv, wv, f"{where} row {r} col {i}", exact=False,
                      rtol=1e-6)
            elif predictions and isinstance(wv, float):
                _same(gv, wv, f"{where} row {r} col {i}", exact=False,
                      rtol=1e-5, atol=1e-5)
            else:
                _same(gv, wv, f"{where} row {r} col {i}", exact=True,
                      rtol=0.0)


class Recorder:
    """Runs statements on one connection, keeping every statement's rows
    (or the name of the error it raised) and every table it names."""

    def __init__(self, con):
        self.con = con
        self.out = []

    def __call__(self, q):
        try:
            rows = self.con.execute(q).fetchall()
        except Exception as e:           # the error's type is compared
            self.out.append((q, type(e).__name__))
            return None
        self.out.append((q, rows))
        return rows

    def table(self, name):
        rel = self.con.tables[name]
        self.out.append((f"table {name} columns", list(rel.names)))
        return self(f"SELECT * FROM {name}")


# ---------------------------------------------------------------------------
# the statements of tests/test_sql.py, one flow a test
# ---------------------------------------------------------------------------

def setup_test(run):
    run("CREATE TABLE test(gb INTEGER, a FLOAT, b FLOAT, c FLOAT, "
        "d INTEGER, e INTEGER, f INTEGER);")
    run("INSERT INTO test VALUES (1,1,2,3,4,5,6), (1,5,6,7,8,9,10), "
        "(2,2,1,3,4,6,8), (2,5,7,6,8,10,12), (2,2,1,3,4,6,8)")


def flow_sum_no_lift_everything(run):
    setup_test(run)
    run("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test")


def flow_sum_no_lift_group_by(run):
    setup_test(run)
    run("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test GROUP BY gb")


def flow_sum_no_lift_having(run):
    setup_test(run)
    run("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test "
        "GROUP BY gb HAVING gb = 2")


def flow_sum_equals_lift_then_sum(run):
    setup_test(run)
    a = run("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test GROUP BY gb")
    b = run("SELECT sum_triple(to_cofactor(a,b,c,d,e,f)) "
            "from test GROUP BY gb")
    assert a == b


def flow_sum_where(run):
    setup_test(run)
    run("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test where gb = 2")


def flow_lift_rows(run):
    setup_test(run)
    run("SELECT to_cofactor(a,b,c,d,e,f) from test")


def flow_multiply_join(run):
    setup_test(run)
    run("SELECT multiply_triple(A, B) FROM ("
        "(SELECT sum_to_triple_2_2(b,c,d,e) AS A FROM test where gb = 1) "
        "INNER JOIN "
        "(SELECT sum_to_triple_2_2(a,c,d,f) AS B FROM test where gb = 2) "
        "ON TRUE)")


def flow_nb_sum(run):
    setup_test(run)
    run("SELECT sum_to_nb_agg_3_3(a,b,c,d,e,f) from test")
    run("SELECT sum_to_nb_agg_3_3(a,b,c,d,e,f) from test GROUP BY gb")


def flow_nb_lift_sum_identity(run):
    setup_test(run)
    run("SELECT sum_nb_agg(to_nb_agg(a,b,c,d,e,f)) from test")


def flow_nb_multiply_join(run):
    setup_test(run)
    run("SELECT multiply_nb_agg(A, B) FROM ("
        "(SELECT sum_to_nb_agg_2_2(b,c,d,e) AS A FROM test where gb = 1) "
        "INNER JOIN "
        "(SELECT sum_to_nb_agg_2_2(a,c,d,f) AS B FROM test where gb = 2) "
        "ON TRUE)")


def flow_scalar_queries(run):
    setup_test(run)
    run("SELECT COUNT(*) FROM test")
    run("SELECT AVG(a) FROM test")
    run("SELECT MODE(d) FROM test")
    run("SELECT DISTINCT d FROM test ORDER BY d")


def flow_where_order_limit(run):
    setup_test(run)
    run("SELECT a, b FROM test WHERE gb = 2 ORDER BY a DESC LIMIT 2")


def flow_nulls_and_case(run):
    setup_test(run)
    run("CREATE TABLE t(x FLOAT, y FLOAT)")
    run("INSERT INTO t VALUES (1, 10), (NULL, 20), (3, NULL)")
    run("SELECT CASE WHEN x IS NULL THEN -1 ELSE x END, COALESCE(y, 0) "
        "FROM t")
    run("SELECT COUNT(x) FROM t")
    run("SELECT x FROM t WHERE x IS NOT NULL")


def flow_list_position_extract(run):
    setup_test(run)
    run("SELECT list_position([4, 8], d), "
        "list_extract([0.5, 0.25], list_position([4, 8], d)) FROM test")


def flow_linreg_struct_literal_round_trip(run):
    setup_test(run)
    triple = run("SELECT sum_to_triple_3_0(a,b,c) FROM test")[0][0]
    params = run(f"select linreg_train({triple!r}{STRUCT}, 0, "
                 "0.001::FLOAT, 0::FLOAT, 10000::INTEGER, false, false)"
                 )[0][0]
    run(f"SELECT linreg_predict({params!r}::FLOAT[], false, false, b, c) "
        "FROM test")


def flow_qda_list_aggregate(run):
    setup_test(run)
    triples, labels = run(
        "SELECT list(agg), list(gb) FROM (SELECT sum_to_triple_3_0(a,b,c) "
        "as agg, gb from test group by gb)")[0]
    params = run(f"select qda_train({triples!r}{STRUCT}[], "
                 f"{labels}::int[], false)")[0][0]
    run(f"SELECT qda_predict({params!r}::float[], false, a, b, c) "
        "FROM test")


def flow_nb_list_aggregate(run):
    setup_test(run)
    aggs, labels = run(
        "SELECT list(agg), list(gb) FROM (SELECT sum_to_nb_agg_3_0(a,b,c) "
        "as agg, gb from test group by gb)")[0]
    params = run(f"select nb_train({aggs!r}{NB_STRUCT}[], "
                 f"{labels}::int[])")[0][0]
    run(f"SELECT nb_predict({params!r}::float[], false, a, b, c) FROM test")


def mice_driver_data():
    """tests/test_sql.py::test_mice_driver_sql_sequence's table: a = 2b − c
    + 0.5 with 25% of a missing."""
    rng = np.random.default_rng(0)
    n = 400
    b = rng.normal(size=n).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    a_true = (2.0 * b - c + 0.5).astype(np.float32)
    missing = rng.random(n) < 0.25
    a = a_true.copy()
    a[missing] = np.nan
    return a, b, c, a_true, missing


def flow_mice_driver_sql_sequence(run):
    a, b, c, _, _ = mice_driver_data()
    run.con.register("raw", {"a": a, "b": b, "c": c})
    mean_a = run("SELECT AVG(a) FROM raw")[0][0]
    run(f"CREATE TABLE t_complete AS SELECT COALESCE(a, {mean_a}) AS a, "
        "b, c, a IS NULL AS a_is_null FROM raw")
    triple = run("SELECT sum_to_triple_3_0(a, b, c) FROM t_complete "
                 "WHERE a_is_null IS FALSE")[0][0]
    params = run(f"select linreg_train({triple!r}{STRUCT}, 0, 0.001::FLOAT, "
                 "0::FLOAT, 10000::INTEGER, false, false)")[0][0]
    run(f"CREATE TABLE rep AS SELECT CASE WHEN a_is_null THEN "
        f"linreg_predict({params!r}::FLOAT[], false, false, b, c) "
        "ELSE a END AS test FROM t_complete")
    run("ALTER TABLE t_complete ALTER COLUMN a SET DEFAULT 10;")
    assert "rep" not in run.con.tables
    run.table("t_complete")


def setup_fj(run, t1="test1", t2="test2"):
    run(f"CREATE TABLE {t1}(gb INTEGER, b FLOAT, c FLOAT, d INTEGER, "
        "e INTEGER)")
    run(f"INSERT INTO {t1} VALUES (1,2,3,4,5), (1,6,7,8,9), (2,1,3,4,6)")
    run(f"CREATE TABLE {t2}(gb INTEGER, a FLOAT, c FLOAT, d INTEGER, "
        "f INTEGER)")
    run(f"INSERT INTO {t2} VALUES (1,2,3,4,6), (2,5,6,8,12), (2,2,3,4,8)")


FJ_QUERY = ("select sum_triple(multiply_triple(A,B)) FROM "
            "(SELECT gb as gb, sum_to_triple_2_2(b,c,d,e) AS A "
            "FROM {t1} GROUP BY gb) as a "
            "INNER JOIN "
            "(SELECT gb as gb, sum_to_triple_2_2(a,c,d,f) AS B "
            "FROM {t2} GROUP BY gb) as b "
            "on a.gb = b.gb")


def flow_readme_factorized_join_query(run):
    setup_test(run)
    setup_fj(run)
    run(FJ_QUERY.format(t1="test1", t2="test2"))


def flow_order_by_group_key_not_in_select(run):
    setup_test(run)
    run("SELECT AVG(a) FROM test GROUP BY gb ORDER BY gb DESC")
    run("SELECT COUNT(*) FROM test GROUP BY gb ORDER BY gb")


def flow_order_by_hidden_column_after_distinct(run):
    setup_test(run)
    run("SELECT DISTINCT gb FROM test ORDER BY gb DESC")


def flow_order_by_string_desc(run):
    run("CREATE TABLE s(v VARCHAR)")
    run("INSERT INTO s VALUES ('a'), ('c'), ('b')")
    run("SELECT v FROM s ORDER BY v DESC")


def flow_grid_suffix_casts_arguments(run):
    setup_test(run)
    run("SELECT sum_to_triple_6_0(a,b,c,d,e,f) FROM test")
    run("SELECT sum_to_triple_2_2(a,b,c) FROM test")      # SQLError


def flow_modulo_sign(run):
    run("CREATE TABLE m(x INTEGER)")
    run("INSERT INTO m VALUES (-7), (7)")
    run("SELECT x % 3 FROM m")


def flow_factorized_join_equals_materialized_join(run):
    setup_test(run)
    setup_fj(run, "fj1", "fj2")
    fz = run(FJ_QUERY.format(t1="fj1", t2="fj2"))
    mat = run("SELECT sum_to_triple_4_4(t1.b, t1.c, t2.a, t2.c, "
              "t1.d, t1.e, t2.d, t2.f) FROM fj1 t1 "
              "INNER JOIN fj2 t2 ON t1.gb = t2.gb")
    assert fz == mat


def flow_order_by_nulls_last(run):
    run("CREATE TABLE o(x FLOAT, y INTEGER)")
    run("INSERT INTO o VALUES (2.5, NULL), (NULL, -1), (1.5, 2), "
        "(NULL, 0), (-0.5, 1)")
    run("SELECT x FROM o ORDER BY x")
    run("SELECT x FROM o ORDER BY x DESC")
    run("SELECT y FROM o ORDER BY y")
    run("SELECT y FROM o ORDER BY y DESC")
    run("SELECT y, x FROM o ORDER BY x, y DESC")


def flow_update_basic_and_3vl(run):
    run("CREATE TABLE u(a FLOAT, b FLOAT, g INTEGER)")
    run("INSERT INTO u VALUES (1, 10, 1), (2, 20, 2), (NULL, 30, 3), "
        "(4, NULL, 4)")
    run("UPDATE u SET b = b + 1 WHERE a > 1")
    run("SELECT b FROM u")
    run("UPDATE u SET a = b, b = a WHERE g = 2")
    run("SELECT a, b FROM u WHERE g = 2")
    run("UPDATE u SET a = NULL")
    run("SELECT a FROM u")


def flow_update_categorical_and_case(run):
    run("CREATE TABLE u(x INTEGER, y FLOAT)")
    run("INSERT INTO u VALUES (1, 0.5), (2, 1.5), (3, 2.5)")
    run("UPDATE u SET x = CASE WHEN y > 1 THEN x * 10 ELSE x END")
    run("SELECT x FROM u")


def flow_delete_3vl_and_all(run):
    run("CREATE TABLE d(a FLOAT)")
    run("INSERT INTO d VALUES (1), (2), (NULL), (4)")
    run("DELETE FROM d WHERE a > 1")
    run("SELECT a FROM d")
    run("DELETE FROM d")
    run("SELECT COUNT(*) FROM d")


def flow_update_delete_feed_aggregation(run):
    run("CREATE TABLE t(a FLOAT, b FLOAT, d INTEGER)")
    run("INSERT INTO t VALUES (1, 2, 1), (3, 4, 2), (5, 6, 1)")
    run("DELETE FROM t WHERE d = 2")
    run("UPDATE t SET a = a * 2")
    run("SELECT sum_to_triple_2_1(a, b, d) FROM t")


# ---------------------------------------------------------------------------
# the statements of tests/test_sql_partition.py
# ---------------------------------------------------------------------------

def setup_partition(run):
    run("CREATE TABLE t(a FLOAT, b FLOAT, d INTEGER, e INTEGER)")
    run("INSERT INTO t VALUES "
        "(1, 2, 4, 1), (2, NULL, 8, 1), (3, 6, NULL, 2), (4, 8, 4, 2), "
        "(5, NULL, NULL, 1), (6, 12, 8, 2), (7, 14, 4, 1), (8, 16, 8, 2)")


def flow_avg_mode_fill_values(run):
    setup_partition(run)
    run("SELECT AVG(b), MODE(d) FROM t LIMIT 10000")


def flow_init_baseline_statement_sequence(run):
    setup_partition(run)
    avg_b, mode_d = run("SELECT AVG(b), MODE(d) FROM t LIMIT 10000")[0]
    run("CREATE TABLE t_complete AS SELECT * FROM t")
    run("CREATE TABLE rep AS SELECT b IS NULL FROM t")
    run("ALTER TABLE t_complete ADD COLUMN b_IS_NULL BOOLEAN DEFAULT false;")
    run("ALTER TABLE t_complete ALTER COLUMN b_IS_NULL SET DEFAULT 10;")
    run(f"CREATE TABLE rep AS SELECT COALESCE(b , {avg_b}) FROM t")
    run("ALTER TABLE t_complete ALTER COLUMN b SET DEFAULT 10;")
    run("CREATE TABLE rep AS SELECT d IS NULL FROM t")
    run("ALTER TABLE t_complete ADD COLUMN d_IS_NULL BOOLEAN DEFAULT false;")
    run("ALTER TABLE t_complete ALTER COLUMN d_IS_NULL SET DEFAULT 10;")
    run(f"CREATE TABLE rep AS SELECT COALESCE(d , {int(mode_d)}) FROM t")
    run("ALTER TABLE t_complete ALTER COLUMN d SET DEFAULT 10;")
    run("SELECT a, b, d, b_IS_NULL, d_IS_NULL FROM t_complete ORDER BY a")
    run("SELECT COUNT(*) FROM t_complete WHERE b IS NULL OR d IS NULL")
    run("SELECT sum_to_triple_2_1(a, b, d) FROM t_complete "
        "WHERE b_IS_NULL IS FALSE")
    run.table("t_complete")


def flow_partition_n_nulls_flow(run):
    setup_partition(run)
    run("CREATE TABLE t_tmp AS SELECT a::FLOAT AS a , b::FLOAT AS b , "
        "d::INTEGER AS d , e::INTEGER AS e , "
        "CASE WHEN b IS NULL THEN 1 ELSE 0 END + "
        "CASE WHEN d IS NULL THEN 1 ELSE 0 END::INTEGER AS n_nulls "
        "FROM t ORDER BY n_nulls")
    run("SELECT n_nulls, COUNT(*) FROM t_tmp GROUP BY n_nulls "
        "ORDER BY n_nulls")
    run("CREATE TABLE t_complete_0 AS SELECT a, b, d, e FROM t_tmp "
        "WHERE n_nulls = 0")
    avg_b = run("SELECT AVG(b) FROM t")[0][0]
    run(f"CREATE TABLE t_complete_b AS SELECT a, COALESCE(b, {avg_b}) AS b,"
        " d, e FROM t_tmp WHERE n_nulls = 1 AND b IS NULL")
    run("CREATE TABLE t_complete_2 AS SELECT a, b, d, e FROM t_tmp "
        "WHERE n_nulls >= 2 AND n_nulls < 2 + 1")
    for name in ("t_complete_0", "t_complete_b", "t_complete_2"):
        run(f"SELECT COUNT(*) FROM {name}")
    run("SELECT a, b FROM t_complete_b")
    run.table("t_tmp")
    run("DROP TABLE t_tmp")
    run("DROP TABLE IF EXISTS t_complete_0")
    run("DROP TABLE t_tmp")                               # SQLError
    assert sorted(run.con.tables) == ["t", "t_complete_2", "t_complete_b"]


def flow_distinct_vocab_query(run):
    setup_partition(run)
    run("SELECT DISTINCT d from t WHERE d IS NOT NULL ORDER BY d")


def flow_cofactor_over_expression(run):
    setup_partition(run)
    run("SELECT to_cofactor(a+b+a) FROM t WHERE a = 1")


def flow_fused_aggregate_over_expressions(run):
    setup_partition(run)
    run("SELECT sum_to_triple_2_1(a*2, a+b, d) FROM t "
        "WHERE b IS NOT NULL AND d IS NOT NULL")
    run("CREATE TABLE proj AS SELECT a*2 AS x, a+b AS y, d FROM t "
        "WHERE b IS NOT NULL AND d IS NOT NULL")
    run("SELECT sum_to_triple_2_1(x, y, d) FROM proj")


def flow_null_comparison_filters_rows(run):
    setup_partition(run)
    run("SELECT COUNT(*) FROM t WHERE b > 0")
    run("SELECT COUNT(*) FROM t WHERE NOT (b > 0)")
    run("SELECT COUNT(*) FROM t WHERE b = NULL")


def flow_null_and_or_short_circuit(run):
    setup_partition(run)
    run("SELECT COUNT(*) FROM t WHERE a < 0 AND b > 0")
    run("SELECT COUNT(*) FROM t WHERE a > 0 OR b > 999")
    run("SELECT COUNT(*) FROM t WHERE a > 0 AND b > 0")


def flow_null_arithmetic_propagates(run):
    setup_partition(run)
    run("SELECT a, b + 1 FROM t ORDER BY a")


def flow_aggregates_ignore_nulls(run):
    setup_partition(run)
    run("SELECT COUNT(*), COUNT(b), SUM(b), MIN(b), MAX(b) FROM t")


def flow_group_by_with_null_dimension(run):
    setup_partition(run)
    run("SELECT d, COUNT(*) FROM t GROUP BY d ORDER BY d")
    run("SELECT d, COUNT(*) FROM t GROUP BY d")


def flow_case_when_over_null(run):
    setup_partition(run)
    run("SELECT CASE WHEN b IS NULL THEN -1 ELSE b END FROM t ORDER BY a")


def flow_coalesce_chain_and_null_flags(run):
    setup_partition(run)
    run("SELECT COALESCE(b, a, 0), b IS NOT NULL FROM t ORDER BY a")


def flow_ignore_null_false_in_aggregate(run):
    setup_partition(run)
    run("SELECT sum_to_triple_1_0(b) FROM t WHERE b IS NOT NULL")


FLOWS = {name[len("flow_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("flow_")}
PREDICTING = {"linreg_struct_literal_round_trip", "mice_driver_sql_sequence"}


def run_flow(name, con):
    run = Recorder(con)
    FLOWS[name](run)
    return run.out


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_statements_match_the_jax_module(name):
    got = run_flow(name, port_connect())
    want = run_flow(name, ref_sql.connect())
    assert len(got) == len(want)
    for (q, g), (_, w) in zip(got, want):
        if isinstance(w, str):
            # the same error (SQLError) or the same column names
            assert g == w, (q, g, w)
            continue
        if isinstance(w, list) and w and isinstance(w[0], str):
            assert g == w, (q, g, w)
            continue
        same_rows(g, w, q[:120], predictions=name in PREDICTING)


def test_the_jax_tests_own_expectations_hold_on_the_port():
    """A few of the JAX tests' absolute expectations, on the port alone:
    the golden sums, the imputed column of the MICE driver sequence, the
    partition counts."""
    import golden_ring as G

    con = port_connect()
    setup_test(Recorder(con))
    assert con.execute("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test"
                       ).fetchall()[0][0] == G.SUM_ALL
    rows = con.execute("SELECT sum_to_triple_3_3(a,b,c,d,e,f) from test "
                       "GROUP BY gb").fetchall()
    assert rows[0][0] == G.SUM_GB1 and rows[1][0] == G.SUM_GB2
    assert con.execute("SELECT to_cofactor(a,b,c,d,e,f) from test"
                       ).fetchall()[3][0] == G.LIFT_ROW3
    assert con.execute("SELECT sum_nb_agg(to_nb_agg(a,b,c,d,e,f)) "
                       "from test").fetchall()[0][0] == G.NB_SUM_ALL

    run = Recorder(port_connect())
    flow_mice_driver_sql_sequence(run)
    _, _, _, a_true, missing = mice_driver_data()
    imputed = np.asarray([r[0] for r in run.out[-1][1]], np.float32)
    np.testing.assert_allclose(imputed[~missing], a_true[~missing],
                               rtol=1e-5)
    assert float(np.abs(imputed[missing] - a_true[missing]).max()) < 0.05

    con = port_connect()
    setup_partition(Recorder(con))
    assert con.execute("SELECT d, COUNT(*) FROM t GROUP BY d ORDER BY d"
                       ).fetchall() == [(4, 3), (8, 3), (None, 2)]


def test_model_params_match_the_api_path():
    """The SQL text round-trip of QDA's per-class triples gives the direct
    api path's parameters (tests/test_sql.py::test_qda_list_aggregate's
    check, rtol 1e-6), and its labels."""
    con = port_connect()
    run = Recorder(con)
    flow_qda_list_aggregate(run)
    params, preds = run.out[-2][1][0][0], run.out[-1][1]
    a = np.array([1, 5, 2, 5, 2], np.float32)
    b = np.array([2, 6, 1, 7, 1], np.float32)
    c = np.array([3, 7, 3, 6, 3], np.float32)
    t = api.sum_to_triple(a, b, c, group_by=np.array([0, 0, 1, 1, 1]),
                          num_groups=2, device="cpu")
    direct = api.qda_train(t, np.array([1, 2]), normalize=False)
    np.testing.assert_allclose(params, direct, rtol=1e-6)
    labels = api.qda_predict(direct, False, a, b, c, device="cpu")
    assert [r[0] for r in preds] == [int(v) for v in labels]


# ---------------------------------------------------------------------------
# linreg_predict with noise: by moments
# ---------------------------------------------------------------------------

def test_noisy_linreg_predict_matches_by_moments():
    """The noise draws of the two packages differ (threefry against
    torch's generator), so the noisy predictions are held by their
    moments: the noise (noisy − noiseless prediction) has mean 0 and the
    trained residual std in both, within 5 standard errors over 20,000
    rows. Both train from the port's triple literal (the JAX module's
    f32 sums round otherwise), so their parameters agree to rtol 1e-6."""
    rng = np.random.default_rng(5)
    n = 20_000
    b = rng.normal(size=n).astype(np.float32)
    a = (1.5 * b + 0.3 * rng.normal(size=n)).astype(np.float32)
    stats, triple = [], None
    for con in (port_connect(), ref_sql.connect()):
        con.register("r", {"a": a, "b": b})
        if triple is None:
            triple = con.execute("SELECT sum_to_triple_2_0(a, b) FROM r"
                                 ).fetchone()[0]
        params = con.execute(
            f"select linreg_train({triple!r}{STRUCT}, 0, 0.001::FLOAT, "
            "0::FLOAT, 10000::INTEGER, true, false)").fetchone()[0]
        rows = con.execute(
            f"SELECT linreg_predict({params!r}::FLOAT[], true, false, b), "
            f"linreg_predict({params!r}::FLOAT[], false, false, b) FROM r"
        ).fetchall()
        noise = np.asarray([r[0] - r[1] for r in rows])
        stats.append((params, noise.mean(), noise.std()))
    (p_got, m_got, s_got), (p_want, m_want, s_want) = stats
    np.testing.assert_allclose(p_got, p_want, rtol=1e-6)
    sigma = p_want[-1]                  # the trained noise std
    assert 0.25 < sigma < 0.35
    for m, s in ((m_got, s_got), (m_want, s_want)):
        assert abs(m) < 5 * sigma / math.sqrt(n), m
        assert abs(s - sigma) < 5 * sigma / math.sqrt(2 * n), (s, sigma)


# ---------------------------------------------------------------------------
# the sqlite differential fuzz against the port
# ---------------------------------------------------------------------------

def port_engines(seed):
    """tests/test_sql_differential.py's `_make_engines` with the port's
    connection: the same seeded tables in both engines."""
    rng = random.Random(seed)
    rows1, rows2 = diff._gen_rows_t1(rng), diff._gen_rows_t2(rng)
    rows3 = diff._gen_rows_t3(rng)
    con = port_connect()
    lite = sqlite3.connect(":memory:")
    for name, cols, lite_cols, rows in (
            ("t1", "id INTEGER, a FLOAT, b FLOAT, c INTEGER, d INTEGER, "
             "s VARCHAR", "id INTEGER, a REAL, b REAL, c INTEGER, "
             "d INTEGER, s TEXT", rows1),
            ("t2", "k INTEGER, v FLOAT, w INTEGER",
             "k INTEGER, v REAL, w INTEGER", rows2),
            ("t3", "u INTEGER, p FLOAT, sk VARCHAR",
             "u INTEGER, p REAL, sk TEXT", rows3)):
        con.execute(f"CREATE TABLE {name}({cols})")
        con.execute(f"INSERT INTO {name} VALUES " + ", ".join(
            "(" + ", ".join(diff._lit(v) for v in r) + ")" for r in rows))
        lite.execute(f"CREATE TABLE {name}({lite_cols})")
        lite.executemany(f"INSERT INTO {name} VALUES ("
                         + ",".join("?" * len(rows[0])) + ")", rows)
    return con, lite, rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sql_differential_vs_sqlite(seed):
    """_run_differential's loop, the port's connection in place of the
    JAX module's: 150 queries, a table mutation every 7th."""
    con, lite, rng = port_engines(seed)
    next_id = 45
    for i in range(150):
        if i % 7 == 6:
            stmts, next_id = diff._make_mutation(rng, next_id)
            for s in stmts:
                con.execute(s)
                lite.execute(s)
        q = diff._make_query(rng)
        diff._assert_same(q, con.execute(q).fetchall(),
                          lite.execute(q).fetchall())


def test_malformed_queries_raise_sqlerror_only():
    """test_sql_differential's mutated queries against the port: each
    executes or raises the port's SQLError, never anything else."""
    rng = random.Random(0)
    con, _, qrng = port_engines(0)
    for _ in range(400):
        toks = diff._make_query(qrng).split(" ")
        m = rng.random()
        if m < 0.4 and len(toks) > 2:
            del toks[rng.randrange(len(toks))]
        elif m < 0.7:
            j = rng.randrange(len(toks))
            toks.insert(j, toks[j])
        elif m < 0.85:
            j = rng.randrange(len(toks) - 1)
            toks[j], toks[j + 1] = toks[j + 1], toks[j]
        else:
            toks.insert(rng.randrange(len(toks)),
                        rng.choice(["$", "nosuchcol", ")", "(", "'unterm",
                                    "9e999", "::", "FROM", ","]))
        try:
            con.execute(" ".join(toks)).fetchall()
        except sql.SQLError:
            pass


# ---------------------------------------------------------------------------
# the GROUP BY key pass
# ---------------------------------------------------------------------------

def tuple_group_ids(keys):
    """The JAX module's key pass: a dict of Python tuples, row by row."""
    seen, gid, first = {}, [], []
    for r in range(len(keys[0])):
        k = tuple(sql._pyval(c, r) for c in keys)
        if k not in seen:
            seen[k] = len(first)
            first.append(r)
        gid.append(seen[k])
    return np.asarray(gid, np.int64), np.asarray(first, np.int64)


def random_key_columns(rng, n):
    """Key columns of every kind with NULLs, -0.0 beside 0.0, NaNs and
    few distinct values (so groups repeat)."""
    f = rng.choice([0.0, -0.0, 1.5, -2.25, np.nan], n).astype(np.float32)
    d = rng.choice([0.0, -0.0, 3.0], n)                        # f64
    i = rng.integers(-2, 3, n).astype(np.int64)
    b = rng.random(n) < 0.5
    s = np.asarray(rng.choice(["ap", "bq", "cr"], n), object)
    return [sql.Column(f, rng.random(n) < 0.2, "f"),
            sql.Column(d, rng.random(n) < 0.1, "f"),
            sql.Column(i, rng.random(n) < 0.2, "i"),
            sql.Column(b, rng.random(n) < 0.1, "b"),
            sql.Column(s, rng.random(n) < 0.2, "s")]


@pytest.mark.parametrize("seed", range(4))
def test_group_ids_match_the_tuple_loop(seed):
    """The vectorised pass against the tuple loop on every kind of key
    column, alone and in pairs and triples: the same group of each row,
    numbered by first appearance."""
    rng = np.random.default_rng(seed)
    cols = random_key_columns(rng, 300)
    sets = [[c] for c in cols] + [[cols[0], cols[2]], [cols[1], cols[3]],
                                  [cols[4], cols[0], cols[3]], cols]
    for keys in sets:
        gid, first = sql._group_ids(keys)
        want_gid, want_first = tuple_group_ids(keys)
        np.testing.assert_array_equal(gid, want_gid)
        np.testing.assert_array_equal(first, want_first)


def test_group_ids_nan_and_signed_zero():
    """NaN equals nothing (a group a row, as a new float object a row in
    a Python tuple), -0.0 equals 0.0 (one group, its first row's key),
    NULL is one group."""
    x = np.array([-0.0, np.nan, 0.0, np.nan, 2.0, 0.0], np.float32)
    null = np.array([False, False, False, False, True, False])
    gid, first = sql._group_ids([sql.Column(x, null, "f")])
    np.testing.assert_array_equal(gid, [0, 1, 0, 2, 3, 0])
    np.testing.assert_array_equal(first, [0, 1, 3, 4])
    assert sql._group_ids([sql.Column(np.zeros(0, np.float32))])[0].size == 0


GROUP_CASES = [
    # NULL keys, a NULL-only group, and the order of first appearance
    "SELECT k, COUNT(*), SUM(v) FROM g GROUP BY k",
    # -0.0 and 0.0 in one group, keyed by the first row's -0.0
    "SELECT z, COUNT(*), SUM(v) FROM g GROUP BY z",
    # multi-column keys, NULL in either part
    "SELECT k, j, COUNT(*), MIN(v) FROM g GROUP BY k, j",
    "SELECT COUNT(*) FROM g GROUP BY j, z, k",
    # first-appearance order after WHERE drops the first rows
    "SELECT k, COUNT(*) FROM g WHERE v > 2 GROUP BY k",
    "SELECT k, j, AVG(v) FROM g WHERE k IS NOT NULL OR v < 0 "
    "GROUP BY j, k HAVING COUNT(*) > 1",
    # an expression key with NaN values (0/0): a group a row
    "SELECT COUNT(*), SUM(v) FROM g GROUP BY z / z",
    # a string key and an aggregate over each group's rows on the device
    "SELECT s, sum_to_triple_1_1(v, j) FROM g WHERE j IS NOT NULL "
    "GROUP BY s",
    # no rows left: no groups
    "SELECT k, COUNT(*) FROM g WHERE v > 1000 GROUP BY k",
]


def setup_groups(con):
    con.execute("CREATE TABLE g(k INTEGER, j INTEGER, z FLOAT, v FLOAT, "
                "s VARCHAR)")
    con.execute(
        "INSERT INTO g VALUES (NULL, 1, -0.0, 1, 'a'), (2, 1, 0.0, 2, 'b'), "
        "(1, NULL, 0.0, 3, 'a'), (2, 2, 1.5, 4, NULL), (NULL, 1, -0.0, 5, "
        "'b'), (1, NULL, 1.5, -1, 'a'), (3, 2, 0.0, 6, 'b'), "
        "(2, 1, -0.0, 7, NULL), (NULL, NULL, 1.5, -2, 'a'), "
        "(3, 1, 0.0, 8, 'b')")


@pytest.mark.parametrize("q", GROUP_CASES)
def test_group_by_directed_cases(q):
    port, ref = port_connect(), ref_sql.connect()
    setup_groups(port)
    setup_groups(ref)
    got, want = port.execute(q).fetchall(), ref.execute(q).fetchall()
    same_rows(got, want, q)
    # the key values themselves, -0.0 included
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float) and wv == 0.0:
                assert math.copysign(1, gv) == math.copysign(1, wv), q


# ---------------------------------------------------------------------------
# the device: the card by default, the connection's device in every call
# ---------------------------------------------------------------------------

def test_connect_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: connect() opens on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sql.connect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sql.Connection()


def test_cpu_connection_values_lie_on_the_cpu():
    """Aggregates, lifted rows, a triple cast back from text and a stacked
    list of them: every tensor on the connection's device."""
    con = port_connect()
    setup_test(Recorder(con))

    def values(q):
        rel = con._run_select(sql.parse(q))
        return [v for c in rel.cols for v in c.data]

    triple = con.execute("SELECT sum_to_triple_3_3(a,b,c,d,e,f) FROM test"
                         ).fetchone()[0]
    for v in (values("SELECT sum_to_triple_3_3(a,b,c,d,e,f) FROM test "
                     "GROUP BY gb")
              + values("SELECT to_nb_agg(a,b,c,d,e,f) FROM test")
              + values(f"SELECT {triple!r}{STRUCT}")
              + values(f"SELECT {[triple, triple]!r}{STRUCT}[]")[0]):
        agg = v.triple if isinstance(v, api.Cofactor) else v.agg
        assert agg.n.device.type == "cpu"
    stacked = sql._stack_cofactors(values(f"SELECT {[triple, triple]!r}"
                                          f"{STRUCT}[]")[0])
    assert stacked.triple.quad.shape == (2, 3, 3)
    assert stacked.triple.quad.device.type == "cpu"
    assert con.to_table("test").num_data.device.type == "cpu"


def test_every_call_passes_the_connections_device(monkeypatch):
    """Each call into the port that builds tensors (the aggregates, the
    lifts, the predictors, a triple from its text, the table handoff)
    receives the connection's device, never its own default."""
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            seen.append((name, kw.get("device")))
            return real(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("sum_to_triple", "sum_to_nb_agg", "to_cofactor",
                 "to_nb_agg", "lda_predict", "linreg_predict",
                 "qda_predict", "nb_predict"):
        spy(api, name)
    for name in ("dict_to_triple", "dict_to_nb"):
        spy(serialize, name)
    import duckdb_imputation_tpu_torch.table as table_mod
    spy(table_mod, "from_numpy")

    for name in ("sum_equals_lift_then_sum", "nb_lift_sum_identity",
                 "linreg_struct_literal_round_trip", "qda_list_aggregate",
                 "nb_list_aggregate", "readme_factorized_join_query"):
        run_flow(name, port_connect())
    a = np.array([0, 1, 2, 2, 1, 0], np.int64)
    b = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    con = port_connect()
    con.register("r", {"b": b, "a": a})
    triple = con.execute("SELECT sum_to_triple_1_1(b, a) FROM r"
                         ).fetchone()[0]
    params = con.execute(f"SELECT lda_train({triple!r}{STRUCT}, 0, 0.001)"
                         ).fetchone()[0]
    con.execute(f"SELECT lda_predict({params!r}::FLOAT[], false, b) FROM r")
    con.to_table("r")
    names = {n for n, _ in seen}
    assert names == {"sum_to_triple", "sum_to_nb_agg", "to_cofactor",
                     "to_nb_agg", "lda_predict", "linreg_predict",
                     "qda_predict", "nb_predict", "dict_to_triple",
                     "dict_to_nb", "from_numpy"}, names
    assert all(d == torch.device("cpu") for _, d in seen), seen


# ---------------------------------------------------------------------------
# the to_table handoff into MICE
# ---------------------------------------------------------------------------

def test_to_table_handoff_matches_the_jax_module():
    """tests/test_sql.py::test_to_table_handoff through both modules: the
    SQL table becomes a Table, run_MICE_baseline imputes it; the tables
    equal, the imputed values within atol 1e-4 (noise off) and within
    0.05 of the truth; also a categorical column with NULLs cast back from
    a float column keeps its NULL flags through the handoff."""
    rng = np.random.default_rng(1)
    n = 200
    b = rng.normal(size=n).astype(np.float32)
    a = (b * 3.0).astype(np.float32)
    a[rng.random(n) < 0.2] = np.nan
    k = (b > 0).astype(np.float32) * 2 + 1
    k[rng.random(n) < 0.1] = np.nan
    tables = []
    for con in (port_connect(), ref_sql.connect()):
        con.register("raw", {"a": a, "b": b, "k": k})
        con.execute("CREATE TABLE t AS SELECT a, b, k::INTEGER AS k "
                    "FROM raw")
        tables.append(con.to_table("t"))
    got, want = tables
    np.testing.assert_array_equal(got.num_data.numpy(),
                                  np.asarray(want.num_data))
    np.testing.assert_array_equal(got.cat_codes.numpy(),
                                  np.asarray(want.cat_codes))
    np.testing.assert_array_equal(got.num_null.numpy(),
                                  np.asarray(want.num_null))
    np.testing.assert_array_equal(got.cat_null.numpy(),
                                  np.asarray(want.cat_null))
    assert got.schema.cat_keys == want.schema.cat_keys == ((1, 3),)
    assert (list(got.num_names), list(got.cat_names)) == (["a", "b"], ["k"])
    out = api.run_MICE_baseline(got, con_columns_nulls=["a"],
                                cat_columns_nulls=["k"], mice_iters=2,
                                noise=False)
    ref = ref_api.run_MICE_baseline(want, con_columns_nulls=["a"],
                                    cat_columns_nulls=["k"], mice_iters=2,
                                    noise=False)
    np.testing.assert_allclose(out.num_data.numpy(),
                               np.asarray(ref.num_data), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.cat_codes.numpy(),
                                  np.asarray(ref.cat_codes))
    mask = np.isnan(a)
    np.testing.assert_allclose(out.num_data.numpy()[0][mask],
                               (b * 3.0)[mask], atol=0.05)
