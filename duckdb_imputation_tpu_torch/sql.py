"""SQL front end: run the reference's SQL workloads verbatim, on torch.

Counterpart of `duckdb_imputation_tpu.sql`. The reference framework's
entire user surface is SQL inside DuckDB: its tests drive `SELECT
sum_to_triple_3_3(a,b,c,d,e,f) FROM test GROUP BY gb`
(duckdb_extension/test/python/test_sum.py) and its MICE driver issues
CREATE TABLE / train / CASE-WHEN predict / ALTER TABLE column-swap
statements (imputation/algorithms/imputation_base.cpp:21-142). This module
lets those statements run unchanged against the port:

    con = sql.connect()                     # the card; device="cpu" too
    con.execute("CREATE TABLE test(gb INTEGER, a FLOAT, b FLOAT, ...)")
    con.execute("INSERT INTO test VALUES (1,1,2,3,4,5,6), ...")
    con.execute("SELECT sum_to_triple_3_3(a,b,c,d,e,f) FROM test")
    triple_dict = con.fetchall()[0][0]

Supported statement surface (everything the reference emits):
  * CREATE TABLE t(col TYPE, …)   — FLOAT/DOUBLE ⇒ numeric, INTEGER ⇒
    categorical, BOOLEAN, VARCHAR (the reference's type-dispatch rule,
    triple/lift.cpp:34-37)
  * INSERT INTO t VALUES (…), (…) — with NULLs
  * CREATE TABLE t AS SELECT …
  * DROP TABLE [IF EXISTS] t
  * ALTER TABLE t ALTER COLUMN c SET DEFAULT <n> — reproduces the
    reference's patched zero-copy column swap: replaces column c with the
    single column of table `rep`, then drops `rep`
    (duckdb_imputation.patch:26-175,178-204)
  * UPDATE t SET c = expr[, …] [WHERE …] and DELETE FROM t [WHERE …] —
    standard 3VL row semantics (NULL predicate rows untouched / kept);
    SET expressions see the pre-update row
  * SELECT expr [AS alias], … FROM t | (subquery) | (sub JOIN sub ON …)
      [WHERE …] [GROUP BY …] [HAVING …] [ORDER BY …] [LIMIT n [OFFSET m]]
    with DISTINCT, CASE WHEN, IS [NOT] NULL/TRUE/FALSE, [NOT] BETWEEN,
    [NOT] IN (value list | subquery), `expr::TYPE` casts (incl.
    `::STRUCT(…)` over triple literals — the reference round-trips
    triples as SQL text, imputation_base.cpp:46), list literals, scalar
    subqueries, and 3-valued NULL logic (including the empty-set rule:
    `x IN ()` is FALSE even for NULL x).

Functions: the full extension registration surface
(duckdb_imputation_extension.cpp:48-249) — to_cofactor, sum_triple,
sum_to_triple_<x>_<y>, multiply_triple, the NB variants, and
{lda,linreg,qda,nb}_{train,predict} — plus the builtins the reference's
MICE SQL needs (AVG, SUM, COUNT, MIN, MAX, MODE, COALESCE, list_position,
list_extract — partition.cpp:42-57,749-801).

Parsing and evaluation are numpy on the host, as in the JAX module: same
statements, same 3-valued logic, same result rows and column names,
`SQLError` the only error. Every call into the port's `api` passes the
connection's `device`, so the aggregates run the port's kernels there: a
WHERE mask and GROUP BY keys select each group's rows (`Relation.take`),
and one `api.sum_to_triple` per group (K1's stacked entry point
`masked_gram`, K7 above P = 88) or `api.sum_to_nb_agg` (K6) aggregates
them; triples cast back from their text form, the stacked per-class
triples of qda_train / nb_train, the predictors' inputs and `to_table`
land on the same device. The one change of design is the GROUP BY key
pass (`_group_ids`): group ids in one vectorised numpy pass over the key
columns instead of a Python tuple a row, with the same groups (NULL its
own group, keys equal as Python tuples are, so -0.0 = 0.0 and a NaN value
equals nothing) in the same first-appearance order.
"""
from __future__ import annotations

import ast
import re
from typing import Any, Optional

import numpy as np
import torch

from . import api
from .ring import serialize
from .ring import triple as ring_triple
from .schema import FeatureSchema


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<str>'(?:[^']|'')*')
  | (?P<op>::|<>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|\[|\]|,|\.|;)
""", re.VERBOSE)


def _tokenize(sql: str):
    """Yield (kind, text) tokens. `{…}` blocks (DuckDB struct-literal text,
    e.g. a triple's ToString()) are captured balanced and parsed eagerly."""
    out = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "{":
            depth, j = 0, i
            while j < n:
                if sql[j] == "{":
                    depth += 1
                elif sql[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                elif sql[j] == "'":
                    j += 1
                    while j < n and sql[j] != "'":
                        j += 1
                j += 1
            if depth != 0:
                raise SQLError("unbalanced '{' in struct literal")
            out.append(("struct", ast.literal_eval(sql[i:j + 1])))
            i = j + 1
            continue
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SQLError(f"cannot tokenize at: {sql[i:i+30]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "ident":
            out.append(("ident", text))
        elif kind == "num":
            out.append(("num", float(text) if ("." in text or "e" in text
                                               or "E" in text) else int(text)))
        elif kind == "str":
            out.append(("str", text[1:-1].replace("''", "'")))
        else:
            out.append(("op", text))
    return out


class SQLError(Exception):
    pass


_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "asc", "desc", "limit", "create", "table", "as", "insert", "into",
    "values", "drop", "if", "exists", "alter", "column", "set", "default",
    "case", "when", "then", "else", "end", "and", "or", "not", "null",
    "true", "false", "is", "join", "inner", "left", "outer", "cross", "on",
    "using", "cast", "view", "add", "between", "in", "offset", "update",
    "delete",
}


# ---------------------------------------------------------------------------
# parser → tuple AST
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.pos = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, offset=0):
        p = self.pos + offset
        return self.toks[p] if p < len(self.toks) else ("eof", None)

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def at_kw(self, *kws):
        k, v = self.peek()
        return k == "ident" and v.lower() in kws

    def eat_kw(self, *kws):
        if self.at_kw(*kws):
            return self.next()[1].lower()
        return None

    def expect_kw(self, kw):
        got = self.eat_kw(kw)
        if got is None:
            raise SQLError(f"expected {kw.upper()}, got {self.peek()}")
        return got

    def at_op(self, *ops):
        k, v = self.peek()
        return k == "op" and v in ops

    def eat_op(self, *ops):
        if self.at_op(*ops):
            return self.next()[1]
        return None

    def expect_op(self, op):
        if not self.eat_op(op):
            raise SQLError(f"expected {op!r}, got {self.peek()}")

    def ident(self):
        k, v = self.next()
        if k != "ident":
            raise SQLError(f"expected identifier, got {(k, v)}")
        return v.lower()

    # -- statements ---------------------------------------------------------
    def statement(self):
        if self.at_kw("select"):
            return self.select()
        if self.at_kw("create"):
            return self.create()
        if self.at_kw("insert"):
            return self.insert()
        if self.at_kw("drop"):
            return self.drop()
        if self.at_kw("alter"):
            return self.alter()
        if self.at_kw("update"):
            return self.update()
        if self.at_kw("delete"):
            return self.delete()
        raise SQLError(f"unsupported statement start: {self.peek()}")

    def update(self):
        self.expect_kw("update")
        name = self.ident()
        self.expect_kw("set")
        sets = []
        while True:
            col = self.ident()
            self.expect_op("=")
            sets.append((col, self.expr()))
            if not self.eat_op(","):
                break
        where = self.expr() if self.eat_kw("where") else None
        return ("update", name, sets, where)

    def delete(self):
        self.expect_kw("delete")
        self.expect_kw("from")
        name = self.ident()
        where = self.expr() if self.eat_kw("where") else None
        return ("delete", name, where)

    def create(self):
        self.expect_kw("create")
        self.expect_kw("table")
        name = self.ident()
        if self.eat_kw("as"):
            return ("create_as", name, self.select())
        self.expect_op("(")
        cols = []
        while True:
            cname = self.ident()
            ctype = self.ident()
            # consume multi-word/array types: DOUBLE PRECISION, FLOAT[]
            while self.at_op("["):
                self.expect_op("[")
                self.expect_op("]")
                ctype += "[]"
            cols.append((cname, ctype.lower()))
            if not self.eat_op(","):
                break
        self.expect_op(")")
        return ("create", name, cols)

    def insert(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.ident()
        if self.at_kw("select"):
            # INSERT INTO t SELECT … — append a query result
            return ("insert_select", name, self.select())
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = []
            while True:
                row.append(self.expr())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            rows.append(row)
            if not self.eat_op(","):
                break
        return ("insert", name, rows)

    def drop(self):
        self.expect_kw("drop")
        self.expect_kw("table")
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ("drop", self.ident(), if_exists)

    def alter(self):
        self.expect_kw("alter")
        self.expect_kw("table")
        name = self.ident()
        if self.eat_kw("add"):
            # ALTER TABLE t ADD COLUMN c TYPE [DEFAULT expr]
            # (init_baseline's flag columns, partition.cpp:695-703)
            self.expect_kw("column")
            col = self.ident()
            ctype = self.ident()
            while self.at_op("["):
                self.expect_op("[")
                self.expect_op("]")
                ctype += "[]"
            default = self.expr() if self.eat_kw("default") else None
            return ("addcol", name, col, ctype.lower(), default)
        self.expect_kw("alter")
        self.expect_kw("column")
        col = self.ident()
        self.expect_kw("set")
        self.expect_kw("default")
        default = self.expr()
        return ("swap", name, col, default)

    # -- SELECT -------------------------------------------------------------
    def select(self):
        self.expect_kw("select")
        distinct = bool(self.eat_kw("distinct"))
        items = []
        while True:
            if self.at_op("*"):
                self.next()
                items.append((("star",), None))
            else:
                e = self.expr()
                alias = None
                if self.eat_kw("as"):
                    alias = self.ident()
                elif (self.peek()[0] == "ident"
                      and self.peek()[1].lower() not in _KEYWORDS):
                    alias = self.ident()
                items.append((e, alias))
            if not self.eat_op(","):
                break
        frm = where = having = None
        group_by, order_by, limit = [], [], None
        if self.eat_kw("from"):
            frm = self.from_clause()
        if self.eat_kw("where"):
            where = self.expr()
        if self.eat_kw("group"):
            self.expect_kw("by")
            while True:
                group_by.append(self.expr())
                if not self.eat_op(","):
                    break
        if self.eat_kw("having"):
            having = self.expr()
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                desc = False
                if self.eat_kw("desc"):
                    desc = True
                else:
                    self.eat_kw("asc")
                nulls_first = None       # None = dialect default (LAST)
                if self.eat_kw("nulls"):
                    if self.eat_kw("first"):
                        nulls_first = True
                    else:
                        self.expect_kw("last")
                        nulls_first = False
                order_by.append((e, desc, nulls_first))
                if not self.eat_op(","):
                    break
        if self.eat_kw("limit"):
            limit = (self._int_token("LIMIT"), 0)
            if self.eat_kw("offset"):
                limit = (limit[0], self._int_token("OFFSET"))
        return ("select", items, frm, where, group_by, having, order_by,
                limit, distinct)

    def from_clause(self):
        left = self.from_atom()
        while True:
            jtype = None
            if self.eat_kw("inner"):
                self.expect_kw("join")
                jtype = "inner"
            elif self.eat_kw("left"):
                self.eat_kw("outer")
                self.expect_kw("join")
                jtype = "left"
            elif self.eat_kw("cross"):
                self.expect_kw("join")
                jtype = "cross"
            elif self.at_kw("join"):
                self.next()
                jtype = "inner"
            else:
                break
            right = self.from_atom()
            on = using = None
            if self.eat_kw("on"):
                on = self.expr()
            elif self.eat_kw("using"):
                self.expect_op("(")
                using = []
                while True:
                    using.append(self.ident())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            left = ("join", left, right, jtype, on, using)
        return left

    def from_atom(self):
        if self.eat_op("("):
            inner = (self.select() if self.at_kw("select")
                     else self.from_clause())
            self.expect_op(")")
            alias = None
            if self.eat_kw("as"):
                alias = self.ident()
            elif (self.peek()[0] == "ident"
                  and self.peek()[1].lower() not in _KEYWORDS):
                alias = self.ident()
            return ("sub", inner, alias)
        name = self.ident()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif (self.peek()[0] == "ident"
              and self.peek()[1].lower() not in _KEYWORDS):
            alias = self.ident()
        return ("table", name, alias)

    # -- expressions (precedence climbing) -----------------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.eat_kw("or"):
            e = ("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.eat_kw("and"):
            e = ("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.eat_kw("not"):
            return ("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.add_expr()
        while True:
            if self.eat_kw("is"):
                neg = bool(self.eat_kw("not"))
                if self.eat_kw("null"):
                    e = ("isnull", e, neg)
                elif self.eat_kw("true"):
                    e = ("istruth", e, True, neg)
                elif self.eat_kw("false"):
                    e = ("istruth", e, False, neg)
                else:
                    raise SQLError("IS must be followed by NULL/TRUE/FALSE")
                continue
            op = self.eat_op("=", "<>", "!=", "<=", ">=", "<", ">")
            if op:
                e = ("cmp", "<>" if op == "!=" else op, e, self.add_expr())
                continue
            if self.eat_kw("between"):
                lo = self.add_expr()
                self.expect_kw("and")
                e = ("between", e, lo, self.add_expr(), False)
                continue
            if self.eat_kw("in"):
                e = ("in", e, self._in_items(), False)
                continue
            if self.at_kw("not"):
                # postfix NOT can only introduce NOT BETWEEN / NOT IN
                self.next()
                if self.eat_kw("between"):
                    lo = self.add_expr()
                    self.expect_kw("and")
                    e = ("between", e, lo, self.add_expr(), True)
                    continue
                if self.eat_kw("in"):
                    e = ("in", e, self._in_items(), True)
                    continue
                raise SQLError("expected BETWEEN or IN after NOT")
            return e

    def _int_token(self, what):
        k, v = self.next()
        if k != "num" or not float(v).is_integer():
            raise SQLError(f"{what} expects an integer literal")
        return int(v)

    def _in_items(self):
        self.expect_op("(")
        if self.at_kw("select"):
            sub = self.select()
            self.expect_op(")")
            return ("insub", sub)
        items = [self.expr()]
        while self.eat_op(","):
            items.append(self.expr())
        self.expect_op(")")
        return ("inlist", items)

    def add_expr(self):
        e = self.mul_expr()
        while True:
            op = self.eat_op("+", "-")
            if not op:
                return e
            e = ("arith", op, e, self.mul_expr())

    def mul_expr(self):
        e = self.unary_expr()
        while True:
            op = self.eat_op("*", "/", "%")
            if not op:
                return e
            e = ("arith", op, e, self.unary_expr())

    def unary_expr(self):
        if self.eat_op("-"):
            return ("neg", self.unary_expr())
        self.eat_op("+")
        return self.postfix_expr()

    def postfix_expr(self):
        e = self.primary()
        while self.eat_op("::"):
            e = ("cast", e, self.type_name())
        return e

    def type_name(self):
        base = self.ident()
        if base == "struct":
            depth = 0
            while True:
                k, v = self.next()
                if k == "op" and v == "(":
                    depth += 1
                elif k == "op" and v == ")":
                    depth -= 1
                    if depth == 0:
                        break
                elif k == "eof":
                    raise SQLError("unterminated STRUCT(...) type")
            base = "struct"
        while self.at_op("["):
            self.expect_op("[")
            self.expect_op("]")
            base += "[]"
        return base

    def primary(self):
        k, v = self.peek()
        if k == "num" or k == "str":
            self.next()
            return ("lit", v)
        if k == "struct":
            self.next()
            return ("structlit", v)
        if k == "op" and v == "[":
            self.next()
            items = []
            if not self.at_op("]"):
                while True:
                    items.append(self.expr())
                    if not self.eat_op(","):
                        break
            self.expect_op("]")
            return ("list", items)
        if k == "op" and v == "(":
            self.next()
            if self.at_kw("select"):
                sub = self.select()
                self.expect_op(")")
                return ("scalar_sub", sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if k == "ident":
            low = v.lower()
            if low == "null":
                self.next()
                return ("lit", None)
            if low == "true":
                self.next()
                return ("lit", True)
            if low == "false":
                self.next()
                return ("lit", False)
            if low == "case":
                return self.case_expr()
            if low == "cast":
                self.next()
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("as")
                t = self.type_name()
                self.expect_op(")")
                return ("cast", e, t)
            self.next()
            if self.eat_op("("):
                if low == "count" and self.at_op("*"):
                    self.next()
                    self.expect_op(")")
                    return ("call", "count", [("star",)])
                args = []
                if not self.at_op(")"):
                    while True:
                        args.append(self.expr())
                        if not self.eat_op(","):
                            break
                self.expect_op(")")
                return ("call", low, args)
            if self.eat_op("."):
                return ("col", f"{low}.{self.ident()}")
            return ("col", low)
        raise SQLError(f"unexpected token {(k, v)}")

    def case_expr(self):
        self.expect_kw("case")
        whens = []
        while self.eat_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        els = None
        if self.eat_kw("else"):
            els = self.expr()
        self.expect_kw("end")
        return ("case", whens, els)


def parse(sql: str):
    sql = sql.strip().rstrip(";")
    p = _Parser(_tokenize(sql))
    stmt = p.statement()
    if p.peek()[0] != "eof":
        raise SQLError(f"trailing tokens at {p.peek()}")
    return stmt


# ---------------------------------------------------------------------------
# storage — a relation is a list of named columns
# ---------------------------------------------------------------------------

class Column:
    """kind: 'f' numeric, 'i' categorical int, 'b' bool, 's' string,
    'o' object (triples, param vectors)."""
    __slots__ = ("data", "null", "kind")

    def __init__(self, data, null=None, kind=None):
        self.data = data
        self.null = (np.zeros(len(data), bool) if null is None
                     else np.asarray(null, bool))
        if kind is None:
            if data.dtype == object:
                kind = "o"
            elif np.issubdtype(data.dtype, np.floating):
                kind = "f"
            elif data.dtype == bool:
                kind = "b"
            elif np.issubdtype(data.dtype, np.integer):
                kind = "i"
            else:
                kind = "s"
        self.kind = kind

    def __len__(self):
        return len(self.data)

    def take(self, idx):
        return Column(self.data[idx], self.null[idx], self.kind)


class Relation:
    def __init__(self, names=None, cols=None):
        self.names: list[str] = names or []
        self.cols: list[Column] = cols or []

    @property
    def n(self):
        return len(self.cols[0]) if self.cols else 0

    def add(self, name, col):
        self.names.append(name.lower())
        self.cols.append(col)

    def get(self, name):
        name = name.lower()
        if name in self.names:
            return self.cols[self.names.index(name)]
        # qualified lookup t.col
        if "." in name:
            bare = name.split(".", 1)[1]
            if bare in self.names:
                return self.cols[self.names.index(bare)]
        else:
            hits = [i for i, nm in enumerate(self.names)
                    if nm.endswith("." + name)]
            if len(hits) == 1:
                return self.cols[hits[0]]
            if len(hits) > 1:
                raise SQLError(f"ambiguous column {name}")
        raise SQLError(f"no such column {name}")

    def take(self, idx):
        return Relation(list(self.names), [c.take(idx) for c in self.cols])

    def copy(self):
        return Relation(list(self.names), list(self.cols))


_KIND_FOR_TYPE = {
    "float": "f", "double": "f", "real": "f", "float4": "f", "float8": "f",
    "decimal": "f", "integer": "i", "int": "i", "int4": "i", "bigint": "i",
    "int8": "i", "smallint": "i", "tinyint": "i", "boolean": "b", "bool": "b",
    "varchar": "s", "text": "s", "string": "s",
}

_EMPTY_FOR_KIND = {
    "f": lambda: np.zeros(0, np.float32),
    "i": lambda: np.zeros(0, np.int64),
    "b": lambda: np.zeros(0, bool),
    "s": lambda: np.zeros(0, object),
    "o": lambda: np.zeros(0, object),
}


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_AGG_FNS = {"sum_triple", "sum_nb_agg", "avg", "sum", "count", "min", "max",
            "mode", "stddev", "var_pop", "list"}
_GRID_RE = re.compile(r"^(sum_to_triple|sum_to_nb_agg)_(\d+)_(\d+)$")


def _is_agg_call(e) -> bool:
    if not isinstance(e, tuple):
        return False
    if e[0] == "call" and (e[1] in _AGG_FNS or _GRID_RE.match(e[1])):
        return True
    return any(_is_agg_call(c) for c in e if isinstance(c, (tuple, list)))


def _null_to(kind, n):
    data = np.full(n, np.nan, np.float64) if kind == "f" else \
        np.zeros(n, np.int64) if kind == "i" else \
        np.zeros(n, bool) if kind == "b" else np.full(n, None, object)
    return Column(data, np.ones(n, bool), kind)


def _broadcast(val, n) -> Column:
    """Python scalar → length-n Column. Float literals are DOUBLE — the
    DuckDB rule (a decimal literal types as DOUBLE/DECIMAL, not FLOAT)."""
    if val is None:
        return _null_to("f", n)
    if isinstance(val, bool):
        return Column(np.full(n, val, bool))
    if isinstance(val, int):
        return Column(np.full(n, val, np.int64))
    if isinstance(val, float):
        return Column(np.full(n, val, np.float64))
    arr = np.empty(n, object)
    arr[:] = [val] * n
    return Column(arr, kind="o")


def _numeric(col: Column) -> np.ndarray:
    """Numeric view for EXPRESSION evaluation: f64 compute everywhere.

    Storage stays f32 (the FLOAT column contract) but every operator
    computes in f64 — the widening is exact, and a single policy keeps the
    engine self-consistent: mixing f32 (CASE/COALESCE outputs) with f64
    (arithmetic's natural numpy promotion) made `x <= COALESCE(x, 0)`
    spuriously FALSE for non-null x (caught by the sqlite differential
    fuzz, test_sql_differential.py). The ring/model call sites re-cast to
    f32 themselves (the kernel input dtype)."""
    if col.kind == "b":
        return col.data.astype(np.float64)
    if col.kind == "f" and col.data.dtype != np.float64:
        return col.data.astype(np.float64)
    return col.data


class Connection:
    """An in-memory database speaking the reference's SQL dialect, whose
    aggregates, trainers' inputs and predictors run on `device` (the card
    unless asked otherwise; a machine without CUDA raises, it never falls
    back to the CPU)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the connection: pass "
                               "device='cpu' for the plain versions")
        self.tables: dict[str, Relation] = {}
        self._result: list[tuple] = []
        self._columns: list[str] = []

    # -- dbapi-ish surface ---------------------------------------------------
    def execute(self, sql: str) -> "Connection":
        stmt = parse(sql)
        kind = stmt[0]
        if kind == "select":
            rel = self._run_select(stmt)
            self._columns = list(rel.names)
            self._result = self._materialize(rel)
        elif kind == "create":
            _, name, cols = stmt
            rel = Relation()
            for cname, ctype in cols:
                k = _KIND_FOR_TYPE.get(ctype.rstrip("[]"), "o")
                if ctype.endswith("[]"):
                    k = "o"
                rel.add(cname, Column(_EMPTY_FOR_KIND[k](), kind=k))
            self.tables[name] = rel
            self._result, self._columns = [], []
        elif kind == "create_as":
            _, name, sel = stmt
            rel = self._run_select(sel)
            # materialized tables get BARE column names (DuckDB drops the
            # `t.` qualifier of star-expanded columns) unless stripping
            # would collide (e.g. a.x JOIN b.x)
            bare = [nm.split(".", 1)[1] if "." in nm else nm
                    for nm in rel.names]
            if len(set(bare)) == len(bare):
                rel = Relation(bare, list(rel.cols))
            self.tables[name] = rel
            self._result, self._columns = [], []
        elif kind == "insert":
            self._run_insert(stmt)
        elif kind == "insert_select":
            self._run_insert_select(stmt)
        elif kind == "drop":
            _, name, if_exists = stmt
            if name in self.tables:
                del self.tables[name]
            elif not if_exists:
                raise SQLError(f"no such table {name}")
            self._result, self._columns = [], []
        elif kind == "swap":
            self._run_swap(stmt)
        elif kind == "addcol":
            self._run_addcol(stmt)
        elif kind == "update":
            self._run_update(stmt)
        elif kind == "delete":
            self._run_delete(stmt)
        else:  # pragma: no cover
            raise SQLError(f"unhandled statement {kind}")
        return self

    query = execute
    sql = execute

    def fetchall(self):
        return list(self._result)

    def fetchone(self):
        return self._result[0] if self._result else None

    def columns(self):
        return list(self._columns)

    def register(self, name: str, cols: dict):
        """Register numpy columns as a table (float ⇒ numeric, int ⇒
        categorical — the reference dispatch rule)."""
        rel = Relation()
        for cname, arr in cols.items():
            arr = np.asarray(arr)
            null = None
            if np.issubdtype(arr.dtype, np.floating):
                null = np.isnan(arr)
                rel.add(cname, Column(arr.astype(np.float32), null, "f"))
            elif arr.dtype == bool:
                rel.add(cname, Column(arr, None, "b"))
            elif np.issubdtype(arr.dtype, np.integer):
                rel.add(cname, Column(arr.astype(np.int64), None, "i"))
            else:
                rel.add(cname, Column(arr.astype(object), None, "o"))
        self.tables[name.lower()] = rel
        return self

    # -- INSERT / column swap -------------------------------------------------
    def _run_insert(self, stmt):
        _, name, rows = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        rel = self.tables[name]
        if rows and len(rows[0]) != len(rel.cols):
            raise SQLError("INSERT arity mismatch")
        new_cols = []
        for j, col in enumerate(rel.cols):
            vals, nulls = [], []
            for row in rows:
                v = _const_eval(row[j], self.device)
                nulls.append(v is None)
                if v is None:
                    vals.append(np.nan if col.kind == "f" else
                                0 if col.kind in ("i", "b") else None)
                else:
                    vals.append(v)
            if col.kind == "f":
                add = np.asarray(vals, np.float32)
            elif col.kind == "i":
                add = np.asarray(vals, np.int64)
            elif col.kind == "b":
                add = np.asarray(vals, bool)
            else:
                add = np.asarray(vals, object)
            new_cols.append(Column(
                np.concatenate([col.data, add]),
                np.concatenate([col.null, np.asarray(nulls, bool)]),
                col.kind))
        self.tables[name] = Relation(list(rel.names), new_cols)
        self._result, self._columns = [], []

    def _run_insert_select(self, stmt):
        """`INSERT INTO t SELECT …` — append the query result, coerced
        column-by-position to the target's kinds (numeric widens/narrows
        through float; int sources feed float targets and vice versa with
        truncation, DuckDB's implicit cast)."""
        _, name, sel = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        rel = self.tables[name]
        src = self._run_select(sel)
        if len(src.cols) != len(rel.cols):
            raise SQLError("INSERT arity mismatch")
        new_cols = []
        for col, add in zip(rel.cols, src.cols):
            data = add.data
            if col.kind == "f":
                data = data.astype(np.float32)
            elif col.kind == "i":
                data = data.astype(np.int64)
            elif col.kind == "b":
                data = data.astype(bool)
            elif col.kind != add.kind:
                data = data.astype(object)
            new_cols.append(Column(
                np.concatenate([col.data, data]),
                np.concatenate([col.null, add.null]), col.kind))
        self.tables[name] = Relation(list(rel.names), new_cols)
        self._result, self._columns = [], []

    def _run_update(self, stmt):
        """`UPDATE t SET c = expr[, …] [WHERE cond]`. The reference never
        issues UPDATE (its write-back is the patched column swap precisely
        because row-level UPDATE is slow in a columnar store), but a DuckDB
        user migrating expects it. Here it is the same O(column) masked
        replace as the swap: rows where the predicate is not TRUE (3VL —
        NULL keeps the old value, the SQL standard rule) are untouched.
        All SET expressions evaluate against the PRE-update row, per the
        standard (`SET a = b, b = a` swaps)."""
        _, name, sets, where = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        rel = self.tables[name]
        mask = (_truthy(self._eval(where, rel)) if where is not None
                else np.ones(rel.n, bool))
        new_vals = [(col, self._eval(expr, rel)) for col, expr in sets]
        out = rel.copy()
        for colname, val in new_vals:
            if colname not in out.names:
                raise SQLError(f"no such column {colname}")
            idx = out.names.index(colname)
            old = out.cols[idx]
            data, null = val.data, val.null
            if old.kind == "f":
                data = data.astype(np.float32)
            elif old.kind == "i" and val.kind == "f":
                # null slots may hold NaN; their values are never read
                data = np.rint(np.where(null, 0.0,
                                        _numeric(val))).astype(np.int64)
            elif old.kind == "i":
                data = np.asarray(data).astype(np.int64)
            elif old.kind == "b":
                data = np.asarray(data).astype(bool)
            if old.kind == "o" or val.kind == "o":
                merged = old.data.astype(object).copy()
                merged[mask] = data[mask]
                out.cols[idx] = Column(merged,
                                       np.where(mask, null, old.null),
                                       old.kind)
            else:
                out.cols[idx] = Column(np.where(mask, data, old.data),
                                       np.where(mask, null, old.null),
                                       old.kind)
        self.tables[name] = out
        self._result, self._columns = [], []

    def _run_delete(self, stmt):
        """`DELETE FROM t [WHERE cond]` — keep rows where the predicate is
        not TRUE (FALSE and NULL rows survive, the 3VL rule)."""
        _, name, where = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        rel = self.tables[name]
        if where is None:
            keep = np.zeros(rel.n, bool)
        else:
            keep = ~_truthy(self._eval(where, rel))
        self.tables[name] = rel.take(np.flatnonzero(keep))
        self._result, self._columns = [], []

    def _run_addcol(self, stmt):
        """`ALTER TABLE t ADD COLUMN c TYPE [DEFAULT expr]` — the
        init_baseline flag-column step (partition.cpp:695-703): adds the
        `<col>_IS_NULL BOOLEAN DEFAULT false` columns that the subsequent
        rep-swap fills with the real null flags."""
        _, name, colname, ctype, default = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        rel = self.tables[name].copy()
        k = _KIND_FOR_TYPE.get(ctype.rstrip("[]"), "o")
        n = rel.n
        if default is None:
            newc = _null_to(k, n)
        else:
            c = self._eval(default, rel)
            data = c.data
            if k == "f":
                data = data.astype(np.float32)
            elif k == "i":
                data = np.asarray(data).astype(np.int64)
            elif k == "b":
                data = np.asarray(data).astype(bool)
            newc = Column(data, c.null.copy(), k)
        rel.add(colname, newc)
        self.tables[name] = rel
        self._result, self._columns = [], []

    def _run_swap(self, stmt):
        """The reference's patched `ALTER TABLE t ALTER COLUMN c SET DEFAULT n`
        column swap: move the single column of table `rep` into column c of t,
        then drop `rep` (duckdb_imputation.patch:26-175,178-204)."""
        _, name, colname, _default = stmt
        if name not in self.tables:
            raise SQLError(f"no such table {name}")
        if "rep" not in self.tables:
            raise SQLError("column swap requires a table named 'rep'")
        rep = self.tables["rep"]
        if len(rep.cols) != 1:
            raise SQLError("'rep' must have exactly one column")
        rel = self.tables[name]
        src = rep.cols[0]
        if rel.n != len(src):
            raise SQLError("row count mismatch in column swap")
        idx = rel.names.index(colname.lower())
        target_kind = rel.cols[idx].kind
        data = src.data
        if target_kind == "f" and src.kind != "f":
            data = data.astype(np.float32)
        elif target_kind == "i" and src.kind == "f":
            data = np.rint(data).astype(np.int64)
        cols = list(rel.cols)
        cols[idx] = Column(data, src.null, target_kind)
        self.tables[name] = Relation(list(rel.names), cols)
        del self.tables["rep"]
        self._result, self._columns = [], []

    # -- SELECT --------------------------------------------------------------
    def _run_select(self, stmt) -> Relation:
        (_, items, frm, where, group_by, having, order_by, limit,
         distinct) = stmt
        rel = self._from_rel(frm) if frm is not None else Relation(
            ["dummy"], [Column(np.zeros(1, np.float32))])
        if where is not None:
            mask = _truthy(self._eval(where, rel))
            rel = rel.take(np.flatnonzero(mask))

        has_agg = any(_is_agg_call(e) for e, _ in items)
        if has_agg or group_by:
            # ORDER BY keys not in the select list ride along as hidden
            # items evaluated per group, then get dropped after the sort
            hidden = [(e, f"__order{i}") for i, (e, *_) in enumerate(order_by)
                      if not any(e == se for se, _ in items)]
            out = self._run_aggregate(items + hidden, rel, group_by, having)
            n_vis = len(items)
        else:
            out = Relation()
            for i, (e, alias) in enumerate(items):
                if e == ("star",):
                    for nm, c in zip(rel.names, rel.cols):
                        out.add(nm, c)
                    continue
                col = self._eval(e, rel)
                out.add(alias or _expr_name(e, i), col)
            hidden = []
            n_vis = len(out.cols)
            if order_by:
                for i, (e, *_) in enumerate(order_by):
                    if not _refs_resolve(e, out):
                        out.add(f"__order{i}", self._eval(e, rel))
                        hidden.append((e, f"__order{i}"))

        if distinct:
            seen, keep = set(), []
            for r in range(out.n):
                key = tuple(_pyval(c, r) for c in out.cols[:n_vis])
                if key not in seen:
                    seen.add(key)
                    keep.append(r)
            out = out.take(np.asarray(keep, np.int64))
        if order_by:
            keys = []
            for e, desc, nulls_first in reversed(order_by):
                hid = next((nm for he, nm in hidden if he == e), None)
                col = (out.get(hid) if hid is not None
                       else self._eval(e, out))
                k = col.data
                if k.dtype == object or k.dtype.kind in ("U", "S"):
                    # factorize so DESC works for strings/objects too
                    _, k = np.unique(np.asarray([str(v) for v in k]),
                                     return_inverse=True)
                if k.dtype.kind == "f":
                    k = np.where(col.null, 0.0, k)  # NaN breaks lexsort order
                if desc:
                    k = -k.astype(np.float64) if k.dtype != bool else ~k
                # DuckDB default NULL placement is NULLS LAST for both ASC
                # and DESC (default_null_order); the null flag is the more
                # significant component of this item's key, so NULL rows
                # sort after every value (an INTEGER column's null slots
                # hold 0 in data and would otherwise sort as 0)
                keys.append(k)
                keys.append(~col.null if nulls_first else col.null)
            idx = np.lexsort(keys)
            out = out.take(idx)
        if hidden:
            out = Relation(out.names[:n_vis], out.cols[:n_vis])
        if limit is not None:
            count, offset = limit
            lo = min(offset, out.n)
            out = out.take(np.arange(lo, min(lo + count, out.n)))
        return out

    def _from_rel(self, frm) -> Relation:
        kind = frm[0]
        if kind == "table":
            _, name, alias = frm
            if name not in self.tables:
                raise SQLError(f"no such table {name}")
            rel = self.tables[name].copy()
            tag = alias or name
            return Relation([f"{tag}.{nm}" if "." not in nm else nm
                             for nm in rel.names], list(rel.cols))
        if kind == "sub":
            _, inner, alias = frm
            rel = (self._run_select(inner) if inner[0] == "select"
                   else self._from_rel(inner))
            if alias:
                rel = Relation([f"{alias}.{nm.split('.')[-1]}"
                                for nm in rel.names], list(rel.cols))
            return rel
        if kind == "join":
            _, lf, rf, jtype, on, using = frm
            left, right = self._from_rel(lf), self._from_rel(rf)
            li, ri = [], []
            if using:
                lkeys = [left.get(u) for u in using]
                rkeys = [right.get(u) for u in using]
                rmap: dict[tuple, list[int]] = {}
                # SQL 3VL: NULL never equals, so rows with any NULL key
                # cannot match (on the LEFT path they then fall out
                # unmatched and get NULL-padded) — round-4 advisor #3;
                # hashing _pyval tuples would make None == None match
                for r in range(right.n):
                    if any(c.null[r] for c in rkeys):
                        continue
                    rmap.setdefault(
                        tuple(_pyval(c, r) for c in rkeys), []).append(r)
                for l in range(left.n):
                    if any(c.null[l] for c in lkeys):
                        continue
                    for r in rmap.get(
                            tuple(_pyval(c, l) for c in lkeys), []):
                        li.append(l)
                        ri.append(r)
            else:
                for l in range(left.n):
                    for r in range(right.n):
                        li.append(l)
                        ri.append(r)
            li = np.asarray(li, np.int64)
            ri = np.asarray(ri, np.int64)
            joined = Relation(
                list(left.names) + list(right.names),
                [c.take(li) for c in left.cols]
                + [c.take(ri) for c in right.cols])
            if on is not None and on != ("lit", True):
                mask = _truthy(self._eval(on, joined))
                keep = np.flatnonzero(mask)
                li, ri = li[keep], ri[keep]
                joined = joined.take(keep)
            if jtype == "left":
                # unmatched left rows survive with NULLs on the right side
                # (standard LEFT OUTER semantics: the ON/USING predicate
                # decides matching, not row survival)
                matched = np.zeros(left.n, bool)
                matched[li] = True
                un = np.flatnonzero(~matched)
                if len(un):
                    cols = [Column(np.concatenate([c.data[li], c.data[un]]),
                                   np.concatenate([c.null[li], c.null[un]]),
                                   c.kind) for c in left.cols]
                    for c in right.cols:
                        pad = _null_to(c.kind, len(un))
                        cols.append(Column(
                            np.concatenate([c.data[ri], pad.data]),
                            np.concatenate([c.null[ri], pad.null]),
                            c.kind))
                    joined = Relation(list(left.names) + list(right.names),
                                      cols)
            return joined
        raise SQLError(f"unhandled FROM {kind}")

    # -- aggregation ----------------------------------------------------------
    def _run_aggregate(self, items, rel, group_by, having) -> Relation:
        if group_by:
            keys = [self._eval(g, rel) for g in group_by]
            gid, first = _group_ids(keys)
            order = [tuple(_pyval(c, r) for c in keys) for r in first]
            # each group's rows in ascending order, by one stable sort
            rows = np.argsort(gid, kind="stable")
            ends = np.cumsum(np.bincount(gid, minlength=len(first)))
            groups = np.split(rows, ends[:-1]) if len(first) else []
        else:
            groups = [np.arange(rel.n)]
            order = [()]

        rows = []
        for g, idx in enumerate(groups):
            grel = rel.take(idx)
            env = {}
            if group_by:
                for ge, kv in zip(group_by, order[g]):
                    env[repr(ge)] = kv
            if having is not None:
                hv = self._eval_scalar(having, grel, env)
                if not hv:
                    continue
            row = []
            for i, (e, alias) in enumerate(items):
                row.append(self._eval_scalar(e, grel, env))
            rows.append(row)

        out = Relation()
        for i, (e, alias) in enumerate(items):
            vals = [r[i] for r in rows]
            arr = np.empty(len(vals), object)
            arr[:] = vals
            nulls = np.asarray([v is None for v in vals], bool)
            if vals and all(isinstance(v, (int, float, np.floating,
                                           np.integer)) or v is None
                            for v in vals):
                if all(isinstance(v, (int, np.integer)) or v is None
                       for v in vals):
                    arr = np.asarray([0 if v is None else int(v)
                                      for v in vals], np.int64)
                    out.add(alias or _expr_name(e, i),
                            Column(arr, nulls, "i"))
                    continue
                arr = np.asarray([np.nan if v is None else float(v)
                                  for v in vals], np.float64)
                out.add(alias or _expr_name(e, i), Column(arr, nulls, "f"))
                continue
            out.add(alias or _expr_name(e, i), Column(arr, nulls, "o"))
        return out

    def _eval_scalar(self, e, grel: Relation, env: dict) -> Any:
        """Evaluate an expression in per-group scalar context: aggregate
        calls consume the group's rows; group-key expressions resolve to
        the group's key value; everything else applies scalar-wise."""
        if repr(e) in env:
            return env[repr(e)]
        kind = e[0]
        if kind == "lit":
            return e[1]
        if kind == "structlit":
            return e[1]
        if kind == "list":
            return [self._eval_scalar(c, grel, env) for c in e[1]]
        if kind == "cast":
            return _apply_cast(self._eval_scalar(e[1], grel, env), e[2],
                               self.device)
        if kind == "call":
            return self._call_scalar(e[1], e[2], grel, env)
        if kind == "arith":
            return _scalar_arith(e[1], self._eval_scalar(e[2], grel, env),
                                 self._eval_scalar(e[3], grel, env))
        if kind == "cmp":
            return _scalar_cmp(e[1], self._eval_scalar(e[2], grel, env),
                               self._eval_scalar(e[3], grel, env))
        if kind == "neg":
            v = self._eval_scalar(e[1], grel, env)
            return None if v is None else -v
        if kind == "and":
            # 3VL: FALSE dominates NULL (Python `and` would return None
            # for NULL AND FALSE and True for NOT NULL — both wrong SQL)
            a = self._eval_scalar(e[1], grel, env)
            b = self._eval_scalar(e[2], grel, env)
            a = None if a is None else bool(a)
            b = None if b is None else bool(b)
            if a is False or b is False:
                return False
            if a is None or b is None:
                return None
            return True
        if kind == "or":
            a = self._eval_scalar(e[1], grel, env)
            b = self._eval_scalar(e[2], grel, env)
            a = None if a is None else bool(a)
            b = None if b is None else bool(b)
            if a is True or b is True:
                return True
            if a is None or b is None:
                return None
            return False
        if kind == "not":
            v = self._eval_scalar(e[1], grel, env)
            return None if v is None else not bool(v)
        if kind == "between":
            v = self._eval_scalar(e[1], grel, env)
            lo = self._eval_scalar(e[2], grel, env)
            hi = self._eval_scalar(e[3], grel, env)
            c1 = None if (v is None or lo is None) else bool(v >= lo)
            c2 = None if (v is None or hi is None) else bool(v <= hi)
            if c1 is False or c2 is False:
                out = False
            elif c1 is None or c2 is None:
                out = None
            else:
                out = True
            return None if out is None else (not out if e[4] else out)
        if kind == "in":
            v = self._eval_scalar(e[1], grel, env)
            spec = e[2]
            if spec[0] == "insub":
                sub = self._run_select(spec[1])
                if len(sub.cols) != 1:
                    raise SQLError("IN subquery must return one column")
                cands = [_pyval(sub.cols[0], r) for r in range(sub.n)]
            else:
                cands = [self._eval_scalar(x, grel, env) for x in spec[1]]
            if any(v is not None and c is not None and v == c
                   for c in cands):
                out = True
            elif (v is None and cands) or any(c is None for c in cands):
                out = None
            else:
                out = False
            return None if out is None else (not out if e[3] else out)
        if kind == "isnull":
            v = self._eval_scalar(e[1], grel, env)
            return (v is not None) if e[2] else (v is None)
        if kind == "istruth":
            v = self._eval_scalar(e[1], grel, env)
            d = v is not None and bool(v) == e[2]
            return not d if e[3] else d
        if kind == "case":
            whens, els = e[1], e[2]
            for cond, val in whens:
                cv = self._eval_scalar(cond, grel, env)
                if cv is not None and cv:
                    return self._eval_scalar(val, grel, env)
            return (self._eval_scalar(els, grel, env) if els is not None
                    else None)
        if kind == "scalar_sub":
            return self._scalar_subquery(e[1])
        if kind == "col":
            raise SQLError(
                f"column {e[1]} must appear in GROUP BY or an aggregate")
        raise SQLError(f"cannot evaluate {kind} in aggregate context")

    def _call_scalar(self, fname, args, grel: Relation, env: dict):
        m = _GRID_RE.match(fname)
        if m or fname in ("sum_to_triple", "sum_to_nb_agg"):
            cols = [self._eval(a, grel) for a in args]
            if m:
                # the _<x>_<y> suffix IS the signature: DuckDB would cast
                # the first x args to FLOAT and the rest to INTEGER
                # (duckdb_imputation_extension.cpp:97-111 registration)
                n_num, n_cat = int(m.group(2)), int(m.group(3))
                if len(cols) != n_num + n_cat:
                    raise SQLError(f"{fname} expects {n_num + n_cat} "
                                   f"columns, got {len(cols)}")
                arrays = ([_numeric(c).astype(np.float32)
                           for c in cols[:n_num]]
                          + [_numeric(c).astype(np.int64)
                             for c in cols[n_num:]])
            else:
                arrays = [(_numeric(c).astype(np.float32)
                           if c.kind in ("f", "b")
                           else c.data.astype(np.int64)) for c in cols]
            base = m.group(1) if m else fname
            fn = api.sum_to_triple if base == "sum_to_triple" \
                else api.sum_to_nb_agg
            val = fn(*arrays, device=self.device)
            val._sql_style = "agg"
            return val
        if fname == "sum_triple":
            inner = self._eval_lifted(args[0], grel)
            val = api.sum_triple(inner) if inner.batched else inner
            val._sql_style = "agg"
            return val
        if fname == "sum_nb_agg":
            inner = self._eval_lifted(args[0], grel, nb=True)
            val = api.sum_nb_agg(inner) if inner.batched else inner
            val._sql_style = "agg"
            return val
        if fname == "list":
            col = self._eval(args[0], grel)
            return [col.data[r] if not col.null[r] else None
                    for r in range(len(col))]
        if fname in ("avg", "sum", "min", "max", "count", "mode", "stddev",
                     "var_pop"):
            if args == [("star",)]:
                return int(grel.n)
            col = self._eval(args[0], grel)
            valid = ~col.null
            vals = col.data[valid]
            if fname == "count":
                return int(valid.sum())
            if len(vals) == 0:
                return None
            if fname == "avg":
                return float(np.mean(vals.astype(np.float64)))
            if fname == "sum":
                if col.kind == "i":
                    return int(vals.sum())
                return float(vals.sum(dtype=np.float64))
            if fname == "min":
                return vals.min().item()
            if fname == "max":
                return vals.max().item()
            if fname == "stddev":
                return float(np.std(vals.astype(np.float64), ddof=1))
            if fname == "var_pop":
                return float(np.var(vals.astype(np.float64)))
            if fname == "mode":
                uniq, cnt = np.unique(vals, return_counts=True)
                return uniq[np.argmax(cnt)].item()
        if fname == "coalesce":
            for a in args:
                v = self._eval_scalar(a, grel, env)
                if v is not None:
                    return v
            return None
        # scalar function of scalar args (e.g. lda_train over a literal)
        sargs = [self._eval_scalar(a, grel, env) for a in args]
        return _scalar_fn(fname, sargs)

    def _eval_lifted(self, e, grel: Relation, nb=False):
        """Argument of sum_triple/sum_nb_agg: either a to_cofactor()/
        to_nb_agg() call over this group's rows, or a column of lifted or
        partial triples (e.g. after a join) to be ring-summed."""
        if e[0] == "call" and e[1] in ("to_cofactor", "to_nb_agg"):
            cols = [self._eval(a, grel) for a in e[2]]
            arrays = [(_numeric(c).astype(np.float32) if c.kind in ("f", "b")
                       else c.data.astype(np.int64)) for c in cols]
            return (api.to_nb_agg if nb or e[1] == "to_nb_agg"
                    else api.to_cofactor)(*arrays, device=self.device)
        if e[0] == "call" and e[1] in ("multiply_triple", "multiply_nb_agg"):
            # sum_triple(multiply_triple(A, B)) — the factorized-join plan
            # (README.md:163-174). Fuse the per-key products and their sum
            # into ONE device dispatch of MXU contractions over the key axis
            # (ring.triple.factorized_join_sum) instead of 2 dispatches per
            # joined row.
            a = self._eval(e[2][0], grel)
            b = self._eval(e[2][1], grel)
            ok = ~(a.null | b.null)
            av = [v for v, m in zip(a.data, ok) if m]
            bv = [v for v, m in zip(b.data, ok) if m]
            if av and (all(isinstance(v, api.Cofactor) and not v.batched
                           for v in av + bv) or
                       all(isinstance(v, api.NBValue) and not v.batched
                           for v in av + bv)):
                from functools import reduce

                def stack(objs, attr, align):
                    # per-key triples may carry per-key vocabularies (SQL
                    # GROUP BY infers a schema per group); re-embed into the
                    # union schema before stacking
                    us = reduce(lambda s, o: s.union(o.schema), objs[1:],
                                objs[0].schema)
                    ts = [align(getattr(o, attr), o.schema, us)
                          for o in objs]
                    return ring_triple._map(lambda *xs: torch.stack(xs),
                                            *ts), us
                if isinstance(av[0], api.Cofactor):
                    at, asch = stack(av, "triple", serialize.align_triple)
                    bt, bsch = stack(bv, "triple", serialize.align_triple)
                    return api.Cofactor(
                        ring_triple.factorized_join_sum(at, bt),
                        asch.concat(bsch))
                at, asch = stack(av, "agg", serialize.align_nb)
                bt, bsch = stack(bv, "agg", serialize.align_nb)
                return api.NBValue(
                    ring_triple.factorized_join_sum_nb(at, bt),
                    asch.concat(bsch))
        col = self._eval(e, grel)
        if col.kind != "o":
            raise SQLError("sum_triple expects triples")
        vals = [v for v, isnull in zip(col.data, col.null) if not isnull]
        # align heterogeneous vocabularies onto the union schema (the map
        # merge of the reference's ring sum, sum_state.cpp:37-96)
        if (len(vals) > 1 and isinstance(vals[0], (api.Cofactor, api.NBValue))
                and any(v.schema != vals[0].schema for v in vals[1:])):
            from functools import reduce
            us = reduce(lambda s, v: s.union(v.schema), vals[1:],
                        vals[0].schema)
            if isinstance(vals[0], api.Cofactor):
                vals = [api.Cofactor(
                    serialize.align_triple(v.triple, v.schema, us), us,
                    v.batched) for v in vals]
            else:
                vals = [api.NBValue(
                    serialize.align_nb(v.agg, v.schema, us), us, v.batched)
                    for v in vals]
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return total

    def _scalar_subquery(self, sel):
        rel = self._run_select(sel)
        if rel.n != 1 or len(rel.cols) != 1:
            raise SQLError("scalar subquery must return exactly one cell")
        return _pyval(rel.cols[0], 0)

    # -- row-context evaluation ------------------------------------------------
    def _eval(self, e, rel: Relation) -> Column:
        n = rel.n
        kind = e[0]
        if kind == "col":
            return rel.get(e[1])
        if kind == "lit":
            return _broadcast(e[1], n)
        if kind == "structlit":
            return _broadcast(e[1], n)
        if kind == "list":
            vals = [_const_eval(c, self.device) for c in e[1]]
            return _broadcast(vals, n)
        if kind == "cast":
            inner = self._eval(e[1], rel)
            return _cast_column(inner, e[2], n, self.device)
        if kind == "neg":
            c = self._eval(e[1], rel)
            return Column(-_numeric(c), c.null, "f" if c.kind == "f" else "i")
        if kind == "arith":
            a, b = self._eval(e[2], rel), self._eval(e[3], rel)
            null = a.null | b.null
            x, y = _numeric(a), _numeric(b)
            op = e[1]
            if op == "+":
                d = x + y
            elif op == "-":
                d = x - y
            elif op == "*":
                d = x * y
            elif op == "/":
                with np.errstate(divide="ignore", invalid="ignore"):
                    d = x.astype(np.float64) / y
            else:
                # SQL % is fmod (sign of the dividend), not np.mod
                with np.errstate(divide="ignore", invalid="ignore"):
                    d = np.fmod(x, y)
            return Column(np.asarray(d), null)
        if kind == "cmp":
            a, b = self._eval(e[2], rel), self._eval(e[3], rel)
            null = a.null | b.null
            x, y = a.data, b.data
            op = e[1]
            if op == "=":
                d = x == y
            elif op == "<>":
                d = x != y
            elif op == "<":
                d = x < y
            elif op == "<=":
                d = x <= y
            elif op == ">":
                d = x > y
            else:
                d = x >= y
            return Column(np.asarray(d, bool), null, "b")
        if kind == "between":
            # x BETWEEN lo AND hi ≡ (x >= lo AND x <= hi) with full 3VL
            a = self._eval(e[1], rel)
            lo, hi = self._eval(e[2], rel), self._eval(e[3], rel)
            c1 = Column(np.asarray(a.data >= lo.data, bool),
                        a.null | lo.null, "b")
            c2 = Column(np.asarray(a.data <= hi.data, bool),
                        a.null | hi.null, "b")
            av, bv = _truthy(c1), _truthy(c2)
            null = (c1.null | c2.null) & ~(~av & ~c1.null) & ~(~bv & ~c2.null)
            d = av & bv & ~null
            if e[4]:                          # NOT BETWEEN: 3VL negation
                d = ~d & ~null
            return Column(d, null, "b")
        if kind == "in":
            # x IN (v…): TRUE on any non-null match; else NULL if x or any
            # candidate is NULL; else FALSE. TRUE dominates NULL.
            a = self._eval(e[1], rel)
            spec = e[2]
            if spec[0] == "insub":
                sub = self._run_select(spec[1])
                if len(sub.cols) != 1:
                    raise SQLError("IN subquery must return one column")
                cands = [_broadcast(_pyval(sub.cols[0], r), n)
                         for r in range(sub.n)]
            else:
                cands = [self._eval(x, rel) for x in spec[1]]
            matched = np.zeros(n, bool)
            # x IN (<empty set>) is FALSE even for NULL x — NULL x only
            # becomes UNKNOWN when there are candidates to be unknown about
            anynull = a.null.copy() if cands else np.zeros(n, bool)
            for c in cands:
                matched |= np.asarray(a.data == c.data, bool) \
                    & ~a.null & ~c.null
                anynull |= c.null
            null = anynull & ~matched
            d = (~matched & ~null) if e[3] else matched
            return Column(d, null, "b")
        if kind == "and":
            a, b = self._eval(e[1], rel), self._eval(e[2], rel)
            av, bv = _truthy(a), _truthy(b)
            # 3VL: FALSE dominates NULL
            null = (a.null | b.null) & ~(~av & ~a.null) & ~(~bv & ~b.null)
            return Column(av & bv & ~null, null, "b")
        if kind == "or":
            a, b = self._eval(e[1], rel), self._eval(e[2], rel)
            av, bv = _truthy(a), _truthy(b)
            null = (a.null | b.null) & ~(av & ~a.null) & ~(bv & ~b.null)
            return Column((av | bv) & ~null, null, "b")
        if kind == "not":
            a = self._eval(e[1], rel)
            return Column(~_truthy(a) & ~a.null, a.null, "b")
        if kind == "isnull":
            a = self._eval(e[1], rel)
            d = ~a.null if e[2] else a.null.copy()
            return Column(d, None, "b")
        if kind == "istruth":
            a = self._eval(e[1], rel)
            want = e[2]
            d = (_truthy(a) == want) & ~a.null
            if e[3]:
                d = ~d
            return Column(d, None, "b")
        if kind == "case":
            whens, els = e[1], e[2]
            result: Optional[Column] = (self._eval(els, rel) if els is not None
                                        else None)
            for cond, val in reversed(whens):
                cmask = _truthy(self._eval(cond, rel))
                v = self._eval(val, rel)
                if result is None:
                    result = _null_to(v.kind, n)
                if v.kind == "o" or result.kind == "o":
                    data = np.where(cmask, v.data.astype(object),
                                    result.data.astype(object))
                    result = Column(data, np.where(cmask, v.null,
                                                   result.null), "o")
                else:
                    kind_out = ("f" if "f" in (v.kind, result.kind)
                                else v.kind)
                    data = np.where(cmask, _numeric(v),
                                    _numeric(result))
                    if kind_out == "f":
                        data = data.astype(np.float64)
                    result = Column(data, np.where(cmask, v.null,
                                                   result.null), kind_out)
            return result if result is not None else _null_to("f", n)
        if kind == "call":
            return self._call_row(e[1], e[2], rel)
        if kind == "scalar_sub":
            return _broadcast(self._scalar_subquery(e[1]), n)
        if kind == "star":
            raise SQLError("* only allowed as a bare select item")
        raise SQLError(f"cannot evaluate {kind} in row context")

    def _call_row(self, fname, args, rel: Relation) -> Column:
        n = rel.n
        if fname in ("to_cofactor", "to_nb_agg"):
            cols = [self._eval(a, rel) for a in args]
            arrays = [(_numeric(c).astype(np.float32) if c.kind in ("f", "b")
                       else c.data.astype(np.int64)) for c in cols]
            batched = (api.to_cofactor if fname == "to_cofactor"
                       else api.to_nb_agg)(*arrays, device=self.device)
            out = np.empty(n, object)
            for r in range(n):
                one = type(batched)(
                    ring_triple._map(lambda a, r=r: a[r],
                                     batched.triple
                                     if hasattr(batched, "triple")
                                     else batched.agg),
                    batched.schema, batched=False)
                one._sql_style = "num"
                out[r] = one
            return Column(out, kind="o")
        if fname in ("multiply_triple", "multiply_nb_agg"):
            a = self._eval(args[0], rel)
            b = self._eval(args[1], rel)
            fn = (api.multiply_triple if fname == "multiply_triple"
                  else api.multiply_nb_agg)
            out = np.empty(n, object)
            for r in range(n):
                v = fn(a.data[r], b.data[r])
                v._sql_style = "num"
                out[r] = v
            return Column(out, a.null | b.null, "o")
        if fname in ("lda_train", "linreg_train", "qda_train", "nb_train",
                     "lda_predict", "linreg_predict", "qda_predict",
                     "nb_predict"):
            return self._call_model(fname, args, rel)
        if fname == "coalesce":
            cols = [self._eval(a, rel) for a in args]
            result = cols[-1]
            for c in reversed(cols[:-1]):
                take = ~c.null
                if c.kind == "o" or result.kind == "o":
                    data = np.where(take, c.data.astype(object),
                                    result.data.astype(object))
                    result = Column(data, np.where(take, c.null,
                                                   result.null), "o")
                else:
                    data = np.where(take, _numeric(c), _numeric(result))
                    kind_out = "f" if "f" in (c.kind, result.kind) else c.kind
                    if kind_out == "f":
                        data = data.astype(np.float64)
                    result = Column(data,
                                    np.where(take, c.null, result.null),
                                    kind_out)
            return result
        if fname == "list_position":
            lst = _const_eval(args[0], self.device)
            col = self._eval(args[1], rel)
            lookup = {v: i + 1 for i, v in enumerate(lst)}  # 1-based
            d = np.asarray([lookup.get(_py(v), 0) for v in col.data],
                           np.int64)
            return Column(d, col.null, "i")
        if fname == "list_extract":
            lst = _const_eval(args[0], self.device)
            idx = self._eval(args[1], rel)
            arr = np.asarray(lst, np.float64)
            pos = np.clip(idx.data.astype(np.int64) - 1, 0, len(arr) - 1)
            null = idx.null | (idx.data <= 0) | (idx.data > len(arr))
            return Column(arr[pos], null, "f")
        if fname == "abs":
            c = self._eval(args[0], rel)
            return Column(np.abs(_numeric(c)), c.null, c.kind)
        if fname in ("sqrt", "ln", "exp", "round", "floor", "ceil"):
            c = self._eval(args[0], rel)
            f = {"sqrt": np.sqrt, "ln": np.log, "exp": np.exp,
                 "round": np.round, "floor": np.floor,
                 "ceil": np.ceil}[fname]
            return Column(f(_numeric(c).astype(np.float64)), c.null, "f")
        raise SQLError(f"unknown function {fname}")

    def _call_model(self, fname, args, rel: Relation) -> Column:
        n = rel.n
        if fname.endswith("_train"):
            # scalar result broadcast over the (single) row context
            sargs = [self._eval_scalar(a, rel, {}) for a in args]
            return _broadcast(_scalar_fn(fname, sargs), n)
        # predict: leading scalar args (params, flags), trailing columns
        n_scalar = {"lda_predict": 2, "qda_predict": 2, "nb_predict": 2,
                    "linreg_predict": 3}[fname]
        sargs = [self._eval_scalar(a, rel, {}) for a in args[:n_scalar]]
        params = np.asarray(sargs[0], np.float32)
        cols = [self._eval(a, rel) for a in args[n_scalar:]]
        arrays = [(_numeric(c).astype(np.float32) if c.kind in ("f", "b")
                   else c.data.astype(np.int64)) for c in cols]
        flags = [bool(f) for f in sargs[1:]]
        fn = getattr(api, fname)
        # linreg_predict's noise takes no generator here, as the JAX module
        # passes no key: the predictor's default stream
        out = np.asarray(fn(params, *flags, *arrays, device=self.device))
        if np.issubdtype(out.dtype, np.floating):
            return Column(out.astype(np.float32), None, "f")
        return Column(out.astype(np.int64), None, "i")

    # -- output ----------------------------------------------------------------
    def _materialize(self, rel: Relation) -> list[tuple]:
        rows = []
        for r in range(rel.n):
            rows.append(tuple(_pyval(c, r) for c in rel.cols))
        return rows

    def to_table(self, name: str):
        """Export a SQL table to a `Table` on the connection's device (MICE
        handoff)."""
        from .table import from_numpy
        rel = self.tables[name]
        num, num_null, num_names = [], [], []
        cat, cat_null, cat_names = [], [], []
        for nm, c in zip(rel.names, rel.cols):
            if c.kind == "f":
                num.append(np.nan_to_num(c.data, nan=0.0))
                num_null.append(c.null)
                num_names.append(nm)
            elif c.kind == "i":
                cat.append(c.data)
                cat_null.append(c.null)
                cat_names.append(nm)
        x = np.stack(num, 0) if num else None
        craw = np.stack(cat, 0) if cat else None
        return from_numpy(
            x.T if x is not None else None,
            craw.T if craw is not None else None,
            np.stack(num_null, 1) if num_null else None,
            np.stack(cat_null, 1) if cat_null else None,
            num_names=num_names, cat_names=cat_names, device=self.device)


# ---------------------------------------------------------------------------
# GROUP BY keys
# ---------------------------------------------------------------------------

def _column_codes(col: Column) -> np.ndarray:
    """i64[n] codes of one key column: two rows share a code iff their
    Python values (`_pyval`) are equal. NULL is one code of its own, a NaN
    value equals nothing (each its own code, as a new float object per row
    compares unequal in a Python tuple), -0.0 equals 0.0. Numeric and
    boolean columns take one vectorised pass; other kinds, a dict of their
    Python values (whose hashing raises for unhashable values, as the JAX
    module's tuple keys do)."""
    n = len(col)
    data = np.asarray(col.data)
    codes = np.empty(n, np.int64)
    valid = ~col.null
    if col.kind in ("f", "i", "b") and data.dtype != object:
        v = data[valid]
        unique_rows = np.zeros(len(v), bool)
        if v.dtype.kind == "f":
            unique_rows = np.isnan(v)
            v = np.where(unique_rows, 0.0, v)
        # np.unique's equality is Python's on numbers: -0.0 = 0.0
        _, inv = np.unique(v, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        k = int(inv.max()) + 1 if len(inv) else 0
        inv[unique_rows] = k + np.arange(int(unique_rows.sum()))
        codes[valid] = inv
        codes[~valid] = k + int(unique_rows.sum())
        return codes
    seen: dict = {}
    for r in range(n):
        codes[r] = seen.setdefault(_pyval(col, r), len(seen))
    return codes


def _group_ids(keys: list[Column]) -> tuple[np.ndarray, np.ndarray]:
    """GROUP BY's group of each row and the first row of each group:
    (gid i64[n], first i64[G]), groups numbered in order of first
    appearance. Two rows share a group iff their key tuples are equal as
    Python tuples of `_pyval` values (the JAX module's dict of tuples),
    computed from each column's codes (`_column_codes`) combined column by
    column."""
    n = len(keys[0])
    code = np.zeros(n, np.int64)
    for col in keys:
        c = _column_codes(col)
        _, code = np.unique(code * (int(c.max(initial=-1)) + 1) + c,
                            return_inverse=True)
        code = code.reshape(-1)
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], first[order]


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def _truthy(col: Column) -> np.ndarray:
    if col.kind == "b":
        return col.data & ~col.null
    return (col.data != 0) & ~col.null


def _py(v):
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _pyval(col: Column, r: int):
    if col.null[r]:
        return None
    v = col.data[r]
    if col.kind == "o":
        if hasattr(v, "to_dict"):
            return v.to_dict(getattr(v, "_sql_style", "agg"))
        if isinstance(v, np.ndarray):
            return [float(x) for x in v]
        if isinstance(v, list):
            return [e.to_dict(getattr(e, "_sql_style", "agg"))
                    if hasattr(e, "to_dict") else _py(e) for e in v]
        return v
    return _py(v)


def _const_eval(e, device):
    """Evaluate a constant expression (INSERT values, list literals); a
    triple literal cast back from text lands on `device`."""
    k = e[0]
    if k == "lit":
        return e[1]
    if k == "neg":
        v = _const_eval(e[1], device)
        return None if v is None else -v
    if k == "list":
        return [_const_eval(c, device) for c in e[1]]
    if k == "structlit":
        return e[1]
    if k == "cast":
        return _apply_cast(_const_eval(e[1], device), e[2], device)
    if k == "arith":
        return _scalar_arith(e[1], _const_eval(e[2], device),
                             _const_eval(e[3], device))
    raise SQLError(f"not a constant expression: {k}")


def _scalar_arith(op, a, b):
    if a is None or b is None:
        return None
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    import math
    return math.fmod(a, b)


def _scalar_cmp(op, a, b):
    if a is None or b is None:
        return None
    if op == "=":
        return a == b
    if op == "<>":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _apply_cast(v, typename: str, device):
    """`expr::TYPE`. A dict ::STRUCT cast re-hydrates a triple/NB aggregate
    on `device` from its SQL text form — the reference round-trips triples
    through ToString() (imputation_base.cpp:46); 4 fields ⇒ NB
    (ML/utils.cpp:72-81)."""
    if v is None:
        return None
    base = typename.rstrip("[]")
    if (base == "struct" and typename.endswith("[]")
            and isinstance(v, (list, tuple))):
        # list of triple literals (qda_train/nb_train take a LIST of
        # per-class aggregates, qda.cpp:27-47); densify against the UNION
        # vocabulary across classes exactly as n_cols_1hot_expansion does
        # over n aggregates (ML/utils.cpp:520-576)
        dicts = list(v)
        nd = len(dicts[0].get("lin_agg", dicts[0].get("lin_num")))
        n_cat = len(dicts[0]["lin_cat"])
        cat_keys = tuple(
            tuple(sorted({int(e["key"]) for d in dicts
                          for e in d["lin_cat"][j]}))
            for j in range(n_cat))
        schema = FeatureSchema(num_cols=nd, cat_keys=cat_keys)
        is_nb = not ("quad_cat" in dicts[0] or "quad_num_cat" in dicts[0])
        out = []
        for d in dicts:
            if is_nb:
                t, _ = serialize.dict_to_nb(d, schema, device=device)
                out.append(api.NBValue(t, schema))
            else:
                t, _ = serialize.dict_to_triple(d, schema, device=device)
                out.append(api.Cofactor(t, schema))
        return out
    if isinstance(v, dict):
        if ("quad_cat" in v or "quad_num_cat" in v
                or len(v) > 4):
            t, schema = serialize.dict_to_triple(v, device=device)
            val = api.Cofactor(t, schema)
        else:
            t, schema = serialize.dict_to_nb(v, device=device)
            val = api.NBValue(t, schema)
        val._sql_style = "agg"
        return val
    if typename.endswith("[]"):
        if base in ("float", "double", "real"):
            return [float(x) for x in v]
        if base in ("integer", "int", "bigint"):
            return [int(x) for x in v]
        return list(v)
    if base in ("float", "double", "real"):
        return float(v)
    if base in ("integer", "int", "bigint"):
        return int(v)
    if base in ("boolean", "bool"):
        return bool(v)
    return v


def _cast_column(col: Column, typename: str, n: int, device) -> Column:
    base = typename.rstrip("[]")
    if col.kind == "o" or typename.endswith("[]") or base == "struct":
        out = np.empty(n, object)
        for r in range(n):
            out[r] = (None if col.null[r]
                      else _apply_cast(col.data[r], typename, device))
        return Column(out, col.null, "o")
    if base in ("float", "double", "real"):
        return Column(_numeric(col).astype(np.float32), col.null, "f")
    if base in ("integer", "int", "bigint"):
        return Column(_numeric(col).astype(np.int64), col.null, "i")
    if base in ("boolean", "bool"):
        return Column(col.data.astype(bool), col.null, "b")
    return col


def _scalar_fn(fname, sargs):
    """Scalar model functions over materialized values (train calls)."""
    if fname == "lda_train":
        triple, label = sargs[0], int(sargs[1])
        shrinkage = float(sargs[2]) if len(sargs) > 2 else 0.0
        normalize = bool(sargs[3]) if len(sargs) > 3 else False
        p = api.lda_train(triple, label, shrinkage, normalize)
        return [float(x) for x in np.asarray(p)]
    if fname == "linreg_train":
        triple, label = sargs[0], int(sargs[1])
        step = float(sargs[2]) if len(sargs) > 2 else 0.001
        lam = float(sargs[3]) if len(sargs) > 3 else 0.0
        iters = int(sargs[4]) if len(sargs) > 4 else 10000
        variance = bool(sargs[5]) if len(sargs) > 5 else False
        normalize = bool(sargs[6]) if len(sargs) > 6 else False
        p = api.linreg_train(triple, label, step, lam, iters, variance,
                             normalize)
        return [float(x) for x in np.asarray(p)]
    if fname == "qda_train":
        triples, labels = sargs[0], sargs[1]
        normalize = bool(sargs[2]) if len(sargs) > 2 else False
        if isinstance(triples, list):
            batched = _stack_cofactors(triples)
        else:
            batched = triples
        p = api.qda_train(batched, np.asarray(labels, np.int64),
                          normalize=normalize)
        return [float(x) for x in np.asarray(p)]
    if fname == "nb_train":
        aggs, labels = sargs[0], sargs[1]
        if isinstance(aggs, list):
            batched = _stack_cofactors(aggs)
        else:
            batched = aggs
        p = api.nb_train(batched, np.asarray(labels, np.int64))
        return [float(x) for x in np.asarray(p)]
    raise SQLError(f"unknown scalar function {fname}")


def _stack_cofactors(values):
    """List of Cofactor/NBValue → one batched value (the reference's
    qda_train takes a LIST of per-class triples, qda.cpp:27-47), stacked
    on the device the values lie on."""
    first = values[0]
    if isinstance(first, api.Cofactor):
        t = ring_triple._map(lambda *xs: torch.stack(xs),
                             *[v.triple for v in values])
        return api.Cofactor(t, first.schema, batched=True)
    t = ring_triple._map(lambda *xs: torch.stack(xs),
                         *[v.agg for v in values])
    return api.NBValue(t, first.schema, batched=True)


def _expr_name(e, i):
    if e[0] == "col":
        return e[1].split(".")[-1]
    if e[0] == "call":
        return e[1]
    return f"col{i}"


def _refs_resolve(e, rel: Relation) -> bool:
    if isinstance(e, list):
        # argument lists (e.g. COALESCE args, CASE arms) recurse into
        # their elements — returning True here hid every column ref
        # inside a function call from the ORDER BY hidden-key logic
        return all(_refs_resolve(c, rel) for c in e)
    if not isinstance(e, tuple):
        return True
    if e[0] == "col":
        try:
            rel.get(e[1])
            return True
        except SQLError:
            return False
    return all(_refs_resolve(c, rel) for c in e
               if isinstance(c, (tuple, list)))


def connect(device="cuda") -> Connection:
    """Open an in-memory database (mirrors duckdb.connect(':memory:')) whose
    aggregates and models run on `device` (the card unless asked
    otherwise)."""
    return Connection(device)
