"""SQL front end: a Spark-SQL SELECT subset compiled to the logical plans
the DataFrame API builds.

Counterpart of ``spark_rapids_tpu/sql.py`` (``session.sql``), trimmed to
what the port lowers.  A hand-written tokenizer and recursive-descent
parser take

  SELECT [DISTINCT] exprs | * FROM t [alias]
    [ [INNER|LEFT|RIGHT|FULL|SEMI|ANTI] JOIN t2 ON a = b [AND ...]
      | JOIN t2 USING (c, ...) | CROSS JOIN t2 ] ...
    [WHERE pred] [GROUP BY exprs | ordinals] [HAVING pred]
    [ORDER BY e [ASC|DESC] [NULLS FIRST|LAST], ...] [LIMIT n]

with arithmetic (``%`` and unary minus included), comparisons, ``<=>``,
AND/OR/NOT, IN lists, [NOT] LIKE, [NOT] RLIKE, BETWEEN, IS [NOT] NULL, CASE
(searched and simple), CAST to every type, ``||``, DATE 'yyyy-mm-dd'
and TIMESTAMP 'yyyy-mm-dd hh:mm:ss' literals, window functions with
OVER (...), subqueries in FROM, and the JAX package's function table
(aggregates with ``first``/``last``, math, strings, date and time,
``rand``).  Views come from ``DataFrame.create_or_replace_temp_view``.

A ``?`` marker takes the next of the values bound to the statement
(``parse_sql(..., params=...)``, which ``session.prepare`` and the
session server's ``submit(..., params=...)`` use) as a ``ParamLiteral``
of its slot; a marker without a value, a value without a marker, or a
NULL value raises ``SqlError``.

The terms of a JOIN's ON clause that are not equalities between the
sides become the join's condition on every join type: an outer join
null-extends a row none of whose matches holds it (TPC-H Q13's
``LEFT OUTER JOIN ... AND o_comment NOT LIKE ...``), which the JAX
package's parser refuses.  What the port cannot run raises ``SqlError``
while the text is parsed (an unknown function) or
``NotImplementedError`` when the query is planned (a gated expression or
cast whose key is off, a non-literal LIKE pattern, a window ``first``).
There is no fallback.

Column references resolve by name against the FROM scope (a qualified
``t.col`` is checked against t's columns); a name in more than one
joined table must be renamed through a subquery, since the planner binds
by name.  The qualifier rides on the attribute (``_sql_qualifier``) so
that the terms of an ON clause find their side.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.columnar import dtypes as _t
from spark_rapids_tpu_torch.columnar.dtypes import STRING, Schema
from spark_rapids_tpu_torch.exprs import arithmetic as ar
from spark_rapids_tpu_torch.exprs import nullexprs as ne
from spark_rapids_tpu_torch.exprs import predicates as pr
from spark_rapids_tpu_torch.exprs import strings as ss
from spark_rapids_tpu_torch.exprs.aggregates import AggregateFunction
from spark_rapids_tpu_torch.exprs.base import Alias, Expression, Literal, \
    ParamLiteral, UnresolvedAttribute
from spark_rapids_tpu_torch.exprs.cast import Cast
from spark_rapids_tpu_torch.exprs.windows import WindowExpression
from spark_rapids_tpu_torch.plan import logical as lp


class SqlError(ValueError):
    pass


def _is_untyped_null(e: Expression) -> bool:
    return isinstance(e, Literal) and getattr(e, "_sql_untyped", False)


def _retype_nulls(exprs: List[Expression]) -> List[Expression]:
    """Give untyped SQL NULLs the type of a non-null sibling (CASE
    branches, coalesce arguments): NULL becomes NullOf(sibling)."""
    sibling = next((e for e in exprs if not _is_untyped_null(e)), None)
    if sibling is None:
        return exprs
    return [ne.NullOf(sibling) if _is_untyped_null(e) else e
            for e in exprs]


def _fold_neg(e: Expression) -> Expression:
    """Unary minus over a numeric literal, folded (IN lists)."""
    if isinstance(e, ar.UnaryMinus) and isinstance(e.children[0], Literal):
        v = e.children[0].value
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return Literal(-v)
    return e


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?
      |\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>`[^`]+`|"[^"]+")
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=>|<=|>=|<>|!=|\|\||[=<>+\-*/%(),.?])
""", re.X)


def tokenize(sql: str) -> List[Tuple[str, str]]:
    toks: List[Tuple[str, str]] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlError(f"cannot tokenize SQL at: {sql[i:i + 30]!r}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        v = m.group()
        if m.lastgroup == "ident":
            toks.append(("IDENT", v))
        elif m.lastgroup == "num":
            toks.append(("NUM", v))
        elif m.lastgroup == "str":
            toks.append(("STR", v[1:-1].replace("''", "'")))
        elif m.lastgroup == "qid":
            toks.append(("IDENT", v[1:-1]))
        else:
            toks.append(("OP", v))
    toks.append(("EOF", ""))
    return toks


# ---------------------------------------------------------------------------
# Functions (SQL name -> expression builder), the port's only
# ---------------------------------------------------------------------------

def _fns():
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.api import Column

    def col_fn(f):
        return lambda args: f(*[Column(a) for a in args]).expr

    def coalesce_fn(args):
        return ne.Coalesce(*_retype_nulls(args))

    def lit_args(f, n_lit):
        # the trailing n_lit arguments must be literals
        def build(args):
            head = [Column(a) for a in args[:-n_lit]]
            tail = []
            for a in args[-n_lit:]:
                if not isinstance(a, Literal):
                    raise SqlError("argument must be a literal")
                tail.append(a.value)
            return f(*head, *tail).expr
        return build

    def rand_fn(args):
        if len(args) > 1:
            raise SqlError("rand() takes at most one seed argument")
        if args and not isinstance(args[0], Literal):
            raise SqlError("rand() seed must be a literal")
        return F.rand(*[a.value for a in args]).expr

    def locate_fn(args):
        if not isinstance(args[0], Literal):
            raise SqlError("locate() substring must be a literal")
        start = 1
        if len(args) > 2:
            if not isinstance(args[2], Literal):
                raise SqlError("locate() start must be a literal")
            start = args[2].value
        return F.locate(args[0].value, Column(args[1]), start).expr

    def concat_ws_fn(args):
        if not isinstance(args[0], Literal):
            raise SqlError("concat_ws() separator must be a literal")
        return F.concat_ws(args[0].value,
                           *[Column(a) for a in args[1:]]).expr

    return {
        "count": lambda args: F.count(
            "*" if args == ["*"] else Column(args[0])).expr,
        "sum": col_fn(F.sum), "min": col_fn(F.min), "max": col_fn(F.max),
        "avg": col_fn(F.avg), "mean": col_fn(F.avg),
        "first": col_fn(F.first), "last": col_fn(F.last),
        "abs": col_fn(F.abs), "sqrt": col_fn(F.sqrt), "exp": col_fn(F.exp),
        "ln": col_fn(F.log), "log": col_fn(F.log),
        "floor": col_fn(F.floor), "ceil": col_fn(F.ceil),
        "ceiling": col_fn(F.ceil),
        "pow": col_fn(F.pow), "power": col_fn(F.pow),
        "pmod": col_fn(F.pmod),
        "coalesce": coalesce_fn, "nvl": coalesce_fn,
        "isnull": col_fn(F.isnull), "isnan": col_fn(F.isnan),
        "nanvl": col_fn(F.nanvl),
        "upper": col_fn(F.upper), "ucase": col_fn(F.upper),
        "lower": col_fn(F.lower), "lcase": col_fn(F.lower),
        "length": col_fn(F.length), "char_length": col_fn(F.length),
        "initcap": col_fn(F.initcap),
        "trim": col_fn(F.trim), "ltrim": col_fn(F.ltrim),
        "rtrim": col_fn(F.rtrim),
        "concat": col_fn(F.concat),
        "substring": col_fn(F.substring), "substr": col_fn(F.substring),
        "instr": lit_args(F.instr, 1),
        "replace": col_fn(F.replace),
        "substring_index": lit_args(F.substring_index, 2),
        "regexp_replace": col_fn(F.regexp_replace),
        "year": col_fn(F.year), "month": col_fn(F.month),
        "day": col_fn(F.dayofmonth), "dayofmonth": col_fn(F.dayofmonth),
        "dayofweek": col_fn(F.dayofweek), "dayofyear": col_fn(F.dayofyear),
        "quarter": col_fn(F.quarter), "hour": col_fn(F.hour),
        "minute": col_fn(F.minute), "second": col_fn(F.second),
        "date_add": col_fn(F.date_add), "date_sub": col_fn(F.date_sub),
        "datediff": col_fn(F.datediff), "last_day": col_fn(F.last_day),
        "unix_timestamp": col_fn(F.unix_timestamp),
        "rand": rand_fn,
        "monotonically_increasing_id":
            lambda args: F.monotonically_increasing_id().expr,
        "spark_partition_id": lambda args: F.spark_partition_id().expr,
        "locate": locate_fn,
        "concat_ws": concat_ws_fn,
    }


_WINDOW_FNS = {"row_number", "rank", "dense_rank", "lag", "lead",
               "sum", "min", "max", "avg", "count", "first", "last"}


def _window_fn(name: str, args):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.api import Column
    n = name.lower()
    if n in ("row_number", "rank", "dense_rank"):
        if args:
            raise SqlError(f"{name}() takes no arguments")
        return getattr(F, n)()
    if n in ("lag", "lead"):
        if not args:
            raise SqlError(f"{name}() needs a column argument")
        off, default = 1, None
        if len(args) > 1:
            if not isinstance(args[1], Literal):
                raise SqlError(f"{name}() offset must be a literal")
            off = int(args[1].value)
        if len(args) > 2:
            if not isinstance(args[2], Literal):
                raise SqlError(f"{name}() default must be a literal")
            default = args[2].value
        return getattr(F, n)(Column(args[0]), off, default)
    if n == "count":
        if not args:
            raise SqlError("count() needs an argument or *")
        return F.count("*" if args == ["*"] else Column(args[0]))
    if not args:
        raise SqlError(f"{name}() needs a column argument")
    return getattr(F, n)(Column(args[0]))


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Scope:
    """FROM-clause name resolution: alias -> schema."""

    def __init__(self):
        self.tables: List[Tuple[str, Schema]] = []

    def add(self, alias: str, schema: Schema) -> None:
        self.tables.append((alias.lower(), schema))

    def resolve(self, qualifier: Optional[str], name: str,
                qualified_dup_ok: bool = False) -> str:
        hits = []      # matches under the requested qualifier
        all_hits = 0   # matches across every table
        for alias, schema in self.tables:
            for f in schema:
                if f.name.lower() == name.lower():
                    all_hits += 1
                    if qualifier is None or alias == qualifier.lower():
                        hits.append(f.name)
        if not hits:
            q = f"{qualifier}." if qualifier else ""
            raise SqlError(f"column {q}{name} not found in FROM scope")
        # the planner binds by name, so a name in more than one joined
        # table cannot be addressed even with a qualifier; the ON keys of
        # a join bind per side, so a qualified one is fine there
        if qualified_dup_ok and qualifier is not None:
            if len(hits) > 1:
                raise SqlError(f"column {qualifier}.{name} is ambiguous")
            return hits[0]
        if all_hits > 1:
            raise SqlError(
                f"column {name} appears in multiple joined tables; the "
                "planner binds by name: rename it through a subquery "
                "projection first")
        return hits[0]

    def all_fields(self, qualifier: Optional[str] = None):
        out = []
        for alias, schema in self.tables:
            if qualifier is not None and alias != qualifier.lower():
                continue
            out.extend(schema.fields)
        return out


_CLAUSE_KWS = ("FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT",
               "UNION")
_JOIN_KWS = ("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "SEMI",
             "ANTI", "ON", "USING")


class _Parser:
    def __init__(self, toks, session, params=None):
        self.toks = toks
        self.i = 0
        self.session = session
        self.fns = _fns()
        self.scope = _Scope()
        # the values bound to ``?`` markers, taken in order
        self._params = params
        self._param_pos = 0
        # ORDER BY may name select-list aliases that exist only after the
        # projection: those resolve when the plan binds
        self._lenient_refs = False
        # the ON keys of a join bind per side
        self._on_join_refs = False

    # -- token helpers ------------------------------------------------------
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        k, v = self.peek()
        return k == "IDENT" and v.upper() in kws

    def accept_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise SqlError(f"expected {kw} at {self.peek()[1]!r}")

    def accept_op(self, op: str) -> bool:
        k, v = self.peek()
        if k == "OP" and v == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r} at {self.peek()[1]!r}")

    # -- entry --------------------------------------------------------------
    def parse(self):
        df = self.parse_select()
        if self.peek()[0] != "EOF":
            raise SqlError(f"unexpected trailing input: {self.peek()[1]!r}")
        return df

    # -- SELECT -------------------------------------------------------------
    def parse_select(self):
        # each SELECT owns its FROM scope: a subquery's aliases stay in it
        outer_scope = self.scope
        self.scope = _Scope()
        try:
            return self._parse_select_body()
        finally:
            self.scope = outer_scope

    def _parse_select_body(self):
        from spark_rapids_tpu_torch.api import DataFrame
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        # the select list names the FROM scope, which comes later: skip
        # its tokens (minding parentheses), parse FROM, then come back
        items_start = self.i
        depth = 0
        while True:
            k, v = self.peek()
            if k == "EOF":
                raise SqlError("SELECT without FROM")
            if k == "OP" and v == "(":
                depth += 1
            elif k == "OP" and v == ")":
                depth -= 1
            elif depth == 0 and k == "IDENT" and v.upper() == "FROM":
                break
            self.next()
        items_end = self.i
        self.expect_kw("FROM")
        df = self.parse_from()
        save_toks, save_i = self.toks, self.i
        self.toks = self.toks[items_start:items_end] + [("EOF", "")]
        self.i = 0
        items = self.parse_select_items()
        if self.peek()[0] != "EOF":
            raise SqlError(
                f"unexpected token in select list: {self.peek()[1]!r}")
        self.toks, self.i = save_toks, save_i
        if self.accept_kw("WHERE"):
            df = df.filter(self.parse_expr())
        group_keys: List[Expression] = []
        grouped = False
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            grouped = True
            group_keys.append(self.parse_expr())
            while self.accept_op(","):
                group_keys.append(self.parse_expr())
            group_keys = self._group_ordinals(group_keys, items)
        having = None
        if self.accept_kw("HAVING"):
            having = self.parse_expr()
        order = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            self._lenient_refs = True
            try:
                order.append(self.parse_order_item())
                while self.accept_op(","):
                    order.append(self.parse_order_item())
            finally:
                self._lenient_refs = False
        limit = None
        if self.accept_kw("LIMIT"):
            k, v = self.next()
            if k != "NUM":
                raise SqlError("LIMIT expects a number")
            limit = int(v)

        df, rewrite, out_items, item_keys = self.assemble(
            df, items, grouped, group_keys, having)
        if distinct:
            df = df.distinct()
        if order:
            df = DataFrame(self.session, lp.Sort(
                self._order_keys(df, order, rewrite, out_items, item_keys),
                df.plan))
        if limit is not None:
            df = df.limit(limit)
        return df

    def _group_ordinals(self, group_keys, items):
        """GROUP BY <ordinal> names the n-th select column, counted after
        star expansion (as ORDER BY counts)."""
        def ordinal(g):
            return isinstance(g, Literal) and isinstance(g.value, int) \
                and not isinstance(g.value, bool)
        if not any(ordinal(g) for g in group_keys):
            return group_keys
        expanded = []
        for e, _alias in items:
            if isinstance(e, tuple) and e[0] == "star":
                expanded += [UnresolvedAttribute(f.name)
                             for f in self.scope.all_fields(e[1])]
            else:
                expanded.append(e)
        out = []
        for g in group_keys:
            if ordinal(g):
                if not 1 <= g.value <= len(expanded):
                    raise SqlError(
                        f"GROUP BY position {g.value} is out of range")
                g = expanded[g.value - 1]
            out.append(g)
        return out

    def _order_keys(self, df, order, rewrite, out_items, item_keys):
        out_names = {f.name for f in df.plan.output_schema()}
        fixed = []
        for e, asc, nf in order:
            if isinstance(e, Literal) and isinstance(e.value, int) \
                    and not isinstance(e.value, bool):
                # ORDER BY <ordinal> names the n-th select column
                if not 1 <= e.value <= len(out_items):
                    raise SqlError(
                        f"ORDER BY position {e.value} is out of range")
                e = UnresolvedAttribute(out_items[e.value - 1])
            elif e.key() in item_keys:
                # the expression is a select item: its output column
                e = UnresolvedAttribute(out_items[item_keys.index(e.key())])
            elif rewrite is not None:
                # aggregates and group-key expressions map to their
                # columns after the aggregate, which the select list must
                # carry through
                e = rewrite(e)
                if not _attr_names(e) <= out_names:
                    raise SqlError("ORDER BY expression must appear in the "
                                   "select list")
            fixed.append((e, asc, nf))
        return fixed

    def parse_select_items(self):
        items = []  # (expr | ("star", qualifier), alias | None)
        while True:
            if self.accept_op("*"):
                items.append((("star", None), None))
            elif self.peek()[0] == "IDENT" and \
                    self.peek(1) == ("OP", ".") and \
                    self.peek(2) == ("OP", "*"):
                q = self.next()[1]
                self.next()
                self.next()
                items.append((("star", q), None))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept_kw("AS"):
                    alias = self.next()[1]
                elif self.peek()[0] == "IDENT" and not self.at_kw(
                        *_CLAUSE_KWS):
                    alias = self.next()[1]
                items.append((e, alias))
            if not self.accept_op(","):
                return items

    def parse_order_item(self):
        e = self.parse_expr()
        asc = True
        if self.accept_kw("DESC"):
            asc = False
        else:
            self.accept_kw("ASC")
        nf = asc  # Spark: nulls first ascending, last descending
        if self.accept_kw("NULLS"):
            if self.accept_kw("FIRST"):
                nf = True
            else:
                self.expect_kw("LAST")
                nf = False
        return (e, asc, nf)

    # -- FROM / JOIN --------------------------------------------------------
    def parse_from(self):
        df = self.parse_table_ref()
        while True:
            how = None
            if self.accept_kw("CROSS"):
                how = "cross"
            elif self.accept_kw("INNER"):
                how = "inner"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                side = self.next()[1].upper()
                self.accept_kw("OUTER")
                if side == "LEFT" and self.accept_kw("SEMI"):
                    how = "semi"
                elif side == "LEFT" and self.accept_kw("ANTI"):
                    how = "anti"
                else:
                    how = side.lower()
            elif self.accept_kw("SEMI"):
                how = "semi"
            elif self.accept_kw("ANTI"):
                how = "anti"
            elif self.at_kw("JOIN"):
                how = "inner"
            if how is None:
                return df
            self.expect_kw("JOIN")
            right = self.parse_table_ref()
            df = self.parse_join_tail(df, right, how)

    def parse_join_tail(self, left, right, how):
        from spark_rapids_tpu_torch.api import DataFrame
        if self.accept_kw("USING"):
            self.expect_op("(")
            names = [self.next()[1]]
            while self.accept_op(","):
                names.append(self.next()[1])
            self.expect_op(")")
            # the output holds one copy of each USING column: drop them
            # from the right table's scope entry, so the merged column
            # resolves unambiguously
            r_alias, r_schema = self.scope.tables[-1]
            lowered = {n.lower() for n in names}
            self.scope.tables[-1] = (r_alias, Schema(
                [f for f in r_schema if f.name.lower() not in lowered]))
            return left.join(right, names, how)
        if how == "cross":
            return DataFrame(self.session, lp.Join(
                left.plan, right.plan, [], [], "cross"))
        self.expect_kw("ON")
        self._on_join_refs = True
        try:
            cond_e = self.parse_expr()
        finally:
            self._on_join_refs = False
        lnames = {f.name.lower() for f in left.plan.output_schema()}
        rnames = {f.name.lower() for f in right.plan.output_schema()}
        # the table just parsed is the join's right side; every earlier
        # alias belongs to the left side built so far
        right_alias = self.scope.tables[-1][0]
        left_aliases = {a for a, _ in self.scope.tables[:-1]}

        def side_of(e) -> Optional[str]:
            sides = set()

            def walk(x):
                if isinstance(x, UnresolvedAttribute):
                    q = getattr(x, "_sql_qualifier", None)
                    n = x.col_name.lower()
                    if q == right_alias:
                        sides.add("r")
                    elif q in left_aliases:
                        sides.add("l")
                    elif n in lnames and n not in rnames:
                        sides.add("l")
                    elif n in rnames and n not in lnames:
                        sides.add("r")
                    else:
                        sides.add("?")
                for c in x.children:
                    walk(c)
            walk(e)
            return next(iter(sides)) if sides in ({"l"}, {"r"}) else None

        lkeys, rkeys, residual = [], [], []

        def collect(e):
            if isinstance(e, pr.And):
                collect(e.children[0])
                collect(e.children[1])
                return
            if isinstance(e, pr.EqualTo):
                a, b = e.children
                sa, sb = side_of(a), side_of(b)
                if (sa, sb) == ("l", "r"):
                    lkeys.append(a)
                    rkeys.append(b)
                    return
                if (sa, sb) == ("r", "l"):
                    lkeys.append(b)
                    rkeys.append(a)
                    return
            # any other term rides as the join's condition: a hash join
            # on the equalities, then a filter on the rest
            residual.append(e)
        collect(cond_e)
        if not lkeys:
            raise SqlError(
                "JOIN ON needs at least one equality between the sides")
        cond = None
        for t in residual:
            cond = t if cond is None else pr.And(cond, t)
        return DataFrame(self.session, lp.Join(
            left.plan, right.plan, lkeys, rkeys, how, condition=cond))

    def parse_table_ref(self):
        if self.accept_op("("):
            df = self.parse_select()
            self.expect_op(")")
            alias = None
            if self.accept_kw("AS"):
                alias = self.next()[1]
            elif self.peek()[0] == "IDENT" and not self.at_kw(
                    *_JOIN_KWS, *_CLAUSE_KWS):
                alias = self.next()[1]
            self.scope.add(alias or f"_subq{len(self.scope.tables)}",
                           df.plan.output_schema())
            return df
        k, name = self.next()
        if k != "IDENT":
            raise SqlError(f"expected table name, got {name!r}")
        df = self.session.table(name)
        alias = name
        if self.accept_kw("AS"):
            alias = self.next()[1]
        elif self.peek()[0] == "IDENT" and not self.at_kw(
                *_JOIN_KWS, *_CLAUSE_KWS):
            alias = self.next()[1]
        self.scope.add(alias, df.plan.output_schema())
        return df

    # -- assembly -----------------------------------------------------------
    def assemble(self, df, items, grouped, group_keys, having):
        """The select list over ``df``, through an aggregate when the
        query groups or aggregates -> (DataFrame, the rewrite of an
        expression onto the aggregate's columns or None, output names,
        the items' keys)."""
        from spark_rapids_tpu_torch.api import DataFrame, \
            _extract_window_exprs
        all_names = [f.name.lower() for f in self.scope.all_fields(None)]
        expanded = []
        for e, alias in items:
            if isinstance(e, tuple) and e[0] == "star":
                for f in self.scope.all_fields(e[1]):
                    if all_names.count(f.name.lower()) > 1:
                        raise SqlError(
                            f"column {f.name} appears in multiple joined "
                            "tables; * cannot expand it: rename it "
                            "through a subquery projection")
                    expanded.append((UnresolvedAttribute(f.name), None))
            else:
                expanded.append((e, alias))
        items = expanded
        out_names = [alias or _auto_name(e).name for e, alias in items]
        item_keys = [e.key() for e, _ in items]
        has_agg = any(_find_aggs(e) for e, _ in items) or \
            (having is not None and bool(_find_aggs(having)))
        if not (grouped or has_agg):
            if having is not None:
                raise SqlError("HAVING requires GROUP BY or aggregates")
            exprs = [Alias(e, alias) if alias else _auto_name(e)
                     for e, alias in items]
            exprs, plan = _extract_window_exprs(exprs, df.plan)
            return (DataFrame(self.session, lp.Project(exprs, plan)), None,
                    out_names, item_keys)

        if any(_has_window(e) for e, _ in items):
            raise SqlError("window functions over an aggregated query are "
                           "not supported; aggregate in a subquery first")
        # the distinct aggregate calls of the select list and HAVING
        aggs: List[AggregateFunction] = []
        agg_names = {}
        for e in [e for e, _ in items] + ([having] if having else []):
            for a in _find_aggs(e):
                if a.key() not in agg_names:
                    agg_names[a.key()] = f"_agg{len(aggs)}"
                    aggs.append(a)
        # expression group keys get names the select list and ORDER BY
        # can refer to after the aggregate
        key_map = {}
        keys_out = []
        for i, g in enumerate(group_keys):
            if isinstance(g, UnresolvedAttribute):
                key_map[g.key()] = g.col_name
                keys_out.append(g)
            else:
                key_map[g.key()] = f"_key{i}"
                keys_out.append(Alias(g, f"_key{i}"))

        # outside aggregate calls the select list may name group keys
        # only: a bare column fails here, not later at binding
        def check_grouping(e: Expression) -> None:
            if isinstance(e, AggregateFunction) or e.key() in key_map:
                return
            if isinstance(e, UnresolvedAttribute):
                raise SqlError(
                    f"column {e.col_name!r} must appear in GROUP BY or "
                    "inside an aggregate function")
            for c in e.children:
                check_grouping(c)
        for e, _ in items:
            check_grouping(e)

        agg_df = DataFrame(self.session, lp.Aggregate(
            keys_out, [Alias(a, agg_names[a.key()]) for a in aggs],
            df.plan))

        def rewrite(e: Expression) -> Expression:
            if isinstance(e, AggregateFunction):
                name = agg_names.get(e.key())
                if name is None:
                    raise SqlError("an aggregate in ORDER BY must also "
                                   "appear in the select list")
                return UnresolvedAttribute(name)
            if e.key() in key_map:
                return UnresolvedAttribute(key_map[e.key()])
            if not e.children:
                return e
            return e.with_children([rewrite(c) for c in e.children])

        out = agg_df
        if having is not None:
            out = out.filter(rewrite(having))
        exprs = []
        for e, alias in items:
            r = rewrite(e)
            exprs.append(Alias(r, alias) if alias else _auto_name(r))
        return (DataFrame(self.session, lp.Project(exprs, out.plan)),
                rewrite, out_names, item_keys)

    # -- expressions (precedence climbing) ----------------------------------
    def parse_expr(self) -> Expression:
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.accept_kw("OR"):
            e = pr.Or(e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept_kw("AND"):
            e = pr.And(e, self.parse_not())
        return e

    def parse_not(self):
        if self.accept_kw("NOT"):
            return pr.Not(self.parse_not())
        return self.parse_cmp()

    _CMP = {"=": pr.EqualTo, "<=>": pr.EqualNullSafe,
            "<>": pr.NotEqual, "!=": pr.NotEqual,
            "<": pr.LessThan, "<=": pr.LessThanOrEqual,
            ">": pr.GreaterThan, ">=": pr.GreaterThanOrEqual}

    def parse_cmp(self):
        e = self.parse_add()
        while True:
            k, v = self.peek()
            if k == "OP" and v in self._CMP:
                self.next()
                e = self._CMP[v](e, self.parse_add())
                continue
            if self.accept_kw("IS"):
                neg = self.accept_kw("NOT")
                self.expect_kw("NULL")
                e = pr.IsNotNull(e) if neg else pr.IsNull(e)
                continue
            save = self.i
            neg = self.accept_kw("NOT")
            if self.accept_kw("IN"):
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                lits = []
                for x in vals:
                    x = _fold_neg(x)
                    if not isinstance(x, Literal):
                        raise SqlError("IN list must be literals")
                    lits.append(x.value)
                e = pr.In(e, lits)
                if neg:
                    e = pr.Not(e)
                continue
            if self.at_kw("LIKE", "RLIKE"):
                kind = self.next()[1].upper()
                pat = self.parse_add()
                e = ss.Like(e, pat) if kind == "LIKE" else ss.RLike(e, pat)
                if neg:
                    e = pr.Not(e)
                continue
            if self.accept_kw("BETWEEN"):
                lo = self.parse_add()
                self.expect_kw("AND")
                hi = self.parse_add()
                rng = pr.And(pr.GreaterThanOrEqual(e, lo),
                             pr.LessThanOrEqual(e, hi))
                e = pr.Not(rng) if neg else rng
                continue
            if neg:
                self.i = save  # the NOT belongs to something else
            return e

    def parse_add(self):
        e = self.parse_mul()
        while True:
            k, v = self.peek()
            if k == "OP" and v in ("+", "-"):
                self.next()
                rhs = self.parse_mul()
                e = ar.Add(e, rhs) if v == "+" else ar.Subtract(e, rhs)
            elif k == "OP" and v == "||":
                self.next()
                e = ss.Concat(e, self.parse_mul())
            else:
                return e

    def parse_mul(self):
        e = self.parse_unary()
        while True:
            k, v = self.peek()
            if k == "OP" and v in ("*", "/", "%"):
                self.next()
                rhs = self.parse_unary()
                e = {"*": ar.Multiply, "/": ar.Divide,
                     "%": ar.Remainder}[v](e, rhs)
            else:
                return e

    def parse_unary(self):
        if self.accept_op("-"):
            return ar.UnaryMinus(self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expression:
        k, v = self.peek()
        if k == "NUM":
            self.next()
            if re.search(r"[.eE]", v):
                return Literal(float(v))
            return Literal(int(v))
        if k == "STR":
            self.next()
            return Literal(v)
        if k == "OP" and v == "?":
            self.next()
            if self._params is None:
                raise SqlError(
                    "parameter marker '?' without bindings: prepare the "
                    "statement (session.prepare) and execute it with "
                    "values")
            if self._param_pos >= len(self._params):
                raise SqlError(f"statement has more '?' markers than the "
                               f"{len(self._params)} value(s) bound")
            slot = self._param_pos
            self._param_pos += 1
            value = self._params[slot]
            if value is None:
                raise SqlError("NULL prepared-statement bindings are not "
                               "supported: inline NULL in the template")
            return ParamLiteral(slot, value)
        if self.accept_op("("):
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if k != "IDENT":
            raise SqlError(f"unexpected token {v!r}")
        up = v.upper()
        if up == "NULL":
            self.next()
            null = Literal(None, STRING)
            null._sql_untyped = True  # takes a sibling's type: _retype_nulls
            return null
        if up in ("TRUE", "FALSE"):
            self.next()
            return Literal(up == "TRUE")
        if up == "DATE" and self.peek(1)[0] == "STR":
            self.next()
            return Literal(_dt.date.fromisoformat(self.next()[1]))
        if up == "TIMESTAMP" and self.peek(1)[0] == "STR":
            self.next()
            return Literal(_dt.datetime.fromisoformat(self.next()[1]))
        if up == "CAST":
            return self.parse_cast()
        if up == "CASE":
            return self.parse_case()
        if self.peek(1) == ("OP", "("):
            return self.parse_call(v)
        # a column reference, maybe qualified
        self.next()
        if self.peek() == ("OP", "."):
            self.next()
            name = self.next()[1]
            try:
                attr = UnresolvedAttribute(self.scope.resolve(
                    v, name, qualified_dup_ok=self._on_join_refs))
                attr._sql_qualifier = v.lower()
                return attr
            except SqlError:
                if self._lenient_refs:
                    return UnresolvedAttribute(name)
                raise
        try:
            return UnresolvedAttribute(self.scope.resolve(None, v))
        except SqlError:
            if self._lenient_refs:
                return UnresolvedAttribute(v)
            raise

    def parse_cast(self):
        self.next()
        self.expect_op("(")
        e = self.parse_expr()
        self.expect_kw("AS")
        tname = self.next()[1]
        try:
            to = _t.from_name(tname)
        except ValueError:
            raise SqlError(f"unknown type {tname.lower()}") from None
        self.expect_op(")")
        return Cast(e, to)

    def parse_call(self, v: str):
        self.next()
        self.expect_op("(")
        fn = self.fns.get(v.lower())
        if fn is None and v.lower() not in _WINDOW_FNS:
            raise SqlError(f"function {v} is unknown or not in the torch "
                           "port")
        args: list = []
        if not self.accept_op(")"):
            args.append("*" if self.accept_op("*") else self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
        if self.at_kw("OVER"):
            if v.lower() not in _WINDOW_FNS:
                raise SqlError(f"{v} is not usable as a window function")
            return self.parse_over(_window_fn(v, args))
        if fn is None:
            raise SqlError(f"{v}() requires an OVER (...) clause")
        return fn(args)

    def parse_over(self, col) -> Expression:
        """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame])."""
        from spark_rapids_tpu_torch.api import WindowSpec
        self.expect_kw("OVER")
        self.expect_op("(")
        parts, orders = [], []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            parts.append(self.parse_expr())
            while self.accept_op(","):
                parts.append(self.parse_expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            orders.append(self.parse_order_item())
            while self.accept_op(","):
                orders.append(self.parse_order_item())
        if not (parts or orders):
            raise SqlError("OVER () needs PARTITION BY and/or ORDER BY")
        spec = WindowSpec(parts, orders)
        if self.at_kw("ROWS", "RANGE"):
            kind = self.next()[1].upper()
            self.expect_kw("BETWEEN")
            lo = self.parse_frame_bound()
            self.expect_kw("AND")
            hi = self.parse_frame_bound()
            spec = spec.rows_between(lo, hi) if kind == "ROWS" \
                else spec.range_between(lo, hi)
        self.expect_op(")")
        return col.over(spec).expr

    def parse_frame_bound(self):
        from spark_rapids_tpu_torch.api import Window
        if self.accept_kw("UNBOUNDED"):
            if self.accept_kw("PRECEDING"):
                return Window.unboundedPreceding
            self.expect_kw("FOLLOWING")
            return Window.unboundedFollowing
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return 0
        if self.accept_op("-"):
            raise SqlError("frame bounds take a non-negative count with "
                           "PRECEDING/FOLLOWING direction")
        k, v = self.next()
        if k != "NUM":
            raise SqlError("frame bound expects a number")
        n = float(v) if re.search(r"[.eE]", v) else int(v)
        if self.accept_kw("PRECEDING"):
            return -n
        self.expect_kw("FOLLOWING")
        return n

    def parse_case(self):
        from spark_rapids_tpu_torch.exprs.conditional import CaseWhen
        self.expect_kw("CASE")
        subject = None if self.at_kw("WHEN") else self.parse_expr()
        branches = []
        while self.accept_kw("WHEN"):
            c = self.parse_expr()
            if subject is not None:
                c = pr.EqualTo(subject, c)
            self.expect_kw("THEN")
            branches.append((c, self.parse_expr()))
        if not branches:
            raise SqlError("CASE needs at least one WHEN")
        otherwise = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        # untyped NULLs among the values take a sibling value's type
        vals = _retype_nulls([t for _, t in branches] + (
            [otherwise] if otherwise is not None else []))
        branches = [(c, t) for (c, _), t in zip(branches, vals)]
        if otherwise is not None:
            otherwise = vals[-1]
        return CaseWhen(branches, otherwise)


def _attr_names(e: Expression) -> set:
    out = {e.col_name} if isinstance(e, UnresolvedAttribute) else set()
    for c in e.children:
        out |= _attr_names(c)
    return out


def _has_window(e: Expression) -> bool:
    return isinstance(e, WindowExpression) or \
        any(_has_window(c) for c in e.children)


def _find_aggs(e: Expression) -> List[AggregateFunction]:
    """The aggregate calls of ``e``, not inside window expressions
    (``SUM(x) OVER (...)`` is a window function)."""
    if isinstance(e, WindowExpression):
        return []
    if isinstance(e, AggregateFunction):
        return [e]
    return [a for c in e.children for a in _find_aggs(c)]


def _auto_name(e: Expression) -> Expression:
    """A select item without an alias: itself when it names a column,
    else aliased by its display name."""
    if isinstance(e, (UnresolvedAttribute, Alias)):
        return e
    return Alias(e, e.name)


def parse_sql(sql: str, session, params=None):
    """SQL text -> DataFrame; raises ``SqlError`` on what it cannot
    parse or the port cannot run.  ``params`` binds the ``?`` markers in
    order."""
    p = _Parser(tokenize(sql), session, params=params)
    df = p.parse()
    if params is not None and p._param_pos != len(params):
        raise SqlError(f"statement has {p._param_pos} '?' marker(s) but "
                       f"{len(params)} value(s) were bound")
    return df


def count_params(sql: str) -> int:
    """The ``?`` markers of a statement (tokenized: none inside string
    literals or comments)."""
    return sum(1 for k, v in tokenize(sql) if k == "OP" and v == "?")
