"""Plan and input-snapshot fingerprints, and prepared-statement binding.

Counterpart of ``spark_rapids_tpu/plan/fingerprint.py``.  The session
server's result cache and prepared statements need a stable identity
for "the same query over the same data":

* ``plan_fingerprint``: a structural digest of a logical plan in which a
  ``ParamLiteral`` contributes its slot and type but not its value, so
  two bindings of one template share it (their values ride in the cache
  key beside it: ``bound_param_values``), while an inline literal's
  value is part of the query.  Every attribute of every node and
  expression goes in, not ``Expression.key()`` alone, so two
  expressions that differ only in state outside their children (a
  cast's type, a pattern) never share a digest.
* ``snapshot_fingerprint``: a digest of what every leaf holds now.  A
  file leaf contributes each file's path, mtime and size, a parquet
  file its footer tail bytes too (``leaf_file_tokens``), so a rewritten
  file changes the key; an in-memory relation its
  columns' object identity, row count and bytes, and the cache entry
  pins the columns, so a recycled ``id()`` never aliases a dead table;
  a range nothing.  A plan over a leaf whose snapshot cannot be made (a
  missing file, an unknown leaf) gives ``None``: the cache skips it.
* ``bind_params``: a fresh copy of a prepared template with new values
  in its ``ParamLiteral`` slots (templates are shared by concurrent
  clients and never change).
* ``conf_fingerprint``: a digest of the conf keys that can change a
  query's rows.
"""

from __future__ import annotations

import copy
import hashlib
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType, Field, Schema
from spark_rapids_tpu_torch.exprs.base import Expression, ParamLiteral
from spark_rapids_tpu_torch.plan import logical as lp

# node attributes outside a plan's structural identity
_SKIP_ATTRS = frozenset({"children"})


# ---------------------------------------------------------------------------
# mapping expressions over a plan
# ---------------------------------------------------------------------------

def _map_value(value, fn: Callable[[Expression], Expression]):
    """``fn`` over every Expression inside one node attribute: a bare
    expression, lists and tuples of them (order triples, window pairs,
    projection lists)."""
    if isinstance(value, Expression):
        return fn(value)
    if isinstance(value, list):
        return [_map_value(v, fn) for v in value]
    if isinstance(value, tuple):
        return tuple(_map_value(v, fn) for v in value)
    return value


def map_plan_exprs(plan: lp.LogicalPlan,
                   fn: Callable[[Expression], Expression]) -> lp.LogicalPlan:
    """A copy of ``plan`` with ``fn`` applied to every expression tree it
    carries; the input plan is left as it is."""
    node = copy.copy(plan)
    for name, value in list(vars(node).items()):
        if name not in _SKIP_ATTRS:
            node.__dict__[name] = _map_value(value, fn)
    node.children = [map_plan_exprs(c, fn) for c in plan.children]
    return node


def _rewrite_params(e: Expression, values: Sequence) -> Expression:
    if isinstance(e, ParamLiteral):
        return ParamLiteral(e.slot, values[e.slot], e._dtype)
    if not e.children:
        return e
    new = [_rewrite_params(c, values) for c in e.children]
    if all(a is b for a, b in zip(new, e.children)):
        return e
    return e.with_children(new)


def bind_params(plan: lp.LogicalPlan, values: Sequence) -> lp.LogicalPlan:
    """A fresh copy of a prepared template, each ``ParamLiteral`` slot
    holding ``values[slot]``.  The caller keeps the values' types those
    of the template (``server/prepared.py`` keeps a template a type
    signature), so the schema does not change."""
    return map_plan_exprs(plan, lambda e: _rewrite_params(e, values))


# ---------------------------------------------------------------------------
# plan fingerprint
# ---------------------------------------------------------------------------

def _value_fp(v, depth: int = 0) -> str:
    if depth > 32:
        raise ValueError("plan attribute nested too deep to fingerprint")
    if isinstance(v, ParamLiteral):
        return f"param[{v.slot}:{v.dtype.name}]"
    if isinstance(v, Expression):
        own = ";".join(f"{k}={_value_fp(x, depth + 1)}"
                       for k, x in sorted(vars(v).items())
                       if k not in _SKIP_ATTRS)
        kids = ",".join(_value_fp(c, depth + 1) for c in v.children)
        return f"{type(v).__name__}({own})[{kids}]"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value_fp(x, depth + 1) for x in v) + "]"
    if isinstance(v, Schema):
        return "schema(" + ",".join(_value_fp(f, depth + 1)
                                    for f in v.fields) + ")"
    if isinstance(v, Field):
        return f"{v.name}:{v.dtype.name}:{int(bool(v.nullable))}"
    if isinstance(v, DataType):
        return v.name
    if isinstance(v, dict):
        # a LocalRelation's host columns: their shape only, what they
        # hold belongs to the snapshot fingerprint
        rows = len(next(iter(v.values()))[0]) if v else 0
        return f"columns({rows}x{len(v)})"
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_value_fp(x, depth + 1)
                                     for x in v)) + "}"
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        digest = hashlib.sha256(np.ascontiguousarray(a).tobytes())
        return f"array({a.dtype},{a.shape},{digest.hexdigest()})"
    if hasattr(v, "__dict__"):
        own = ";".join(f"{k}={_value_fp(x, depth + 1)}"
                       for k, x in sorted(vars(v).items()))
        return f"{type(v).__name__}({own})"
    return repr(v)


def _node_fp(node: lp.LogicalPlan) -> str:
    own = ";".join(f"{k}={_value_fp(v)}" for k, v in sorted(vars(node).items())
                   if k not in _SKIP_ATTRS)
    kids = ",".join(_node_fp(c) for c in node.children)
    return f"{node.node_name}({own})[{kids}]"


def plan_fingerprint(plan: lp.LogicalPlan) -> str:
    """The structural digest of a plan, parameter values masked."""
    return hashlib.sha256(_node_fp(plan).encode()).hexdigest()


def bound_param_values(plan: lp.LogicalPlan) -> tuple:
    """The ``(slot, value)`` pairs of every ParamLiteral in a plan, by
    slot: the cache key carries them beside the masked fingerprint, so a
    DataFrame made by ``stmt.bind(x)`` and submitted as is never meets
    another binding's entry."""
    found = {}

    def scan(e: Expression) -> None:
        if isinstance(e, ParamLiteral):
            found[e.slot] = e.value
        for c in e.children:
            scan(c)

    def walk_value(v) -> None:
        if isinstance(v, Expression):
            scan(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk_value(x)

    def walk(node: lp.LogicalPlan) -> None:
        for k, v in vars(node).items():
            if k not in _SKIP_ATTRS:
                walk_value(v)
        for c in node.children:
            walk(c)

    walk(plan)
    return tuple(sorted(found.items()))


# conf keys that never change a query's rows: the server's sizing,
# deadlines (a tenant's timeout must not split the cache across
# tenants), observation, and the fleet and stream keys
_RESULT_NEUTRAL_PREFIXES = (
    "spark.rapids.server.",
    "spark.rapids.sql.obs.",
    "spark.rapids.sql.trace.",
    "spark.rapids.sql.compile.",
    "spark.rapids.fleet.",
    "spark.rapids.stream.",
)
_RESULT_NEUTRAL_KEYS = frozenset({
    "spark.rapids.sql.queryTimeoutMs",
    "spark.rapids.sql.cancel.checkIntervalMs",
    "spark.rapids.sql.watchdog.hangTimeoutMs",
})


def conf_fingerprint(conf) -> str:
    """Digest of the conf settings that could change a query's result;
    every key but the result-neutral ones keys the cache."""
    items = sorted((k, str(v)) for k, v in conf.to_dict().items()
                   if k not in _RESULT_NEUTRAL_KEYS
                   and not k.startswith(_RESULT_NEUTRAL_PREFIXES))
    return hashlib.sha256(repr(items).encode()).hexdigest()


# ---------------------------------------------------------------------------
# input snapshot fingerprint
# ---------------------------------------------------------------------------

def _file_tokens(paths, expand, tail=None
                 ) -> Optional[List[Tuple[str, str]]]:
    """One ``(path, "path:mtime_ns:size[:tail]")`` pair a file, or None
    when a file cannot be stat'ed or there is none."""
    try:
        files = expand(paths)
        if not files:
            return None
        out = []
        for f in files:
            st = os.stat(f)
            mark = f":{tail(f)}" if tail is not None else ""
            out.append((f, f"{f}:{st.st_mtime_ns}:{st.st_size}{mark}"))
        return out
    except OSError:
        return None


def leaf_file_tokens(node: lp.LogicalPlan
                     ) -> Optional[List[Tuple[str, str]]]:
    """The ``(path, token)`` pairs of a file relation (None for another
    node, or one that cannot be snapshot): the one spelling the result
    cache's key, its maintenance diff and the stream's tailing sources
    share, so the three agree on what changed.  A parquet file's token
    carries its footer tail bytes besides its mtime and size."""
    if isinstance(node, lp.ParquetRelation):
        from spark_rapids_tpu_torch.io.parquet import expand_paths, \
            tail_marker
        return _file_tokens(node.paths, expand_paths, tail_marker)
    if isinstance(node, lp.OrcRelation):
        from spark_rapids_tpu_torch.io.orc import expand_orc_paths
        return _file_tokens(node.paths, expand_orc_paths)
    if isinstance(node, lp.CsvRelation):
        from spark_rapids_tpu_torch.io.csv import expand_csv_paths
        return _file_tokens(node.paths, expand_csv_paths)
    return None


def _columns_nbytes(cols) -> int:
    total = 0
    for values, valid in cols.values():
        total += int(valid.nbytes)
        chars = getattr(values, "chars", None)
        if chars is not None:
            total += int(chars.nbytes) + int(values.lengths.nbytes)
        else:
            total += int(values.nbytes)
    return total


def snapshot_detail(plan: lp.LogicalPlan
                    ) -> Tuple[Optional[str], tuple, tuple]:
    """``(digest, pins, leaves)``: ``snapshot_fingerprint`` and each file
    relation's ``(node, ((path, token), ...))`` in walk order, which the
    result cache's maintenance diffs; ``(None, (), ())`` when a leaf
    cannot be snapshot."""
    parts: List[str] = []
    pins: List[object] = []
    leaves: List[tuple] = []

    def walk(node: lp.LogicalPlan) -> bool:
        pairs = leaf_file_tokens(node)
        if pairs is not None:
            leaves.append((node, tuple(pairs)))
            toks = [tok for _, tok in pairs]
        elif isinstance(node, lp.FILE_RELATIONS):
            return False  # a file relation that cannot be snapshot
        elif isinstance(node, lp.LocalRelation):
            cols = node.cols
            pins.append(cols)
            rows = len(next(iter(cols.values()))[0]) if cols else 0
            toks = [f"local:{id(cols)}:{rows}:{_columns_nbytes(cols)}"]
        elif isinstance(node, lp.Range) or node.children:
            toks = []
        else:
            return False  # an unknown leaf
        parts.extend(toks)
        return all(walk(c) for c in node.children)

    if not walk(plan):
        return None, (), ()
    digest = hashlib.sha256("\n".join(parts).encode()).hexdigest()
    return digest, tuple(pins), tuple(leaves)


def snapshot_fingerprint(plan: lp.LogicalPlan) -> Tuple[Optional[str], tuple]:
    """``(digest, pins)`` of what every leaf holds now, or ``(None, ())``
    when a leaf cannot be snapshot.  ``pins`` are the objects the cache
    entry keeps alive (the in-memory relations' columns)."""
    digest, pins, _ = snapshot_detail(plan)
    return digest, pins
