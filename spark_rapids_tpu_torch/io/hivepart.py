"""Hive-style partition discovery for the file scans.

Counterpart of ``spark_rapids_tpu/io/hivepart.py`` (pure Python).
``discover`` parses the ``col=value`` directories between a scan root
and each file and infers each partition column's type (int64, then
float64, then string; ``__HIVE_DEFAULT_PARTITION__`` is null, ``%XX``
escapes are undone); the scans then drop the files whose partition
values cannot satisfy the pushed predicate (``prune_files``) and append
one constant column a partition field to every batch of a file, built on
the device (``append_partition_columns``).  Partition columns come after
the file's columns.  ``simple_predicates`` reads the ``col <op>
literal`` conjuncts of a bound predicate, which the parquet row-group
and ORC stripe pruning use too.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT64, STRING, \
    Field, Schema

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _hive_unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "%" and i + 3 <= len(s):
            try:
                out.append(chr(int(s[i + 1:i + 3], 16)))
                i += 3
                continue
            except ValueError:
                pass
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_segments(rel: str) -> List[Tuple[str, Optional[str]]]:
    """The directory segments of a relative file path -> [(col, value or
    None)], or [] when one is not ``col=value``."""
    out = []
    for seg in rel.split(os.sep)[:-1]:
        if "=" not in seg:
            return []
        name, _, raw = seg.partition("=")
        if not name:
            return []
        out.append((name, None if raw == HIVE_NULL else _hive_unescape(raw)))
    return out


def roots_of(paths) -> List[str]:
    return list(paths) if isinstance(paths, (list, tuple)) else [paths]


def discover(roots: Sequence[str], files: Sequence[str]):
    """-> (partition Schema or None, one value tuple a file).  The layout
    is partitioned only when every file carries the same ordered
    partition columns; otherwise the files are plain ones."""
    norm_roots = sorted((os.path.abspath(r) for r in roots
                         if os.path.isdir(r)), key=len, reverse=True)
    per_file: List[List[Tuple[str, Optional[str]]]] = []
    for f in files:
        af = os.path.abspath(f)
        segs: List[Tuple[str, Optional[str]]] = []
        for r in norm_roots:
            if af.startswith(r + os.sep):
                segs = _parse_segments(os.path.relpath(af, r))
                break
        per_file.append(segs)
    if not per_file or not per_file[0]:
        return None, []
    cols = [c for c, _ in per_file[0]]
    for segs in per_file:
        if [c for c, _ in segs] != cols:
            return None, []
    fields, typed = [], []
    for c in cols:
        vs = [dict(segs)[c] for segs in per_file]
        for caster, dt in ((int, INT64), (float, FLOAT64)):
            try:
                tv = [None if v is None else caster(v) for v in vs]
                break
            except (TypeError, ValueError):
                continue
        else:
            tv, dt = list(vs), STRING
        fields.append(Field(c, dt, True))
        typed.append(tv)
    values = [tuple(typed[ci][fi] for ci in range(len(cols)))
              for fi in range(len(files))]
    return Schema(fields), values


def file_fields(schema: Schema, part_schema: Optional[Schema]) -> Schema:
    """The columns a scan reads from its files: all but the partition
    columns."""
    if not part_schema:
        return schema
    names = set(part_schema.names)
    return Schema([f for f in schema if f.name not in names])


def with_partition_fields(file_schema: Schema, paths, files) -> Schema:
    """A file's schema with the layout's partition columns after it."""
    part_schema, _ = discover(roots_of(paths), files)
    if not part_schema:
        return file_schema
    return Schema([f for f in file_schema if f.name not in part_schema.names]
                  + list(part_schema.fields))


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

def _literal_value(e):
    """The Python value of a literal, through a value-preserving cast
    the binder put in (an int32 literal against an int64 column); None
    when the value could change (a float truncated to an int)."""
    from spark_rapids_tpu_torch.exprs.base import Literal
    from spark_rapids_tpu_torch.exprs.cast import Cast
    if isinstance(e, Cast):
        inner = _literal_value(e.children[0])
        if inner is None or isinstance(inner, bool) \
                or not isinstance(inner, (int, float)):
            return None
        if isinstance(inner, int) and e.to.is_integral:
            info = np.iinfo(e.to.numpy_dtype)
            return inner if info.min <= inner <= info.max else None
        if e.to.is_floating:
            return float(np.dtype(e.to.numpy_dtype).type(inner))
        return None
    if isinstance(e, Literal):
        return e.value
    return None


def simple_predicates(pred) -> List[Tuple[str, str, object]]:
    """The AND-tree of ``column <op> literal`` in a bound predicate ->
    [(column name, op, value)], op one of eq, lt, le, gt, ge."""
    from spark_rapids_tpu_torch.exprs import predicates as pr
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    ops = {pr.EqualTo: "eq", pr.LessThan: "lt", pr.LessThanOrEqual: "le",
           pr.GreaterThan: "gt", pr.GreaterThanOrEqual: "ge"}
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    out = []

    def walk(e):
        if isinstance(e, pr.And):
            walk(e.children[0])
            walk(e.children[1])
            return
        op = ops.get(type(e))
        if op is None:
            return
        left, right = e.children
        lv, rv = _literal_value(left), _literal_value(right)
        if isinstance(left, BoundReference) and rv is not None:
            out.append((left.col_name, op, rv))
        elif isinstance(right, BoundReference) and lv is not None:
            out.append((right.col_name, flip[op], lv))

    if pred is not None:
        walk(pred)
    return out


def may_match(checks, bounds: Dict[str, Tuple[object, object]]) -> bool:
    """False when some check cannot hold for a column whose values lie
    in ``bounds[name]`` = (min, max); incomparable values keep it."""
    for name, op, value in checks:
        if name not in bounds:
            continue
        mn, mx = bounds[name]
        try:
            if (op == "eq" and (value < mn or value > mx)) \
                    or (op == "lt" and mn >= value) \
                    or (op == "le" and mn > value) \
                    or (op == "gt" and mx <= value) \
                    or (op == "ge" and mx < value):
                return False
        except TypeError:
            continue
    return True


def prune_files(part_schema: Optional[Schema], file_values, files, pred):
    """The files (and their values) whose partition values can satisfy
    the predicate's simple conjuncts; a null partition value satisfies
    none."""
    if pred is None or part_schema is None:
        return list(files), list(file_values)
    checks = simple_predicates(pred)
    if not checks:
        return list(files), list(file_values)
    idx = {f.name: i for i, f in enumerate(part_schema)}
    checks = [c for c in checks if c[0] in idx]
    keep_f, keep_v = [], []
    for f, vals in zip(files, file_values):
        if any(vals[idx[name]] is None for name, _, _ in checks):
            continue
        bounds = {name: (vals[idx[name]], vals[idx[name]])
                  for name, _, _ in checks}
        if may_match(checks, bounds):
            keep_f.append(f)
            keep_v.append(vals)
    return keep_f, keep_v


# ---------------------------------------------------------------------------
# the constant columns
# ---------------------------------------------------------------------------

def constant_column(dtype, value, n: int, capacity: int, device):
    """A column of ``n`` copies of ``value`` (None: null) at
    ``capacity``, made on the device."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
        bucket_capacity
    from spark_rapids_tpu_torch.columnar.dtypes import device_dtype
    valid = torch.zeros(capacity, dtype=torch.bool, device=device)
    if value is not None:
        valid[:n] = True
    if dtype == STRING:
        raw = b"" if value is None else str(value).encode()
        width = bucket_capacity(max(1, len(raw)))
        chars = torch.zeros((capacity, width), dtype=torch.uint8,
                            device=device)
        data = torch.zeros(capacity, dtype=torch.int32, device=device)
        if raw:
            chars[:n, :len(raw)] = torch.tensor(list(raw), dtype=torch.uint8,
                                                device=device)
            data[:n] = len(raw)
        return DeviceColumn(STRING, data, valid, n, chars)
    data = torch.zeros(capacity, dtype=device_dtype(dtype), device=device)
    if value is not None:
        data[:n] = value
    return DeviceColumn(dtype, data, valid, n)


def append_partition_columns(batch, part_schema: Schema, vals,
                             schema: Optional[Schema] = None):
    """The batch with one constant column a partition field after its
    own."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    cols = list(batch.columns)
    for f, v in zip(part_schema, vals):
        cols.append(constant_column(f.dtype, v, batch.num_rows,
                                    batch.capacity, batch.device))
    if schema is None and batch.schema is not None:
        schema = Schema(list(batch.schema.fields) + list(part_schema.fields))
    return ColumnarBatch(cols, batch.num_rows, schema)
