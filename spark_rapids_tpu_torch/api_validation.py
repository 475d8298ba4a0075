"""API surface validation against the pyspark-parity contract.

Counterpart of ``spark_rapids_tpu/api_validation.py``: ``EXPECTED`` is
the JAX package's list with ``TpuSession`` read as ``TorchSession``,
and ``validate()`` reflects it over the port's classes.  One entry is
left out by name: ``DataFrame.to_jax``, a handoff to JAX arrays, which a
package that imports no JAX does not offer (``to_torch`` and
``to_device_batches`` are its handoffs).  ``python -m
spark_rapids_tpu_torch.api_validation`` prints the report and exits
non-zero while anything is missing.
"""

from __future__ import annotations

import sys
from typing import Dict, List

# entries of the JAX package's contract the port leaves out, and why
EXCLUDED: Dict[str, Dict[str, str]] = {
    "DataFrame": {"to_jax": "a handoff to JAX arrays; the port imports "
                            "no JAX"},
}

EXPECTED: Dict[str, List[str]] = {
    "DataFrame": [
        "select", "filter", "where", "with_column", "union", "limit",
        "order_by", "sort", "group_by", "rollup", "cube", "agg", "join",
        "repartition", "distinct", "collect", "count", "to_arrow",
        "explain", "to_numpy", "to_torch", "to_device_batches",
        "write",
    ],
    "Column": [
        "alias", "cast", "is_null", "is_not_null", "isin", "startswith",
        "endswith", "contains", "like", "substr", "eq_null_safe", "asc",
        "desc", "over",
        "__add__", "__sub__", "__mul__", "__truediv__", "__mod__",
        "__neg__", "__eq__", "__ne__", "__lt__", "__le__", "__gt__",
        "__ge__", "__and__", "__or__", "__invert__",
    ],
    "functions": [
        "col", "lit", "when", "coalesce", "count", "sum", "min", "max",
        "avg", "first", "last", "pmod", "sqrt", "exp", "log", "pow",
        "floor", "ceil", "abs", "isnull", "isnan", "nanvl", "year",
        "month", "dayofmonth", "dayofweek", "dayofyear", "quarter",
        "hour", "minute", "second", "date_add", "date_sub", "datediff",
        "last_day", "unix_timestamp", "upper", "lower", "length",
        "substring", "concat", "trim", "ltrim", "rtrim", "row_number",
        "rank", "dense_rank", "lag", "lead", "grouping_id",
    ],
    "Window": [
        "partition_by", "partitionBy", "order_by", "orderBy",
        "rows_between", "rowsBetween", "range_between", "rangeBetween",
        "unboundedPreceding", "unboundedFollowing", "currentRow",
    ],
    "WindowSpec": [
        "partition_by", "order_by", "rows_between", "range_between",
    ],
    "TorchSession": [
        "builder", "active", "set_conf", "create_dataframe", "read",
        "range", "stop", "last_query_metrics", "last_query_profile",
        "engine_stats",
    ],
    "DataFrameReader": ["parquet", "csv", "orc"],
    "DataFrameWriter": ["parquet", "csv", "orc", "mode"],
    "GroupedData": ["agg", "count"],
}


def _surface_of(name: str):
    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch import api, functions
    if name == "functions":
        return functions
    for mod in (st, api):
        obj = getattr(mod, name, None)
        if obj is not None:
            return obj
    raise KeyError(name)


def validate() -> Dict[str, Dict[str, List[str]]]:
    """-> {class: {"missing": [...], "present": [...]}}."""
    report: Dict[str, Dict[str, List[str]]] = {}
    for cls_name, members in EXPECTED.items():
        try:
            obj = _surface_of(cls_name)
        except KeyError:
            # a whole class missing is reported, not raised
            report[cls_name] = {"missing": list(members), "present": []}
            continue
        missing = [m for m in members if not hasattr(obj, m)]
        present = [m for m in members if hasattr(obj, m)]
        report[cls_name] = {"missing": missing, "present": present}
    return report


def main() -> int:
    report = validate()
    total = missing = 0
    for cls_name, r in sorted(report.items()):
        total += len(r["missing"]) + len(r["present"])
        missing += len(r["missing"])
        status = "OK" if not r["missing"] else \
            f"MISSING {', '.join(r['missing'])}"
        sys.stdout.write(f"{cls_name:16s} {len(r['present']):3d}/"
                         f"{len(r['present']) + len(r['missing']):3d}  "
                         f"{status}\n")
    sys.stdout.write(f"\n{total - missing}/{total} surface entries "
                     "present\n")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
