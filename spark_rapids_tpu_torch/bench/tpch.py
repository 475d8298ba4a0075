"""TPC-H-like corpus: a numpy generator and the bench's six queries.

Counterpart of ``spark_rapids_tpu/bench/tpch.py``.  ``gen_tpch_numpy``
makes the same eight tables as the JAX package's ``gen_tpch``, column for
column, from the same seed: it draws from one ``np.random.default_rng``
in ``gen_tpch``'s order, per-row draws included, but returns numpy
arrays (strings as ``U`` arrays, dates as ``datetime64[D]``) instead of
writing parquet, so it needs no pyarrow.  q1, q3, q5, q6, q10 and q18
follow the JAX package's text on the port's API; monetary values are
float64.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api import col, lit

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
             "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
               "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_TYPES = ["PROMO BRUSHED STEEL", "PROMO ANODIZED TIN", "STANDARD BRUSHED"
          " COPPER", "ECONOMY POLISHED BRASS", "MEDIUM PLATED NICKEL",
          "SMALL BURNISHED STEEL"]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
            "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA",
            "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO",
            "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
            "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"]
_COLORS = ["green", "red", "blue", "ivory", "forest", "navy", "salmon",
           "plum"]
_COMMENTS = ["fast deliver", "special requests sleep", "carefully final",
             "quick brown", "pending special", "regular ideas"]

Tables = Dict[str, Dict[str, np.ndarray]]


def _days(y, m, d) -> int:
    return (dt.date(y, m, d) - dt.date(1970, 1, 1)).days


def _pick(words, idx) -> np.ndarray:
    return np.array(words)[idx]


def _dates(days: np.ndarray) -> np.ndarray:
    return days.astype(np.int64).astype("datetime64[D]")


def gen_tpch_numpy(lineitem_rows: int = 30_000, seed: int = 19) -> Tables:
    """The eight tables as {table: {column: numpy array}}, equal to what
    ``gen_tpch(dir, lineitem_rows, seed)`` writes; sizes scale off
    ``lineitem_rows`` as dbgen's ratios do."""
    rng = np.random.default_rng(seed)
    n_orders = max(1, lineitem_rows // 4)
    n_cust = max(1, n_orders // 10)
    n_supp = max(1, lineitem_rows // 100)
    n_part = max(1, lineitem_rows // 50)

    region = {"r_regionkey": np.arange(5, dtype=np.int64),
              "r_name": np.array(_REGIONS)}
    nation = {"n_nationkey": np.arange(25, dtype=np.int64),
              "n_name": np.array(_NATIONS),
              "n_regionkey": (np.arange(25) % 5).astype(np.int64)}
    # every draw below comes in gen_tpch's order
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(n_cust)]),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cust), 2),
        "c_mktsegment": _pick(_SEGMENTS, rng.integers(0, 5, n_cust)),
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int64),
        "c_phone": np.array(
            [f"{rng.integers(10, 35)}-{rng.integers(100, 999)}-"
             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for _ in range(n_cust)]),
    }
    part = {
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_name": np.array(
            [f"{_COLORS[rng.integers(0, len(_COLORS))]} "
             f"{_COLORS[rng.integers(0, len(_COLORS))]} part{i}"
             for i in range(n_part)]),
        "p_mfgr": np.array([f"Manufacturer#{1 + i % 5}"
                            for i in range(n_part)]),
        "p_brand": np.array(
            [f"Brand#{rng.integers(1, 6)}{rng.integers(1, 6)}"
             for _ in range(n_part)]),
        "p_type": _pick(_TYPES, rng.integers(0, len(_TYPES), n_part)),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
    }
    sizes = _pick(["SM", "MED", "LG", "JUMBO"], rng.integers(0, 4, n_part))
    boxes = _pick(["BOX", "CASE", "PACK", "BAG"], rng.integers(0, 4, n_part))
    part["p_container"] = np.char.add(np.char.add(sizes, " "), boxes)
    supplier = {
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(n_supp)]),
        "s_acctbal": np.round(rng.uniform(-999, 9999, n_supp), 2),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
    }
    n_ps = n_part * 4
    partsupp = {
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int64), 4),
        "ps_suppkey": rng.integers(0, n_supp, n_ps).astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
    }
    d0, d1 = _days(1992, 1, 1), _days(1998, 8, 2)
    odate = rng.integers(d0, d1, n_orders).astype(np.int32)
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        # about 40 % of the customers never order
        "o_custkey": rng.integers(0, max(1, int(n_cust * 0.6)),
                                  n_orders).astype(np.int64),
        "o_orderstatus": _pick(["F", "O", "P"],
                               rng.integers(0, 3, n_orders)),
        "o_orderdate": _dates(odate),
        "o_orderpriority": _pick(_PRIORITIES, rng.integers(0, 5, n_orders)),
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
        "o_comment": _pick(_COMMENTS, rng.integers(0, len(_COMMENTS),
                                                   n_orders)),
    }
    n = lineitem_rows
    okey = rng.integers(0, n_orders, n).astype(np.int64)
    ship = (odate[okey] + rng.integers(1, 122, n)).astype(np.int32)
    commit = (odate[okey] + rng.integers(30, 92, n)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n)).astype(np.int32)
    lineitem = {
        "l_orderkey": okey,
        "l_partkey": rng.integers(0, n_part, n).astype(np.int64),
        "l_suppkey": rng.integers(0, n_supp, n).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105_000, n), 2),
        "l_discount": np.round(rng.integers(0, 11, n) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, n) * 0.01, 2),
        "l_returnflag": _pick(["A", "N", "R"], rng.integers(0, 3, n)),
        "l_linestatus": _pick(["F", "O"], rng.integers(0, 2, n)),
        "l_shipdate": _dates(ship),
        "l_commitdate": _dates(commit),
        "l_receiptdate": _dates(receipt),
        "l_shipmode": _pick(_SHIPMODES, rng.integers(0, len(_SHIPMODES),
                                                     n)),
    }
    return {"region": region, "nation": nation, "customer": customer,
            "supplier": supplier, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


def load_tables(session, tables) -> Dict[str, object]:
    """{table: parquet path or {column: numpy array}} -> DataFrames."""
    return {name: session.read.parquet(src) if isinstance(src, str)
            else session.create_dataframe(src)
            for name, src in tables.items()}


def q1(t):
    """TPC-H Q1: pricing summary report."""
    li = t["lineitem"]
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (li.filter(col("l_shipdate") <= lit(dt.date(1998, 9, 2)))
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum(col("l_quantity")).alias("sum_qty"),
                 F.sum(col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg(col("l_quantity")).alias("avg_qty"),
                 F.avg(col("l_extendedprice")).alias("avg_price"),
                 F.avg(col("l_discount")).alias("avg_disc"),
                 F.count(lit(1)).alias("count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def q3(t):
    """TPC-H Q3: shipping priority (top unshipped orders by revenue)."""
    cust = t["customer"].filter(col("c_mktsegment") == lit("BUILDING")) \
        .select(col("c_custkey").alias("o_custkey"))
    orders = t["orders"].filter(
        col("o_orderdate") < lit(dt.date(1995, 3, 15)))
    li = t["lineitem"].filter(
        col("l_shipdate") > lit(dt.date(1995, 3, 15))) \
        .select(col("l_orderkey").alias("o_orderkey"),
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("volume"))
    return (cust.join(orders, "o_custkey")
            .join(li, "o_orderkey")
            .group_by("o_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(col("volume")).alias("revenue"))
            .order_by(col("revenue").desc(), "o_orderdate")
            .limit(10))


def q5(t):
    """TPC-H Q5: local supplier volume within one region."""
    cust = t["customer"].select(
        col("c_custkey").alias("o_custkey"), col("c_nationkey"))
    orders = t["orders"].filter(
        (col("o_orderdate") >= lit(dt.date(1994, 1, 1)))
        & (col("o_orderdate") < lit(dt.date(1995, 1, 1))))
    li = t["lineitem"].select(
        col("l_orderkey").alias("o_orderkey"),
        col("l_suppkey").alias("s_suppkey"),
        (col("l_extendedprice")
         * (lit(1.0) - col("l_discount"))).alias("volume"))
    supp = t["supplier"].select(
        col("s_suppkey"), col("s_nationkey").alias("n_nationkey"))
    region = t["region"].filter(col("r_name") == lit("ASIA")) \
        .select(col("r_regionkey").alias("n_regionkey"))
    return (cust.join(orders, "o_custkey")
            .join(li, "o_orderkey")
            .join(supp, "s_suppkey")
            # the local-supplier constraint: customer and supplier share
            # the nation
            .filter(col("c_nationkey") == col("n_nationkey"))
            .join(t["nation"], "n_nationkey")
            .join(region, "n_regionkey")
            .group_by("n_name")
            .agg(F.sum(col("volume")).alias("revenue"))
            .order_by(col("revenue").desc()))


def q6(t):
    """TPC-H Q6: forecasting revenue change (a filter and a global
    aggregate)."""
    return (t["lineitem"].filter(
        (col("l_shipdate") >= lit(dt.date(1994, 1, 1)))
        & (col("l_shipdate") < lit(dt.date(1995, 1, 1)))
        & (col("l_discount") >= lit(0.05))
        & (col("l_discount") <= lit(0.07))
        & (col("l_quantity") < lit(24.0)))
        .agg(F.sum(col("l_extendedprice") * col("l_discount"))
             .alias("revenue")))


def q10(t):
    """TPC-H Q10: returned item reporting (top 20 customers by lost
    revenue)."""
    orders = t["orders"].filter(
        (col("o_orderdate") >= lit(dt.date(1993, 10, 1)))
        & (col("o_orderdate") < lit(dt.date(1994, 1, 1)))) \
        .select(col("o_orderkey").alias("l_orderkey"),
                col("o_custkey").alias("c_custkey"))
    li = t["lineitem"].filter(col("l_returnflag") == lit("R")) \
        .select("l_orderkey",
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("volume"))
    nation = t["nation"].select(
        col("n_nationkey").alias("c_nationkey"), "n_name")
    return (t["customer"].join(orders, "c_custkey")
            .join(li, "l_orderkey")
            .join(nation, "c_nationkey")
            .group_by("c_custkey", "c_name", "c_acctbal", "n_name")
            .agg(F.sum(col("volume")).alias("revenue"))
            .order_by(col("revenue").desc())
            .limit(20))


def q18(t):
    """TPC-H Q18: large volume customers (an aggregate with a having,
    joins and a top-N)."""
    big = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > lit(212.0))
           .select(col("l_orderkey").alias("o_orderkey"), "sum_qty"))
    orders = t["orders"].select("o_orderkey",
                                col("o_custkey").alias("c_custkey"),
                                "o_orderdate")
    return (big.join(orders, "o_orderkey")
            .join(t["customer"], "c_custkey")
            .select("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    col("sum_qty").alias("total_qty"))
            .order_by(col("total_qty").desc(), "o_orderkey")
            .limit(100))


TPCH_QUERIES = {"q1": q1, "q3": q3, "q5": q5, "q6": q6, "q10": q10,
                "q18": q18}
