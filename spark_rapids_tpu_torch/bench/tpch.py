"""TPC-H-like corpus: a numpy generator and the 22 queries.

Counterpart of ``spark_rapids_tpu/bench/tpch.py``.  ``gen_tpch_numpy``
makes the same eight tables as the JAX package's ``gen_tpch``, column for
column, from the same seed: it draws from one ``np.random.default_rng``
in ``gen_tpch``'s order, per-row draws included, but returns numpy
arrays (strings as ``U`` arrays, dates as ``datetime64[D]``) instead of
writing parquet, so it needs no pyarrow.  q1 to q22 follow the JAX
package's text on the port's API (correlated and scalar subqueries
become joins, as there: a constant key ``_const_key`` joins a one-row
aggregate to every row); monetary values are float64.  ``BENCH_QUERIES``
names the six that ``bench.py`` runs.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api import col, lit, when

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


def q4(t):
    """TPC-H Q4: order priority checking (semi join on late lineitems)."""
    late = t["lineitem"].filter(
        col("l_commitdate") < col("l_receiptdate")) \
        .select(col("l_orderkey").alias("o_orderkey"))
    return (t["orders"]
            .filter((col("o_orderdate") >= lit(dt.date(1993, 7, 1)))
                    & (col("o_orderdate") < lit(dt.date(1993, 10, 1))))
            .join(late, "o_orderkey", "semi")
            .group_by("o_orderpriority")
            .agg(F.count(lit(1)).alias("order_count"))
            .order_by("o_orderpriority"))


def q12(t):
    """TPC-H Q12: shipmode / order priority (conditional CASE sums)."""
    li = t["lineitem"].filter(
        ((col("l_shipmode") == lit("MAIL"))
         | (col("l_shipmode") == lit("SHIP")))
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= lit(dt.date(1994, 1, 1)))
        & (col("l_receiptdate") < lit(dt.date(1995, 1, 1)))) \
        .select(col("l_orderkey").alias("o_orderkey"), "l_shipmode")
    high = when((col("o_orderpriority") == lit("1-URGENT"))
                | (col("o_orderpriority") == lit("2-HIGH")), 1) \
        .otherwise(0)
    low = when((col("o_orderpriority") != lit("1-URGENT"))
               & (col("o_orderpriority") != lit("2-HIGH")), 1) \
        .otherwise(0)
    return (t["orders"].join(li, "o_orderkey")
            .group_by("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(low).alias("low_line_count"))
            .order_by("l_shipmode"))


def q14(t):
    """TPC-H Q14: promotion effect (conditional revenue share)."""
    li = t["lineitem"].filter(
        (col("l_shipdate") >= lit(dt.date(1995, 9, 1)))
        & (col("l_shipdate") < lit(dt.date(1995, 10, 1)))) \
        .select("l_partkey",
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("volume"))
    part = t["part"].select(col("p_partkey").alias("l_partkey"),
                            "p_type")
    joined = li.join(part, "l_partkey")
    promo = when(col("p_type").startswith("PROMO"),
                 col("volume")).otherwise(0.0)
    agged = joined.agg(F.sum(promo).alias("promo"),
                       F.sum(col("volume")).alias("total"))
    return agged.select(
        (lit(100.0) * col("promo") / col("total"))
        .alias("promo_revenue"))


def _const_key(df, name="_jk"):
    """Append a constant join key (the scalar-subquery join idiom)."""
    return df.with_column(name, lit(1))


def q2(t):
    """TPC-H Q2: minimum-cost supplier (correlated min via groupby
    join)."""
    supp_eu = (t["supplier"]
               .join(t["nation"]
                     .join(t["region"]
                           .filter(col("r_name") == lit("EUROPE"))
                           .select(col("r_regionkey")
                                   .alias("n_regionkey")),
                           "n_regionkey")
                     .select(col("n_nationkey").alias("s_nationkey"),
                             "n_name"),
                     "s_nationkey"))
    ps = (t["partsupp"].select(col("ps_partkey").alias("p_partkey"),
                               col("ps_suppkey").alias("s_suppkey"),
                               "ps_supplycost")
          .join(supp_eu, "s_suppkey"))
    part_f = t["part"].filter(
        (col("p_size") == lit(15)) & col("p_type").endswith("STEEL")) \
        .select("p_partkey", "p_mfgr")
    joined = part_f.join(ps, "p_partkey")
    mn = (joined.group_by("p_partkey")
          .agg(F.min(col("ps_supplycost")).alias("min_cost")))
    return (joined.join(mn, "p_partkey")
            .filter(col("ps_supplycost") == col("min_cost"))
            .select("s_acctbal", "s_name", "n_name", "p_partkey",
                    "p_mfgr")
            .order_by(col("s_acctbal").desc(), "n_name", "s_name",
                      "p_partkey")
            .limit(100))


def q7(t):
    """TPC-H Q7: volume shipping between two nations by year."""
    n1 = t["nation"].select(col("n_nationkey").alias("s_nationkey"),
                            col("n_name").alias("supp_nation"))
    n2 = t["nation"].select(col("n_nationkey").alias("c_nationkey"),
                            col("n_name").alias("cust_nation"))
    li = t["lineitem"].filter(
        (col("l_shipdate") >= lit(dt.date(1995, 1, 1)))
        & (col("l_shipdate") <= lit(dt.date(1996, 12, 31)))) \
        .select(col("l_orderkey").alias("o_orderkey"),
                col("l_suppkey").alias("s_suppkey"),
                F.year(col("l_shipdate")).alias("l_year"),
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("volume"))
    orders = t["orders"].select("o_orderkey",
                                col("o_custkey").alias("c_custkey"))
    cust = t["customer"].select("c_custkey", "c_nationkey").join(
        n2, "c_nationkey")
    supp = t["supplier"].select("s_suppkey", "s_nationkey").join(
        n1, "s_nationkey")
    j = (li.join(orders, "o_orderkey").join(cust, "c_custkey")
         .join(supp, "s_suppkey")
         .filter(((col("supp_nation") == lit("FRANCE"))
                  & (col("cust_nation") == lit("GERMANY")))
                 | ((col("supp_nation") == lit("GERMANY"))
                    & (col("cust_nation") == lit("FRANCE")))))
    return (j.group_by("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(col("volume")).alias("revenue"))
            .order_by("supp_nation", "cust_nation", "l_year"))


def q8(t):
    """TPC-H Q8: national market share within a region by year."""
    region = t["region"].filter(col("r_name") == lit("AMERICA")) \
        .select(col("r_regionkey").alias("n_regionkey"))
    n_cust = t["nation"].join(region, "n_regionkey").select(
        col("n_nationkey").alias("c_nationkey"))
    n_supp = t["nation"].select(col("n_nationkey").alias("s_nationkey"),
                                col("n_name").alias("supp_nation"))
    orders = t["orders"].filter(
        (col("o_orderdate") >= lit(dt.date(1995, 1, 1)))
        & (col("o_orderdate") <= lit(dt.date(1996, 12, 31)))) \
        .select(col("o_orderkey").alias("l_orderkey"),
                col("o_custkey").alias("c_custkey"),
                F.year(col("o_orderdate")).alias("o_year"))
    part_f = t["part"].filter(
        col("p_type") == lit("ECONOMY POLISHED BRASS")) \
        .select(col("p_partkey").alias("l_partkey"))
    li = t["lineitem"].select(
        "l_orderkey", "l_partkey",
        col("l_suppkey").alias("s_suppkey"),
        (col("l_extendedprice")
         * (lit(1.0) - col("l_discount"))).alias("volume"))
    j = (li.join(part_f, "l_partkey")
         .join(orders, "l_orderkey")
         .join(t["customer"].select("c_custkey", "c_nationkey")
               .join(n_cust, "c_nationkey"), "c_custkey")
         .join(t["supplier"].select("s_suppkey", "s_nationkey")
               .join(n_supp, "s_nationkey"), "s_suppkey"))
    brazil = when(col("supp_nation") == lit("BRAZIL"),
                  col("volume")).otherwise(0.0)
    return (j.group_by("o_year")
            .agg(F.sum(brazil).alias("brazil_volume"),
                 F.sum(col("volume")).alias("total_volume"))
            .select("o_year", (col("brazil_volume")
                               / col("total_volume")).alias("mkt_share"))
            .order_by("o_year"))


def q9(t):
    """TPC-H Q9: product-type profit measure by nation and year."""
    part_f = t["part"].filter(col("p_name").contains("green")) \
        .select(col("p_partkey").alias("l_partkey"))
    supp = t["supplier"].select(col("s_suppkey").alias("l_suppkey"),
                                col("s_nationkey").alias("n_nationkey"))
    ps = t["partsupp"].select(col("ps_partkey").alias("l_partkey"),
                              col("ps_suppkey").alias("l_suppkey"),
                              "ps_supplycost")
    orders = t["orders"].select(col("o_orderkey").alias("l_orderkey"),
                                F.year(col("o_orderdate"))
                                .alias("o_year"))
    li = t["lineitem"].select(
        "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
        (col("l_extendedprice")
         * (lit(1.0) - col("l_discount"))).alias("gross"))
    j = (li.join(part_f, "l_partkey")
         .join(supp, "l_suppkey")
         .join(ps, ["l_partkey", "l_suppkey"])
         .join(orders, "l_orderkey")
         .join(t["nation"].select("n_nationkey", "n_name"),
               "n_nationkey"))
    profit = col("gross") - col("ps_supplycost") * col("l_quantity")
    return (j.select("n_name", "o_year", profit.alias("amount"))
            .group_by("n_name", "o_year")
            .agg(F.sum(col("amount")).alias("sum_profit"))
            .order_by("n_name", col("o_year").desc()))


def q11(t):
    """TPC-H Q11: important stock identification (value share of one
    nation's partsupp, scalar-subquery threshold via const-key join)."""
    germany = t["nation"].filter(col("n_name") == lit("GERMANY")) \
        .select(col("n_nationkey").alias("s_nationkey"))
    ps = (t["partsupp"].select(col("ps_partkey"),
                               col("ps_suppkey").alias("s_suppkey"),
                               (col("ps_supplycost")
                                * col("ps_availqty")).alias("value"))
          .join(t["supplier"].select("s_suppkey", "s_nationkey")
                .join(germany, "s_nationkey"), "s_suppkey"))
    per_part = (ps.group_by("ps_partkey")
                .agg(F.sum(col("value")).alias("part_value")))
    total = _const_key(ps.agg(F.sum(col("value")).alias("total_value")))
    return (_const_key(per_part).join(total, "_jk")
            .filter(col("part_value")
                    > col("total_value") * lit(0.001))
            .select("ps_partkey", "part_value")
            .order_by(col("part_value").desc(), "ps_partkey")
            .limit(100))


def q13(t):
    """TPC-H Q13: customer order-count distribution (left join +
    double aggregation)."""
    o = t["orders"].filter(
        ~col("o_comment").contains("special")) \
        .select(col("o_custkey").alias("c_custkey"), "o_orderkey")
    j = t["customer"].select("c_custkey").join(o, "c_custkey", "left")
    per_c = (j.group_by("c_custkey")
             .agg(F.count(col("o_orderkey")).alias("c_count")))
    return (per_c.group_by("c_count")
            .agg(F.count(lit(1)).alias("custdist"))
            .order_by(col("custdist").desc(), col("c_count").desc()))


def q15(t):
    """TPC-H Q15: top supplier (max-revenue scalar subquery)."""
    rev = (t["lineitem"].filter(
        (col("l_shipdate") >= lit(dt.date(1996, 1, 1)))
        & (col("l_shipdate") < lit(dt.date(1996, 4, 1))))
        .select(col("l_suppkey").alias("s_suppkey"),
                (col("l_extendedprice")
                 * (lit(1.0) - col("l_discount"))).alias("v"))
        .group_by("s_suppkey")
        .agg(F.sum(col("v")).alias("total_revenue")))
    mx = _const_key(rev.agg(F.max(col("total_revenue")).alias("mx")))
    top = (_const_key(rev).join(mx, "_jk")
           .filter(col("total_revenue") == col("mx"))
           .select("s_suppkey", "total_revenue"))
    return (top.join(t["supplier"].select("s_suppkey", "s_name"),
                     "s_suppkey")
            .select("s_suppkey", "s_name", "total_revenue")
            .order_by("s_suppkey"))


def q16(t):
    """TPC-H Q16: parts/supplier relationship (distinct supplier counts
    per brand/type/size)."""
    part_f = t["part"].filter(
        (col("p_brand") != lit("Brand#45"))
        & ~col("p_type").startswith("MEDIUM")
        & col("p_size").isin(1, 4, 7, 10, 14, 19, 25, 39, 45, 49)) \
        .select(col("p_partkey").alias("ps_partkey"), "p_brand",
                "p_type", "p_size")
    j = (t["partsupp"].select("ps_partkey", "ps_suppkey")
         .join(part_f, "ps_partkey")
         .select("p_brand", "p_type", "p_size", "ps_suppkey")
         .distinct())
    return (j.group_by("p_brand", "p_type", "p_size")
            .agg(F.count(lit(1)).alias("supplier_cnt"))
            .order_by(col("supplier_cnt").desc(), "p_brand", "p_type",
                      "p_size"))


def q17(t):
    """TPC-H Q17: small-quantity-order revenue (per-part avg quantity
    correlated subquery via groupby join)."""
    li = t["lineitem"].select("l_partkey", "l_quantity",
                              "l_extendedprice")
    avg_q = (li.group_by("l_partkey")
             .agg(F.avg(col("l_quantity")).alias("avg_qty")))
    part_f = t["part"].filter(
        (col("p_brand") == lit("Brand#23"))
        & (col("p_container") == lit("MED BOX"))) \
        .select(col("p_partkey").alias("l_partkey"))
    j = (li.join(part_f, "l_partkey").join(avg_q, "l_partkey")
         .filter(col("l_quantity") < col("avg_qty") * lit(0.8)))
    return (j.agg(F.sum(col("l_extendedprice")).alias("total"))
            .select((col("total") / lit(7.0)).alias("avg_yearly")))


def q19(t):
    """TPC-H Q19: discounted revenue (OR-of-ANDs over part attrs)."""
    li = t["lineitem"].select(
        "l_partkey", "l_quantity",
        (col("l_extendedprice")
         * (lit(1.0) - col("l_discount"))).alias("v"))
    part = t["part"].select(col("p_partkey").alias("l_partkey"),
                            "p_brand", "p_container", "p_size")
    j = li.join(part, "l_partkey")
    c1 = ((col("p_brand") == lit("Brand#12"))
          & col("p_container").startswith("SM")
          & (col("l_quantity") >= lit(1.0))
          & (col("l_quantity") <= lit(11.0))
          & (col("p_size") <= lit(5)))
    c2 = ((col("p_brand") == lit("Brand#23"))
          & col("p_container").startswith("MED")
          & (col("l_quantity") >= lit(10.0))
          & (col("l_quantity") <= lit(20.0))
          & (col("p_size") <= lit(10)))
    c3 = ((col("p_brand") == lit("Brand#34"))
          & col("p_container").startswith("LG")
          & (col("l_quantity") >= lit(20.0))
          & (col("l_quantity") <= lit(30.0))
          & (col("p_size") <= lit(15)))
    return (j.filter(c1 | c2 | c3)
            .agg(F.sum(col("v")).alias("revenue")))


def q20(t):
    """TPC-H Q20: potential part promotion (availqty vs half of shipped
    quantity; nested semi joins)."""
    pk = t["part"].filter(col("p_name").startswith("forest")) \
        .select(col("p_partkey").alias("ps_partkey"))
    liq = (t["lineitem"].filter(
        (col("l_shipdate") >= lit(dt.date(1994, 1, 1)))
        & (col("l_shipdate") < lit(dt.date(1995, 1, 1))))
        .select(col("l_partkey").alias("ps_partkey"),
                col("l_suppkey").alias("ps_suppkey"), "l_quantity")
        .group_by("ps_partkey", "ps_suppkey")
        .agg(F.sum(col("l_quantity")).alias("ship_qty"))
        .select("ps_partkey", "ps_suppkey",
                (col("ship_qty") * lit(0.5)).alias("half_qty")))
    cand = (t["partsupp"].select("ps_partkey", "ps_suppkey",
                                 "ps_availqty")
            .join(pk, "ps_partkey")
            .join(liq, ["ps_partkey", "ps_suppkey"])
            .filter(col("ps_availqty") > col("half_qty"))
            .select(col("ps_suppkey").alias("s_suppkey")))
    return (t["supplier"].select("s_suppkey", "s_name")
            .join(cand, "s_suppkey", "semi")
            .order_by("s_name"))


def q21(t):
    """TPC-H Q21: suppliers who kept orders waiting (the only late
    supplier on multi-supplier 'F' orders; exists/not-exists expressed
    as aggregated joins)."""
    pairs = t["lineitem"].select("l_orderkey", "l_suppkey").distinct()
    n_supp = (pairs.group_by("l_orderkey")
              .agg(F.count(lit(1)).alias("n_suppliers")))
    late_pairs = (t["lineitem"]
                  .filter(col("l_receiptdate") > col("l_commitdate"))
                  .select("l_orderkey", "l_suppkey").distinct())
    n_late = (late_pairs.group_by("l_orderkey")
              .agg(F.count(lit(1)).alias("n_late")))
    orders_f = t["orders"].filter(
        col("o_orderstatus") == lit("F")) \
        .select(col("o_orderkey").alias("l_orderkey"))
    saudi = t["nation"].filter(col("n_name") == lit("SAUDI ARABIA")) \
        .select(col("n_nationkey").alias("s_nationkey"))
    supp = (t["supplier"].select(col("s_suppkey").alias("l_suppkey"),
                                 "s_name", "s_nationkey")
            .join(saudi, "s_nationkey"))
    j = (late_pairs.join(orders_f, "l_orderkey")
         .join(n_supp, "l_orderkey").join(n_late, "l_orderkey")
         .filter((col("n_suppliers") >= lit(2))
                 & (col("n_late") == lit(1)))
         .join(supp, "l_suppkey"))
    return (j.group_by("s_name")
            .agg(F.count(lit(1)).alias("numwait"))
            .order_by(col("numwait").desc(), "s_name")
            .limit(100))


def q22(t):
    """TPC-H Q22: global sales opportunity (acctbal above the positive
    average, customers with no orders; anti join + const-key avg)."""
    cc = F.substring(col("c_phone"), 1, 2)
    cust = t["customer"].select("c_custkey", "c_acctbal",
                                cc.alias("cntrycode"))
    cust = cust.filter(
        col("cntrycode").isin("13", "31", "23", "29", "30", "18", "17"))
    avg_bal = _const_key(
        cust.filter(col("c_acctbal") > lit(0.0))
        .agg(F.avg(col("c_acctbal")).alias("avg_bal")))
    cand = (_const_key(cust).join(avg_bal, "_jk")
            .filter(col("c_acctbal") > col("avg_bal"))
            .select("c_custkey", "cntrycode", "c_acctbal"))
    no_orders = cand.join(
        t["orders"].select(col("o_custkey").alias("c_custkey")),
        "c_custkey", "anti")
    return (no_orders.group_by("cntrycode")
            .agg(F.count(lit(1)).alias("numcust"),
                 F.sum(col("c_acctbal")).alias("totacctbal"))
            .order_by("cntrycode"))


TPCH_QUERIES = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5,
                "q6": q6, "q7": q7, "q8": q8, "q9": q9, "q10": q10,
                "q11": q11, "q12": q12, "q13": q13, "q14": q14,
                "q15": q15, "q16": q16, "q17": q17, "q18": q18,
                "q19": q19, "q20": q20, "q21": q21, "q22": q22}
# the queries bench.py:_tpch_suites runs
BENCH_QUERIES = ("q1", "q3", "q5", "q6", "q10", "q18")
