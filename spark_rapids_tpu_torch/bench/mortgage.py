"""Mortgage-like ETL: a numpy generator and the pipeline.

Counterpart of ``spark_rapids_tpu/bench/mortgage.py``.
``gen_mortgage_numpy`` makes the performance and acquisition tables of
the JAX package's ``gen_mortgage``, column for column, from the same
seed: it draws from one ``np.random.default_rng`` in ``gen_mortgage``'s
order, but returns numpy arrays (strings as ``U`` arrays, DATE columns
as ``datetime64[D]``) instead of writing parquet, so it needs no
pyarrow.  ``mortgage_etl`` is the same pipeline on the port's API:
per-loan delinquency features (conditional max and min aggregates over
the performance rows), a left join back to the acquisitions, ``coalesce``
over the loans without reports, and a rollup by seller and channel.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api import col, lit, when
from spark_rapids_tpu_torch.bench.tpch import Tables, load_tables

_SELLERS = ["BANK OF AMERICA", "WELLS FARGO", "QUICKEN", "CITIMORTGAGE",
            "JPMORGAN", "OTHER", "PNC", "USAA", "TRUIST"]
_CHANNELS = ["R", "C", "B"]


def _days(y, m, d) -> int:
    return (dt.date(y, m, d) - dt.date(1970, 1, 1)).days


def gen_mortgage_numpy(perf_rows: int = 100_000, seed: int = 23) -> Tables:
    """{"perf": {...}, "acq": {...}}, equal to what ``gen_mortgage(dir,
    perf_rows, seed)`` writes; about 24 monthly reports a loan."""
    rng = np.random.default_rng(seed)
    n_loans = max(1, perf_rows // 24)
    # every draw below comes in gen_mortgage's order
    loan_ids = rng.integers(0, n_loans, perf_rows).astype(np.int64)
    month0 = _days(2000, 1, 1)
    period = (month0 + 30 * rng.integers(0, 48, perf_rows)).astype(np.int32)
    delinq = np.where(rng.random(perf_rows) < 0.85, 0,
                      rng.integers(1, 8, perf_rows)).astype(np.int32)
    perf = {
        "loan_id": loan_ids,
        "monthly_reporting_period": period.astype(np.int64)
        .astype("datetime64[D]"),
        "current_actual_upb": np.round(
            rng.uniform(10_000, 800_000, perf_rows), 2),
        "loan_age": rng.integers(0, 360, perf_rows).astype(np.int64),
        "current_loan_delinquency_status": delinq,
        "interest_rate": np.round(rng.uniform(2.0, 9.5, perf_rows), 3),
    }
    acq = {
        "loan_id": np.arange(n_loans, dtype=np.int64),
        "orig_channel": np.array(_CHANNELS)[rng.integers(0, 3, n_loans)],
        "seller_name": np.array(_SELLERS)[
            rng.integers(0, len(_SELLERS), n_loans)],
        "orig_interest_rate": np.round(rng.uniform(2.0, 9.5, n_loans), 3),
        "orig_upb": np.round(rng.uniform(10_000, 800_000, n_loans), 2),
        "orig_loan_term": rng.choice([180, 240, 360], n_loans)
        .astype(np.int64),
        "orig_date": (month0 - 30 * rng.integers(0, 60, n_loans))
        .astype(np.int64).astype("datetime64[D]"),
    }
    return {"perf": perf, "acq": acq}


def mortgage_etl(session, tables: Dict[str, object]):
    """The pipeline over ``tables`` ({"perf", "acq"}: parquet paths or
    numpy columns) -> DataFrame, one row a (seller, channel)."""
    t = load_tables(session, tables)
    perf, acq = t["perf"], t["acq"]
    d = col("current_loan_delinquency_status")
    delinq = perf.group_by("loan_id").agg(
        F.max(when(d >= 1, 1).otherwise(0)).alias("ever_30"),
        F.max(when(d >= 3, 1).otherwise(0)).alias("ever_90"),
        F.max(when(d >= 6, 1).otherwise(0)).alias("ever_180"),
        F.min(when(d >= 1, col("monthly_reporting_period"))
              .otherwise(lit(dt.date(2100, 1, 1))))
        .alias("delinquency_30"),
        F.max(col("current_actual_upb")).alias("max_upb"),
        F.avg(col("interest_rate")).alias("avg_rate"),
        F.count(lit(1)).alias("reports"),
    )
    joined = acq.join(delinq, "loan_id", "left")
    cleaned = joined.with_column(
        "rate_delta",
        F.coalesce(col("avg_rate"), col("orig_interest_rate"))
        - col("orig_interest_rate")).with_column(
        "ever_90", F.coalesce(col("ever_90"), lit(0)))
    return (cleaned.group_by("seller_name", "orig_channel")
            .agg(F.count(lit(1)).alias("loans"),
                 F.sum(col("ever_90")).alias("ever_90_loans"),
                 F.avg(col("orig_upb")).alias("avg_upb"),
                 F.avg(col("rate_delta")).alias("avg_rate_delta"))
            .order_by("seller_name", "orig_channel"))
