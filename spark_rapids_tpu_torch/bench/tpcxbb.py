"""TPCx-BB-like corpus: a numpy generator, views and the 25 SQL queries.

Counterpart of ``spark_rapids_tpu/bench/tpcxbb.py``: the retail star
schema that the JAX package's ``gen_tpcxbb`` writes and its 25 queries,
whose texts are copied verbatim and run through ``session.sql``.
``gen_tpcxbb_numpy`` makes the same fourteen tables, column for column,
from the same seed: it draws from one ``np.random.default_rng`` in
``gen_tpcxbb``'s order (``ca_state``'s scalar draws included) but
returns numpy arrays instead of writing parquet, so it needs no pyarrow;
``ca_state`` is an object array whose ``None`` is null.
``register_views`` registers each table as a view, from parquet paths
or numpy columns.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch.bench.tpch import Tables, load_tables

_CATEGORIES = ["Books", "Electronics", "Home", "Music", "Shoes",
               "Sports", "Toys", "Jewelry"]
_STATES = ["CA", "NY", "TX", "WA", "OR", "IL", "FL", "GA", "MA", "CO",
           "UT", "AZ", "NV", "NM", "OK"]


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return np.round(rng.uniform(lo, hi, n), 2)


def gen_tpcxbb_numpy(sales_rows: int = 60_000, seed: int = 31) -> Tables:
    """The fourteen tables as {table: {column: numpy array}}, equal to
    what ``gen_tpcxbb(dir, sales_rows, seed)`` writes; sizes scale off
    ``sales_rows`` as there."""
    rng = np.random.default_rng(seed)
    n_item = max(8, sales_rows // 60)
    n_cust = max(4, sales_rows // 30)
    n_addr = max(4, n_cust // 2)
    n_wh = 5
    n_dates = 365
    # every draw below comes in gen_tpcxbb's order

    def ints(lo, hi, n):
        return rng.integers(lo, hi, n).astype(np.int64)

    item = {"i_item_sk": np.arange(n_item, dtype=np.int64),
            "i_category": np.array(_CATEGORIES)[
                rng.integers(0, len(_CATEGORIES), n_item)],
            "i_current_price": _money(rng, 0.5, 300.0, n_item)}
    # gen_tpcxbb draws the states' indices first, then one scalar a row
    # for its null
    states = np.array(_STATES, dtype=object)[
        rng.integers(0, len(_STATES), n_addr)]
    states[np.array([rng.random() < 0.02 for _ in range(n_addr)],
                    dtype=bool)] = None
    customer_address = {"ca_address_sk": np.arange(n_addr, dtype=np.int64),
                        "ca_state": states}
    customer = {"c_customer_sk": np.arange(n_cust, dtype=np.int64),
                "c_current_addr_sk": ints(0, n_addr, n_cust)}
    date_dim = {"d_date_sk": np.arange(n_dates, dtype=np.int64),
                "d_year": np.where(np.arange(n_dates) < 180, 2001, 2002)
                .astype(np.int64),
                "d_moy": (np.arange(n_dates) // 30 % 12 + 1).astype(np.int64)}
    s = sales_rows
    store_sales = {"ss_item_sk": ints(0, n_item, s),
                   "ss_customer_sk": ints(0, n_cust, s),
                   "ss_ticket_number": ints(0, max(1, s // 4), s),
                   "ss_quantity": ints(1, 101, s),
                   "ss_list_price": _money(rng, 1.0, 310.0, s),
                   "ss_sales_price": _money(rng, 0.5, 290.0, s),
                   "ss_sold_date_sk": ints(0, n_dates, s)}
    w = max(8, s // 2)
    web_sales = {"ws_item_sk": ints(0, n_item, w),
                 "ws_bill_customer_sk": ints(0, n_cust, w),
                 "ws_order_number": ints(0, max(1, w // 3), w),
                 "ws_warehouse_sk": ints(0, n_wh, w),
                 "ws_sales_price": _money(rng, 0.5, 290.0, w),
                 "ws_sold_date_sk": ints(0, n_dates, w)}
    r = max(4, w // 5)
    web_returns = {"wr_order_number": ints(0, max(1, w // 3), r),
                   "wr_item_sk": ints(0, n_item, r),
                   "wr_return_amt": _money(rng, 0.5, 200.0, r)}
    sr = max(4, s // 8)
    store_returns = {"sr_customer_sk": ints(0, n_cust, sr),
                     "sr_item_sk": ints(0, n_item, sr),
                     "sr_returned_date_sk": ints(0, n_dates, sr)}
    c = max(8, s // 2)
    web_clickstreams = {"wcs_user_sk": ints(0, n_cust, c),
                        "wcs_item_sk": ints(0, n_item, c),
                        "wcs_click_date_sk": ints(0, n_dates, c)}
    customer_demographics = {
        "cd_demo_sk": np.arange(n_cust, dtype=np.int64),
        "cd_gender": np.where(rng.integers(0, 2, n_cust) != 0, "M", "F")}
    n_rev = max(8, s // 10)
    product_reviews = {"pr_item_sk": ints(0, n_item, n_rev),
                       "pr_review_rating": ints(1, 6, n_rev)}
    item_marketprices = {"imp_item_sk": ints(0, n_item, n_item * 2),
                         "imp_competitor_price": _money(rng, 0.3, 280.0,
                                                        n_item * 2)}
    warehouse = {"w_warehouse_sk": np.arange(n_wh, dtype=np.int64),
                 "w_state": np.array([_STATES[i % len(_STATES)]
                                      for i in range(n_wh)])}
    inv = s // 3
    inventory = {"inv_warehouse_sk": ints(0, n_wh, inv),
                 "inv_item_sk": ints(0, n_item, inv),
                 "inv_date_sk": ints(0, n_dates, inv),
                 "inv_quantity_on_hand": ints(0, 1000, inv)}
    # in the order gen_tpcxbb returns its paths
    return {"item": item, "customer": customer,
            "customer_address": customer_address, "date_dim": date_dim,
            "store_sales": store_sales, "inventory": inventory,
            "web_sales": web_sales, "web_returns": web_returns,
            "store_returns": store_returns,
            "web_clickstreams": web_clickstreams,
            "customer_demographics": customer_demographics,
            "product_reviews": product_reviews,
            "item_marketprices": item_marketprices, "warehouse": warehouse}


def register_views(session, tables: Dict[str, object]) -> None:
    """Register each of ``tables`` ({name: parquet path or numpy
    columns}) as a view of ``session``."""
    for name, df in load_tables(session, tables).items():
        df.create_or_replace_temp_view(name)


# the JAX package's 25 query texts, verbatim
Q7_LIKE = """
SELECT ca.ca_state, COUNT(*) AS cnt
FROM customer_address ca
JOIN customer c ON ca.ca_address_sk = c.c_current_addr_sk
JOIN store_sales s ON c.c_customer_sk = s.ss_customer_sk
JOIN (
  SELECT k.i_item_sk
  FROM item k
  JOIN (
    SELECT i_category, AVG(i_current_price) * 1.2 AS avg_price
    FROM item GROUP BY i_category
  ) acp ON acp.i_category = k.i_category
  WHERE k.i_current_price > acp.avg_price
) hp ON s.ss_item_sk = hp.i_item_sk
JOIN date_dim d ON s.ss_sold_date_sk = d.d_date_sk
WHERE ca.ca_state IS NOT NULL AND d.d_year = 2001 AND d.d_moy = 2
GROUP BY ca.ca_state
HAVING COUNT(*) >= 3
ORDER BY cnt DESC, ca_state
LIMIT 10
"""

Q9_LIKE = """
SELECT SUM(ss_quantity) AS total
FROM store_sales
WHERE (ss_quantity >= 1 AND ss_quantity <= 20
       AND ss_list_price >= 50 AND ss_list_price <= 150)
   OR (ss_quantity >= 21 AND ss_quantity <= 60
       AND ss_sales_price >= 30 AND ss_sales_price <= 130)
   OR (ss_quantity >= 61 AND ss_quantity <= 100
       AND ss_list_price >= 10 AND ss_list_price <= 110)
"""

Q22_LIKE = """
SELECT w_item, inv_before, inv_after
FROM (
  SELECT inv_item_sk AS w_item,
         SUM(CASE WHEN inv_date_sk < 180 THEN inv_quantity_on_hand
             ELSE 0 END) AS inv_before,
         SUM(CASE WHEN inv_date_sk >= 180 THEN inv_quantity_on_hand
             ELSE 0 END) AS inv_after
  FROM inventory
  GROUP BY inv_item_sk
) x
WHERE inv_before > 0
  AND CAST(inv_after AS DOUBLE) / CAST(inv_before AS DOUBLE)
      BETWEEN 0.667 AND 1.5
ORDER BY w_item
LIMIT 100
"""

Q1_LIKE = """
SELECT ia, ib, COUNT(*) AS cnt
FROM (SELECT ss_ticket_number AS ta, ss_item_sk AS ia
      FROM store_sales) a
JOIN (SELECT ss_ticket_number AS tb, ss_item_sk AS ib
      FROM store_sales) b ON a.ta = b.tb
WHERE ia < ib
GROUP BY ia, ib
HAVING COUNT(*) >= 2
ORDER BY cnt DESC, ia, ib
LIMIT 100
"""

Q5_LIKE = """
SELECT i.i_category, COUNT(*) AS clicks,
       SUM(CASE WHEN cd.cd_gender = 'M' THEN 1 ELSE 0 END) AS male_clicks
FROM web_clickstreams w
JOIN item i ON w.wcs_item_sk = i.i_item_sk
JOIN customer_demographics cd ON w.wcs_user_sk = cd.cd_demo_sk
GROUP BY i.i_category
ORDER BY clicks DESC, i_category
LIMIT 10
"""

Q6_LIKE = """
SELECT s.cust, s.store_amt, w.web_amt
FROM (SELECT ss_customer_sk AS cust, SUM(ss_sales_price) AS store_amt
      FROM store_sales GROUP BY ss_customer_sk) s
JOIN (SELECT ws_bill_customer_sk AS cust2, SUM(ws_sales_price) AS web_amt
      FROM web_sales GROUP BY ws_bill_customer_sk) w
  ON s.cust = w.cust2
WHERE w.web_amt > s.store_amt * 1.2
ORDER BY web_amt DESC, cust
LIMIT 100
"""

Q12_LIKE = """
SELECT COUNT(*) AS conversions
FROM web_clickstreams w
JOIN store_sales s ON w.wcs_user_sk = s.ss_customer_sk
                  AND w.wcs_item_sk = s.ss_item_sk
WHERE s.ss_sold_date_sk > w.wcs_click_date_sk
  AND s.ss_sold_date_sk <= w.wcs_click_date_sk + 90
"""

Q15_LIKE = """
SELECT i.i_category, d.d_moy, SUM(s.ss_sales_price) AS amt
FROM store_sales s
JOIN item i ON s.ss_item_sk = i.i_item_sk
JOIN date_dim d ON s.ss_sold_date_sk = d.d_date_sk
WHERE d.d_year = 2001
GROUP BY i.i_category, d.d_moy
ORDER BY i_category, d_moy
"""

Q16_LIKE = """
SELECT w.w_state,
       SUM(CASE WHEN d.d_date_sk < 180 THEN ws.ws_sales_price
           ELSE 0.0 END) AS sales_before,
       SUM(CASE WHEN d.d_date_sk >= 180 THEN ws.ws_sales_price
           ELSE 0.0 END) AS sales_after,
       SUM(wr.wr_return_amt) AS returned
FROM web_sales ws
JOIN web_returns wr ON ws.ws_order_number = wr.wr_order_number
                   AND ws.ws_item_sk = wr.wr_item_sk
JOIN date_dim d ON ws.ws_sold_date_sk = d.d_date_sk
JOIN warehouse w ON ws.ws_warehouse_sk = w.w_warehouse_sk
GROUP BY w.w_state
ORDER BY w_state
"""

Q20_LIKE = """
SELECT s.cust, s.n_sales, r.n_returns
FROM (SELECT ss_customer_sk AS cust, COUNT(*) AS n_sales
      FROM store_sales GROUP BY ss_customer_sk) s
JOIN (SELECT sr_customer_sk AS cust2, COUNT(*) AS n_returns
      FROM store_returns GROUP BY sr_customer_sk) r
  ON s.cust = r.cust2
WHERE r.n_returns * 5 > s.n_sales
ORDER BY n_returns DESC, cust
LIMIT 100
"""

Q24_LIKE = """
SELECT i.i_item_sk AS item_sk,
       SUM(CASE WHEN s.ss_sold_date_sk < 180 THEN s.ss_quantity
           ELSE 0 END) AS qty_before,
       SUM(CASE WHEN s.ss_sold_date_sk >= 180 THEN s.ss_quantity
           ELSE 0 END) AS qty_after
FROM store_sales s
JOIN item i ON s.ss_item_sk = i.i_item_sk
JOIN item_marketprices mp ON i.i_item_sk = mp.imp_item_sk
WHERE mp.imp_competitor_price < i.i_current_price * 0.9
GROUP BY i.i_item_sk
ORDER BY item_sk
LIMIT 100
"""

Q26_LIKE = """
SELECT s.ss_customer_sk AS cid, COUNT(*) AS cnt,
       SUM(s.ss_sales_price) AS amt
FROM store_sales s
JOIN item i ON s.ss_item_sk = i.i_item_sk
WHERE i.i_category = 'Books'
GROUP BY s.ss_customer_sk
HAVING COUNT(*) >= 2
ORDER BY cid
LIMIT 100
"""

Q30_LIKE = """
SELECT ia, ib, COUNT(*) AS views
FROM (SELECT wcs_user_sk AS u, wcs_click_date_sk AS dt,
             wcs_item_sk AS ia FROM web_clickstreams) a
JOIN (SELECT wcs_user_sk AS u2, wcs_click_date_sk AS dt2,
             wcs_item_sk AS ib FROM web_clickstreams) b
  ON a.u = b.u2 AND a.dt = b.dt2
WHERE ia < ib
GROUP BY ia, ib
ORDER BY views DESC, ia, ib
LIMIT 100
"""

Q2_LIKE = """
SELECT ib AS also_viewed, COUNT(*) AS views
FROM (SELECT wcs_user_sk AS u, wcs_click_date_sk AS dt,
             wcs_item_sk AS ia FROM web_clickstreams) a
JOIN (SELECT wcs_user_sk AS u2, wcs_click_date_sk AS dt2,
             wcs_item_sk AS ib FROM web_clickstreams) b
  ON a.u = b.u2 AND a.dt = b.dt2
WHERE ia = 3 AND ib <> 3
GROUP BY ib
ORDER BY views DESC, also_viewed
LIMIT 30
"""

Q3_LIKE = """
SELECT w.wcs_item_sk AS viewed, COUNT(*) AS cnt
FROM web_clickstreams w
JOIN store_sales s ON w.wcs_user_sk = s.ss_customer_sk
JOIN item i ON s.ss_item_sk = i.i_item_sk
WHERE i.i_category = 'Electronics'
  AND s.ss_sold_date_sk > w.wcs_click_date_sk
  AND s.ss_sold_date_sk <= w.wcs_click_date_sk + 10
GROUP BY w.wcs_item_sk
ORDER BY cnt DESC, viewed
LIMIT 30
"""

Q8_LIKE = """
SELECT COUNT(*) AS web_conversions
FROM web_clickstreams w
JOIN web_sales ws ON w.wcs_user_sk = ws.ws_bill_customer_sk
                 AND w.wcs_item_sk = ws.ws_item_sk
WHERE ws.ws_sold_date_sk > w.wcs_click_date_sk
  AND ws.ws_sold_date_sk <= w.wcs_click_date_sk + 30
"""

Q11_LIKE = """
SELECT r.item, r.avg_rating, s.n_sold
FROM (SELECT pr_item_sk AS item, AVG(pr_review_rating) AS avg_rating
      FROM product_reviews GROUP BY pr_item_sk) r
JOIN (SELECT ss_item_sk AS item2, COUNT(*) AS n_sold
      FROM store_sales GROUP BY ss_item_sk) s
  ON r.item = s.item2
WHERE r.avg_rating >= 4.0
ORDER BY n_sold DESC, item
LIMIT 100
"""

Q13_LIKE = """
SELECT s.cust, s.amt_2001, s.amt_2002
FROM (SELECT ss.ss_customer_sk AS cust,
             SUM(CASE WHEN d.d_year = 2001 THEN ss.ss_sales_price
                 ELSE 0.0 END) AS amt_2001,
             SUM(CASE WHEN d.d_year = 2002 THEN ss.ss_sales_price
                 ELSE 0.0 END) AS amt_2002
      FROM store_sales ss
      JOIN date_dim d ON ss.ss_sold_date_sk = d.d_date_sk
      GROUP BY ss.ss_customer_sk) s
WHERE s.amt_2001 > 0.0 AND s.amt_2002 > s.amt_2001
ORDER BY amt_2002 DESC, cust
LIMIT 100
"""

Q21_LIKE = """
SELECT r.sr_item_sk AS item_sk, COUNT(*) AS rebuys
FROM store_returns r
JOIN store_sales s ON r.sr_customer_sk = s.ss_customer_sk
                  AND r.sr_item_sk = s.ss_item_sk
WHERE s.ss_sold_date_sk > r.sr_returned_date_sk
  AND s.ss_sold_date_sk <= r.sr_returned_date_sk + 60
GROUP BY r.sr_item_sk
ORDER BY rebuys DESC, item_sk
LIMIT 100
"""

Q23_LIKE = """
SELECT w_item, n, mean_q, m2
FROM (
  SELECT inv_item_sk AS w_item, COUNT(*) AS n,
         AVG(inv_quantity_on_hand) AS mean_q,
         SUM(inv_quantity_on_hand * inv_quantity_on_hand) AS m2
  FROM inventory
  GROUP BY inv_item_sk
) x
WHERE n >= 4
  AND m2 - CAST(n AS DOUBLE) * mean_q * mean_q
      > 0.09 * CAST(n AS DOUBLE) * mean_q * mean_q
ORDER BY w_item
LIMIT 100
"""

Q4_LIKE = """
SELECT c.wcs_user_sk AS shopper, c.n_views
FROM (SELECT wcs_user_sk, COUNT(*) AS n_views
      FROM web_clickstreams GROUP BY wcs_user_sk) c
JOIN (SELECT ss_customer_sk FROM store_sales
      GROUP BY ss_customer_sk) s
  ON c.wcs_user_sk = s.ss_customer_sk
WHERE c.n_views >= 5
ORDER BY n_views DESC, shopper
LIMIT 100
"""

Q10_LIKE = """
SELECT i.i_category, COUNT(*) AS n_reviews,
       AVG(r.pr_review_rating) AS avg_rating
FROM product_reviews r
JOIN item i ON r.pr_item_sk = i.i_item_sk
GROUP BY i.i_category
HAVING COUNT(*) >= 3
ORDER BY avg_rating DESC, i_category
"""

Q14_LIKE = """
SELECT CAST(SUM(CASE WHEN d.d_moy <= 6 THEN 1 ELSE 0 END) AS DOUBLE)
       / CAST(SUM(CASE WHEN d.d_moy > 6 THEN 1 ELSE 0 END) AS DOUBLE)
       AS first_half_ratio
FROM store_sales s
JOIN date_dim d ON s.ss_sold_date_sk = d.d_date_sk
"""

Q17_LIKE = """
SELECT i.i_category,
       SUM(CASE WHEN mp.imp_competitor_price < i.i_current_price
           THEN s.ss_sales_price ELSE 0.0 END) AS undercut_sales,
       SUM(s.ss_sales_price) AS total_sales
FROM store_sales s
JOIN item i ON s.ss_item_sk = i.i_item_sk
JOIN item_marketprices mp ON i.i_item_sk = mp.imp_item_sk
GROUP BY i.i_category
ORDER BY i_category
"""

Q25_LIKE = """
SELECT s.ss_customer_sk AS cid,
       MAX(s.ss_sold_date_sk) AS last_purchase,
       COUNT(*) AS frequency,
       SUM(s.ss_sales_price) AS monetary
FROM store_sales s
GROUP BY s.ss_customer_sk
HAVING COUNT(*) >= 3
ORDER BY monetary DESC, cid
LIMIT 100
"""

TPCXBB_QUERIES = {
    "q1": Q1_LIKE, "q2": Q2_LIKE, "q3": Q3_LIKE, "q4": Q4_LIKE,
    "q5": Q5_LIKE, "q6": Q6_LIKE, "q7": Q7_LIKE, "q8": Q8_LIKE,
    "q9": Q9_LIKE, "q10": Q10_LIKE, "q11": Q11_LIKE, "q12": Q12_LIKE,
    "q13": Q13_LIKE, "q14": Q14_LIKE, "q15": Q15_LIKE, "q16": Q16_LIKE,
    "q17": Q17_LIKE, "q20": Q20_LIKE, "q21": Q21_LIKE, "q22": Q22_LIKE,
    "q23": Q23_LIKE, "q24": Q24_LIKE, "q25": Q25_LIKE, "q26": Q26_LIKE,
    "q30": Q30_LIKE,
}


# the queries bench.py runs first (its ``_tpcxbb_suites`` lead)
LEAD_QUERIES = ("q5", "q24", "q26", "q15", "q7", "q13", "q11", "q12")
