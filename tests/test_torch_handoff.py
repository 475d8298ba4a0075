"""The torch port's device handoff and DataFrame aliases against the JAX
package.

``to_device_batches()`` returns the result's ``ColumnarBatch``es with
their tensors on the session's device (the CPU here); their rows, read
back as numpy, equal the rows of the JAX package's
``to_device_batches()`` for the same query: the values of valid rows,
the validity masks, and a string column's bytes below each row's
length (the two packages may pad the char matrix to different widths).
``where`` is ``filter`` and ``sort`` is ``order_by``, in both packages.
Comparisons are exact.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import functions as F
from spark_rapids_tpu.api import col
from tests.compare import assert_tables_equal, tpu_session

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


def _port():
    return st.TorchSession({"spark.rapids.torch.device": "cpu"})


def _table(n=2500, seed=8):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 30, n), pa.int64()),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"row{int(i)}" for i in rng.integers(0, 99, n)]),
    })


def _rows(batches, names):
    """Each column's (values where valid, validity) over the batches,
    concatenated, as numpy."""
    out = {}
    for i, name in enumerate(names):
        vals, valid = [], []
        for b in batches:
            c = b.columns[i]
            n = b.num_rows
            ok = np.asarray(c.validity)[:n].astype(bool)
            data = np.asarray(c.data)[:n]
            if c.chars is not None:
                chars = np.asarray(c.chars)[:n]
                data = np.array([bytes(chars[r, :int(data[r])])
                                 for r in range(n)], dtype=object)
            vals.append(np.where(ok, data, np.zeros_like(data))
                        if c.chars is None else
                        np.array([d if o else b"" for d, o in zip(data, ok)],
                                 dtype=object))
            valid.append(ok)
        out[name] = (np.concatenate(vals) if vals else np.zeros(0),
                     np.concatenate(valid) if valid else np.zeros(0, bool))
    return out


QUERIES = {
    "scan": lambda c, f, df: df,
    "filter_project": lambda c, f, df: df.filter(c("v") > 0).select(
        "k", (c("v") * 3).alias("v3"), "s"),
    "aggregate": lambda c, f, df: df.group_by("k").agg(
        f.sum(c("v")).alias("sv"), f.max(c("s")).alias("ms")).order_by("k"),
    "empty": lambda c, f, df: df.filter(c("k") > 1000),
}


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_device_batches_rows_match_jax(qname):
    t = _table()
    q = QUERIES[qname]
    jb = q(col, F, tpu_session().create_dataframe(t)).to_device_batches()
    ps = _port()
    df = q(st.col, TF, ps.create_dataframe(t))
    pb = df.to_device_batches()
    assert all(isinstance(b, ColumnarBatch) for b in pb)
    for b in pb:
        for c in b.columns:
            assert c.data.device == ps.device
    names = df.columns
    got, want = _rows(pb, names), _rows(jb, names)
    for name in names:
        np.testing.assert_array_equal(got[name][1], want[name][1], name)
        assert got[name][0].tolist() == want[name][0].tolist(), name
    # the handoff is a query: the session keeps its profile
    assert ps.last_query_profile().root.rows == sum(b.num_rows for b in pb)


@pytest.mark.parametrize("alias,name", [("where", "filter"),
                                        ("sort", "order_by")])
def test_aliases_are_the_methods(alias, name):
    assert getattr(st.DataFrame, alias) is getattr(st.DataFrame, name)
    t = _table(800)
    pdf = _port().create_dataframe(t)
    jdf = tpu_session().create_dataframe(t)
    if name == "filter":
        got = pdf.where(st.col("v") < 0).to_arrow()
        want = jdf.where(col("v") < 0).to_arrow()
        assert_tables_equal(got, pdf.filter(st.col("v") < 0).to_arrow(),
                            ignore_order=False)
    else:
        got = pdf.sort(st.col("k").desc(), "s").to_arrow()
        want = jdf.sort(col("k").desc(), "s").to_arrow()
        assert_tables_equal(got, pdf.order_by(st.col("k").desc(), "s")
                            .to_arrow(), ignore_order=False)
    assert_tables_equal(got, want, ignore_order=False)
