"""The torch port's ``utils/tracing.py``: analogs of ``tests/test_tracing.py``
and ``tests/test_aux.py``'s tracing tests.

Ranges are None while the switch is off and no ``torch.profiler``
capture records; ``trace_range`` and ``MetricSet.timed`` add their time
traced or not; ``query_trace`` sets the switch from the conf for one
query and gives the earlier value back, on an error as well; with
``trace.enabled`` and ``trace.dir`` a query writes one Chrome trace
there, whose events include the operators' ranges.  The JAX package's
switch is held beside the port's where the two contracts are the same
(the same conf, the same states before and after).
"""

import glob
import json

import numpy as np
import pytest
import torch

from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.utils import tracing as jtracing

import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.utils import tracing
from spark_rapids_tpu_torch.utils.metrics import MetricSet


@pytest.fixture(autouse=True)
def _restore_switch():
    prev = tracing.is_enabled()
    yield
    tracing.set_enabled(prev)


def _session(extra=None):
    return st.TorchSession({"spark.rapids.torch.device": "cpu",
                            **(extra or {})})


def _df(s, n=400):
    rng = np.random.default_rng(4)
    return s.create_dataframe({"k": rng.integers(0, 10, n),
                               "v": rng.normal(size=n)})


def test_annotation_off_is_none():
    tracing.set_enabled(False)
    assert tracing.annotation("x.section") is None


def test_annotation_on_is_usable_context():
    tracing.set_enabled(True)
    ann = tracing.annotation("x.section")
    assert ann is not None
    with ann:
        pass


def test_annotation_opens_under_an_active_profiler():
    """The switch is off, but a capture is recording: the range opens, so
    a caller's own ``torch.profiler`` sees the operators' ranges."""
    tracing.set_enabled(False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.trace_range("x.section"):
            torch.ones(4).sum()
    assert tracing.annotation("x.section") is None
    assert "x.section" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("on", [False, True])
def test_trace_range_accumulates_metric(on):
    tracing.set_enabled(on)
    ms = MetricSet(owner="TestOp", adhoc=True)
    with tracing.trace_range("TestOp.section", ms["sectionTime"]):
        pass
    assert ms["sectionTime"].value > 0


def test_trace_range_without_metric():
    for on in (False, True):
        tracing.set_enabled(on)
        with tracing.trace_range("TestOp.bare"):
            pass


@pytest.mark.parametrize("on", [False, True])
def test_timed_sections(on):
    tracing.set_enabled(on)
    ms = MetricSet(owner="TestOp")
    with ms.timed("totalTime"):
        pass
    assert ms.snapshot()["totalTime"] > 0


def test_query_trace_sets_switch_from_conf_as_jax():
    for on in (True, False):
        key = {"spark.rapids.sql.trace.enabled": on}
        jtracing.set_enabled(not on)
        tracing.set_enabled(not on)
        with jtracing.query_trace(TpuConf(key)):
            inside_jax = jtracing.is_enabled()
        with tracing.query_trace(TorchConf(key)):
            inside = tracing.is_enabled()
        assert inside == inside_jax == on
        assert tracing.is_enabled() == jtracing.is_enabled() == (not on)
    jtracing.set_enabled(False)


def test_query_trace_restores_on_exception():
    tracing.set_enabled(False)
    with pytest.raises(RuntimeError):
        with tracing.query_trace(TorchConf(
                {"spark.rapids.sql.trace.enabled": True})):
            assert tracing.is_enabled()
            raise RuntimeError("query failed mid-trace")
    assert not tracing.is_enabled()


@pytest.mark.parametrize("action", ["collect", "to_torch",
                                    "to_device_batches"])
def test_actions_restore_the_switch(action):
    tracing.set_enabled(False)
    s = _session({"spark.rapids.sql.trace.enabled": "true"})
    out = getattr(_df(s), action)()
    assert out is not None
    assert not tracing.is_enabled()


def test_query_execution_with_spans_on():
    s = _session({"spark.rapids.sql.trace.enabled": "true"})
    out = _df(s).filter(st.col("v") > 0).group_by("k").agg(
        TF.count(st.col("v")).alias("c")).collect()
    assert len(out) > 0
    assert not tracing.is_enabled()


def test_query_trace_writes_one_capture_a_query(tmp_path):
    s = _session({"spark.rapids.sql.trace.enabled": "true",
                  "spark.rapids.sql.trace.dir": str(tmp_path)})
    dim = s.create_dataframe({"k": np.arange(10), "w": np.arange(10.0)})
    q = _df(s).join(dim, on="k").group_by("k").agg(
        TF.sum(st.col("w")).alias("sw"))
    q.collect()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("join.") for n in names if n), sorted(
        n for n in names if n)[:40]
    q.to_torch()
    _df(s).to_device_batches()
    assert len(glob.glob(str(tmp_path / "*.json"))) == 3
    # without the switch a trace.dir writes nothing
    off = _session({"spark.rapids.sql.trace.dir": str(tmp_path / "off")})
    _df(off).collect()
    assert not glob.glob(str(tmp_path / "off" / "*.json"))
