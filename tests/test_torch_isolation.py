"""The torch port stands alone.

It imports no jax, no module of the JAX package and, on its main path
(the TPC-H and TPCx-BB queries and the mortgage ETL from numpy tables
included, the SQL front end with them, query profiles, ``explain`` and
the device handoff; CSV written, partitioned, read back and decoded, and
a standing query refreshed over a tailed CSV root), no pyarrow; pyarrow
may be imported only inside functions.  A fleet replica, a spawned process of its own, loads none
of them either.  A session on the card fails when no card is usable:
nothing moves to the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import spark_rapids_tpu_torch as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spark_rapids_tpu_torch")

_PROBE = """
import sys
import numpy as np
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
s = st.TorchSession({"spark.rapids.torch.device": "cpu"})
df = s.create_dataframe({"k": np.array([3, 1, 3, 2]),
                         "v": np.array([1.0, 2.0, 3.0, 4.0])})
cols, masks, n = (df.filter(st.col("v") > 1.0).group_by("k")
                  .agg(F.sum(st.col("v")).alias("s")).order_by("k")
                  .to_torch())
assert n == 3 and cols["k"].tolist() == [1, 2, 3], cols
assert cols["s"].tolist() == [2.0, 4.0, 3.0], cols
from spark_rapids_tpu_torch.bench import tpch
tables = tpch.load_tables(s, tpch.gen_tpch_numpy(400))
for q in tpch.TPCH_QUERIES.values():
    q(tables).to_torch()
from spark_rapids_tpu_torch.bench import mortgage, tpcxbb
mortgage.mortgage_etl(s, mortgage.gen_mortgage_numpy(2400)).to_torch()
tpcxbb.register_views(s, tpcxbb.gen_tpcxbb_numpy(1200))
for sql in tpcxbb.TPCXBB_QUERIES.values():
    s.sql(sql).to_torch()
q = tpch.TPCH_QUERIES["q1"](tables)
q.explain()
q.explain(analyze=True)
assert s.last_query_profile().to_dict()["plan"]["rows"] > 0
assert s.last_query_metrics()
assert q.to_device_batches()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                    "spark_rapids_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_main_path_imports_no_jax_or_pyarrow():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout


_CSV_PROBE = """
import os, sys, tempfile
import numpy as np
import spark_rapids_tpu_torch as st
from spark_rapids_tpu_torch import functions as F
root = tempfile.mkdtemp(dir=sys.argv[1])
conf = {"spark.rapids.torch.device": "cpu",
        "spark.rapids.stream.enabled": "true",
        "spark.rapids.stream.pollIntervalMs": "60000"}
s = st.TorchSession(conf)
df = s.create_dataframe({"k": np.array([3, 1, 3, 2]),
                         "v": np.array([1.5, 2.0, 3.0, 4.0]),
                         "r": np.array(["a", "b", "a", "c"])})
df.write.csv(os.path.join(root, "plain"))
df.write.partition_by("r").csv(os.path.join(root, "hive"))
back = s.read.csv(os.path.join(root, "hive")).filter(st.col("r") == "a")
assert back.collect() == [{"k": 3, "v": 1.5, "r": "a"},
                          {"k": 3, "v": 3.0, "r": "a"}], back.collect()
server = s.server(max_concurrency=1)
reg = server.streaming
q = reg.register(s.read.csv(os.path.join(root, "plain")).group_by("k")
                 .agg(F.sum(st.col("v")).alias("s")))
df.write.mode("append").csv(os.path.join(root, "plain"))
assert reg.tick() == 1 and q.incremental
assert sorted(r["s"] for r in q.result().collect()) == [4.0, 8.0, 9.0]
s.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                    "spark_rapids_tpu"))
print("BAD=" + ",".join(bad))
"""


def test_csv_and_streams_import_no_pyarrow(tmp_path):
    out = subprocess.run([sys.executable, "-c", _CSV_PROBE, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout


_REPLICA_PROBE = """
import sys
import numpy as np
import spark_rapids_tpu_torch as st
if __name__ == "__main__":
    s = st.TorchSession({"spark.rapids.torch.device": "cpu",
                         "spark.rapids.fleet.replicas": 1})
    fleet = s.fleet()
    fleet.register_table_view("t", {"k": np.array([3, 1, 3, 2]),
                                    "v": np.array([1.0, 2.0, 3.0, 4.0])})
    r = fleet.submit("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert r.result(timeout=120).to_numpy()["s"].tolist() == [2.0, 4.0, 4.0]
    mods = fleet.replica_stats(0)["process"]["modules"]
    s.stop()
    bad = sorted(m for m in list(sys.modules) + mods
                 if m.split(".")[0] in ("jax", "jaxlib", "pyarrow",
                                        "spark_rapids_tpu"))
    assert "spark_rapids_tpu_torch.fleet.replica" in mods
    print("BAD=" + ",".join(bad))
"""


def test_fleet_replica_imports_no_jax_or_pyarrow(tmp_path):
    script = tmp_path / "replica_probe.py"
    script.write_text(_REPLICA_PROBE)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_stay_inside_the_port(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    top_level = set(id(n) for n in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            where = f"{os.path.relpath(path, REPO)}:{node.lineno}"
            assert root not in ("jax", "jaxlib", "spark_rapids_tpu"), where
            if root == "pyarrow":
                assert id(node) not in top_level, \
                    f"{where}: pyarrow imported at module level"


def test_default_session_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default session is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        st.TorchSession()
    with pytest.raises(RuntimeError, match="cuda"):
        st.TorchSession.builder().get_or_create()
