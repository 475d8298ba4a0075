"""The multi-shard dry run: the mesh pipelines against numpy oracles.

Counterpart of ``__graft_entry__.py: dryrun_multichip``.  Over a mesh of
``n_devices`` shards on ``device`` (the session's default, the card,
unless the caller asks for ``cpu``; all shards on that one device,
through ``parallel/mesh.py: virtual_pool``, so the peer copy between two
GPUs is not exercised), it runs

1. a grouped aggregation (``DistributedAggregate``: count, sum, min,
   max, avg by an integer key);
2. a broadcast join fused with a grouped aggregation
   (``DistributedBroadcastJoinAggregate``: the sharded fact stream, the
   replicated dimension build, groups by a string column of the
   dimension);
3. a global sort (``DistributedSort``);
4. the same join, aggregate and sort through ``session.sql`` under
   ``spark.rapids.sql.mesh.devices`` and under
   ``spark.rapids.shuffle.mode=ici``, against the single-device
   session;

and checks each against numpy (counts exact, sums within 1e-9
relative).  It needs neither pyarrow nor JAX.  ``python -m
spark_rapids_tpu_torch.parallel.dryrun [n] [device]`` runs it (``python
-m spark_rapids_tpu_torch.parallel.dryrun 8 cpu`` on a machine without a
card).
"""

from __future__ import annotations

import collections
import sys
from typing import Dict

import numpy as np
import torch


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-9 * max(1.0, abs(b))


def dryrun_multichip(n_devices: int = 8, device=None) -> Dict[str, int]:
    """Run the four checks on ``device`` (default: the conf's
    ``spark.rapids.torch.device``, the card); raise ``AssertionError`` on
    a mismatch -> the number of groups or rows each produced."""
    from spark_rapids_tpu_torch.conf import DEVICE, TorchConf
    from spark_rapids_tpu_torch.parallel.mesh import virtual_pool
    device = torch.device(device if device is not None
                          else TorchConf().get(DEVICE))
    with virtual_pool(n_devices):
        return _dryrun(n_devices, device)


def _dryrun(n_devices: int, device: torch.device) -> Dict[str, int]:
    from spark_rapids_tpu_torch.columnar.batch import \
        host_batch_to_device, host_columns_from_numpy
    from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT64, \
        STRING
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.exprs.aggregates import Average, Count, \
        Max, Min, Sum
    from spark_rapids_tpu_torch.exprs.base import Alias, BoundReference
    from spark_rapids_tpu_torch.parallel import \
        DistributedBroadcastJoinAggregate, DistributedAggregate, data_mesh
    from spark_rapids_tpu_torch.parallel.distsort import DistributedSort

    conf = TorchConf({"spark.rapids.torch.device": str(device)})
    mesh = data_mesh(n_devices, conf=conf)
    out: Dict[str, int] = {}

    rng = np.random.default_rng(42)
    n = 64 * n_devices
    kk = rng.integers(0, 23, n).astype(np.int64)
    vv = rng.normal(size=n)
    schema, cols = host_columns_from_numpy({"k": kk, "v": vv})
    batch = host_batch_to_device(schema, cols, device)
    k = BoundReference(0, INT64, True, "k")
    v = BoundReference(1, FLOAT64, True, "v")

    # 1. grouped aggregation
    aggs = [Alias(Count(v), "cnt"), Alias(Sum(v), "s"), Alias(Min(v), "mn"),
            Alias(Max(v), "mx"), Alias(Average(v), "avg")]
    res = DistributedAggregate([k], aggs, mesh=mesh, conf=conf).run(batch)
    got = [c.data[:res.num_rows].cpu().numpy() for c in res.columns]
    keys = np.unique(kk)
    assert res.num_rows == len(keys), (res.num_rows, len(keys))
    for key, cnt, s, mn, mx, avg in zip(*got):
        sel = vv[kk == key]
        assert int(cnt) == len(sel), (key, cnt, len(sel))
        assert _close(float(s), float(sel.sum())), (key, s)
        assert float(mn) == sel.min() and float(mx) == sel.max(), key
        assert _close(float(avg), float(sel.mean())), (key, avg)
    out["groupby_groups"] = res.num_rows

    # 2. broadcast join + grouped aggregation
    names = np.array([f"g{i % 4}" for i in range(23)], dtype=object)
    dschema, dcols = host_columns_from_numpy(
        {"k": np.arange(23, dtype=np.int64), "grp": names})
    dim = host_batch_to_device(dschema, dcols, device)
    grp = BoundReference(3, STRING, True, "grp")
    dist = DistributedBroadcastJoinAggregate(
        dim, [k], [BoundReference(0, INT64, True, "k")], [grp],
        [Alias(Count(v), "c"), Alias(Sum(v), "s")], mesh=mesh, conf=conf)
    jres = dist.run(batch)
    want_c = collections.Counter()
    want_s = collections.defaultdict(float)
    for key, val in zip(kk, vv):
        want_c[names[key]] += 1
        want_s[names[key]] += float(val)
    lens = jres.columns[0].data[:jres.num_rows].cpu().numpy()
    chars = jres.columns[0].chars[:jres.num_rows].cpu().numpy()
    got_names = [bytes(chars[i, :lens[i]]).decode() for i in range(len(lens))]
    cnts = jres.columns[1].data[:jres.num_rows].cpu().numpy()
    sums = jres.columns[2].data[:jres.num_rows].cpu().numpy()
    assert sorted(got_names) == sorted(want_c), (got_names, want_c)
    for nm, c, s in zip(got_names, cnts, sums):
        assert int(c) == want_c[nm] and _close(float(s), want_s[nm]), nm
    out["broadcast_join_groups"] = jres.num_rows

    # 3. global sort
    sres = DistributedSort([(v, True, True)], schema, mesh=mesh).run(batch)
    sv = sres.columns[1].data[:sres.num_rows].cpu().numpy()
    assert sres.num_rows == n
    assert np.array_equal(sv, np.sort(vv)), "distributed sort out of order"
    out["sort_rows"] = sres.num_rows

    # 4. the planner's lowerings through session.sql
    import spark_rapids_tpu_torch as st
    fact = {"k": rng.integers(0, 23, n).astype(np.int64),
            "v": rng.normal(size=n)}
    dim2 = {"k": np.arange(23, dtype=np.int64),
            "grp": rng.integers(0, 4, 23).astype(np.int64)}
    sql = ("SELECT grp, COUNT(v) AS c, SUM(v) AS s FROM fact "
           "JOIN dim ON fact.k = dim.k GROUP BY grp ORDER BY grp")
    base = {"spark.rapids.torch.device": str(device)}
    results = {}
    for mode, extra in (("single", {}),
                        ("mesh", {"spark.rapids.sql.mesh.devices":
                                  n_devices}),
                        ("ici", {"spark.rapids.shuffle.mode": "ici"})):
        ses = st.TorchSession({**base, **extra})
        ses.create_dataframe(fact).create_or_replace_temp_view("fact")
        ses.create_dataframe(dim2).create_or_replace_temp_view("dim")
        df = ses.sql(sql)
        if mode != "single":
            from spark_rapids_tpu_torch.plan.planner import plan_query
            tree = plan_query(df.plan, ses.conf).tree_string()
            assert "TorchMesh" in tree, tree
        results[mode] = df.to_numpy()
    want = results["single"]
    for mode in ("mesh", "ici"):
        got = results[mode]
        assert np.array_equal(got["grp"], want["grp"]), mode
        assert np.array_equal(got["c"], want["c"]), mode
        assert all(_close(float(a), float(b))
                   for a, b in zip(got["s"], want["s"])), mode
    out["sql_groups"] = len(want["grp"])
    return out


if __name__ == "__main__":
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = sys.argv[2] if len(sys.argv) > 2 else None
    print(dryrun_multichip(width, dev))
