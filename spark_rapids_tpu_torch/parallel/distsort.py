"""Distributed global sort over the mesh.

Counterpart of ``spark_rapids_tpu/parallel/distsort.py``
(``DistributedSort``).  The host samples the sort keys' bounds once over
the whole input, as the JAX package does: an evenly spaced
``np.linspace`` sample of at most 10,000 rows, pulled in one counted
``device_pull``, whose bound tuples come from the port's
``exec/exchange.py: compute_range_bounds``, line for line the JAX
package's.  Then each shard sends each row to the number of bounds its
key tuple is above (``range_pids``), ``parallel/mesh.py: exchange`` moves
the rows, and each shard sorts what it received (``exec/sort.py:
sort_batch``).  The shards laid end to end in shard order are the global
sort.  An empty input, or one with no bound, comes back as it was.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.exec.exchange import compute_range_bounds, \
    observed_key_width, range_sort_keys
from spark_rapids_tpu_torch.exec.sort import sort_batch
from spark_rapids_tpu_torch.exprs.base import Expression
from spark_rapids_tpu_torch.parallel.mesh import DeviceMesh, data_mesh, \
    dense_batch, exchange, gather_batches, shard_table


def range_pids(keys: Sequence[torch.Tensor], bounds, live: torch.Tensor,
               n_dev: int) -> torch.Tensor:
    """Destination shard a row: how many bound tuples its key tuple is
    lexicographically above (the compare of the single-device range
    exchange); a dead row gets ``n_dev``."""
    cap = live.shape[0]
    dev = live.device
    nb = n_dev - 1
    eq = torch.ones((cap, nb), dtype=torch.bool, device=dev)
    gt = torch.zeros((cap, nb), dtype=torch.bool, device=dev)
    for k, b in zip(keys, bounds):
        br = torch.as_tensor(np.asarray(b), device=dev).to(k.dtype)[None, :]
        kc = k[:, None]
        gt = gt | (eq & (kc > br))
        eq = eq & (kc == br)
    pid = gt.sum(dim=1).to(torch.int64)
    return torch.where(live, pid, torch.full_like(pid, n_dev))


class DistributedSort:
    """A global sort over a 1-D mesh of shards."""

    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 schema: Schema, mesh: Optional[DeviceMesh] = None,
                 n_devices: Optional[int] = None, pad_width: int = 512,
                 conf=None, metrics=None):
        self.mesh = mesh if mesh is not None else \
            data_mesh(n_devices, conf=conf)
        self.n_dev = self.mesh.size
        self.orders = list(orders)
        self.schema = schema
        # the configured widest string key; each run derives its own pad
        # from its input
        self.pad_max = pad_width
        if metrics is None:
            from spark_rapids_tpu_torch.utils.metrics import MetricSet
            metrics = MetricSet(owner="DistributedSort")
        self.metrics = metrics

    def _bounds(self, batch: ColumnarBatch, sample_max: int = 10_000):
        """The bound tuples of an evenly spaced sample over the whole
        input, in one counted ``device_pull`` -> (bounds or None, pad)."""
        from spark_rapids_tpu_torch.columnar.transfer import device_pull
        pad = observed_key_width(self.orders, batch, self.pad_max)
        keys = range_sort_keys(self.orders, batch, pad)
        n = batch.num_rows
        take = min(n, sample_max)
        idx = np.unique(np.linspace(0, max(n - 1, 0), max(take, 1))
                        .astype(np.int64))
        at = torch.from_numpy(idx).to(batch.device)
        sample = device_pull(tuple(k[at] for k in keys), self.metrics)
        key_rows = [tuple(np.asarray(a) for a in sample)]
        return compute_range_bounds(key_rows, self.n_dev,
                                    sample_max=sample_max), pad

    def run_sharded(self, batch: ColumnarBatch):
        """Sample the bounds, shard, exchange and sort each shard -> (each
        shard's rows, each shard's sorted batch or None); (None, None)
        for a degenerate input (empty, or no bound), which ``run``
        returns as it came."""
        if batch.num_rows == 0:
            return None, None
        batch = dense_batch(batch)
        bounds, pad = self._bounds(batch)
        if bounds is None:
            return None, None
        shards, _, _ = shard_table(batch, self.n_dev, self.mesh.devices)
        return self.run_stacked(shards, bounds, pad)

    def run_stacked(self, shards: Sequence[ColumnarBatch], bounds, pad: int):
        """The exchange and the local sorts over placed shards, with the
        bounds already sampled."""
        pids: List[Optional[torch.Tensor]] = []
        for shard in shards:
            if shard.num_rows == 0:
                pids.append(None)
                continue
            keys = range_sort_keys(self.orders, shard, pad)
            live = torch.arange(shard.capacity, device=shard.device) \
                < shard.num_rows
            pids.append(range_pids(keys, bounds, live, self.n_dev))
        received, _ = exchange(shards, pids, self.mesh)
        self.metrics["hostSyncs"] += 1  # the count matrix
        n_local = np.zeros(self.n_dev, np.int64)
        outs: List[Optional[ColumnarBatch]] = []
        for d, recv in enumerate(received):
            if recv is None:
                outs.append(None)
                continue
            outs.append(sort_batch(self.orders, recv))
            n_local[d] = recv.num_rows
        return n_local, outs

    def gather(self, outs, device=None) -> ColumnarBatch:
        """The shards in shard order: the global sort."""
        return gather_batches(outs, [f.dtype for f in self.schema],
                              self.schema,
                              device if device is not None
                              else self.mesh.devices[0])

    def run(self, batch: ColumnarBatch) -> ColumnarBatch:
        n_local, outs = self.run_sharded(batch)
        if n_local is None:
            return batch
        return self.gather(outs)
