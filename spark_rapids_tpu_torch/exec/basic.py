"""The local scan, the range, the union and the limit.

Counterpart of ``spark_rapids_tpu/exec/basic.py``: ``TorchLocalScanExec``
scans in-memory host columns, uploaded in batches of 1 << 20 rows, as in
the JAX package (whatever the reader conf says), a low-cardinality string
column as codes and a dictionary, and an integer or boolean column as an
RLE, delta-narrowed or bit-packed plane where that crosses fewer bytes,
while compressed ingest is on (the JAX package's local scan uploads
plain planes and encodes at its ``HostToDeviceExec`` and file scans; the
port's local scan is the path the card's machine, which has no pyarrow,
runs).  Its batches go through ``io/hostio.py: pipelined_scan``, as the
JAX package's ``HostToDeviceExec`` (``exec/basic.py:231``) sends a host
child's: each slice's upload is pinned and, while
``spark.rapids.sql.io.prefetch.enabled`` is on, double-buffered.
``TorchRangeExec`` makes
``[start, end)`` by ``step`` on the device in batches of 1 << 20 rows;
``TorchUnionExec`` streams its children's batches back to back;
``TorchLocalLimitExec`` passes batches on until the limit is reached.
``TorchProjectExec`` and ``TorchFilterExec`` are the one-step chains the
fusion pass leaves (``plan/fusion.py``), over the fused stage's own code
(``exec/stage.py: StepsExec``).  ``HostToDeviceExec`` and
``DeviceToHostExec`` are the counted transitions around a part of a plan
the placement pass runs on the host (``plan/placement.py``): the first
runs its child on the host and uploads each batch through ``Upload``,
the second pulls its device child's batches through ``device_pull``.
``host_egress`` is the result egress of a plan that ran whole on the
host: it pulls nothing.  None of them holds a batch, so none registers
one with the spill catalog.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, HostColumns, host_batch_columns, host_batch_to_device,
)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, \
    bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import INT64, Field, Schema
from spark_rapids_tpu_torch.columnar import encoding
from spark_rapids_tpu_torch.conf import COMPRESSED_MAX_DICT_FRACTION, \
    MAX_STRING_WIDTH
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.exec.stage import StepsExec

BATCH_ROWS = 1 << 20


class TorchProjectExec(StepsExec):
    """A projection on its own (the JAX ``TpuProjectExec``)."""

    def __init__(self, exprs, child: TorchExec):
        super().__init__([("project", tuple(exprs))], child)
        self.exprs = list(exprs)

    def describe(self) -> str:
        return "TorchProject [" + ", ".join(e.name for e in self.exprs) \
            + "]"


class TorchFilterExec(StepsExec):
    """A filter on its own (the JAX ``TpuFilterExec``)."""

    def __init__(self, pred, child: TorchExec):
        super().__init__([("filter", (pred,))], child)
        self.pred = pred

    def describe(self) -> str:
        return f"TorchFilter [{self.pred.name}]"


class HostToDeviceExec(TorchExec):
    """Runs its child on the host (``ExecContext.on_host``) and uploads
    each non-empty batch to the query's device, through the scans' tail
    (``io/hostio.py: pipelined_scan``, each batch one ``Upload``): the
    JAX ``HostToDeviceExec`` (``exec/basic.py:231``)."""

    def __init__(self, child: TorchExec):
        super().__init__()
        self.children = [child]

    def describe(self) -> str:
        return "HostToDevice"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.io.hostio import host_nbytes, \
            pipelined_scan
        schema = self.output_schema
        max_w = ctx.conf.get(MAX_STRING_WIDTH)

        def host_items():
            with contextlib.closing(
                    self.children[0].execute(ctx.on_host())) as stream:
                for b in stream:
                    if b.num_rows:
                        yield host_batch_columns(b, schema)

        def upload(cols):
            return host_batch_to_device(schema, cols, ctx.device, max_w,
                                        defer=True)
        yield from pipelined_scan(ctx, self.metrics, host_items(), upload,
                                  "host-to-device", host_nbytes)


class DeviceToHostExec(TorchExec):
    """Pulls its device child's batches (``device_pull``, counted in
    ``d2hPulls`` and ``d2hBytes``) into host tensors: the JAX
    ``DeviceToHostExec`` (``exec/basic.py:271``) at the bottom of a
    remainder the placement pass put on the host.  Its child runs in the
    device context the host one was made from."""

    def __init__(self, child: TorchExec):
        super().__init__()
        self.children = [child]

    def describe(self) -> str:
        return "DeviceToHost"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.columnar.batch import \
            device_batch_to_host
        schema = self.output_schema
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        dev = ctx.parent if ctx.parent is not None else ctx
        for b in self.children[0].execute(dev):
            cols = device_batch_to_host(b, schema, self.metrics)
            yield host_batch_to_device(schema, cols, ctx.device, max_w)


def host_egress(batches: Iterator[ColumnarBatch],
                schema: Schema) -> Iterator[HostColumns]:
    """The result of a plan that ran on the host -> its host columns,
    with no pull (``host_batch_columns``)."""
    for b in batches:
        yield host_batch_columns(b, schema)


class TorchLocalScanExec(TorchExec):
    def __init__(self, schema: Schema, cols: HostColumns):
        super().__init__()
        self._schema = schema
        self.cols = cols
        self.children = []

    @property
    def num_rows(self) -> int:
        return len(self.cols[self._schema[0].name][0]) \
            if len(self._schema) else 0

    def describe(self) -> str:
        return f"TorchLocalScan [rows={self.num_rows}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.io.hostio import host_nbytes, \
            pipelined_scan
        n = self.num_rows
        max_w = ctx.conf.get(MAX_STRING_WIDTH)
        encoder = make_encoder(ctx, self.metrics, memo=True)

        def host_items():
            for start in range(0, n, BATCH_ROWS):
                yield {name: (v[start:start + BATCH_ROWS],
                              m[start:start + BATCH_ROWS])
                       for name, (v, m) in self.cols.items()}

        def upload(part):
            return host_batch_to_device(self._schema, part, ctx.device,
                                        max_w, encoder, defer=True)
        yield from pipelined_scan(ctx, self.metrics, host_items(), upload,
                                  "local-scan", host_nbytes)


# the pack's group of result batches (the JAX DeviceToHostExec's)
EGRESS_GROUP_BYTES = 256 * 1024 * 1024


def device_to_host(batches: Iterator[ColumnarBatch], schema: Schema,
                   ctx: ExecContext, metrics=None) -> Iterator[HostColumns]:
    """A query's result batches -> its host columns, a part at a time:
    the counterpart of the JAX package's ``DeviceToHostExec.
    execute_host`` (``exec/basic.py:271``), the port's one result egress
    (``DataFrame`` results, the writers, the server's and the fleet's
    serial results).  It runs ``transfer.pipelined_d2h`` over groups of
    up to ``EGRESS_GROUP_BYTES`` of result batches, each group packed
    and pulled once (``pack_dispatch`` / ``pack_finish``) while
    ``spark.rapids.sql.transfer.pack.enabled`` is on, else each batch's
    planes copied (``start_host_copies``) and pulled
    (``device_batch_to_host``).  ``metrics`` gets ``d2hPulls``,
    ``d2hBytes`` and ``d2hOverlapMs``."""
    from spark_rapids_tpu_torch.columnar.batch import device_batch_to_host, \
        pull_planes
    from spark_rapids_tpu_torch.columnar.transfer import pack_dispatch, \
        pack_finish, pipelined_d2h, start_host_copies
    from spark_rapids_tpu_torch.conf import TRANSFER_PACK_ENABLED, \
        TRANSFER_STATS_THRESHOLD
    if not ctx.conf.get(TRANSFER_PACK_ENABLED):
        yield from pipelined_d2h(
            batches, lambda b: (b, start_host_copies(pull_planes(b))),
            lambda t: device_batch_to_host(t[0], schema, metrics, t[1]),
            ctx, metrics, nbytes=lambda t: t[1].nbytes())
        return
    thresh = ctx.conf.get(TRANSFER_STATS_THRESHOLD)

    def groups():
        group, nbytes = [], 0
        for b in batches:
            group.append(b)
            nbytes += b.size_bytes()
            if nbytes >= EGRESS_GROUP_BYTES:
                yield group
                group, nbytes = [], 0
        if group:
            yield group

    yield from pipelined_d2h(
        groups(), lambda g: pack_dispatch(g, schema, thresh, metrics),
        lambda p: pack_finish(p, metrics), ctx, metrics,
        nbytes=lambda p: p.wire_bytes())


def make_encoder(ctx: ExecContext, metrics=None, memo: bool = False):
    """The scan's ``IngestEncoder`` while compressed ingest is on, else
    None (every column rides its plain planes); ``memo`` keeps its
    encodings for the next scan of the same host arrays."""
    if not encoding.ingest_enabled():
        return None
    return encoding.IngestEncoder(
        ctx.device, metrics, ctx.conf.get(COMPRESSED_MAX_DICT_FRACTION),
        ctx.conf.get(MAX_STRING_WIDTH), memo)


class TorchRangeExec(TorchExec):
    """The int64 column ``id``: ``start`` to ``end`` (exclusive) by
    ``step``, ``-(-(end - start) // step)`` rows (none when that is not
    positive), made on the device in batches of ``BATCH_ROWS``.  A step
    of 0 raises ``ZeroDivisionError`` when the range runs, as in the JAX
    package."""

    def __init__(self, start: int, end: int, step: int = 1,
                 name: str = "id"):
        super().__init__()
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.children = []
        self._schema = Schema([Field(name, INT64, nullable=False)])

    def describe(self) -> str:
        return f"TorchRange [{self.start}, {self.end}, {self.step}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        for pos in range(0, total, BATCH_ROWS):
            n = min(BATCH_ROWS, total - pos)
            cap = bucket_capacity(n)
            iota = torch.arange(cap, dtype=torch.int64, device=ctx.device)
            data = iota * self.step + (self.start + pos * self.step)
            yield ColumnarBatch([DeviceColumn(INT64, data, iota < n, n)], n,
                                self._schema)


class TorchUnionExec(TorchExec):
    """UNION ALL: each child's batches in turn, under the first child's
    schema; no batch is concatenated (a coalesce above sizes them)."""

    def __init__(self, children):
        super().__init__()
        self.children = list(children)

    def describe(self) -> str:
        return f"TorchUnion [{len(self.children)} children]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        for child in self.children:
            yield from child.execute(ctx)


def head(batch: ColumnarBatch, n: int) -> ColumnarBatch:
    """The first ``min(n, num_rows)`` rows of ``batch``, at a capacity no
    larger than the bucket of ``n``."""
    n = min(n, batch.num_rows)
    cap = min(batch.capacity, bucket_capacity(max(1, n)))
    live = torch.arange(cap, device=batch.device) < n
    outs = [(d[:cap], v[:cap] & live, None if ch is None else ch[:cap])
            for d, v, ch in (encoding.col_planes(c, True)
                             for c in batch.columns)]
    return encoding.wrap_gathered(batch.columns, outs, n, batch.schema)


class TorchLocalLimitExec(TorchExec):
    """The first ``limit`` rows of the child, in its order."""

    def __init__(self, limit: int, child: TorchExec):
        super().__init__()
        self.limit = int(limit)
        self.children = [child]

    def describe(self) -> str:
        return f"TorchLocalLimit [{self.limit}]"

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for batch in self.children[0].execute(ctx):
            if remaining <= 0:
                break
            out = head(batch, remaining)
            remaining -= out.num_rows
            yield out
