"""Parquet scan.

Counterpart of ``spark_rapids_tpu/io/parquet.py:TpuParquetScanExec``:
pyarrow reads each file on the host in record batches of
``spark.rapids.sql.reader.batchSizeRows`` rows, combines them up to that
many rows (``io/hostio.py``), as the JAX package's host reader does, and
each combined batch is uploaded through ``io/hostio.py:
pipelined_scan`` (the read on a background thread and the uploads
double-buffered while ``spark.rapids.sql.io.prefetch.enabled`` is on).  A hive-partitioned layout adds its
partition columns to every batch of a file, and files whose partition
values cannot satisfy the pushed predicate are not read; within a file,
a row group whose footer min/max cannot satisfy it is not read either
(``_stats_prune``).  The Filter above the scan stays.  While compressed
ingest is on, string columns are read as Arrow dictionaries
(``read_dictionary``), so the ingest encoder takes parquet's own
dictionary pages, as in the JAX package.  pyarrow is
imported inside the functions that read, so the rest of the port runs
without it; they raise ``PyarrowRequiredError`` where it is missing.

The parquet, ORC and CSV scans serve their device batches through
``cached_device_scan`` (``spark.rapids.sql.scan.deviceCacheEnabled``):
a read whose ``scan_cache_key`` the runtime's ``ScanCache`` holds
yields the cached batches, replays the scan's pruning metrics and counts
``scanCacheHits``; a read that runs to its end stores its batches; a
read its consumer stops early (a limit, an error, a cancel) stores
nothing and closes its handles at once.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, \
    host_batch_to_device
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH, \
    READER_BATCH_SIZE_ROWS, SCAN_DEVICE_CACHE
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.io import hivepart
from spark_rapids_tpu_torch.io.hostio import coalesce_host_batches, \
    make_uploader, pipelined_scan, read_dictionary_columns
from spark_rapids_tpu_torch.utils.metrics import METRIC_NUM_FILES_READ, \
    METRIC_NUM_FILES_TOTAL, METRIC_NUM_ROW_GROUPS_READ, \
    METRIC_NUM_ROW_GROUPS_TOTAL, METRIC_SCAN_CACHE_HITS


def expand_paths(path) -> List[str]:
    if isinstance(path, (list, tuple)):
        return [f for p in path for f in expand_paths(p)]
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "**", "*.parquet"),
                                 recursive=True))
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def tail_marker(path: str) -> str:
    """A parquet file's last 8 bytes (footer length and ``PAR1``), hex:
    a rewrite within the file system's mtime granularity at the same
    size still changes it."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        if f.tell() < 8:
            raise OSError(f"{path}: too short for a parquet footer")
        f.seek(-8, os.SEEK_END)
        return f.read(8).hex()


def read_schema(paths) -> Schema:
    from spark_rapids_tpu_torch.io.writers import require_pyarrow
    require_pyarrow("reading parquet")
    import pyarrow.parquet as pq
    files = expand_paths(paths)
    if not files:
        raise FileNotFoundError(f"no parquet files at {paths!r}")
    return hivepart.with_partition_fields(
        Schema.from_arrow(pq.read_schema(files[0])), paths, files)


def _stats_prune(md, ridx: int, checks) -> bool:
    """True when row group ``ridx`` may hold rows the checks keep, by
    its footer's min/max."""
    if not checks:
        return True
    rg = md.row_group(ridx)
    bounds = {}
    for ci in range(rg.num_columns):
        col = rg.column(ci)
        st = col.statistics
        if st is not None and st.has_min_max:
            bounds[col.path_in_schema] = (st.min, st.max)
    return hivepart.may_match(checks, bounds)


class ParquetPartitionReader:
    """One file: the footer read and pruned at ``read_host``, then its
    kept row groups' record batches."""

    def __init__(self, path: str, schema: Schema, pred=None,
                 batch_rows: int = 1 << 20, read_dictionary=None):
        self.path = path
        self.schema = schema
        self.pred = pred
        self.batch_rows = batch_rows
        # the string columns to read as Arrow dictionaries, so that the
        # ingest encoder takes parquet's own dictionary pages
        self.read_dictionary = read_dictionary
        self.total_row_groups = 0
        self.read_row_groups = 0

    def read_host(self) -> Iterator:
        import pyarrow.parquet as pq
        f = pq.ParquetFile(self.path,
                           read_dictionary=self.read_dictionary or None)
        md = f.metadata
        checks = hivepart.simple_predicates(self.pred)
        keep = [i for i in range(md.num_row_groups)
                if _stats_prune(md, i, checks)]
        self.total_row_groups = md.num_row_groups
        self.read_row_groups = len(keep)
        return self._iter(f, keep)

    def _iter(self, f, keep) -> Iterator:
        if not keep:
            return
        for b in f.iter_batches(batch_size=self.batch_rows, row_groups=keep,
                                columns=self.schema.names):
            if b.num_rows:
                yield b


def file_identity(path: str) -> tuple:
    """``(absolute path, st_mtime_ns, st_size, st_ino)``: what changes
    when a file is rewritten, but for a same-size rewrite in place
    within one timestamp tick, which the writers cover by invalidating
    (``runtime.py: TorchRuntime.invalidate_paths``)."""
    st = os.stat(path)
    return (os.path.abspath(path), st.st_mtime_ns, st.st_size, st.st_ino)


def scan_cache_key(ctx: ExecContext, kind: str, paths: List[str],
                   schema: Schema, pred, extra=()) -> Optional[tuple]:
    """The device scan cache's key: the files' identities (the second
    element, which ``ScanCache.invalidate_paths`` reads), the schema,
    the pushed predicate's ``key()``, the batch rows, the string width
    cap, the encoding switches (``encoding.ingest_key``) and the scan's
    own ``extra`` -> None when a file cannot be stat'ed."""
    from spark_rapids_tpu_torch.columnar import encoding
    try:
        ids = tuple(file_identity(p) for p in paths)
    except OSError:
        return None
    return (kind, ids, tuple((f.name, f.dtype.name) for f in schema),
            pred.key() if pred is not None else None,
            ctx.conf.get(READER_BATCH_SIZE_ROWS),
            ctx.conf.get(MAX_STRING_WIDTH), encoding.ingest_key(), extra)


def cached_device_scan(ctx: ExecContext, key, gen: Callable[[], Iterator],
                       metrics=None, metric_names: Sequence[str] = ()
                       ) -> Iterator[ColumnarBatch]:
    """The scan's batches through the runtime's scan cache: ``gen()``
    makes the fresh stream.  On a hit the entry's handles are yielded
    (promoted to the device if they were demoted), the named metrics'
    counts from the read that stored them are added to ``metrics``, and
    ``scanCacheHits`` counts one.  On a miss each batch is registered as
    a ``PRIORITY_RECREATABLE`` handle with its writes guarded before it
    is yielded, and the handles are stored once the stream has run to
    its end; a stream closed before that closes them.  A cached batch
    written in place raises ``CachedBatchWrittenError``, and its entry
    is dropped: it is not read again, which would hide the write."""
    from spark_rapids_tpu_torch.memory.spill import PRIORITY_RECREATABLE, \
        CachedBatchWrittenError, SpillableBatch, close_all
    if key is None or not ctx.conf.get(SCAN_DEVICE_CACHE):
        yield from gen()
        return
    cache = ctx.runtime.scan_cache
    ent = cache.get(key)
    if ent is not None:
        try:
            if metrics is not None:
                for name, v in ent.metrics.items():
                    metrics[name] += v
                metrics[METRIC_SCAN_CACHE_HITS] += 1
            for h in ent.handles:
                try:
                    b = h.get()
                except CachedBatchWrittenError:
                    cache.invalidate(key)
                    raise
                yield b
        finally:
            cache.release(ent)
        return
    before = {n: int(metrics[n]) for n in metric_names} \
        if metrics is not None else {}
    handles = []
    stored = False
    try:
        for b in gen():
            h = SpillableBatch(b, ctx.runtime.catalog,
                               priority=PRIORITY_RECREATABLE)
            h.suppress_leak_warning = True
            handles.append(h)
            h.guard_writes()
            yield b
        snap = {n: int(metrics[n]) - before[n] for n in metric_names} \
            if metrics is not None else {}
        stored = cache.put(key, handles, snap)
    finally:
        if not stored:
            close_all(handles)


class TorchParquetScanExec(TorchExec):
    def __init__(self, paths, schema: Schema, pred=None):
        super().__init__()
        self.paths = expand_paths(paths)
        # kept for the host shuffle, which discovers a stripe's hive
        # values again (shuffle/stage.py: _restrict_to_split)
        self.roots = hivepart.roots_of(paths)
        self.part_schema, self.part_values = hivepart.discover(
            self.roots, self.paths)
        self._schema = schema
        self._file_schema = hivepart.file_fields(schema, self.part_schema)
        self.pred = pred
        self.children = []

    def describe(self) -> str:
        extra = f", pushdown={self.pred.name}" if self.pred is not None \
            else ""
        if self.part_schema:
            extra += f", partitioned by {self.part_schema.names}"
        return f"TorchParquetScan [{len(self.paths)} files{extra}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.io.writers import require_pyarrow
        require_pyarrow("reading parquet")
        rows = ctx.conf.get(READER_BATCH_SIZE_ROWS)
        files, fvals = hivepart.prune_files(
            self.part_schema, self.part_values, self.paths, self.pred)
        if self.part_schema:
            self.metrics[METRIC_NUM_FILES_TOTAL] += len(self.paths)
            self.metrics[METRIC_NUM_FILES_READ] += len(files)
        upload = make_uploader(ctx, self._file_schema, self.part_schema,
                               fvals, self._schema, host_batch_to_device,
                               self.metrics)
        read_dict = read_dictionary_columns(self._file_schema)

        def host_items():
            for fi, path in enumerate(files):
                reader = ParquetPartitionReader(path, self._file_schema,
                                                self.pred, rows, read_dict)
                it = reader.read_host()
                self.metrics[METRIC_NUM_ROW_GROUPS_TOTAL] += \
                    reader.total_row_groups
                self.metrics[METRIC_NUM_ROW_GROUPS_READ] += \
                    reader.read_row_groups
                for rb in coalesce_host_batches(it, rows):
                    yield fi, rb

        def gen():
            return pipelined_scan(ctx, self.metrics, host_items(), upload,
                                  "parquet-decode", lambda t: t[1].nbytes)
        key = scan_cache_key(ctx, "parquet", files, self._schema, self.pred)
        yield from cached_device_scan(
            ctx, key, gen, self.metrics,
            (METRIC_NUM_ROW_GROUPS_TOTAL, METRIC_NUM_ROW_GROUPS_READ))
