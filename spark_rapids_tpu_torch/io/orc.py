"""ORC scan.

Counterpart of ``spark_rapids_tpu/io/orc.py``: pyarrow decodes one stripe
at a time on the host, a stripe whose decoded min/max cannot satisfy the
pushed predicate is dropped before it is cast and uploaded
(``_stripe_may_match``, the JAX package's search-argument analog), and
the rest upload through ``io/hostio.py``, hive partition columns
appended, served through the device scan cache (``io/parquet.py:
cached_device_scan``, the stripe counts replayed on a hit).  The Filter
above the scan stays.  pyarrow is imported inside
the functions that read; they raise ``PyarrowRequiredError`` where it
is missing.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.dtypes import Schema
from spark_rapids_tpu_torch.conf import READER_BATCH_SIZE_ROWS
from spark_rapids_tpu_torch.exec.base import ExecContext, TorchExec
from spark_rapids_tpu_torch.io import hivepart
from spark_rapids_tpu_torch.io.hostio import coalesce_host_batches, \
    make_uploader, pipelined_scan
from spark_rapids_tpu_torch.io.parquet import cached_device_scan, \
    scan_cache_key
from spark_rapids_tpu_torch.utils.metrics import METRIC_NUM_FILES_READ, \
    METRIC_NUM_FILES_TOTAL, METRIC_NUM_STRIPES_READ, \
    METRIC_NUM_STRIPES_TOTAL


def expand_orc_paths(path) -> List[str]:
    if isinstance(path, (list, tuple)):
        return [f for p in path for f in expand_orc_paths(p)]
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "**", "*.orc"),
                                 recursive=True))
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def read_orc_schema(paths) -> Schema:
    from spark_rapids_tpu_torch.io.writers import require_pyarrow
    require_pyarrow("reading ORC")
    import pyarrow.orc as paorc
    files = expand_orc_paths(paths)
    if not files:
        raise FileNotFoundError(f"no orc files at {paths!r}")
    return hivepart.with_partition_fields(
        Schema.from_arrow(paorc.ORCFile(files[0]).schema), paths, files)


def read_orc_relation(paths, schema: Optional[Schema], pred=None):
    from spark_rapids_tpu_torch.plan import logical as lp
    return lp.OrcRelation(paths, schema or read_orc_schema(paths),
                          pushed=pred)


def _stripe_may_match(table, pred) -> bool:
    """False when the decoded stripe's min/max cannot satisfy the
    predicate's simple conjuncts."""
    if pred is None or table.num_rows == 0:
        return True
    import pyarrow as pa
    import pyarrow.compute as pc
    checks = hivepart.simple_predicates(pred)
    names = set(table.column_names)
    bounds = {}
    for name, _, _ in checks:
        if name not in names or name in bounds:
            continue
        col = table.column(name)
        if col.null_count == len(col):
            continue
        try:
            mm = pc.min_max(col).as_py()
        except (TypeError, pa.ArrowInvalid):
            continue
        if mm["min"] is not None:
            bounds[name] = (mm["min"], mm["max"])
    return hivepart.may_match(checks, bounds)


class OrcPartitionReader:
    """One file, a stripe at a time, skipping the stripes that cannot
    match."""

    def __init__(self, path: str, schema: Schema, pred=None,
                 batch_rows: int = 1 << 20):
        self.path = path
        self.schema = schema
        self.pred = pred
        self.batch_rows = batch_rows
        self.total_stripes = 0
        self.read_stripes = 0

    def read_host(self) -> Iterator:
        import pyarrow as pa
        import pyarrow.orc as paorc
        f = paorc.ORCFile(self.path)
        target = self.schema.to_arrow()
        self.total_stripes = f.nstripes
        for i in range(f.nstripes):
            stripe = f.read_stripe(i, columns=self.schema.names)
            table = pa.Table.from_batches([stripe]) \
                if isinstance(stripe, pa.RecordBatch) else stripe
            if not _stripe_may_match(table, self.pred):
                continue
            self.read_stripes += 1
            table = table.select(self.schema.names).cast(target)
            for rb in table.to_batches(max_chunksize=self.batch_rows):
                if rb.num_rows:
                    yield rb


class TorchOrcScanExec(TorchExec):
    def __init__(self, paths, schema: Schema, pred=None):
        super().__init__()
        self.paths = expand_orc_paths(paths)
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
        return f"TorchOrcScan [{len(self.paths)} files{extra}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def execute(self, ctx: ExecContext) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.io.writers import require_pyarrow
        require_pyarrow("reading ORC")
        rows = ctx.conf.get(READER_BATCH_SIZE_ROWS)
        files, fvals = hivepart.prune_files(
            self.part_schema, self.part_values, self.paths, self.pred)
        if self.part_schema:
            self.metrics[METRIC_NUM_FILES_TOTAL] += len(self.paths)
            self.metrics[METRIC_NUM_FILES_READ] += len(files)
        upload = make_uploader(ctx, self._file_schema, self.part_schema,
                               fvals, self._schema, metrics=self.metrics)

        def host_items():
            for fi, path in enumerate(files):
                reader = OrcPartitionReader(path, self._file_schema,
                                            self.pred, rows)
                try:
                    for rb in coalesce_host_batches(reader.read_host(),
                                                    rows):
                        yield fi, rb
                finally:
                    self.metrics[METRIC_NUM_STRIPES_TOTAL] += \
                        reader.total_stripes
                    self.metrics[METRIC_NUM_STRIPES_READ] += \
                        reader.read_stripes

        def gen():
            return pipelined_scan(ctx, self.metrics, host_items(), upload,
                                  "orc-decode", lambda t: t[1].nbytes)
        key = scan_cache_key(ctx, "orc", files, self._schema, self.pred)
        yield from cached_device_scan(
            ctx, key, gen, self.metrics,
            (METRIC_NUM_STRIPES_TOTAL, METRIC_NUM_STRIPES_READ))
