"""File writers: CSV without pyarrow, parquet and ORC through it.

Counterpart of ``spark_rapids_tpu/io/writers.py``.  A write runs the
DataFrame's query in its query scope, pulls each result batch to the
host and writes a directory of part files under Spark's save modes
(``mode``: error or errorifexists, append, overwrite, ignore; a bad one
or a clash raises ``WriteModeError``).  ``partition_cols`` writes one
``col=value`` directory a distinct partition tuple (Hive escaping, null
as ``__HIVE_DEFAULT_PARTITION__``), each holding a part file of the rows
without the partition columns; an append adds files numbered after the
highest already there.  The JAX package's ``write_csv`` ignores
``partition_cols``; the port's writes the same layout as its parquet
and ORC writers.

``write_csv`` needs no pyarrow, and its files are byte for byte those of
pyarrow's ``CSVWriter`` (which the JAX package uses) for the same table:
a quoted header, strings quoted with ``"`` doubled, a null an empty
unquoted field (an empty string ``""``), booleans ``true``/``false``,
dates ``1995-03-15``, timestamps ``2000-01-01 01:02:03.000000Z``, and
doubles in their shortest round-trip digits (Python's ``repr``'s) laid
out as Arrow lays them: decimal when the exponent is in [-6, 10), else
``1e-7``, ``1e+20``, ``1.2345678901234568e+17``; ``-0``, ``nan``,
``inf``.  The text is made on the device, a batch at a time
(``io/csvformat.py``); only the finished bytes come back.

A write drops the device scan cache's entries that name files under
its path, in every runtime, once it ends (``runtime.py:
TorchRuntime.invalidate_paths``).

``write_parquet`` and ``write_orc`` import pyarrow inside the function;
where it cannot be imported they raise ``PyarrowRequiredError``, which
names the package.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, Iterator, List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, \
    HostStrings, device_batch_to_host
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import DATE, Schema
from spark_rapids_tpu_torch.io import csvformat
from spark_rapids_tpu_torch.io.hivepart import HIVE_NULL

# rows formatted at once
FORMAT_ROWS = 1 << 20


class WriteModeError(RuntimeError):
    pass


class PyarrowRequiredError(ImportError):
    """A parquet or ORC read or write where ``pyarrow`` cannot be
    imported."""


def require_pyarrow(what: str):
    """``import pyarrow``, or ``PyarrowRequiredError`` naming it."""
    try:
        import pyarrow
    except ImportError as e:
        raise PyarrowRequiredError(
            f"{what} needs the 'pyarrow' package, which cannot be imported "
            f"here ({e}); CSV reads and writes need no pyarrow") from e
    return pyarrow


def _hive_escape(v) -> str:
    """A partition value -> its directory name (Spark's escaping)."""
    if v is None:
        return HIVE_NULL
    out = []
    for ch in str(v):
        if ch in '"#%\\\'*/:=?\x7f{[]^' or ord(ch) < 0x20:
            out.append(f"%{ord(ch):02X}")
        else:
            out.append(ch)
    return "".join(out) or HIVE_NULL


def _part_indices(path: str, recursive: bool) -> List[int]:
    names = [f for _, _, fs in os.walk(path) for f in fs] if recursive \
        else os.listdir(path)
    out = []
    for f in names:
        if f.startswith("part-"):
            try:
                out.append(int(f[5:10]))
            except ValueError:
                pass
    return out


def _prepare_dir(path: str, mode: str) -> int:
    """Apply the save mode; the next part index, or -1 when the write is
    skipped (``ignore`` over existing output)."""
    if os.path.exists(path):
        if mode in ("error", "errorifexists"):
            raise WriteModeError(
                f"path {path} already exists (SaveMode.ErrorIfExists)")
        if mode == "ignore":
            return -1
        if mode == "overwrite":
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            os.makedirs(path)
            return 0
        if mode == "append":
            if not os.path.isdir(path):
                raise WriteModeError(f"cannot append to non-directory {path}")
            return max(_part_indices(path, False), default=-1) + 1
        raise WriteModeError(f"unknown save mode {mode!r}")
    os.makedirs(path)
    return 0


def device_batches(df) -> Iterator[ColumnarBatch]:
    """Run the DataFrame's query in its query scope and yield its result
    batches, on the device."""
    with df._query():
        _, batches = df._execute()
        yield from batches


def host_parts(df) -> Iterator:
    """Run the DataFrame's query and yield its result on the host, a
    part at a time, through the result egress (``exec/basic.py:
    device_to_host``: packed pulls, double-buffered)."""
    _, parts = df._execute(egress=True)
    yield from parts


def _rows(batch: ColumnarBatch, r0: int, r1: int):
    """Views of rows [r0, r1) of a batch's columns."""
    return [DeviceColumn(c.dtype, c.data[r0:r1], c.validity[r0:r1], r1 - r0,
                         None if c.chars is None else c.chars[r0:r1])
            for c in batch.columns]


class _CsvW:
    def __init__(self, base: str, schema: Schema, header: bool = True,
                 sep: str = ","):
        self._f = open(base + ".csv", "wb")
        self._sep = sep
        if header:
            self._f.write(csvformat.header(schema, sep))

    def write(self, schema: Schema, batch: ColumnarBatch) -> None:
        for r0 in range(0, batch.num_rows, FORMAT_ROWS):
            r1 = min(batch.num_rows, r0 + FORMAT_ROWS)
            self._f.write(csvformat.format_rows(
                schema, _rows(batch, r0, r1), r1 - r0, self._sep))

    def close(self) -> None:
        self._f.close()


class _ArrowW:
    """A parquet or ORC part file through pyarrow."""

    def __init__(self, base: str, schema: Schema, fmt: str):
        self._schema = schema
        self._arrow = schema.to_arrow()
        if fmt == "parquet":
            import pyarrow.parquet as pq
            self._w = pq.ParquetWriter(base + ".parquet", self._arrow)
        else:
            import pyarrow.orc as paorc
            self._w = paorc.ORCWriter(base + ".orc")
        self._fmt = fmt
        self._wrote = False

    def _put(self, t) -> None:
        if self._fmt == "parquet":
            self._w.write_table(t)
        else:
            self._w.write(t)

    def write(self, schema: Schema, batch: ColumnarBatch) -> None:
        self.write_host(device_batch_to_host(batch, schema))

    def write_host(self, cols) -> None:
        """Host columns (``HostColumns``) of the writer's schema."""
        from spark_rapids_tpu_torch.columnar.batch import \
            host_columns_to_arrow
        self._put(host_columns_to_arrow(self._schema, cols))
        self._wrote = True

    def close(self) -> None:
        if not self._wrote:
            self._put(self._arrow.empty_table())
        self._w.close()


def _group_rows(batch: ColumnarBatch, schema: Schema,
                names: Sequence[str]):
    """Rows of a batch grouped by the columns ``names``, on the device
    -> (the group of each row, each group's key tuple)."""
    n = batch.num_rows
    dev = batch.device
    codes = torch.zeros(n, dtype=torch.int64, device=dev)
    for name in names:
        c = batch.columns[schema.field_index(name)]
        valid = c.validity[:n]
        if c.chars is not None:
            lens = torch.where(valid, c.data[:n], -1).to(torch.int32)
            key = torch.cat([c.chars[:n] * valid[:, None],
                             lens[:, None].view(torch.uint8)], 1)
        else:
            bits = c.data[:n].contiguous()
            if bits.dtype.is_floating_point:
                bits = bits.view(torch.int64 if bits.element_size() == 8
                                 else torch.int32)
            key = torch.stack([valid.long(),
                               torch.where(valid, bits.long(), 0)], 1)
        _, inv = torch.unique(key, dim=0, return_inverse=True)
        codes = codes * (int(inv.max()) + 1 if n else 1) + inv
    _, inv = torch.unique(codes, return_inverse=True)
    groups = int(inv.max()) + 1 if n else 0
    first = torch.full((groups,), n, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=dev),
                                 "amin").cpu().tolist()
    host = device_batch_to_host(batch.gather(
        torch.tensor(first, dtype=torch.int64, device=dev), groups), schema)
    keys = [tuple(None if not host[name][1][g] else _py_value(
        schema[schema.field_index(name)].dtype, host[name][0], g)
        for name in names) for g in range(groups)]
    return inv, keys


def _py_value(dtype, values, r: int):
    if isinstance(values, HostStrings):
        return bytes(values.chars[r, :values.lengths[r]]).decode(
            "utf-8", "replace")
    if dtype == DATE:
        import datetime
        return datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(values[r]))
    return values[r].item()


def _write(df, path: str, mode: str, partition_cols,
           open_writer: Callable[[str, Schema], object]) -> None:
    from spark_rapids_tpu_torch.runtime import TorchRuntime
    try:
        _write_parts(df, path, mode, partition_cols, open_writer)
    finally:
        # the device scan cache must not serve what this write replaced:
        # a same-size rewrite within one timestamp tick may keep a
        # file's (mtime_ns, size, inode)
        TorchRuntime.invalidate_paths(path)


def _write_parts(df, path: str, mode: str, partition_cols,
                 open_writer: Callable[[str, Schema], object]) -> None:
    part = _prepare_dir(path, mode)
    if part < 0:
        return
    schema = df.plan.output_schema()
    if not partition_cols:
        w = open_writer(os.path.join(path, f"part-{part:05d}"), schema)
        try:
            if isinstance(w, _ArrowW):
                # parquet and ORC encode on the host: the result comes
                # back through the result egress
                for cols in host_parts(df):
                    w.write_host(cols)
            else:
                for b in device_batches(df):
                    w.write(schema, b)
        finally:
            w.close()
        return
    names = schema.names
    for c in partition_cols:
        if c not in names:
            raise WriteModeError(
                f"partition column {c!r} not in schema {names}")
    if mode == "append":
        part = max(_part_indices(path, True), default=-1) + 1
    data_idx = [i for i, f in enumerate(schema) if f.name not in
                partition_cols]
    data_schema = Schema([schema[i] for i in data_idx])
    writers: Dict[str, object] = {}
    try:
        for b in device_batches(df):
            inv, keys = _group_rows(b, schema, partition_cols)
            data = ColumnarBatch([b.columns[i] for i in data_idx],
                                 b.num_rows, data_schema)
            order = sorted(range(len(keys)), key=lambda g: tuple(
                (x is None, str(x)) for x in keys[g]))
            for g in order:
                rows = torch.nonzero(inv == g).squeeze(1)
                d = os.path.join(path, *[
                    f"{c}={_hive_escape(v)}"
                    for c, v in zip(partition_cols, keys[g])])
                w = writers.get(d)
                if w is None:
                    os.makedirs(d, exist_ok=True)
                    w = open_writer(os.path.join(d, f"part-{part:05d}"),
                                    data_schema)
                    writers[d] = w
                w.write(data_schema, data.gather(rows, rows.numel()))
    finally:
        for w in writers.values():
            w.close()


def write_csv(df, path: str, mode: str = "error", header: bool = True,
              sep: str = ",", partition_cols=None) -> None:
    """A directory of CSV part files, pyarrow's bytes, without it."""
    _write(df, path, mode, partition_cols,
           lambda base, schema: _CsvW(base, schema, header, sep))


def write_parquet(df, path: str, mode: str = "error",
                  partition_cols=None) -> None:
    require_pyarrow("writing parquet")
    _write(df, path, mode, partition_cols,
           lambda base, schema: _ArrowW(base, schema, "parquet"))


def write_orc(df, path: str, mode: str = "error",
              partition_cols=None) -> None:
    require_pyarrow("writing ORC")
    _write(df, path, mode, partition_cols,
           lambda base, schema: _ArrowW(base, schema, "orc"))


class DataFrameWriter:
    """``df.write``: ``mode``, ``partition_by`` (``partitionBy``), then
    ``csv``, ``parquet`` or ``orc``."""

    def __init__(self, df):
        self.df = df
        self._mode = "error"
        self._partition_cols: List[str] = []

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m
        return self

    def partition_by(self, *cols_) -> "DataFrameWriter":
        self._partition_cols = list(cols_)
        return self

    partitionBy = partition_by

    def csv(self, path: str, header: bool = True, sep: str = ",") -> None:
        write_csv(self.df, path, self._mode, header, sep,
                  partition_cols=self._partition_cols)

    def parquet(self, path: str) -> None:
        write_parquet(self.df, path, self._mode,
                      partition_cols=self._partition_cols)

    def orc(self, path: str) -> None:
        write_orc(self.df, path, self._mode,
                  partition_cols=self._partition_cols)
