"""The scans' shared host side: coalescing, the uploader and the
pipelined tail.

Counterpart of ``spark_rapids_tpu/io/hostio.py``: ``coalesce_host_batches``
combines the reader's record batches up to the scan's row cap before an
upload; ``make_uploader`` turns one ``(file index, record batch)`` into
a device batch with the file's hive partition columns appended, its
string, integer and boolean columns through the scan's
``IngestEncoder`` (``columnar/encoding.py``) while compressed ingest is
on, every plane through one pinned ``transfer.Upload``; and
``pipelined_scan`` is the tail every scan shares (the local, parquet,
ORC and CSV scans): the host decode through ``io/prefetch.py:
maybe_prefetch``, the serial path's uploads each admitted through the
catalog's ``staging`` limiter, and the uploads double-buffered by
``columnar/transfer.py: pipelined_h2d``.  With
``spark.rapids.sql.io.prefetch.enabled`` off it is the serial decode ->
upload -> yield loop, with the same batches in the same order.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional


def _combine(rbs):
    """Record batches -> one, or the one given."""
    import pyarrow as pa
    if len(rbs) == 1:
        return rbs[0]
    return pa.Table.from_batches(rbs).combine_chunks()


def coalesce_host_batches(it: Iterator, target_rows: int) -> Iterator:
    """Combine record batches host-side up to ``target_rows`` (a cap: a
    batch that would cross it flushes the buffer first)."""
    buf, n = [], 0
    for rb in it:
        if buf and n + rb.num_rows > target_rows:
            yield _combine(buf)
            buf, n = [], 0
        buf.append(rb)
        n += rb.num_rows
        if n >= target_rows:
            yield _combine(buf)
            buf, n = [], 0
    if buf:
        yield _combine(buf)


def make_uploader(ctx, file_schema, part_schema=None, part_values=None,
                  schema=None, to_device=None, metrics=None) -> Callable:
    """``upload((file index, record batch))`` -> the device batch at the
    session's string width cap, the file's partition columns after its
    own.  ``to_device`` is the host-to-device conversion
    (``columnar/batch.py: host_batch_to_device`` unless the scan names
    its own).  While compressed ingest is on, the scan's
    ``IngestEncoder`` takes its string, integer and boolean columns: a
    column the reader gave as an Arrow dictionary (parquet's
    ``read_dictionary``) is decided from that dictionary, any other
    from its host values; ``encodedColumns`` counts on ``metrics``."""
    from spark_rapids_tpu_torch.columnar.batch import \
        host_batch_to_device, host_columns_from_arrow
    from spark_rapids_tpu_torch.columnar.column import bucket_capacity
    from spark_rapids_tpu_torch.conf import MAX_STRING_WIDTH
    from spark_rapids_tpu_torch.exec.basic import make_encoder
    from spark_rapids_tpu_torch.io import hivepart
    max_w = ctx.conf.get(MAX_STRING_WIDTH)
    to_device = to_device or host_batch_to_device
    encoder = make_encoder(ctx, metrics)

    def upload(item):
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.transfer import Upload
        fi, rb = item
        up = Upload(ctx.device)
        decided = {}
        if encoder is not None:
            cap = bucket_capacity(rb.num_rows)
            for f, arr in zip(file_schema, rb.columns):
                if pa.types.is_dictionary(arr.type):
                    decided[f.name] = encoder.upload_arrow(arr, f.dtype, cap,
                                                           up)
        _, cols = host_columns_from_arrow(rb)
        b = to_device(file_schema, cols, ctx.device, max_w, encoder,
                      decided, up=up, defer=True)
        if part_schema:
            ready = b.ready
            b = hivepart.append_partition_columns(
                b, part_schema, part_values[fi], schema)
            b.ready = ready
        return b
    return upload


def pipelined_scan(ctx, metrics, host_items: Iterator, upload: Callable,
                   name: str, nbytes: Callable) -> Iterator:
    """The shared scan tail (see the module docstring): ``host_items``
    are the scan's host items in order, ``upload(item)`` dispatches one
    item's upload (a batch, or anything with a ``ready`` event), and
    ``nbytes(item)`` sizes its staging admission.  On the prefetch path
    an item's bytes are admitted by its queue grant, held until the
    consumer pulls the next one, so its upload takes no second grant."""
    from spark_rapids_tpu_torch.columnar.transfer import pipelined_h2d
    from spark_rapids_tpu_torch.conf import IO_PREFETCH_ENABLED
    from spark_rapids_tpu_torch.io.prefetch import maybe_prefetch
    src = maybe_prefetch(host_items, ctx, metrics, nbytes=nbytes, name=name)
    if src is host_items:
        staging = ctx.runtime.catalog.staging

        def do_upload(item):
            with staging.limit(nbytes(item)):
                return upload(item)
    else:
        do_upload = upload
    try:
        yield from pipelined_h2d(src, do_upload, ctx.runtime, metrics,
                                 enabled=ctx.conf.get(IO_PREFETCH_ENABLED))
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            close()


def host_nbytes(cols) -> int:
    """Host bytes of a dict of ``(values, validity)`` columns."""
    total = 0
    for values, valid in cols.values():
        total += valid.nbytes
        chars = getattr(values, "chars", None)
        total += values.nbytes if chars is None \
            else chars.nbytes + values.lengths.nbytes
    return int(total)


def read_dictionary_columns(file_schema) -> Optional[List[str]]:
    """The string columns a parquet scan reads as Arrow dictionaries
    while compressed ingest is on (the JAX scan's ``read_dictionary``),
    else None."""
    from spark_rapids_tpu_torch.columnar import encoding
    from spark_rapids_tpu_torch.columnar.dtypes import STRING
    if not encoding.ingest_enabled():
        return None
    return [f.name for f in file_schema if f.dtype == STRING] or None
