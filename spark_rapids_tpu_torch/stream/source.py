"""Tailing file sources: a directory's diff -> append micro-batches.

Counterpart of ``spark_rapids_tpu/stream/source.py``.  A
``TailingSource`` watches one parquet, ORC or CSV root (a directory, a
glob or a file list, as the relation's reader expands it) and turns what
changed since its committed snapshot into a ``MicroBatch``:

* new files, oldest first (by path) and at most
  ``spark.rapids.stream.maxFilesPerTick`` a tick, ride as the stream
  relation over just those paths, so they go through the normal scan
  (a CSV file decoded on the device);
* grown files are read from their committed high-water mark: a CSV
  file's bytes past its committed size, decoded on the device
  (``io/csv.py: decode_file`` from that byte, no header), a parquet or
  ORC file re-read and sliced at its committed row count; they ride as
  an in-memory relation of the leaf's schema;
* a file that shrank or vanished is not an append: the batch lists it
  under ``rewritten`` and the registry recomputes every bound query.

A file's change token is ``(mtime_ns, size, parquet tail marker)``, the
grammar of ``plan/fingerprint.leaf_file_tokens``, so the poller and the
result cache agree on what changed.  ``poll()`` consults the
``stream.poll`` fault site first and never moves the committed snapshot:
the caller commits once the batch's consumers are done, so a failed tick
loses nothing.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.stream import stats as stream_stats

FAULT_SITE_POLL = "stream.poll"

# a committed file: (mtime_ns, size, marker, rows); rows is the
# high-water row count of a parquet or ORC file (a CSV file's is its
# byte size)
_Rec = Tuple[int, int, str, int]

_FORMATS = {lp.ParquetRelation: "parquet", lp.OrcRelation: "orc",
            lp.CsvRelation: "csv"}


def leaf_format(leaf: lp.LogicalPlan) -> str:
    try:
        return _FORMATS[type(leaf)]
    except KeyError:
        raise TypeError(f"not a tailable relation: {leaf.node_name}") \
            from None


def _expand(fmt: str, paths) -> List[str]:
    if fmt == "parquet":
        from spark_rapids_tpu_torch.io.parquet import expand_paths
        return expand_paths(paths)
    if fmt == "orc":
        from spark_rapids_tpu_torch.io.orc import expand_orc_paths
        return expand_orc_paths(paths)
    from spark_rapids_tpu_torch.io.csv import expand_csv_paths
    return expand_csv_paths(paths)


def _marker(fmt: str, path: str) -> str:
    if fmt == "parquet":
        from spark_rapids_tpu_torch.io.parquet import tail_marker
        return tail_marker(path)
    return ""


def _row_count(fmt: str, path: str) -> int:
    if fmt == "parquet":
        import pyarrow.parquet as pq
        return int(pq.ParquetFile(path).metadata.num_rows)
    if fmt == "orc":
        import pyarrow.orc as paorc
        return int(paorc.ORCFile(path).nrows)
    return 0


def new_files_leaf(leaf: lp.LogicalPlan,
                   files: List[str]) -> lp.LogicalPlan:
    """The leaf relation over exactly ``files``: same kind, schema,
    options and pushed predicate."""
    if not isinstance(leaf, lp.FILE_RELATIONS):
        raise TypeError(f"not a tailable relation: {leaf.node_name}")
    return lp.with_paths(leaf, list(files))


def empty_leaf(leaf: lp.LogicalPlan) -> lp.LogicalPlan:
    """An in-memory relation of no rows with the leaf's schema."""
    from spark_rapids_tpu_torch.columnar.batch import empty_host_values
    cols = {f.name: (empty_host_values(f.dtype), np.zeros(0, np.bool_))
            for f in leaf.schema}
    return lp.LocalRelation(leaf.schema, cols)


class MicroBatch:
    """One tick's append delta against the committed snapshot."""

    def __init__(self, source: "TailingSource", new_files: List[str],
                 grown: List[Tuple[str, int]], rewritten: List[str],
                 snapshot: Dict[str, _Rec]):
        self.source = source
        self.new_files = new_files      # whole files not seen before
        self.grown = grown              # (path, committed high-water)
        self.rewritten = rewritten      # shrunk or vanished: no append
        self.detected_at = time.monotonic()
        self._snapshot = snapshot       # committed on success

    def __bool__(self) -> bool:
        return bool(self.new_files or self.grown or self.rewritten)


class TailingSource:
    """One watched root; ``poll()`` diffs, ``commit()`` advances."""

    def __init__(self, paths, fmt: str, max_files_per_tick: int = 64,
                 device=None):
        if fmt not in ("parquet", "orc", "csv"):
            raise ValueError(f"untailable format {fmt!r}")
        self.paths = paths
        self.fmt = fmt
        self.max_files_per_tick = max(1, int(max_files_per_tick))
        # where a grown CSV tail is decoded
        self.device = device if device is not None else "cpu"
        self._lock = threading.Lock()
        self._committed: Dict[str, _Rec] = {}
        self.baseline()

    @property
    def key(self) -> tuple:
        p = self.paths
        return (self.fmt, tuple(p) if isinstance(p, (list, tuple)) else (p,))

    def baseline(self) -> None:
        """Commit the current file set without a batch: the snapshot a
        standing query's bootstrap reads (``committed_files``)."""
        snap: Dict[str, _Rec] = {}
        for f in _expand(self.fmt, self.paths):
            rec = self._stat(f)
            if rec is not None:
                snap[f] = rec
        with self._lock:
            self._committed = snap

    def _stat(self, path: str) -> Optional[_Rec]:
        try:
            st = os.stat(path)
        except OSError:
            return None  # vanished while listed: the next tick settles it
        try:
            return (st.st_mtime_ns, st.st_size, _marker(self.fmt, path),
                    _row_count(self.fmt, path))
        except Exception:
            # listed but not readable: a torn write, or a rewrite with
            # its stats restored.  Never an append: a new file waits for
            # a clean read, a committed one is rewritten
            return (st.st_mtime_ns, st.st_size, "corrupt", -1)

    def committed_files(self) -> List[str]:
        with self._lock:
            return sorted(self._committed)

    def poll(self) -> Optional[MicroBatch]:
        """The live file set against the committed snapshot, or None
        when nothing changed.  An injected ``stream.poll`` failure
        raises before anything moves."""
        faults.maybe_fail(FAULT_SITE_POLL, "injected tailing-source poll "
                          f"failure ({self.fmt} {self.paths!r})")
        with self._lock:
            committed = dict(self._committed)
        live = _expand(self.fmt, self.paths)
        new_files: List[str] = []
        grown: List[Tuple[str, int]] = []
        rewritten: List[str] = []
        snapshot: Dict[str, _Rec] = dict(committed)
        for f in live:
            old = committed.get(f)
            rec = self._stat(f)
            if rec is None:
                continue
            if old is None:
                if rec[2] == "corrupt":
                    continue
                if len(new_files) < self.max_files_per_tick:
                    new_files.append(f)
                    snapshot[f] = rec
                continue
            if rec[:3] == old[:3]:
                continue
            if rec[2] == "corrupt" or rec[1] < old[1]:
                rewritten.append(f)
            elif self.fmt == "csv":
                grown.append((f, old[1]))   # the byte high-water
            elif rec[3] < old[3]:
                rewritten.append(f)
            else:
                grown.append((f, old[3]))   # the row high-water
            snapshot[f] = rec
        live_set = set(live)
        for f in committed:
            if f not in live_set:
                rewritten.append(f)
                snapshot.pop(f, None)
        batch = MicroBatch(self, new_files, grown, rewritten, snapshot)
        return batch if batch else None

    def commit(self, batch: MicroBatch) -> None:
        """Advance the committed snapshot to the batch's; called once
        every consumer of the batch is done, so a failed refresh replays
        the same delta."""
        with self._lock:
            self._committed = dict(batch._snapshot)

    # -- the delta ----------------------------------------------------------

    def _read_tail(self, leaf: lp.LogicalPlan, path: str, mark: int):
        """The appended rows of one grown file as host columns."""
        from spark_rapids_tpu_torch.columnar.batch import \
            device_batch_to_host, host_columns_from_arrow
        if self.fmt == "csv":
            from spark_rapids_tpu_torch.io.csv import decode_file
            parts = [device_batch_to_host(b) for b in decode_file(
                path, leaf.schema, False, leaf.sep, self.device, 1 << 62,
                start=mark)]
            return parts
        if self.fmt == "parquet":
            import pyarrow.parquet as pq
            t = pq.read_table(path)
        else:
            import pyarrow.orc as paorc
            t = paorc.ORCFile(path).read()
        t = t.slice(mark).select(leaf.schema.names).cast(
            leaf.schema.to_arrow())
        return [host_columns_from_arrow(t)[1]] if t.num_rows else []

    def delta_leaf(self, batch: MicroBatch,
                   leaf: lp.LogicalPlan) -> lp.LogicalPlan:
        """The micro-batch as a relation of ``leaf``'s schema: new files
        as the stream relation over them, grown tails as an in-memory
        relation, both under a Union when a tick has both."""
        from spark_rapids_tpu_torch.columnar.batch import \
            concat_host_values
        parts: List[lp.LogicalPlan] = []
        if batch.new_files:
            parts.append(new_files_leaf(leaf, batch.new_files))
        if batch.grown:
            tails = [c for p, mark in batch.grown
                     for c in self._read_tail(leaf, p, mark)]
            tails = [c for c in tails if len(next(iter(c.values()))[1])]
            if tails:
                cols = {f.name: (concat_host_values(
                    [c[f.name][0] for c in tails]),
                    np.concatenate([c[f.name][1] for c in tails]))
                    for f in leaf.schema}
                stream_stats.bump("batch_rows", len(
                    cols[leaf.schema[0].name][1]))
                parts.append(lp.LocalRelation(leaf.schema, cols))
        if not parts:
            return empty_leaf(leaf)
        return parts[0] if len(parts) == 1 else lp.Union(parts)
