"""Device-resident columns.

Counterpart of ``spark_rapids_tpu/columnar/column.py``.  A column is a
data plane and a validity plane (``torch.bool``, False = null or
padding), both padded to a power-of-two bucket capacity.  A STRING
column adds ``chars``, a (capacity, width) uint8 char matrix holding each
row's UTF-8 bytes from column 0, with ``data`` holding the int32 byte
lengths; the width is the bucket of the batch's longest string, and
padding bytes and padding rows are 0 when a batch is uploaded.  The TPU
package pads so that XLA compiles one kernel per bucket; the port keeps
the same layout so that every operator, and the dense-slot kernel, sees
the shapes the JAX package gives it.  Rows beyond ``num_rows`` are
padding and never valid.

The row count is a host integer.  Where the JAX package keeps a count on
the device (``LazyRows``) to save a link round trip, the port reads it
back: on a card on the host's PCIe bus one small read costs microseconds.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar.dtypes import DataType

from spark_rapids_tpu_torch.compile import buckets as _buckets


def bucket_capacity(n: int) -> int:
    """The next rung >= ``n`` of the power-of-two capacity ladder
    (``compile/buckets.py``: at least 8, the JAX package's floor, unless
    ``spark.rapids.sql.compile.buckets.minRows`` raises it), so both
    packages pad every batch to the same capacity."""
    return _buckets.bucket_capacity(n)


class DeviceColumn:
    """One device column: ``data`` and ``validity`` of shape (capacity,),
    and for STRING the (capacity, width) uint8 ``chars``."""

    __slots__ = ("dtype", "data", "validity", "num_rows", "chars")

    def __init__(self, dtype: DataType, data: torch.Tensor,
                 validity: torch.Tensor, num_rows: int,
                 chars: Optional[torch.Tensor] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.num_rows = int(num_rows)
        self.chars = chars

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def string_width(self) -> int:
        return int(self.chars.shape[1]) if self.chars is not None else 0

    def size_bytes(self) -> int:
        total = (self.data.numel() * self.data.element_size()
                 + self.validity.numel() * self.validity.element_size())
        if self.chars is not None:
            total += self.chars.numel()
        return int(total)

    def slice_rows(self, start: int, n: int, cap: int) -> "DeviceColumn":
        """Rows ``start`` to ``start + n`` at capacity ``cap``, padding
        rows zero and invalid, a string's width kept; a slice that fills
        ``cap`` exactly is a view of these planes.  An encoded or plane
        column (``columnar/encoding.py``) gives its own."""
        planes = []
        for a in (self.data, self.validity, self.chars):
            if a is None:
                planes.append(None)
                continue
            out = a[start:start + n]
            if n < cap:
                out = a.new_zeros((cap,) + tuple(a.shape[1:]))
                out[:n] = a[start:start + n]
            planes.append(out)
        return DeviceColumn(self.dtype, planes[0], planes[1], n, planes[2])

    def __repr__(self):
        return (f"DeviceColumn({self.dtype}, rows={self.num_rows}, "
                f"cap={self.capacity})")
