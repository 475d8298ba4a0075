"""Carry a batch across from the JAX package, bit for bit.

The tests hand both packages the same capacity-padded batches: they take
the planes of a JAX ``ColumnarBatch`` with ``np.asarray`` and pass them
here, so the port never sees a jax object.  For this system data takes
the place of model weights, and this is how one set of it feeds both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.columnar.dtypes import (
    STRING, DataType, Field, Schema, device_dtype,
)


def batch_from_planes(planes: Sequence[Tuple[np.ndarray, ...]],
                      dtypes: Sequence[DataType], num_rows: int,
                      capacity: int, device,
                      names: Optional[Sequence[str]] = None
                      ) -> ColumnarBatch:
    """``(data, validity)`` numpy planes of shape (capacity,), and for a
    STRING column ``(lengths, validity, chars)`` with chars of shape
    (capacity, width) uint8 -> a port batch holding the same bits on
    ``device``."""
    names = list(names) if names is not None else \
        [f"c{i}" for i in range(len(dtypes))]
    cols = []
    for plane, dt in zip(planes, dtypes):
        data, valid = np.asarray(plane[0]), np.asarray(plane[1])
        chars = None
        if dt == STRING:
            if len(plane) != 3:
                raise ValueError("a string column needs (lengths, validity, "
                                 "chars) planes")
            chars = np.asarray(plane[2])
            if chars.dtype != np.uint8 or chars.ndim != 2 \
                    or chars.shape[0] != capacity:
                raise TypeError(f"chars must be ({capacity}, width) uint8, "
                                f"got {chars.dtype}{chars.shape}")
            chars = torch.from_numpy(chars.copy()).to(device)
        want = torch.empty(0, dtype=device_dtype(dt)).numpy().dtype
        if data.shape != (capacity,) or valid.shape != (capacity,):
            raise ValueError(f"planes of shape {data.shape}/{valid.shape}, "
                             f"capacity {capacity}")
        if data.dtype != want or valid.dtype != np.bool_:
            raise TypeError(f"{dt.name} planes must be {want}/bool, got "
                            f"{data.dtype}/{valid.dtype}")
        cols.append(DeviceColumn(
            dt, torch.from_numpy(data.copy()).to(device),
            torch.from_numpy(valid.copy()).to(device), num_rows, chars))
    schema = Schema([Field(n, dt, True) for n, dt in zip(names, dtypes)])
    return ColumnarBatch(cols, num_rows, schema)
