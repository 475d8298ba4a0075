"""Sort keys and the lexicographic sort permutation.

Counterpart of ``spark_rapids_tpu/exec/sortkeys.py``.  Each column maps
to a list of key tensors whose lexicographic ascending order is the
column's SQL order: a leading null key (nulls first or last), then the
data; float keys are a (NaN rank, canonical value) pair, so NaN is
greatest, all NaNs are equal and -0.0 == 0.0; a string's keys are its
bytes in 4-byte big-endian blocks packed into int64, most significant
first, then its length as a tiebreak (bytes at or after the length count
as 0); descending is the bitwise NOT of an integer key (negation of a
float key).

The permutation is a sequence of stable ``torch.sort`` passes from the
least significant key to the most.  The TPU package's bitonic network
(``bitonic_lex_sort``) works around XLA's sort compile times on a TPU
and is not carried over.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, FLOAT32, \
    FLOAT64, STRING, DataType
from spark_rapids_tpu_torch.exprs.base import ColVal


def float_order_keys(x: torch.Tensor) -> List[torch.Tensor]:
    """Float column -> [nan_rank int32, canonical float] whose
    lexicographic order is Spark's: NaN greatest and all NaNs equal,
    -0.0 == 0.0."""
    isnan = torch.isnan(x)
    canon = torch.where(isnan | (x == 0), torch.zeros_like(x), x)
    return [isnan.to(torch.int32), canon]


def string_order_keys(chars: torch.Tensor,
                      lengths: torch.Tensor) -> List[torch.Tensor]:
    """(capacity, width) chars and their lengths -> int64 keys whose
    lexicographic order is the strings' byte order (JAX
    ``sortkeys.py:62-73``).  Widths are powers of two >= 8, so the
    blocks tile a row."""
    rows, w = chars.shape
    inside = torch.arange(w, device=chars.device)[None, :] \
        < lengths[:, None]
    c = torch.where(inside, chars, torch.zeros_like(chars))
    # a 4-byte block at a time: widening the whole matrix to int64 first
    # would hold 8 bytes a char (2 GiB for 2^23 rows of 32 bytes)
    keys = []
    for j in range(0, w, 4):
        b = c[:, j:j + 4].to(torch.int64)
        keys.append((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
                    | b[:, 3])
    return keys + [lengths.to(torch.int64)]


def colval_sort_keys(cv: ColVal, dtype: DataType, ascending: bool = True,
                     nulls_first: bool = True) -> List[torch.Tensor]:
    """ColVal -> key tensors, most significant first."""
    nk = cv.validity.to(torch.int32)
    keys = [nk if nulls_first else 1 - nk]
    if dtype == STRING:
        data_keys = string_order_keys(cv.chars, cv.data)
    elif dtype == BOOLEAN:
        data_keys = [cv.data.to(torch.int32)]
    elif dtype in (FLOAT32, FLOAT64):
        data_keys = float_order_keys(cv.data)
    else:
        data_keys = [cv.data]
    if not ascending:
        data_keys = [-k if k.dtype.is_floating_point else ~k
                     for k in data_keys]
    # null rows carry arbitrary data; zero it so equal nulls group
    keys.extend(torch.where(cv.validity, k, torch.zeros_like(k))
                for k in data_keys)
    return keys


def sort_permutation(all_keys: List[torch.Tensor],
                     live_first: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Stable lexicographic sort -> permutation.  ``live_first`` (True =
    live row) forces padding rows to the end."""
    keys = list(all_keys)
    if live_first is not None:
        keys.insert(0, (~live_first).to(torch.int32))
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm
