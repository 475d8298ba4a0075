"""Nondeterministic expressions: ``rand``, ``monotonically_increasing_id``
and ``spark_partition_id``.

Counterpart of ``spark_rapids_tpu/exprs/nondeterministic.py``.  Each
row's value depends on the partition, which is the ordinal of the batch
in its stage's input (``EvalContext.partition_id``), as the JAX package
threads it.

``rand(seed)`` is bit for bit the JAX package's
``jax.random.uniform(fold_in(PRNGKey(seed), partition), (capacity,),
float64)`` under ``jax_threefry_partitionable`` and ``jax_enable_x64``:
the key is the seed's two 32-bit halves, ``fold_in`` hashes the pair
(0, partition) with threefry-2x32 under it, and row i's 64 bits are the
threefry-2x32 hash of the counter pair (i >> 32, i & 0xFFFFFFFF) under
the folded key, high word first; the top 52 bits become the mantissa of
a double in [1, 2), less 1.  torch has no uint32, so the words are
carried in int64 and masked after every add and shift.  It is a
different generator than Spark's XORShift, hence incompatible
(``spark.rapids.sql.incompatibleOps.enabled``).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar.dtypes import FLOAT64, INT32, INT64
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, Expression

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def contains_nondeterministic(e: Expression) -> bool:
    """Whether the tree holds an expression whose value depends on the
    row's position or partition."""
    if isinstance(e, (Rand, MonotonicallyIncreasingID, SparkPartitionID)):
        return True
    return any(contains_nondeterministic(c) for c in e.children)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the words (x0, x1) under the
    key (k0, k1); every word an int64 holding a uint32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def rand_key(seed: int, partition_id: int):
    """``fold_in(PRNGKey(seed), partition_id)`` as two ints."""
    seed &= (1 << 64) - 1
    k0, k1 = seed >> 32, seed & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([partition_id & _M32]))
    return int(y0), int(y1)


def uniform_doubles(seed: int, partition_id: int, n: int,
                    device) -> torch.Tensor:
    """The first ``n`` doubles of the stream of (seed, partition)."""
    k0, k1 = rand_key(seed, partition_id)
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(k0, k1, i >> 32, i & _M32)
    # bits >> 12 | the exponent of 1.0, as a double, less 1
    mant = ((hi << 20) | (lo >> 12)) & ((1 << 52) - 1)
    one = 0x3FF0000000000000
    return (mant | one).view(torch.float64) - 1.0


class Rand(Expression):
    """rand(seed): uniform in [0, 1), DOUBLE."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.children = ()

    @property
    def dtype(self):
        return FLOAT64

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return f"rand({self.seed})"

    def key(self) -> str:
        return f"rand[{self.seed}]"

    def emit(self, ctx: EvalContext) -> ColVal:
        vals = uniform_doubles(self.seed, ctx.partition_id, ctx.capacity,
                               ctx.device)
        return ColVal(vals, torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))


class MonotonicallyIncreasingID(Expression):
    """(partition << 33) + the row's index in its batch, as Spark splits
    the bits."""

    def __init__(self):
        self.children = ()

    @property
    def dtype(self):
        return INT64

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return "monotonically_increasing_id()"

    def key(self) -> str:
        return "monotonically_increasing_id"

    def emit(self, ctx: EvalContext) -> ColVal:
        ids = (int(ctx.partition_id) << 33) + torch.arange(
            ctx.capacity, dtype=torch.int64, device=ctx.device)
        return ColVal(ids, torch.ones(ctx.capacity, dtype=torch.bool,
                                      device=ctx.device))


class SparkPartitionID(Expression):
    """The partition ordinal."""

    def __init__(self):
        self.children = ()

    @property
    def dtype(self):
        return INT32

    @property
    def nullable(self) -> bool:
        return False

    @property
    def name(self) -> str:
        return "spark_partition_id()"

    def key(self) -> str:
        return "spark_partition_id"

    def emit(self, ctx: EvalContext) -> ColVal:
        return ColVal(
            torch.full((ctx.capacity,), int(ctx.partition_id),
                       dtype=torch.int32, device=ctx.device),
            torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device))
