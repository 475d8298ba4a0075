"""Expression base classes and binding.

Counterpart of ``spark_rapids_tpu/exprs/base.py``.  A bound expression
tree ``emit``s torch operations on ``ColVal`` (data, validity) pairs.
The JAX package traces the tree into one jitted kernel per operator;
PyTorch runs eagerly, so here each ``emit`` runs its ops as it is
called, on the device of the batch it reads.
"""

from __future__ import annotations

import datetime
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import (
    BOOLEAN, DATE, FLOAT64, INT32, INT64, STRING, TIMESTAMP, DataType,
    Schema, device_dtype,
)


class ColVal(NamedTuple):
    """A column value inside expression evaluation: the data plane (for
    STRING the int32 byte lengths), the validity plane (False = null),
    and for STRING the (capacity, width) uint8 char matrix."""
    data: torch.Tensor
    validity: torch.Tensor
    chars: Optional[torch.Tensor] = None


def colvals(columns) -> List[ColVal]:
    """A batch's ``DeviceColumn``s -> their ColVals."""
    return [ColVal(c.data, c.validity, c.chars) for c in columns]


def take(cv: ColVal, rows: torch.Tensor) -> ColVal:
    """The values at ``rows``; a string's chars move with its length."""
    return ColVal(cv.data[rows], cv.validity[rows],
                  None if cv.chars is None else cv.chars[rows])


class EvalContext:
    """Carries the batch being evaluated into ``Expression.emit``."""

    __slots__ = ("cols", "num_rows", "capacity", "device", "partition_id",
                 "aux")

    def __init__(self, cols: Sequence[ColVal], num_rows: int, capacity: int,
                 device, partition_id: int = 0, aux: Sequence[ColVal] = ()):
        self.cols = list(cols)
        self.num_rows = num_rows
        self.capacity = capacity
        self.device = device
        # the ordinal of the batch in its stage's input, as the JAX
        # package threads it: rand, monotonically_increasing_id and
        # spark_partition_id read it
        self.partition_id = partition_id
        # the dictionary-domain gather tables of a code view
        # (columnar/encoding.py DictGather): an ordinal space apart from
        # ``cols``, so that a filter's compaction never sweeps them
        self.aux = tuple(aux)


class Expression:
    """Immutable expression tree node."""

    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    @property
    def name(self) -> str:
        return str(self)

    def key(self) -> str:
        args = ",".join(c.key() for c in self.children)
        return f"{type(self).__name__}({args})"

    def emit(self, ctx: EvalContext) -> ColVal:
        raise NotImplementedError(type(self).__name__)

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        """Generic rebuild; subclasses with extra state must override."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.children = tuple(children)
        return new

    def __repr__(self):
        return self.key()


class UnresolvedAttribute(Expression):
    """A by-name column reference prior to binding."""

    def __init__(self, col_name: str):
        self.col_name = col_name
        self.children = ()

    @property
    def name(self) -> str:
        return self.col_name

    def key(self) -> str:
        return f"attr[{self.col_name}]"

    def emit(self, ctx):
        raise RuntimeError(f"unresolved attribute {self.col_name!r}; "
                           "bind_expression() first")


class BoundReference(Expression):
    """Input column by ordinal."""

    def __init__(self, ordinal: int, dtype: DataType, nullable: bool = True,
                 col_name: str = ""):
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable
        self.col_name = col_name
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    @property
    def name(self) -> str:
        return self.col_name or f"c{self.ordinal}"

    def key(self) -> str:
        return f"in[{self.ordinal}:{self._dtype.name}]"

    def emit(self, ctx: EvalContext) -> ColVal:
        return ctx.cols[self.ordinal]


class Literal(Expression):
    """A scalar constant broadcast to the batch capacity."""

    def __init__(self, value, dtype: Optional[DataType] = None):
        if isinstance(value, datetime.datetime):
            # microseconds since the epoch, UTC (a naive value is UTC), in
            # integer arithmetic: float seconds would lose the last micro
            if value.tzinfo is None:
                value = value.replace(tzinfo=datetime.timezone.utc)
            epoch = datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
            value = (value - epoch) // datetime.timedelta(microseconds=1)
            dtype = dtype or TIMESTAMP
        elif isinstance(value, datetime.date):
            # days since the epoch, as a DATE column holds them
            value = (value - datetime.date(1970, 1, 1)).days
            dtype = dtype or DATE
        self.value = value
        self._dtype = dtype if dtype is not None else \
            _infer_literal_type(value)
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    @property
    def name(self) -> str:
        return repr(self.value)

    def key(self) -> str:
        return f"lit[{self.value!r}:{self._dtype.name}]"

    def emit(self, ctx: EvalContext) -> ColVal:
        cap, dev = ctx.capacity, ctx.device
        dt = device_dtype(self._dtype)
        if self._dtype == STRING:
            # width bucket_capacity(len), the row broadcast over capacity
            b = b"" if self.value is None else self.value.encode("utf-8")
            row = torch.zeros(bucket_capacity(max(1, len(b))),
                              dtype=torch.uint8)
            row[:len(b)] = torch.tensor(list(b), dtype=torch.uint8)
            return ColVal(
                torch.full((cap,), len(b), dtype=dt, device=dev),
                torch.full((cap,), self.value is not None, dtype=torch.bool,
                           device=dev),
                row.to(dev).expand(cap, row.shape[0]))
        if self.value is None:
            return ColVal(torch.zeros(cap, dtype=dt, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        # explicit dtype: torch.full would otherwise give a Python float
        # the default float32
        return ColVal(torch.full((cap,), self.value, dtype=dt, device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev))


class ParamLiteral(Literal):
    """A prepared statement's binding of a ``?`` marker (``sql.py``): a
    ``Literal`` whose ``slot`` lets the plan fingerprint and the
    re-binding of a template find it (``plan/fingerprint.py``).  It
    evaluates as the Literal it is; the port has no kernel cache to
    hoist its value out of."""

    def __init__(self, slot: int, value, dtype=None):
        super().__init__(value, dtype)
        self.slot = int(slot)

    def key(self) -> str:
        return f"param[{self.slot}]{super().key()}"


def _infer_literal_type(value) -> DataType:
    if value is None:
        raise ValueError("untyped null literal; pass dtype explicitly")
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, (int, np.integer)):
        return INT32 if -(2 ** 31) <= int(value) < 2 ** 31 else INT64
    if isinstance(value, (float, np.floating)):
        return FLOAT64
    if isinstance(value, str):
        return STRING
    raise TypeError(f"cannot infer literal type for {value!r}")


class Alias(Expression):
    """Named output column."""

    def __init__(self, child: Expression, out_name: str):
        self.children = (child,)
        self.out_name = out_name

    @property
    def dtype(self) -> DataType:
        return self.children[0].dtype

    @property
    def nullable(self) -> bool:
        return self.children[0].nullable

    @property
    def name(self) -> str:
        return self.out_name

    def key(self) -> str:
        return f"alias[{self.out_name}]({self.children[0].key()})"

    def emit(self, ctx: EvalContext) -> ColVal:
        return self.children[0].emit(ctx)

    def with_children(self, children):
        return Alias(children[0], self.out_name)


def bind_expression(expr: Expression, schema: Schema) -> Expression:
    """Resolve attributes to BoundReference and apply type coercion."""
    if isinstance(expr, UnresolvedAttribute):
        i = schema.field_index(expr.col_name)
        f = schema[i]
        return BoundReference(i, f.dtype, f.nullable, f.name)
    if not expr.children:
        return expr
    rebuilt = expr.with_children(
        [bind_expression(c, schema) for c in expr.children])
    coerce = getattr(rebuilt, "coerce", None)
    return coerce() if coerce is not None else rebuilt


def fixed(data: torch.Tensor, validity: torch.Tensor) -> ColVal:
    return ColVal(data, validity)


def align_chars(a_chars: torch.Tensor, b_chars: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the narrower of two char matrices with zero bytes so that both
    share the wider width."""
    w = max(a_chars.shape[1], b_chars.shape[1])
    return tuple(torch.nn.functional.pad(c, (0, w - c.shape[1]))
                 if c.shape[1] < w else c for c in (a_chars, b_chars))

