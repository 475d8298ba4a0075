"""Generator expressions: explode and posexplode of array literals.

Counterpart of ``spark_rapids_tpu/exprs/generators.py``.  As in the JAX
package there is no array column type: ``explode(array(...))`` of a
literal array is the one shape a generator takes, and the DataFrame API
refuses an array literal anywhere else.  The generate exec
(``exec/generate.py``) evaluates the generator; a projection never
does.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.exprs.base import Expression, Literal


class ArrayLiteral(Expression):
    """A literal array; valid only as the child of a generator."""

    def __init__(self, values, elem_dtype: Optional[DataType] = None):
        vals: List = []
        dt = elem_dtype
        for v in values:
            if v is None:
                vals.append(None)
                continue
            lit = v if isinstance(v, Literal) else Literal(v)
            dt = dt or lit.dtype
            vals.append(lit.value)
        if dt is None:
            raise ValueError(
                "cannot infer array element type from all-null array; "
                "pass elem_dtype")
        self.values = vals
        self._dtype = dt
        self.children = ()

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return any(v is None for v in self.values)

    def key(self) -> str:
        return f"arraylit[{self._dtype.name};{self.values!r}]"

    def emit(self, ctx):
        raise RuntimeError(
            "ArrayLiteral is only valid inside explode()/posexplode()")


class Explode(Expression):
    """explode / posexplode: ``with_pos`` adds the element's position;
    ``outer`` gives a row whose array is empty one null-extended row."""

    def __init__(self, array: ArrayLiteral, with_pos: bool = False,
                 outer: bool = False):
        if not isinstance(array, ArrayLiteral):
            raise ValueError(
                "explode() supports literal arrays only — build one with "
                "F.array(...) (reference restriction, "
                "GpuGenerateExec.scala:33-190)")
        self.children = (array,)
        self.with_pos = bool(with_pos)
        self.outer = bool(outer)

    @property
    def array(self) -> ArrayLiteral:
        return self.children[0]

    @property
    def dtype(self) -> DataType:
        return self.array.dtype

    @property
    def nullable(self) -> bool:
        return self.array.nullable or self.outer

    @property
    def name(self) -> str:
        return "col"

    def key(self) -> str:
        return (f"explode[pos={self.with_pos},outer={self.outer}]"
                f"({self.array.key()})")

    def emit(self, ctx):
        raise RuntimeError(
            "Explode must be evaluated by a generate exec, not a projection")


def find_generators(e: Expression) -> List[Explode]:
    """Every Explode in an expression tree."""
    out: List[Explode] = [e] if isinstance(e, Explode) else []
    for c in e.children:
        out.extend(find_generators(c))
    return out


def find_stray_array_literals(e: Expression) -> bool:
    """True when an ArrayLiteral stands anywhere but directly under an
    Explode."""
    if isinstance(e, Explode):
        return False
    if isinstance(e, ArrayLiteral):
        return True
    return any(find_stray_array_literals(c) for c in e.children)
