"""String predicates with a literal pattern over the char matrix.

Counterpart of ``spark_rapids_tpu/exprs/strings.py``, trimmed to this
slice: ``_static_pattern``, ``StringExpression``, ``_PatternPredicate``
and its ``StartsWith``, ``EndsWith`` and ``Contains``.  A STRING
``ColVal`` is (lengths int32, validity, chars uint8 (capacity, width));
each predicate compares the literal's bytes against windows of the char
matrix with torch ops, under the JAX package's edge rules: an empty
pattern matches every row, a pattern wider than the matrix matches none,
only bytes before a row's length take part, and a null pattern gives an
all-null result.  The rest of the JAX module (case conversion, substring,
concat, LIKE, RLIKE, split and trim) is not in the port yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, STRING, DataType
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext, \
    Expression, Literal, fixed


def _static_pattern(e: Expression) -> Tuple[bool, Optional[bytes]]:
    """(is_static, UTF-8 bytes or None for a null literal) of a pattern.
    Only a Literal is static: the JAX package sends any other pattern to
    its CPU engine, and the port, which has none, refuses it."""
    if not isinstance(e, Literal):
        return False, None
    if e.value is None:
        return True, None
    return True, e.value.encode("utf-8")


def contains_unrolled(chars: torch.Tensor, lengths: torch.Tensor,
                      pat: bytes) -> torch.Tensor:
    """(capacity,) bool: some window ``j`` with ``j + k <= lengths[r]``
    has ``chars[r, j:j+k] == pat``.  One shifted comparison per pattern
    byte over every candidate window at once, as JAX ``Contains._match``
    does; ``k == 0`` is true and ``k > width`` false for every row."""
    k, w = len(pat), chars.shape[1]
    rows = chars.shape[0]
    if k == 0:
        return torch.ones(rows, dtype=torch.bool, device=chars.device)
    if k > w:
        return torch.zeros(rows, dtype=torch.bool, device=chars.device)
    npos = w - k + 1
    acc = chars[:, 0:npos] == pat[0]
    for j in range(1, k):
        acc &= chars[:, j:j + npos] == pat[j]
    starts = torch.arange(npos, device=chars.device)
    acc &= starts[None, :] + k <= lengths[:, None]
    return acc.any(dim=1)


class StringExpression(Expression):
    """Base for expressions producing STRING."""

    @property
    def dtype(self) -> DataType:
        return STRING


class _PatternPredicate(Expression):
    def __init__(self, left: Expression, pattern: Expression):
        self.children = (left, pattern)
        self.is_static, self.pat = _static_pattern(pattern)
        if not self.is_static:
            raise NotImplementedError(
                f"{type(self).__name__}: the pattern must be a literal "
                "(the torch port has no CPU engine to run another)")

    def with_children(self, children):
        return type(self)(children[0], children[1])

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return (f"{type(self).__name__.lower()}({self.children[0].name}, "
                f"{self.children[1].name})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if c.chars is None:
            raise TypeError(f"{type(self).__name__} needs a string input, "
                            f"got {self.children[0].dtype}")
        if self.pat is None:
            none = torch.zeros(ctx.capacity, dtype=torch.bool,
                               device=ctx.device)
            return fixed(none, none)
        return fixed(self._match(c), c.validity)

    def _match(self, c: ColVal) -> torch.Tensor:
        raise NotImplementedError


def _edge(c: ColVal, k: int) -> Optional[torch.Tensor]:
    """The result every row gets when ``k`` alone decides it, else None."""
    if k == 0:
        return torch.ones_like(c.validity)
    if k > c.chars.shape[1]:
        return torch.zeros_like(c.validity)
    return None


def _pattern(pat: bytes, device) -> torch.Tensor:
    return torch.tensor(list(pat), dtype=torch.uint8, device=device)


class StartsWith(_PatternPredicate):
    def _match(self, c: ColVal) -> torch.Tensor:
        k = len(self.pat)
        edge = _edge(c, k)
        if edge is not None:
            return edge
        pat = _pattern(self.pat, c.chars.device)
        hit = (c.chars[:, :k] == pat[None, :]).all(dim=1)
        return (c.data >= k) & hit


class EndsWith(_PatternPredicate):
    def _match(self, c: ColVal) -> torch.Tensor:
        k = len(self.pat)
        edge = _edge(c, k)
        if edge is not None:
            return edge
        w = c.chars.shape[1]
        pat = _pattern(self.pat, c.chars.device)
        idx = c.data[:, None].to(torch.int64) - k \
            + torch.arange(k, device=c.chars.device)[None, :]
        g = torch.gather(c.chars, 1, idx.clamp(0, w - 1))
        return (c.data >= k) & (g == pat[None, :]).all(dim=1)


class Contains(_PatternPredicate):
    """All candidate windows compared at once (``contains_unrolled``)."""

    def _match(self, c: ColVal) -> torch.Tensor:
        return contains_unrolled(c.chars, c.data, self.pat)
