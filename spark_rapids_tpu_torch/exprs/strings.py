"""String predicates with a literal pattern over the char matrix.

Counterpart of ``spark_rapids_tpu/exprs/strings.py``, trimmed to this
slice: ``_static_pattern``, ``StringExpression``, ``_PatternPredicate``
and its ``StartsWith``, ``EndsWith`` and ``Contains``, ``StringLength``
and ``Substring`` (both in UTF-8 characters).  A STRING
``ColVal`` is (lengths int32, validity, chars uint8 (capacity, width));
each predicate compares the literal's bytes against windows of the char
matrix with torch ops, under the JAX package's edge rules: an empty
pattern matches every row, a pattern wider than the matrix matches none,
only bytes before a row's length take part, and a null pattern gives an
all-null result.  The rest of the JAX module (case conversion, concat,
LIKE, RLIKE, split and trim) is not in the port yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, INT32, STRING, \
    DataType
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


def _char_starts(chars: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(capacity, width) mask of the UTF-8 lead bytes (a character's first
    byte) before each row's length."""
    inside = torch.arange(chars.shape[1], device=chars.device)[None, :] \
        < lengths[:, None]
    return inside & ((chars & 0xC0) != 0x80)


class StringLength(Expression):
    """length(s): the number of UTF-8 characters, not bytes."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def name(self) -> str:
        return f"length({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        n = _char_starts(c.chars, c.data).sum(dim=1, dtype=torch.int32)
        return fixed(n, c.validity)


class Substring(StringExpression):
    """substring(s, pos[, len]) in UTF-8 characters, with Spark's rules:
    ``pos`` is 1-based, 0 counts as 1, a negative ``pos`` counts from the
    end and, past the start, eats into the length; no length means to the
    end.  ``pos`` and ``len`` must be non-null literals: the JAX package
    sends any other to its CPU engine, and the port, which has none,
    raises when the planner binds it."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Optional[Expression] = None):
        self.children = (child, pos) + (() if length is None else (length,))
        self.pos = self.length = None
        if (isinstance(pos, Literal) and pos.value is not None
                and (length is None or (isinstance(length, Literal)
                                        and length.value is not None))):
            self.pos = int(pos.value)
            self.length = None if length is None else int(length.value)

    def with_children(self, children):
        return Substring(children[0], children[1],
                         children[2] if len(children) > 2 else None)

    def coerce(self) -> Expression:
        if self.pos is None:
            raise NotImplementedError(
                "substring: pos and len must be non-null literals (the "
                "torch port has no CPU engine to run another)")
        return self

    @property
    def name(self) -> str:
        return (f"substring({self.children[0].name}, {self.pos}"
                + (f", {self.length})" if self.length is not None else ")"))

    def key(self) -> str:
        return f"Substring[{self.pos},{self.length}]({self.children[0].key()})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        w = c.chars.shape[1]
        pos = torch.arange(w, device=c.chars.device)[None, :]
        inside = pos < c.data[:, None]
        starts = _char_starts(c.chars, c.data)
        # a continuation byte takes its lead byte's 0-based character index
        char_idx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
        # int64: substring(s, p, 2**31 - 1) ("to the end") overflows int32
        n = starts.sum(dim=1)
        if self.pos > 0:
            st = torch.full_like(n, self.pos - 1)
        elif self.pos < 0:
            st = n + self.pos
        else:
            st = torch.zeros_like(n)
        if self.length is None:
            en = n
        elif self.length < 0:
            en = st
        else:
            en = st + min(self.length, 1 << 40)
        st, en = st.clamp(min=0)[:, None], en.clamp(min=0)[:, None]
        # the kept bytes are one run, since char_idx never decreases:
        # gather it to the front of the row
        first = (inside & (char_idx < st)).sum(dim=1, keepdim=True)
        new_len = (inside & (char_idx >= st) & (char_idx < en)).sum(dim=1)
        src = (first + pos).clamp(max=w - 1)
        out = torch.where(pos < new_len[:, None],
                          torch.gather(c.chars, 1, src),
                          torch.zeros((), dtype=torch.uint8,
                                      device=c.chars.device))
        return ColVal(new_len.to(torch.int32), c.validity, out)
