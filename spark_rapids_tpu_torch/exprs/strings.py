"""String expressions over the char matrix.

Counterpart of ``spark_rapids_tpu/exprs/strings.py``.  A STRING
``ColVal`` is (lengths int32, validity, chars uint8 (capacity, width)),
and every expression here is a torch op over that matrix: case
conversion an elementwise ``where`` (ASCII only, so ``Upper``, ``Lower``
and ``InitCap`` need ``spark.rapids.sql.incompatibleOps.enabled``, as in
the JAX package), character counting a mask of UTF-8 lead bytes,
substring, trim, split_part and substring_index a keep-mask compacted to
the front of each row (``_compact_left``), concat a gather from both
operands, replace a scatter of copied and replacement bytes, and LIKE
and RLIKE one NFA over decoded code points (``_nfa_match``), a step per
character.  The predicates with a literal pattern compare its bytes
against windows of the matrix under the JAX package's edge rules: an
empty pattern matches every row, a pattern wider than the matrix matches
none, only bytes before a row's length take part, and a null pattern
gives an all-null result.

Where the JAX package needs a literal pattern, delimiter or count and
sends any other to its CPU engine, the port, which has none, raises
``NotImplementedError`` when the planner binds the expression
(``coerce``).  ``Substring`` takes a column position and length as
well.  Every output keeps the column invariant: bytes past a row's
length are 0.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.columnar.dtypes import BOOLEAN, INT32, \
    STRING, DataType
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




# ---------------------------------------------------------------------------
# Shared helpers over the char matrix
# ---------------------------------------------------------------------------

def _in_len(chars: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(capacity, width) mask of the bytes inside each row's string."""
    return torch.arange(chars.shape[1], device=chars.device)[None, :] \
        < lengths[:, None]


def _compact_left(chars: torch.Tensor, keep: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept bytes of each row moved to its front in order, the tail
    zeroed -> (chars, int32 lengths).  Each kept byte scatters to its
    rank among the row's kept bytes (the JAX package's stable argsort on
    ``~keep`` gives the same matrix)."""
    rows, w = chars.shape
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, dest, torch.full_like(dest, w))
    out = torch.zeros((rows, w + 1), dtype=torch.uint8, device=chars.device)
    out.scatter_(1, dest, torch.where(keep, chars, torch.zeros_like(chars)))
    return out[:, :w].contiguous(), keep.sum(dim=1).to(torch.int32)


def _shift_left(b: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's columns moved ``k`` to the left, zeros shifted in."""
    if k >= b.shape[1]:
        return torch.zeros_like(b)
    return torch.nn.functional.pad(b[:, k:], (0, k))


def _decode_codepoints(chars: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UTF-8 -> (capacity, width) int32 code points compacted to the left
    of each row (-1 past its character count), and the counts."""
    b = chars.to(torch.int32)
    b1, b2, b3 = _shift_left(b, 1), _shift_left(b, 2), _shift_left(b, 3)
    code2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    code3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    code4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12)
             | ((b2 & 0x3F) << 6) | (b3 & 0x3F))
    code = torch.where(b < 0x80, b, torch.where(
        b < 0xE0, code2, torch.where(b < 0xF0, code3, code4)))
    starts = _char_starts(chars, lengths)
    rows, w = chars.shape
    dest = torch.cumsum(starts.to(torch.int64), dim=1) - 1
    dest = torch.where(starts, dest, torch.full_like(dest, w))
    codes = torch.full((rows, w + 1), -1, dtype=torch.int32,
                       device=chars.device)
    codes.scatter_(1, dest, torch.where(starts, code, -1))
    return codes[:, :w], starts.sum(dim=1).to(torch.int32)


def _null_string(cap: int, device, width: int = 8) -> ColVal:
    return ColVal(torch.zeros(cap, dtype=torch.int32, device=device),
                  torch.zeros(cap, dtype=torch.bool, device=device),
                  torch.zeros((cap, width), dtype=torch.uint8, device=device))


def _null_bool(cap: int, device) -> ColVal:
    none = torch.zeros(cap, dtype=torch.bool, device=device)
    return fixed(none, none)


def _literal_only(self, *what: str) -> None:
    """Raise at planning when an operand the device path needs as a
    literal is not one."""
    missing = [w for w in what if getattr(self, w + "_static") is False]
    if missing:
        raise NotImplementedError(
            f"{type(self).__name__}: {' and '.join(missing)} must be "
            "literal (the torch port has no CPU engine to run another)")


def _int_literal(e: Expression) -> Tuple[bool, Optional[int]]:
    """(is_static, int value or None for a null literal)."""
    if not isinstance(e, Literal):
        return False, None
    return True, None if e.value is None else int(e.value)


# ---------------------------------------------------------------------------
# Substring (characters, Spark's 1-based and negative positions)
# ---------------------------------------------------------------------------

class Substring(StringExpression):
    """substring(s, pos[, len]) in UTF-8 characters, with Spark's rules
    (UTF8String.substringSQL): ``pos`` is 1-based, 0 counts as 1, a
    negative ``pos`` counts from the end and, past the start, eats into
    the length; no length means to the end, a negative one gives ''.
    ``pos`` and ``len`` may be literals or integer columns (the JAX
    package sends a column to its CPU engine; the port computes it per
    row); a null ``pos`` or ``len`` gives null."""

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
        for c in self.children[1:]:
            if not (c.dtype.is_integral or (isinstance(c, Literal)
                                            and c.value is None)):
                raise TypeError(f"substring: {c.name} must be an integer")
        return self

    @property
    def name(self) -> str:
        if self.pos is None:
            args = ", ".join(c.name for c in self.children)
            return f"substring({args})"
        return (f"substring({self.children[0].name}, {self.pos}"
                + (f", {self.length})" if self.length is not None else ")"))

    def key(self) -> str:
        if self.pos is None:
            return super().key()
        return f"Substring[{self.pos},{self.length}]({self.children[0].key()})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        dev = c.chars.device
        valid = c.validity
        w = c.chars.shape[1]
        starts = _char_starts(c.chars, c.data)
        # a continuation byte takes its lead byte's 0-based character index
        char_idx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
        # int64: substring(s, p, 2**31 - 1) ("to the end") overflows int32
        n = starts.sum(dim=1)
        if self.pos is not None:
            pos = torch.full_like(n, self.pos)
            ln = None if self.length is None else \
                torch.full_like(n, self.length)
        else:
            pcv = self.children[1].emit(ctx)
            pos, valid = pcv.data.to(torch.int64), valid & pcv.validity
            ln = None
            if len(self.children) > 2:
                lcv = self.children[2].emit(ctx)
                ln, valid = lcv.data.to(torch.int64), valid & lcv.validity
        st = torch.where(pos > 0, pos - 1,
                         torch.where(pos < 0, n + pos, torch.zeros_like(n)))
        if ln is None:
            en = n
        else:
            en = torch.where(ln < 0, st, st + ln.clamp(max=1 << 40))
        st, en = st.clamp(min=0)[:, None], en.clamp(min=0)[:, None]
        pos_w = torch.arange(w, device=dev)[None, :]
        inside = pos_w < c.data[:, None]
        # the kept bytes are one run, since char_idx never decreases:
        # gather it to the front of the row
        first = (inside & (char_idx < st)).sum(dim=1, keepdim=True)
        new_len = (inside & (char_idx >= st) & (char_idx < en)).sum(dim=1)
        src = (first + pos_w).clamp(max=w - 1)
        out = torch.where(pos_w < new_len[:, None],
                          torch.gather(c.chars, 1, src),
                          torch.zeros((), dtype=torch.uint8, device=dev))
        return ColVal(new_len.to(torch.int32), valid, out)


# ---------------------------------------------------------------------------
# Case conversion (ASCII only; incompatibleOps)
# ---------------------------------------------------------------------------

class _CaseConvert(StringExpression):
    _lo: int
    _hi: int
    _delta: int

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def name(self) -> str:
        return f"{type(self).__name__.lower()}({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        b = c.chars
        conv = (b >= self._lo) & (b <= self._hi)
        return ColVal(c.data, c.validity,
                      torch.where(conv, b + self._delta, b).to(torch.uint8))


class Upper(_CaseConvert):
    """ASCII upper case."""
    _lo, _hi, _delta = 0x61, 0x7A, -32


class Lower(_CaseConvert):
    """ASCII lower case."""
    _lo, _hi, _delta = 0x41, 0x5A, 32


class InitCap(StringExpression):
    """The first character of each space-delimited word upper-cased, the
    rest lower-cased (ASCII only)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def name(self) -> str:
        return f"initcap({self.children[0].name})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        b = c.chars
        lower = torch.where((b >= 0x41) & (b <= 0x5A), b + 32, b)
        prev = torch.nn.functional.pad(b, (1, 0))[:, :-1]
        word_start = (torch.arange(b.shape[1], device=b.device)[None, :]
                      == 0) | (prev == 0x20)
        upper = torch.where((lower >= 0x61) & (lower <= 0x7A), lower - 32,
                            lower)
        out = torch.where(word_start, upper, lower)
        out = torch.where(_in_len(b, c.data), out, torch.zeros_like(out))
        return ColVal(c.data, c.validity, out.to(torch.uint8))


# ---------------------------------------------------------------------------
# Concat and concat_ws
# ---------------------------------------------------------------------------

def _concat2(a: ColVal, b: ColVal) -> ColVal:
    """Row-wise a || b at width ``bucket_capacity(wa + wb)``; null when
    either is."""
    wa, wb = a.chars.shape[1], b.chars.shape[1]
    w = bucket_capacity(wa + wb)
    dev = a.chars.device
    idx = torch.arange(w, device=dev)[None, :].expand(a.data.shape[0], w)
    la = a.data[:, None].to(torch.int64)
    lb = b.data[:, None].to(torch.int64)
    av = torch.gather(a.chars, 1, idx.clamp(0, wa - 1))
    bv = torch.gather(b.chars.expand(a.data.shape[0], wb), 1,
                      (idx - la).clamp(0, wb - 1))
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    out = torch.where(idx < la, av, torch.where(idx < la + lb, bv, zero))
    return ColVal((a.data + b.data).to(torch.int32),
                  a.validity & b.validity, out)


class Concat(StringExpression):
    """concat(...): null when any input is null; no input gives ''."""

    def __init__(self, *children: Expression):
        if len(children) == 1 and isinstance(children[0], (list, tuple)):
            children = tuple(children[0])
        self.children = tuple(children)

    def with_children(self, children):
        return Concat(*children)

    def coerce(self) -> Expression:
        from spark_rapids_tpu_torch.exprs.cast import cast_to
        return Concat(*[cast_to(c, STRING) for c in self.children])

    @property
    def name(self) -> str:
        return "concat(" + ", ".join(c.name for c in self.children) + ")"

    def emit(self, ctx: EvalContext) -> ColVal:
        vals = [c.emit(ctx) for c in self.children]
        if not vals:
            cap, dev = ctx.capacity, ctx.device
            return ColVal(torch.zeros(cap, dtype=torch.int32, device=dev),
                          torch.ones(cap, dtype=torch.bool, device=dev),
                          torch.zeros((cap, 8), dtype=torch.uint8,
                                      device=dev))
        acc = vals[0]
        for v in vals[1:]:
            acc = _concat2(acc, v)
        return acc


class ConcatWs(StringExpression):
    """concat_ws(sep, ...): null inputs are skipped; null only when the
    literal separator is null."""

    def __init__(self, sep: Expression, *children: Expression):
        self.children = (sep,) + tuple(children)
        self.sep_static, self.sep = _static_pattern(sep)

    def with_children(self, children):
        return ConcatWs(children[0], *children[1:])

    def coerce(self) -> Expression:
        _literal_only(self, "sep")
        return self

    @property
    def nullable(self) -> bool:
        return self.sep is None

    @property
    def name(self) -> str:
        return ("concat_ws("
                + ", ".join(c.name for c in self.children) + ")")

    def key(self) -> str:
        return (f"ConcatWs[{self.sep!r}]("
                + ",".join(c.key() for c in self.children[1:]) + ")")

    def emit(self, ctx: EvalContext) -> ColVal:
        cap, dev = ctx.capacity, ctx.device
        if self.sep is None:
            return _null_string(cap, dev)
        sep = self.sep
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        acc = ColVal(torch.zeros(cap, dtype=torch.int32, device=dev), ones,
                     torch.zeros((cap, 8), dtype=torch.uint8, device=dev))
        has = torch.zeros(cap, dtype=torch.bool, device=dev)
        sep_row = _pattern(sep, dev)[None, :] if sep else None
        for v in (c.emit(ctx) for c in self.children[1:]):
            # acc + sep + v, the separator only once acc has a piece
            with_sep = acc
            if sep_row is not None:
                with_sep = _concat2(acc, ColVal(
                    torch.where(has, len(sep), 0).to(torch.int32), ones,
                    sep_row.expand(cap, len(sep))))
            joined = _concat2(with_sep, ColVal(v.data, ones, v.chars))
            w_new = joined.chars.shape[1]
            pad_acc = torch.nn.functional.pad(
                acc.chars, (0, w_new - acc.chars.shape[1]))
            skip = ~v.validity
            acc = ColVal(torch.where(skip, acc.data, joined.data), ones,
                         torch.where(skip[:, None], pad_acc, joined.chars))
            has = has | v.validity
        return acc


# ---------------------------------------------------------------------------
# LIKE and RLIKE: one NFA over decoded code points
# ---------------------------------------------------------------------------

def _parse_like(pattern: str, escape: str) -> List[Tuple[str, int]]:
    """Pattern -> tokens ('lit', cp) | ('any1', 0) | ('many', 0).  The
    escape character makes the next one literal; it may precede only
    ``_``, ``%`` or itself, and a dangling escape is an error (Spark)."""
    toks: List[Tuple[str, int]] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape:
            if i + 1 >= len(pattern):
                raise ValueError(f"LIKE pattern ends with escape: {pattern!r}")
            nxt = pattern[i + 1]
            if nxt not in ("_", "%", escape):
                raise ValueError(
                    f"the escape character is not allowed to precede "
                    f"{nxt!r} in LIKE pattern {pattern!r}")
            toks.append(("lit", ord(nxt)))
            i += 2
        elif ch == "%":
            toks.append(("many", 0))
            i += 1
        elif ch == "_":
            toks.append(("any1", 0))
            i += 1
        else:
            toks.append(("lit", ord(ch)))
            i += 1
    return toks


def _segments(toks: List[Tuple[str, int]]):
    """A token list of literals and '%' only -> (anchored at the start,
    the literal runs as UTF-8 bytes, anchored at the end); None when it
    holds a single-character wildcard."""
    if any(k == "any1" for k, _ in toks):
        return None
    segs, cur = [], []
    for k, cp in toks:
        if k == "lit":
            cur.append(chr(cp))
        elif cur:
            segs.append("".join(cur).encode("utf-8"))
            cur = []
    if cur:
        segs.append("".join(cur).encode("utf-8"))
    return (bool(toks) and toks[0][0] == "lit", segs,
            bool(toks) and toks[-1][0] == "lit")


def _segment_match(c: ColVal, start_anchor: bool, segs: List[bytes],
                   end_anchor: bool) -> torch.Tensor:
    """Whether each row matches L0 % L1 % ... % Lk: each literal run
    found at its leftmost place after the one before (the first pinned
    to the start, the last to the end when anchored).  A UTF-8 literal
    can only match at a character's first byte, so bytes compare as
    characters do; this gives the NFA's answer with a search per run
    instead of a step per character."""
    lengths = c.data.to(torch.int64)
    cap, w = c.chars.shape
    dev = c.chars.device
    if not segs:  # '%' matches everything
        return torch.ones(cap, dtype=torch.bool, device=dev)
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    pos = torch.zeros(cap, dtype=torch.int64, device=dev)
    idx = torch.arange(w, device=dev)[None, :]
    last = len(segs) - 1
    for i, seg in enumerate(segs):
        k = len(seg)
        if k > w:
            return torch.zeros(cap, dtype=torch.bool, device=dev)
        pat = _pattern(seg, dev)
        if i == 0 and start_anchor:
            ok &= (lengths >= k) & (c.chars[:, :k] == pat[None, :]).all(1)
            if i == last and end_anchor:
                ok &= lengths == k
            pos = torch.full_like(pos, k)
            continue
        if i == last and end_anchor:
            st = lengths - k
            g = torch.gather(c.chars, 1, (st[:, None] + torch.arange(
                k, device=dev)[None, :]).clamp(0, w - 1))
            ok &= (st >= pos) & (g == pat[None, :]).all(1)
            continue
        m = _match_windows(c.chars, c.data, seg) & (idx >= pos[:, None])
        first = torch.where(m, idx, torch.full_like(idx, w)).amin(dim=1)
        ok &= first < w
        pos = first + k
    return ok


def _like_match(c: ColVal, toks: List[Tuple[str, int]]) -> torch.Tensor:
    """LIKE and RLIKE's matcher: ``_segment_match`` for a pattern of
    literals and '%', else ``_nfa_match``."""
    if not toks:  # '' matches the empty string only
        return c.data == 0
    plan = _segments(toks)
    if plan is None:
        return _nfa_match(c, toks)
    return _segment_match(c, *plan)


def _nfa_match(c: ColVal, toks: List[Tuple[str, int]]) -> torch.Tensor:
    """Whether each row's whole string matches the token list: a state
    vector of (capacity, tokens + 1) booleans advanced one decoded code
    point a step, as the JAX package's ``lax.scan`` does.  Exact in
    characters for multi-byte UTF-8."""
    m = len(toks)
    codes, n_chars = _decode_codepoints(c.chars, c.data)
    cap, w = codes.shape
    dev = codes.device
    lit_cp = torch.tensor([cp if k == "lit" else -2 for k, cp in toks],
                          dtype=torch.int32, device=dev)
    any1 = torch.tensor([k == "any1" for k, _ in toks], dtype=torch.bool,
                        device=dev)
    many = torch.tensor([k == "many" for k, _ in toks], dtype=torch.bool,
                        device=dev)
    many_at = [j for j, (k, _) in enumerate(toks) if k == "many"]

    def closure(dp):
        # a '%' may match nothing: its state passes on, in token order
        for j in many_at:
            dp[:, j + 1] |= dp[:, j]
        return dp

    dp = torch.zeros((cap, m + 1), dtype=torch.bool, device=dev)
    dp[:, 0] = True
    dp = closure(dp)
    for i in range(w):
        code = codes[:, i]
        step = (code[:, None] == lit_cp[None, :]) | any1[None, :]
        nd = torch.zeros_like(dp)
        nd[:, 1:] = dp[:, :-1] & step & ~many[None, :]
        # a '%' consumes the character by staying where it is
        nd[:, :-1] |= dp[:, :-1] & many[None, :]
        nd = closure(nd)
        dp = torch.where((i < n_chars)[:, None], nd, dp)
    return dp[:, m]


class Like(Expression):
    """SQL LIKE with a literal pattern (default escape ``\\``), matched
    by ``_nfa_match``.  A null pattern gives null."""

    def __init__(self, left: Expression, pattern: Expression,
                 escape: str = "\\"):
        self.children = (left, pattern)
        self.escape = escape
        self.tokens = None
        self.pattern_static, pb = _static_pattern(pattern)
        if pb is not None:
            self.tokens = _parse_like(pb.decode("utf-8"), escape)

    def with_children(self, children):
        return Like(children[0], children[1], self.escape)

    def coerce(self) -> Expression:
        _literal_only(self, "pattern")
        return self

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.children[0].name} LIKE {self.children[1].name})"

    def key(self) -> str:
        return (f"Like[{self.escape!r}]({self.children[0].key()},"
                f"{self.children[1].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if self.tokens is None:
            return _null_bool(ctx.capacity, ctx.device)
        return fixed(_like_match(c, self.tokens), c.validity)


_REGEX_META = set("\\^$.|?*+()[]{}")


def _parse_regex_lite(pattern: str) -> Optional[List[Tuple[str, int]]]:
    """The anchored-wildcard regex subset as LIKE tokens: literal
    characters, escaped metacharacters, ``.`` (any1), ``.*`` (many),
    ``.+`` (any1, many), and ``^``/``$`` anchors (an unanchored end gets
    a ``many``, as ``Matcher.find`` does).  None for anything else:
    alternation, classes, bounded repeats, groups, class escapes."""
    n = len(pattern)
    i = 1 if pattern.startswith("^") else 0
    end_anchor = (n > i and pattern.endswith("$")
                  and not pattern.endswith("\\$"))
    end = n - 1 if end_anchor else n
    toks: List[Tuple[str, int]] = []
    if i == 0:
        toks.append(("many", 0))
    while i < end:
        ch = pattern[i]
        nxt = pattern[i + 1] if i + 1 < end else ""
        if ch == "\\":
            if nxt not in _REGEX_META:
                return None
            if i + 2 < end and pattern[i + 2] in "*+?{":
                return None
            toks.append(("lit", ord(nxt)))
            i += 2
        elif ch == ".":
            if nxt == "*":
                toks.append(("many", 0))
                i += 2
            elif nxt == "+":
                toks += [("any1", 0), ("many", 0)]
                i += 2
            elif nxt == "?":
                return None
            else:
                toks.append(("any1", 0))
                i += 1
        elif ch in _REGEX_META:
            return None
        else:
            if nxt and nxt in "*+?{":
                return None
            toks.append(("lit", ord(ch)))
            i += 1
    if not end_anchor:
        toks.append(("many", 0))
    return toks


class RLike(Expression):
    """SQL RLIKE over the regex subset of ``_parse_regex_lite``.  A
    pattern outside it, or a non-literal one, raises at planning: the
    JAX package runs those on its CPU engine, which the port has not."""

    def __init__(self, left: Expression, pattern: Expression):
        self.children = (left, pattern)
        self.tokens: Optional[List[Tuple[str, int]]] = None
        self.pattern_static, pb = _static_pattern(pattern)
        self.outside = False
        if pb is not None:
            self.tokens = _parse_regex_lite(pb.decode("utf-8"))
            self.outside = self.tokens is None

    def with_children(self, children):
        return RLike(children[0], children[1])

    def coerce(self) -> Expression:
        _literal_only(self, "pattern")
        if self.outside:
            raise NotImplementedError(
                f"RLIKE {self.children[1].name}: a regex outside the device "
                "subset (literals, '.', '.*', '.+', anchors) needs a CPU "
                "engine, which the torch port has not")
        return self

    @property
    def dtype(self) -> DataType:
        return BOOLEAN

    @property
    def name(self) -> str:
        return f"({self.children[0].name} RLIKE {self.children[1].name})"

    def key(self) -> str:
        return f"RLike({self.children[0].key()},{self.children[1].key()})"

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if self.tokens is None:
            return _null_bool(ctx.capacity, ctx.device)
        return fixed(_like_match(c, self.tokens), c.validity)


# ---------------------------------------------------------------------------
# Matches of a literal, left to right
# ---------------------------------------------------------------------------

def _match_windows(chars: torch.Tensor, lengths: torch.Tensor,
                   pat: bytes) -> torch.Tensor:
    """(capacity, width) mask: a whole ``pat`` starts at this byte."""
    cap, w = chars.shape
    k = len(pat)
    if k == 0 or k > w:
        return torch.zeros((cap, w), dtype=torch.bool, device=chars.device)
    npos = w - k + 1
    acc = chars[:, 0:npos] == pat[0]
    for j in range(1, k):
        acc &= chars[:, j:j + npos] == pat[j]
    acc &= torch.arange(npos, device=chars.device)[None, :] + k \
        <= lengths[:, None]
    return torch.nn.functional.pad(acc, (0, w - npos))


def _overlaps(pat: bytes) -> bool:
    """Whether two matches of ``pat`` can overlap: only when a proper
    prefix of it is also a suffix."""
    return any(pat[:i] == pat[-i:] for i in range(1, len(pat)))


def _greedy_select(matches: torch.Tensor, pat: bytes) -> torch.Tensor:
    """The non-overlapping matches taken left to right (the scan order
    of UTF8String.replace): a byte-by-byte pass with each row's next
    free position, as the JAX package's ``lax.scan``; every match when
    two of ``pat`` cannot overlap."""
    k = len(pat)
    if not _overlaps(pat):
        return matches
    cap, w = matches.shape
    next_free = torch.zeros(cap, dtype=torch.int64, device=matches.device)
    sel = torch.zeros_like(matches)
    for j in range(w):
        take = matches[:, j] & (next_free <= j)
        sel[:, j] = take
        next_free = torch.where(take, j + k, next_free)
    return sel


def _covered(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Bytes inside a selected match of length ``k``."""
    w = sel.shape[1]
    started = torch.cumsum(sel.to(torch.int32), dim=1)
    ended = torch.cumsum(torch.nn.functional.pad(sel, (k, 0))[:, :w]
                         .to(torch.int32), dim=1)
    return started - ended > 0


class SplitPart(StringExpression):
    """split_part(str, delim, partNum): the partNum-th piece of the split
    on a literal delimiter (1-based, negative from the end, '' out of
    range; an empty delimiter leaves the string whole).  partNum must be
    a non-zero literal."""

    def __init__(self, child: Expression, delim: Expression,
                 part: Expression):
        self.children = (child, delim, part)
        self.delim_static, self.delim = _static_pattern(delim)
        self.part_static, self.part = _int_literal(part)

    def with_children(self, children):
        return SplitPart(*children)

    def coerce(self) -> Expression:
        _literal_only(self, "delim", "part")
        if self.part == 0:
            raise NotImplementedError(
                "split_part: partNum 0 is an error in Spark, which the "
                "JAX package leaves to its CPU engine")
        return self

    @property
    def name(self) -> str:
        return f"split_part({self.children[0].name})"

    def key(self) -> str:
        return (f"SplitPart[{self.delim!r},{self.part}]"
                f"({self.children[0].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        cap = ctx.capacity
        if self.delim is None or self.part is None:
            return _null_string(cap, ctx.device, c.chars.shape[1])
        k, part = len(self.delim), self.part
        w = c.chars.shape[1]
        if k == 0:
            if part in (1, -1):
                return c
            return ColVal(torch.zeros_like(c.data), c.validity,
                          torch.zeros_like(c.chars))
        sel = _greedy_select(_match_windows(c.chars, c.data, self.delim),
                             self.delim)
        part_id = torch.cumsum(torch.nn.functional.pad(sel, (k, 0))[:, :w]
                               .to(torch.int32), dim=1)
        n_parts = sel.sum(dim=1).to(torch.int32) + 1
        target = torch.full_like(n_parts, part - 1) if part > 0 \
            else n_parts + part
        keep = _in_len(c.chars, c.data) & ~_covered(sel, k) \
            & (part_id == target[:, None])
        out, new_len = _compact_left(c.chars, keep)
        return ColVal(new_len, c.validity, out)


# ---------------------------------------------------------------------------
# Trim
# ---------------------------------------------------------------------------

class _TrimBase(StringExpression):
    """Strip any of the trim characters (default space) from one or both
    ends.  The trim characters must be an ASCII literal: matching bytes
    inside a multi-byte character would break it, so the JAX package
    sends other ones to its CPU engine and the port raises."""

    mode = "both"

    def __init__(self, child: Expression,
                 trim_str: Optional[Expression] = None):
        self.children = (child,) + (() if trim_str is None else (trim_str,))
        self.trim_static, self.trim_bytes = True, b" "
        if trim_str is not None:
            self.trim_static, self.trim_bytes = _static_pattern(trim_str)

    def with_children(self, children):
        return type(self)(children[0],
                          children[1] if len(children) > 1 else None)

    def coerce(self) -> Expression:
        _literal_only(self, "trim")
        if self.trim_bytes is not None and any(b >= 0x80
                                               for b in self.trim_bytes):
            raise NotImplementedError(
                f"{type(self).__name__}: non-ASCII trim characters need a "
                "CPU engine, which the torch port has not")
        return self

    @property
    def name(self) -> str:
        return f"{type(self).__name__.lower()}({self.children[0].name})"

    def key(self) -> str:
        return (f"{type(self).__name__}[{self.trim_bytes!r}]"
                f"({self.children[0].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        if self.trim_bytes is None:
            return _null_string(ctx.capacity, ctx.device, c.chars.shape[1])
        in_len = _in_len(c.chars, c.data)
        is_trim = torch.zeros_like(in_len)
        for tb in set(self.trim_bytes):
            is_trim |= c.chars == tb
        anchor = (in_len & ~is_trim).to(torch.int32)
        keep = in_len
        if self.mode in ("both", "left"):
            keep = keep & (torch.cumsum(anchor, dim=1) > 0)
        if self.mode in ("both", "right"):
            keep = keep & (torch.cumsum(anchor.flip(1), dim=1).flip(1) > 0)
        out, new_len = _compact_left(c.chars, keep)
        return ColVal(new_len, c.validity, out)


class StringTrim(_TrimBase):
    mode = "both"


class StringTrimLeft(_TrimBase):
    mode = "left"


class StringTrimRight(_TrimBase):
    mode = "right"


# ---------------------------------------------------------------------------
# Locate, replace, substring_index, regexp_replace
# ---------------------------------------------------------------------------

class StringLocate(Expression):
    """locate(substr, str, start): the 1-based character position of the
    first occurrence at or after ``start``, 0 when absent, ``start`` for
    an empty substr (UTF8String.indexOf); substr and start literal."""

    def __init__(self, substr: Expression, child: Expression,
                 start: Expression):
        self.children = (substr, child, start)
        self.substr_static, self.pat = _static_pattern(substr)
        self.start_static, self.start = _int_literal(start)

    def with_children(self, children):
        return StringLocate(*children)

    def coerce(self) -> Expression:
        _literal_only(self, "substr", "start")
        return self

    @property
    def dtype(self) -> DataType:
        return INT32

    @property
    def name(self) -> str:
        return (f"locate({self.children[0].name}, "
                f"{self.children[1].name}, {self.start})")

    def key(self) -> str:
        return (f"StringLocate[{self.pat!r},{self.start}]"
                f"({self.children[1].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[1].emit(ctx)
        cap, dev = ctx.capacity, ctx.device
        if self.pat is None or self.start is None:
            return fixed(torch.zeros(cap, dtype=torch.int32, device=dev),
                         torch.zeros(cap, dtype=torch.bool, device=dev))
        start, k, w = self.start, len(self.pat), c.chars.shape[1]
        if start < 1 or k > w:
            return fixed(torch.zeros(cap, dtype=torch.int32, device=dev),
                         c.validity)
        if k == 0:
            return fixed(torch.full((cap,), start, dtype=torch.int32,
                                    device=dev), c.validity)
        m = _match_windows(c.chars, c.data, self.pat)
        starts = _char_starts(c.chars, c.data)
        char_idx = torch.cumsum(starts.to(torch.int64), dim=1) - 1
        hit = m & starts & (char_idx >= start - 1)
        first = torch.where(hit, char_idx,
                            torch.full_like(char_idx, w + 1)).amin(dim=1)
        return fixed(torch.where(first <= w, first + 1,
                                 torch.zeros_like(first)).to(torch.int32),
                     c.validity)


class StringReplace(StringExpression):
    """replace(str, search, rep) with literal search and rep: every
    non-overlapping occurrence, left to right; an empty search leaves
    the string as it is (UTF8String.replace)."""

    def __init__(self, child: Expression, search: Expression,
                 rep: Expression):
        self.children = (child, search, rep)
        self.search_static, self.search = _static_pattern(search)
        self.rep_static, self.rep = _static_pattern(rep)

    def with_children(self, children):
        return StringReplace(*children)

    def coerce(self) -> Expression:
        _literal_only(self, "search", "rep")
        return self

    @property
    def name(self) -> str:
        return f"replace({self.children[0].name})"

    def key(self) -> str:
        return (f"StringReplace[{self.search!r}->{self.rep!r}]"
                f"({self.children[0].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        cap, dev = ctx.capacity, ctx.device
        if self.search is None or self.rep is None:
            return _null_string(cap, dev, c.chars.shape[1])
        k = len(self.search)
        if k == 0:
            return c
        sel = _greedy_select(_match_windows(c.chars, c.data, self.search),
                             self.search)
        if len(self.rep) == k:
            return _replace_in_place(c, sel, self.rep)
        return _replace_spread(c, sel, k, self.rep)


def _replace_in_place(c: ColVal, sel: torch.Tensor, rep: bytes) -> ColVal:
    """Each selected match's bytes overwritten by ``rep``, as long as the
    search: the lengths and the width stay."""
    out, w = c.chars, c.chars.shape[1]
    for i, rb in enumerate(rep):
        at = torch.nn.functional.pad(sel, (i, 0))[:, :w]
        out = torch.where(at, torch.full_like(out, rb), out)
    return ColVal(c.data, c.validity, out)


def _replace_spread(c: ColVal, sel: torch.Tensor, k: int,
                    rep: bytes) -> ColVal:
    """Each selected match of a ``k``-byte search replaced by ``rep`` of
    any length: every kept byte and every replacement byte scattered to
    its offset in the output row."""
    (cap, w), dev, r = c.chars.shape, c.chars.device, len(rep)
    in_len = _in_len(c.chars, c.data)
    copy = in_len & ~_covered(sel, k)
    # output bytes each input position contributes
    delta = torch.where(sel, r, copy.to(torch.int64))
    out_w = w if r <= k else bucket_capacity((w // k) * r + w)
    off = torch.cumsum(delta, dim=1) - delta
    new_len = delta.sum(dim=1).to(torch.int32)
    out = torch.zeros((cap, out_w + 1), dtype=torch.uint8, device=dev)
    drop = torch.full_like(off, out_w)
    out.scatter_(1, torch.where(copy, off, drop),
                 torch.where(copy, c.chars, torch.zeros_like(c.chars)))
    for i, rb in enumerate(rep):
        out.scatter_(1, torch.where(sel, off + i, drop),
                     torch.where(sel, rb, 0).to(torch.uint8))
    return ColVal(new_len, c.validity, out[:, :out_w].contiguous())


class SubstringIndex(StringExpression):
    """substring_index(str, delim, count): what comes before the
    count-th delimiter from the left (count > 0) or after it from the
    right (count < 0); the whole string when there are fewer; '' for a
    count of 0 or an empty delimiter.  Occurrences may overlap, as
    UTF8String.subStringIndex steps one byte a match."""

    def __init__(self, child: Expression, delim: Expression,
                 count: Expression):
        self.children = (child, delim, count)
        self.delim_static, self.delim = _static_pattern(delim)
        self.count_static, self.count = _int_literal(count)

    def with_children(self, children):
        return SubstringIndex(*children)

    def coerce(self) -> Expression:
        _literal_only(self, "delim", "count")
        return self

    @property
    def name(self) -> str:
        return f"substring_index({self.children[0].name})"

    def key(self) -> str:
        return (f"SubstringIndex[{self.delim!r},{self.count}]"
                f"({self.children[0].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        c = self.children[0].emit(ctx)
        cap = ctx.capacity
        if self.delim is None or self.count is None:
            return _null_string(cap, ctx.device, c.chars.shape[1])
        n, k, w = self.count, len(self.delim), c.chars.shape[1]
        if n == 0 or k == 0:
            return ColVal(torch.zeros_like(c.data), c.validity,
                          torch.zeros_like(c.chars))
        sel = _match_windows(c.chars, c.data, self.delim)
        pos = torch.arange(w, device=c.chars.device)[None, :]
        if n > 0:
            rank = torch.cumsum(sel.to(torch.int32), dim=1)
            nth = torch.where(sel & (rank == n), pos,
                              torch.full_like(pos, w)).amin(dim=1)
            keep = _in_len(c.chars, c.data) & (pos < nth[:, None])
        else:
            rank = torch.cumsum(sel.to(torch.int32).flip(1), dim=1).flip(1)
            nth = torch.where(sel & (rank == -n), pos,
                              torch.full_like(pos, -1)).amax(dim=1)
            start = torch.where(nth >= 0, nth + k, torch.zeros_like(nth))
            keep = _in_len(c.chars, c.data) & (pos >= start[:, None])
        out, new_len = _compact_left(c.chars, keep)
        return ColVal(new_len, c.validity, out)


class RegExpReplace(StringExpression):
    """regexp_replace with a literal pattern free of regex
    metacharacters and a literal replacement free of ``$`` and ``\\``:
    a plain replace, as the JAX package runs it on its device.  Any
    other pattern raises at planning (the JAX package's CPU engine
    runs it)."""

    def __init__(self, child: Expression, pattern: Expression,
                 rep: Expression):
        self.children = (child, pattern, rep)
        self.pattern_static, pat = _static_pattern(pattern)
        self.rep_static, rep_b = _static_pattern(rep)
        self.pattern_text = None if pat is None else pat.decode("utf-8")
        self.rep_text = None if rep_b is None else rep_b.decode("utf-8")

    def with_children(self, children):
        return RegExpReplace(*children)

    def coerce(self) -> Expression:
        _literal_only(self, "pattern", "rep")
        why = None
        if self.pattern_text is not None and any(
                ch in _REGEX_META for ch in self.pattern_text):
            why = "regex metacharacters"
        elif self.pattern_text == "":
            why = "an empty pattern"
        elif self.rep_text is not None and ("$" in self.rep_text
                                            or "\\" in self.rep_text):
            why = "group references or escapes in the replacement"
        if why is not None:
            raise NotImplementedError(
                f"regexp_replace: {why} need a CPU engine, which the "
                "torch port has not")
        return self

    @property
    def name(self) -> str:
        return f"regexp_replace({self.children[0].name})"

    def key(self) -> str:
        return (f"RegExpReplace[{self.pattern_text!r}->{self.rep_text!r}]"
                f"({self.children[0].key()})")

    def emit(self, ctx: EvalContext) -> ColVal:
        if self.pattern_text is None or self.rep_text is None:
            c = self.children[0].emit(ctx)
            return _null_string(ctx.capacity, ctx.device, c.chars.shape[1])
        return StringReplace(self.children[0], Literal(self.pattern_text),
                             Literal(self.rep_text)).emit(ctx)
