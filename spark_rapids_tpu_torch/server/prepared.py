"""Prepared statements: SQL with ``?`` markers, parsed once a binding
type signature.

Counterpart of ``spark_rapids_tpu/server/prepared.py``.  The first
execution with a given signature (the types ``Literal`` infers from the
values: a float, an int32 or int64 by magnitude, a date, a string)
parses the SQL with each ``?`` a ``ParamLiteral`` and keeps the logical
plan as that signature's template; later executions copy the template
with the new values in its slots (``plan/fingerprint.bind_params``), a
fresh tree each time, so concurrent clients share one template.  A
binding of another signature parses a template of its own, so a type
change never reuses a plan made for another type.  NULL bindings are
refused (inline NULL in the template instead).  Views resolve when a
template is parsed: re-registering a view does not retarget a template
made before.  The JAX package's kernel sharing across bindings (its
hoisted literals) has no counterpart: the port keeps no compiled
kernels a plan.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Tuple

from spark_rapids_tpu_torch.exprs.base import Literal
from spark_rapids_tpu_torch.server import stats

# templates a statement keeps: one a binding type signature seen
_MAX_TEMPLATES = 8


class PreparedStatement:
    """What ``session.prepare`` and ``SessionServer.prepare`` return."""

    def __init__(self, session, sql: str):
        from spark_rapids_tpu_torch.sql import count_params
        self._session = session
        self.sql = sql
        self.num_params = count_params(sql)
        self._lock = threading.Lock()
        self._templates: "OrderedDict[Tuple[str, ...], object]" = \
            OrderedDict()
        stats.bump("prepared")

    @property
    def template_count(self) -> int:
        with self._lock:
            return len(self._templates)

    def _type_signature(self, params) -> Tuple[str, ...]:
        if len(params) != self.num_params:
            raise ValueError(f"statement has {self.num_params} "
                             f"parameter(s), {len(params)} value(s) bound")
        sig = []
        for v in params:
            if v is None:
                raise ValueError("NULL bindings are not supported: inline "
                                 "NULL in the template instead")
            # the inference the parser applies, so the signature and
            # the plan agree on each slot's type
            sig.append(Literal(v).dtype.name)
        return tuple(sig)

    def bind(self, *params, session=None):
        """A DataFrame for one binding; ``session`` is the session the
        plan runs under (the server passes its tenant's view)."""
        from spark_rapids_tpu_torch.api import DataFrame
        sess = session if session is not None else self._session
        sig = self._type_signature(params)
        with self._lock:
            template = self._templates.get(sig)
            if template is not None:
                self._templates.move_to_end(sig)
        stats.bump("prepared_execs")
        if template is None:
            from spark_rapids_tpu_torch.sql import parse_sql
            df = parse_sql(self.sql, sess, params=list(params))
            with self._lock:
                self._templates[sig] = df.plan
                self._templates.move_to_end(sig)
                while len(self._templates) > _MAX_TEMPLATES:
                    self._templates.popitem(last=False)
            return df
        from spark_rapids_tpu_torch.plan.fingerprint import bind_params
        return DataFrame(sess, bind_params(template, list(params)))

    def execute(self, *params):
        """Bind and run: the result as a ``HostResult``."""
        return self.bind(*params)._host()

    def __repr__(self):
        return f"PreparedStatement({self.sql!r}, params={self.num_params})"
