"""Delta-merge refreshes for continuous queries.

Counterpart of ``spark_rapids_tpu/exec/incremental.py``.
``IncrementalState`` owns the maintained state of one standing query (or
one maintained result-cache entry) and turns an append micro-batch into
a refreshed result by running the plans ``plan/incremental.py`` built,
each through the normal engine (the caller's ``run(plan) ->
HostResult``, a server submission for a standing query):

* agg mode: aggregate only the delta into partial-state columns on the
  device, merge old and delta state with one group-by over their Union,
  and finalize back to the original output columns;
* append mode: run the plan over the delta leaf alone and append its
  rows to the maintained result.

The state and the result are ``HostResult``s (host numpy columns, no
Arrow).  Every refresh is cast to the bootstrap result's schema, so an
incremental refresh equals a full recompute value for value.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import concat_host_values
from spark_rapids_tpu_torch.plan import logical as lp


def cast_result(result, schema):
    """``result`` under ``schema``'s names and types (columns by
    position; a fixed-width column of another type converted)."""
    from spark_rapids_tpu_torch.api import HostResult
    cols = {}
    for f, g in zip(schema, result.schema):
        values, valid = result.columns[g.name]
        if f.dtype != g.dtype and f.dtype.numpy_dtype is not None:
            values = values.astype(f.dtype.numpy_dtype)
        cols[f.name] = (values, valid)
    return HostResult(schema, cols)


def concat_results(a, b):
    """``a``'s rows then ``b``'s, under ``a``'s schema."""
    from spark_rapids_tpu_torch.api import HostResult
    b = cast_result(b, a.schema)
    cols = {f.name: (concat_host_values([a.columns[f.name][0],
                                         b.columns[f.name][0]]),
                     np.concatenate([a.columns[f.name][1],
                                     b.columns[f.name][1]]))
            for f in a.schema}
    return HostResult(a.schema, cols)


Runner = Callable[[lp.LogicalPlan], object]


class IncrementalState:
    """Maintained state and result of one incrementalizable plan."""

    def __init__(self, rewrite):
        self.rewrite = rewrite          # IncrementalAggPlan | ...AppendPlan
        self.state = None               # agg mode only
        self.result = None
        self.refreshes = 0

    @property
    def state_bytes(self) -> int:
        return int(self.state.nbytes) if self.state is not None else 0

    def bootstrap(self, run: Runner,
                  base_leaf: Optional[lp.LogicalPlan] = None):
        """A full pass over the input (or ``base_leaf``, the stream leaf
        pinned to a committed file list): the initial state and the
        result whose schema later refreshes are cast to."""
        rw = self.rewrite
        if rw.kind == "agg":
            self.state = run(rw.state_plan() if base_leaf is None
                             else rw.delta_state_plan(base_leaf))
            result = run(rw.finalize_plan(self.state))
        else:
            result = run(rw.plan if base_leaf is None
                         else rw.delta_plan(base_leaf))
        self.result = result
        return result

    def apply_delta(self, run: Runner, delta_leaf: lp.LogicalPlan):
        """Fold one append micro-batch (a delta leaf relation) into the
        maintained result; the refreshed result."""
        if self.result is None:
            raise RuntimeError("apply_delta before bootstrap")
        rw = self.rewrite
        if rw.kind == "agg":
            delta_state = run(rw.delta_state_plan(delta_leaf))
            merged = run(rw.merge_plan([self.state, delta_state]))
            # the state's schema stays the bootstrap one
            self.state = cast_result(merged, self.state.schema)
            result = run(rw.finalize_plan(self.state))
        else:
            result = concat_results(self.result,
                                    run(rw.delta_plan(delta_leaf)))
        self.result = cast_result(result, self.result.schema)
        self.refreshes += 1
        return self.result
