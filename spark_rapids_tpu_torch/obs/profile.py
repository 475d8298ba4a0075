"""Query profiles: the executed plan tree with its measured metrics.

Counterpart of ``spark_rapids_tpu/obs/profile.py``.
``QueryProfile.from_plan`` walks the executed physical tree (the live
operators, so adaptive execution's evolved children show as they ran)
and takes a snapshot of every operator's metrics.  The port's metrics
are host ints, so the snapshot reads nothing from the card.

Three renderings share the walk:

* ``render()``: the ``df.explain(analyze=True)`` tree, one line an
  operator with rows, batches, wall time, self time and every other
  non-zero metric;
* ``to_dict()``: the same tree as plain dicts
  (``session.last_query_profile().to_dict()``);
* ``legacy_lines()``: the flat ``session.last_query_metrics()`` lines,
  in the JAX package's format byte for byte.

``totalTime`` is the host wall time of an operator's pulls (the pull
boundary in ``exec/base.py``), children's pulls included; self time is
its own minus its children's, clamped at 0, as in the JAX package.
Kernels on the card run asynchronously, so an operator's time holds
what the host waited for, not the card's time; no operator
synchronizes the card to make it exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class OperatorProfile:
    """One node of the executed plan: its identity and metrics."""

    __slots__ = ("name", "describe", "metrics", "children")

    def __init__(self, name: str, describe: str,
                 metrics: Dict[str, int],
                 children: List["OperatorProfile"]):
        self.name = name
        self.describe = describe
        self.metrics = metrics
        self.children = children

    @property
    def rows(self) -> int:
        return self.metrics.get("numOutputRows", 0)

    @property
    def batches(self) -> int:
        return self.metrics.get("numOutputBatches", 0)

    @property
    def time_ms(self) -> float:
        return self.metrics.get("totalTime", 0) / 1e6

    @property
    def self_time_ms(self) -> float:
        child_ns = sum(c.metrics.get("totalTime", 0)
                       for c in self.children)
        return max(0.0, (self.metrics.get("totalTime", 0)
                         - child_ns) / 1e6)


class QueryProfile:
    """The executed plan tree of one query with each operator's
    metrics."""

    def __init__(self, root: OperatorProfile,
                 query_id: Optional[int] = None,
                 wall_ms: Optional[float] = None,
                 placement: Optional[List[dict]] = None):
        self.root = root
        self.query_id = query_id
        self.wall_ms = wall_ms
        # the static placement decisions (plan/placement.py): none
        # under the default mode, so the renderings stay as they were
        self.placement = list(placement or [])

    @classmethod
    def from_plan(cls, physical, query_id: Optional[int] = None,
                  wall_ms: Optional[float] = None,
                  placement: Optional[List[dict]] = None
                  ) -> "QueryProfile":
        def walk(node) -> OperatorProfile:
            children = [walk(c) for c in node.children]
            return OperatorProfile(node.node_name, node.describe(),
                                   node.metrics.snapshot(), children)
        return cls(walk(physical), query_id=query_id, wall_ms=wall_ms,
                   placement=placement)

    _CORE = ("numOutputRows", "numOutputBatches", "totalTime")

    @staticmethod
    def _fmt(name: str, v) -> str:
        """One metric as ``name=value``; a name ending in ``time`` (ns)
        prints as ms."""
        if name.lower().endswith("time"):
            return f"{name}={v / 1e6:.1f}ms"
        return f"{name}={v}"

    def render(self) -> str:
        """The ``explain(analyze=True)`` text tree."""
        head = "== Executed plan"
        if self.query_id is not None:
            head += f" (query {self.query_id}"
            if self.wall_ms is not None:
                head += f", {self.wall_ms:.1f} ms"
            head += ")"
        head += " =="
        lines = [head]

        def walk(node: OperatorProfile, depth: int) -> None:
            parts = [f"rows={node.rows}", f"batches={node.batches}"]
            if node.metrics.get("totalTime", 0):
                parts.append(f"time={node.time_ms:.1f}ms")
                parts.append(f"self={node.self_time_ms:.1f}ms")
            for name, v in sorted(node.metrics.items()):
                if name in self._CORE or not v:
                    continue
                parts.append(self._fmt(name, v))
            lines.append("  " * depth + node.describe + ": "
                         + " ".join(parts))
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        for d in self.placement:
            lines.append(
                f"Placement: {d.get('fragment')} -> {d.get('engine')} "
                f"[{d.get('phase')}] tpu={d.get('tpu_ms')}ms "
                f"cpu={d.get('cpu_ms')}ms deciding={d.get('deciding')}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        def walk(node: OperatorProfile) -> dict:
            return {"name": node.name, "describe": node.describe,
                    "rows": node.rows, "batches": node.batches,
                    "time_ms": round(node.time_ms, 3),
                    "self_time_ms": round(node.self_time_ms, 3),
                    "metrics": {n: v for n, v in node.metrics.items()
                                if v},
                    "children": [walk(c) for c in node.children]}
        out = {"query_id": self.query_id, "wall_ms": self.wall_ms,
               "plan": walk(self.root)}
        if self.placement:
            out["placement"] = self.placement
        return out

    def legacy_lines(self) -> List[str]:
        """One line an operator, its non-zero metrics sorted by name,
        the ``*time`` names in ms."""
        lines: List[str] = []

        def walk(node: OperatorProfile, depth: int) -> None:
            parts = [self._fmt(name, v)
                     for name, v in sorted(node.metrics.items()) if v]
            lines.append("  " * depth + node.describe
                         + (": " + ", ".join(parts) if parts else ""))
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return lines
