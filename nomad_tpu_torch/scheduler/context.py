"""Per-evaluation context (reference ``nomad_tpu/scheduler/context.py``):
the state snapshot, the in-progress plan, parse caches and the
placement metrics."""

from __future__ import annotations

from typing import List, Optional

from ..structs import AllocMetric, Plan, TaskGroup


class EvalContext:
    def __init__(self, snapshot, plan: Optional[Plan] = None,
                 eval_id: str = ""):
        self.snapshot = snapshot
        self.plan = plan
        self.eval_id = eval_id
        self.regex_cache: dict = {}
        self.metrics: Optional[AllocMetric] = None
        self._tg_res: dict = {}
        self._tg_vec: dict = {}

    def tg_resources(self, tg: TaskGroup):
        """Per-eval memo of tg.combined_resources()."""
        r = self._tg_res.get(id(tg))
        if r is None:
            r = self._tg_res[id(tg)] = tg.combined_resources()
        return r

    def tg_vec(self, tg: TaskGroup):
        v = self._tg_vec.get(id(tg))
        if v is None:
            v = self._tg_vec[id(tg)] = self.tg_resources(tg).vec()
        return v

    def new_metrics(self) -> AllocMetric:
        self.metrics = AllocMetric()
        return self.metrics

    def proposed_allocs(self, node_id: str) -> List:
        """The node's allocs as they would be if the in-progress plan
        committed: state minus evictions plus placements."""
        existing = self.snapshot.allocs_by_node_terminal(node_id, False)
        if self.plan is None:
            return existing
        removed = {a.id for a in self.plan.node_update.get(node_id, ())}
        removed |= {a.id for a in self.plan.node_preemptions.get(node_id, ())}
        placed = self.plan.node_allocation.get(node_id, ())
        placed_ids = {a.id for a in placed}
        out = [a for a in existing
               if a.id not in removed and a.id not in placed_ids]
        out.extend(placed)
        return out
