"""Per-evaluation context (reference ``nomad_tpu/scheduler/context.py``):
the state snapshot, the in-progress plan, parse caches, the
computed-class eligibility memo, the seeded node shuffle of the host
oracle and the placement metrics."""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..structs import AllocMetric, Job, Node, Plan, TaskGroup


class EvalEligibility:
    """Feasibility memoized per computed node class; constraints on
    node-unique targets escape the memo."""

    def __init__(self):
        self.job: Dict[str, bool] = {}
        self.tg: Dict[str, Dict[str, bool]] = {}
        self.job_escaped = False
        self.tg_escaped: Dict[str, bool] = {}

    def set_job(self, job: Job) -> None:
        from .feasible import is_class_escaped

        self.job_escaped = any(
            is_class_escaped(c.ltarget) or is_class_escaped(c.rtarget)
            for c in job.constraints)
        for tg in job.task_groups:
            constraints = list(tg.constraints)
            for t in tg.tasks:
                constraints.extend(t.constraints)
            self.tg_escaped[tg.name] = any(
                is_class_escaped(c.ltarget) or is_class_escaped(c.rtarget)
                for c in constraints)

    def job_status(self, klass: str) -> Optional[bool]:
        if self.job_escaped or not klass:
            return None
        return self.job.get(klass)

    def set_job_status(self, klass: str, eligible: bool) -> None:
        if not self.job_escaped and klass:
            self.job[klass] = eligible

    def tg_status(self, tg_name: str, klass: str) -> Optional[bool]:
        if self.tg_escaped.get(tg_name) or not klass:
            return None
        return self.tg.get(tg_name, {}).get(klass)

    def set_tg_status(self, tg_name: str, klass: str, eligible: bool) -> None:
        if not self.tg_escaped.get(tg_name) and klass:
            self.tg.setdefault(tg_name, {})[klass] = eligible


class EvalContext:
    def __init__(self, snapshot, plan: Optional[Plan] = None,
                 eval_id: str = ""):
        self.snapshot = snapshot
        self.plan = plan
        self.eval_id = eval_id
        self.regex_cache: dict = {}
        self.eligibility = EvalEligibility()
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

    def shuffled_nodes(self, nodes: List[Node], attempt: int = 0) -> List[Node]:
        """Deterministic shuffle seeded by eval id and retry attempt, so
        retries explore different prefixes."""
        rng = random.Random(f"{self.eval_id}:{attempt}")
        out = list(nodes)
        rng.shuffle(out)
        return out
