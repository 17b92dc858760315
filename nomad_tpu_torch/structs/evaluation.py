"""Evaluation (reference ``nomad_tpu/structs/evaluation.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from . import enums


@dataclass(slots=True)
class Evaluation:
    """A request to (re)schedule a job: the unit of scheduler work."""

    id: str = ""
    namespace: str = "default"
    priority: int = 50
    type: str = enums.JOB_TYPE_SERVICE
    triggered_by: str = enums.TRIGGER_JOB_REGISTER
    job_id: str = ""
    node_id: str = ""
    status: str = enums.EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until: float = 0.0              # delayed evals (the broker's heap)
    previous_eval: str = ""
    blocked_eval: str = ""
    # blocked evals: computed class -> eligible (core/blocked.py); the
    # schedulers leave it empty, so a blocked eval unblocks on any node
    class_eligibility: Dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    failed_tg_allocs: Dict[str, object] = field(default_factory=dict)
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0
    create_time: float = 0.0
    modify_time: float = 0.0
    # lifecycle trace id (obs/trace.py); empty: the eval is its own trace
    trace_id: str = ""

    def trace(self) -> str:
        """The trace id of this eval's lifecycle spans."""
        return self.trace_id or self.id

    def should_enqueue(self) -> bool:
        return self.status == enums.EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == enums.EVAL_STATUS_BLOCKED

    def make_plan(self, job):
        from .plan import Plan

        return Plan(eval_id=self.id, priority=self.priority, job=job,
                    all_at_once=bool(job.all_at_once) if job is not None
                    else False)
