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
    status: str = enums.EVAL_STATUS_PENDING
    status_description: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    failed_tg_allocs: Dict[str, object] = field(default_factory=dict)
    queued_allocations: Dict[str, int] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def make_plan(self, job):
        from .plan import Plan

        return Plan(eval_id=self.id, priority=self.priority, job=job,
                    all_at_once=bool(job.all_at_once) if job is not None
                    else False)
