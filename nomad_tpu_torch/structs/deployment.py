"""Deployment and DeploymentState (reference
``nomad_tpu/structs/deployment.py``): the rollout record a service job
version with an ``update`` stanza opens, its canaries held until the
group is promoted."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from . import enums


@dataclass(slots=True)
class DeploymentState:
    """Per-task-group rollout state."""

    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: list = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 0.0
    require_progress_by: float = 0.0


@dataclass(slots=True)
class Deployment:
    """Tracks the rollout of one job version."""

    id: str = ""
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    task_groups: Dict[str, DeploymentState] = field(default_factory=dict)
    status: str = enums.DEPLOYMENT_STATUS_RUNNING
    status_description: str = "Deployment is running"
    eval_priority: int = 50
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in (enums.DEPLOYMENT_STATUS_RUNNING,
                               enums.DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        """A group still holds unpromoted canaries."""
        return any(s.desired_canaries > 0 and not s.promoted
                   for s in self.task_groups.values())

    def has_auto_promote(self) -> bool:
        """Every group holding canaries promotes itself, and one still
        waits for it."""
        if not self.active():
            return False
        return all(s.auto_promote for s in self.task_groups.values()
                   if s.desired_canaries > 0) and self.requires_promotion()
