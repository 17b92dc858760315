"""Deployment and DeploymentState (reference
``nomad_tpu/structs/deployment.py``): the rollout record a fresh service
job version with an ``update`` stanza opens."""

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
