"""Job / TaskGroup / Task, trimmed to what the bulk path reads
(reference ``nomad_tpu/structs/job.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import enums
from .constraint import Affinity, Constraint, Spread
from .resources import NetworkResource, Resources


@dataclass(slots=True)
class ReschedulePolicy:
    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"
    max_delay_s: float = 3600.0
    unlimited: bool = True


@dataclass(slots=True)
class UpdateStrategy:
    """Rolling-update / deployment strategy. A fresh job version whose
    groups carry one opens a Deployment; canaries are not modelled yet
    and raise in the reconciler."""

    max_parallel: int = 1
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0


@dataclass(slots=True)
class MigrateStrategy:
    """Drain migration strategy; preemption reads its ``max_parallel``."""

    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass(slots=True)
class EphemeralDisk:
    size_mb: int = 300


@dataclass(slots=True)
class Task:
    name: str = "task"
    driver: str = "mock"
    config: Dict[str, object] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)


@dataclass(slots=True)
class TaskGroup:
    """A co-scheduled set of tasks; the unit of placement."""

    name: str = "group"
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    reschedule_policy: Optional[ReschedulePolicy] = None
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    networks: List[NetworkResource] = field(default_factory=list)
    volumes: Dict[str, object] = field(default_factory=dict)

    def combined_resources(self) -> Resources:
        """Sum of task asks plus the group ephemeral disk: what one
        allocation of this group consumes."""
        total = Resources(cpu=0, memory_mb=0,
                          disk_mb=float(self.ephemeral_disk.size_mb))
        for t in self.tasks:
            r = t.resources
            total.cpu += r.cpu
            total.memory_mb += r.memory_mb
            total.cores += r.cores
            total.networks.extend(r.networks)
            total.devices.extend(r.devices)
        total.networks.extend(self.networks)
        return total


@dataclass(slots=True)
class Job:
    id: str = ""
    name: str = ""
    namespace: str = "default"
    type: str = enums.JOB_TYPE_SERVICE
    priority: int = 50
    datacenters: List[str] = field(default_factory=lambda: ["dc1"])
    node_pool: str = enums.NODE_POOL_DEFAULT
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    all_at_once: bool = False
    stop: bool = False
    status: str = enums.JOB_STATUS_PENDING
    version: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop
