"""Job / TaskGroup / Task, trimmed to what the placement paths and the
reconciler read (reference ``nomad_tpu/structs/job.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import enums
from .constraint import Affinity, Constraint, Spread
from .resources import NetworkResource, Resources
from .volumes import VolumeMount, VolumeRequest


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
    """Rolling-update / deployment strategy: a job version whose groups
    carry one opens a Deployment, ``max_parallel`` paces destructive
    updates an eval, ``canary`` holds the old allocs until promotion."""

    max_parallel: int = 1
    min_healthy_time_s: float = 10.0
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
    migrate: bool = False


@dataclass(slots=True)
class Task:
    name: str = "task"
    driver: str = "mock"
    config: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    user: str = ""
    resources: Resources = field(default_factory=Resources)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    volume_mounts: List[VolumeMount] = field(default_factory=list)


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
    # group volume stanzas by name
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    # an alloc on a node that stops heartbeating goes "unknown" for this
    # long (with a replacement) before it is lost; None: lost at once
    max_client_disconnect_s: Optional[float] = None

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
