"""Job / TaskGroup / Task, trimmed to what the placement paths, the
reconciler and the HTTP API read (reference ``nomad_tpu/structs/job.py``):
the jobspec's stanzas ride as data (``meta``, ``restart_policy``,
``services``, ``scaling``, ``parameterized``, a task's ``plugin``), and
``spec_diff`` is what a dry-run plan reports."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import enums
from .constraint import Affinity, Constraint, Spread
from .resources import NetworkResource, Resources
from .volumes import VolumeMount, VolumeRequest


@dataclass(slots=True)
class RestartPolicy:
    """Client-side restart policy (the client's task runner reads it)."""

    attempts: int = 2
    interval_s: float = 30 * 60.0
    delay_s: float = 15.0
    mode: str = "fail"  # fail | delay


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
    # the client's health watch gives up on an alloc after this long
    healthy_deadline_s: float = 300.0
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
    sticky: bool = False
    migrate: bool = False


@dataclass(slots=True)
class ScalingPolicy:
    """A group's scaling bounds: ``/v1/scaling/policies`` lists them and
    ``scale_job`` holds a count to them."""

    min: int = 0
    max: int = 0
    enabled: bool = True
    policy: Dict[str, object] = field(default_factory=dict)


@dataclass(slots=True)
class Service:
    """A group's or a task's service stanza: the client registers an
    instance of it while the alloc runs (``structs/services.py``)."""

    name: str = ""
    port_label: str = ""
    provider: str = "builtin"
    tags: List[str] = field(default_factory=list)
    checks: List[dict] = field(default_factory=list)


@dataclass(slots=True)
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


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
    leader: bool = False
    kill_timeout_s: float = 5.0
    meta: Dict[str, str] = field(default_factory=dict)
    # {"type": "volume" | "device", "id": ...}; None: no stanza
    plugin: Optional[Dict[str, str]] = None
    services: List[Service] = field(default_factory=list)
    lifecycle_hook: str = ""      # "" (main) | prestart | poststart | poststop
    lifecycle_sidecar: bool = False
    log_config: LogConfig = field(default_factory=LogConfig)


@dataclass(slots=True)
class TaskGroup:
    """A co-scheduled set of tasks; the unit of placement."""

    name: str = "group"
    count: int = 1
    tasks: List[Task] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
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
    # a client cut off from the servers this long stops the alloc itself
    stop_after_client_disconnect_s: Optional[float] = None
    services: List[Service] = field(default_factory=list)
    scaling: Optional[ScalingPolicy] = None
    meta: Dict[str, str] = field(default_factory=dict)

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
class ParameterizedJobConfig:
    payload: str = "optional"
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)


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
    stable: bool = False
    submit_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0
    meta: Dict[str, str] = field(default_factory=dict)
    # a template that never schedules (dispatch is not ported)
    parameterized: Optional[ParameterizedJobConfig] = None

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    @property
    def is_parameterized(self) -> bool:
        return self.parameterized is not None

    def stopped(self) -> bool:
        return self.stop


def spec_diff(old: Optional[Job], new: Job) -> Dict[str, object]:
    """The changed field paths of a job update, list elements labelled by
    their name or id where they have one (reference ``job.py:242``)."""
    if old is None:
        return {"type": "added", "fields": []}
    from .wire import wire_encode

    skip = {"version", "create_index", "modify_index", "job_modify_index",
            "submit_time", "status", "_avail_vec"}
    changed: List[str] = []

    def label(item, idx):
        if isinstance(item, dict) and "__f" in item:
            f = item["__f"]
            return f.get("name") or f.get("id") or str(idx)
        return str(idx)

    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            if "__f" in a and "__f" in b:
                a, b = a["__f"], b["__f"]
            for k in sorted(set(a) | set(b)):
                if k in skip:
                    continue
                sub = f"{path}.{k}" if path else k
                if k not in a or k not in b:
                    changed.append(sub)
                else:
                    walk(a[k], b[k], sub)
            return
        if isinstance(a, list) and isinstance(b, list):
            amap = {label(x, i): x for i, x in enumerate(a)}
            bmap = {label(x, i): x for i, x in enumerate(b)}
            for k in sorted(set(amap) | set(bmap)):
                sub = f"{path}[{k}]"
                if k not in amap or k not in bmap:
                    changed.append(sub)
                else:
                    walk(amap[k], bmap[k], sub)
            return
        if a != b:
            changed.append(path)

    walk(wire_encode(old), wire_encode(new), "")
    return {"type": "edited" if changed else "none", "fields": changed}
