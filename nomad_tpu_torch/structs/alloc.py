"""Allocation, AllocMetric and the columnar AllocBlock (reference
``nomad_tpu/structs/alloc.py``)."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import enums
from .resources import comparable


@dataclass(slots=True)
class TaskEvent:
    """One event of a task's lifecycle (reference
    ``structs/alloc.py:71-81``)."""

    type: str = ""
    time: float = 0.0
    message: str = ""
    details: Dict[str, str] = field(default_factory=dict)
    exit_code: Optional[int] = None
    restart_reason: str = ""


@dataclass(slots=True)
class TaskState:
    """Client-observed state of one task: pending, running or dead
    (reference ``structs/alloc.py:84-105``)."""

    state: str = "pending"
    failed: bool = False
    restarts: int = 0
    last_restart: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    events: List[TaskEvent] = field(default_factory=list)

    def successful(self) -> bool:
        return self.state == "dead" and not self.failed

    def copy(self) -> "TaskState":
        """A detached copy: the runner's thread keeps writing the live
        object, the store must hold one that does not move."""
        return TaskState(
            state=self.state, failed=self.failed, restarts=self.restarts,
            last_restart=self.last_restart, started_at=self.started_at,
            finished_at=self.finished_at, events=list(self.events))


@dataclass(slots=True)
class RescheduleEvent:
    reschedule_time: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""


@dataclass(slots=True)
class RescheduleTracker:
    """History of reschedule attempts, carried and extended through the
    chain of replacements (reference ``structs/alloc.py:23-28``)."""

    events: List[RescheduleEvent] = field(default_factory=list)


@dataclass(slots=True)
class DesiredTransition:
    """Server-requested transitions: the drainer's ``migrate`` and an
    alloc stop's ``reschedule`` (reference ``structs/alloc.py:31-40``)."""

    migrate: bool = False
    reschedule: bool = False
    force_reschedule: bool = False


@dataclass(slots=True)
class AllocMetric:
    """Why/how a placement was made."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_in_pool: int = 0
    constraint_filtered: Dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    dimension_exhausted: Dict[str, int] = field(default_factory=dict)
    scores: Dict[str, float] = field(default_factory=dict)
    allocation_time_s: float = 0.0
    coalesced_failures: int = 0

    def exhaust_node(self, dimension: str) -> None:
        self.nodes_exhausted += 1
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1)

    def filter_node(self, reason: str) -> None:
        self.nodes_filtered += 1
        if reason:
            self.constraint_filtered[reason] = (
                self.constraint_filtered.get(reason, 0) + 1)


@dataclass(slots=True)
class AllocatedPort:
    label: str = ""
    value: int = 0
    to: int = 0
    host_ip: str = ""


@dataclass(slots=True)
class Allocation:
    """A placement of a task group on a node. ``allocated_vec`` is the
    dense comparable resource total of the alloc."""

    id: str = ""
    eval_id: str = ""
    deployment_id: str = ""
    name: str = ""
    namespace: str = "default"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: object = None
    job_version: int = 0
    task_group: str = ""
    allocated_vec: np.ndarray = field(default_factory=lambda: comparable())
    # exact ports, device instances (group id -> instance ids) and cores
    allocated_ports: List[AllocatedPort] = field(default_factory=list)
    allocated_devices: Dict[str, List[str]] = field(default_factory=dict)
    allocated_cores: List[int] = field(default_factory=list)
    desired_status: str = enums.ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(
        default_factory=DesiredTransition)
    client_status: str = enums.ALLOC_CLIENT_PENDING
    client_description: str = ""
    # client-reported task states and deployment health verdict
    # ({"healthy": bool}), merged by the store's client updates
    task_states: Dict[str, object] = field(default_factory=dict)
    deployment_status: Optional[dict] = None
    canary: bool = False
    # the replacement chain: the alloc this one replaces, and the one
    # that replaced it
    previous_allocation: str = ""
    next_allocation: str = ""
    reschedule_tracker: Optional[RescheduleTracker] = None
    follow_up_eval_id: str = ""
    metrics: Optional[AllocMetric] = None
    allocated_at: float = 0.0
    preempted_by_allocation: str = ""
    # when the last task finished: a failure's reschedule clock starts
    # here, else at modify_time
    task_finished_at: float = 0.0
    modify_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def copy_for_update(self) -> "Allocation":
        """A shallow copy to rewrite as the alloc's next row (store rows
        are immutable by convention); the transition is copied too."""
        new = copy.copy(self)
        new.desired_transition = copy.copy(self.desired_transition)
        return new

    def server_terminal(self) -> bool:
        return self.desired_status in (enums.ALLOC_DESIRED_STOP,
                                       enums.ALLOC_DESIRED_EVICT)

    def client_terminal(self) -> bool:
        return self.client_status in (enums.ALLOC_CLIENT_COMPLETE,
                                      enums.ALLOC_CLIENT_FAILED,
                                      enums.ALLOC_CLIENT_LOST)

    def terminal_status(self) -> bool:
        return self.server_terminal() or self.client_terminal()

    def should_count_for_usage(self) -> bool:
        """Client-terminal allocs are free in fit math."""
        return not self.client_terminal()

    def index(self) -> int:
        """The bracketed index of the alloc name "<job>.<group>[i]"."""
        l, r = self.name.rfind("["), self.name.rfind("]")
        if l == -1 or r == -1 or r <= l:
            return -1
        try:
            return int(self.name[l + 1:r])
        except ValueError:
            return -1


def alloc_name(job_id: str, group: str, index: int) -> str:
    return f"{job_id}.{group}[{index}]"


# block alloc id = "<block uuid>.<position>"
BLOCK_SEP = "."


@dataclass(slots=True)
class AllocBlock:
    """Columnar batch of K identical fresh placements of one task group:
    ``node_ids[m]`` receives ``counts[m]`` placements; global position p
    maps to a node row through the counts' prefix sums, to alloc id
    ``"{id}.{p}"`` and to name index ``name_indices[p]``. Individual
    ``Allocation`` rows materialize lazily (and are cached). The plan
    applier's partial commit marks whole node rows rejected
    (``without_nodes``) and GC drops single positions (``with_dropped``,
    reference ``structs/alloc.py:252-420``), neither renumbering, so ids
    stay stable."""

    id: str = ""
    eval_id: str = ""
    namespace: str = "default"
    job_id: str = ""
    job: object = None
    job_version: int = 0
    task_group: str = ""
    deployment_id: str = ""
    name_indices: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    node_ids: List[str] = field(default_factory=list)
    node_names: List[str] = field(default_factory=list)
    counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    allocated_vec: np.ndarray = field(default_factory=lambda: comparable())
    mean_score: float = 0.0
    allocated_at: float = 0.0
    modify_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0
    # node rows the plan applier rejected (never committed)
    rejected_rows: frozenset = frozenset()
    # positions GC'd after their promoted rows went away
    dropped: frozenset = frozenset()
    _offsets: object = field(default=None, repr=False, compare=False)
    _mat: dict = field(default_factory=dict, repr=False, compare=False)
    _metrics: object = field(default=None, repr=False, compare=False)

    @property
    def size(self) -> int:
        """Plan-time placement count (rejected and dropped included)."""
        return len(self.name_indices)

    def live_size(self) -> int:
        """Committed, un-GC'd placements."""
        n = self.size - len(self.dropped)
        if self.rejected_rows:
            off = self.offsets()
            for m in self.rejected_rows:
                lo, hi = int(off[m]), int(off[m + 1])
                n -= (hi - lo) - sum(1 for p in self.dropped if lo <= p < hi)
        return n

    def offsets(self) -> np.ndarray:
        off = self._offsets
        if off is None:
            off = self._offsets = np.concatenate(
                [[0], np.cumsum(self.counts)]).astype(np.int64)
        return off

    def row_for_pos(self, p: int) -> int:
        return int(np.searchsorted(self.offsets(), p, side="right")) - 1

    def live_rows(self):
        if not self.rejected_rows:
            return range(len(self.node_ids))
        return (m for m in range(len(self.node_ids))
                if m not in self.rejected_rows)

    def visible(self, p: int) -> bool:
        if p in self.dropped:
            return False
        return (not self.rejected_rows
                or self.row_for_pos(p) not in self.rejected_rows)

    def positions_for_row(self, m: int) -> range:
        off = self.offsets()
        return range(int(off[m]), int(off[m + 1]))

    def _shared_metrics(self) -> AllocMetric:
        metrics = self._metrics
        if metrics is None:
            metrics = self._metrics = AllocMetric(
                scores={"bulk.normalized-score": self.mean_score})
        return metrics

    def alloc_at(self, p: int) -> Allocation:
        a = self._mat.get(p)
        if a is None:
            m = self.row_for_pos(p)
            a = self._mat[p] = Allocation(
                id=f"{self.id}{BLOCK_SEP}{p}",
                eval_id=self.eval_id,
                deployment_id=self.deployment_id,
                name=alloc_name(self.job_id, self.task_group,
                                int(self.name_indices[p])),
                namespace=self.namespace,
                node_id=self.node_ids[m],
                node_name=self.node_names[m] if self.node_names else "",
                job_id=self.job_id,
                job=self.job,
                job_version=self.job_version,
                task_group=self.task_group,
                allocated_vec=self.allocated_vec,
                metrics=self._shared_metrics(),
                allocated_at=self.allocated_at,
                modify_time=self.modify_time,
                create_index=self.create_index,
                modify_index=self.modify_index,
            )
        return a

    def allocs_for_row(self, m: int) -> List[Allocation]:
        if m in self.rejected_rows:
            return []
        if not self.dropped:
            return [self.alloc_at(p) for p in self.positions_for_row(m)]
        return [self.alloc_at(p) for p in self.positions_for_row(m)
                if p not in self.dropped]

    def allocs_for_node(self, node_id: str) -> List[Allocation]:
        out: List[Allocation] = []
        for m, nid in enumerate(self.node_ids):
            if nid == node_id:
                out.extend(self.allocs_for_row(m))
        return out

    def iter_allocs(self):
        for m in self.live_rows():
            yield from self.allocs_for_row(m)

    def without_nodes(self, bad_node_ids) -> "AllocBlock":
        """A copy with the given nodes' rows marked rejected (reference
        ``structs/alloc.py:399``, the applier's partial commit).
        Positions and ids stay stable."""
        bad = set(bad_node_ids)
        rows = {m for m, nid in enumerate(self.node_ids) if nid in bad}
        new = copy.copy(self)
        new.rejected_rows = self.rejected_rows | rows
        new._offsets = self._offsets
        new._mat = {}
        new._metrics = None
        return new

    def with_dropped(self, positions) -> "AllocBlock":
        """A copy with the given positions dropped (GC of their promoted
        rows). Positions and ids stay stable."""
        new = copy.copy(self)
        new.dropped = self.dropped | set(positions)
        new._offsets = self._offsets
        new._mat = {}
        new._metrics = None
        return new
