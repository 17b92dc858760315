"""Allocation, AllocMetric and the columnar AllocBlock (reference
``nomad_tpu/structs/alloc.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import enums
from .resources import comparable


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
    desired_status: str = enums.ALLOC_DESIRED_RUN
    client_status: str = enums.ALLOC_CLIENT_PENDING
    metrics: Optional[AllocMetric] = None
    allocated_at: float = 0.0
    create_index: int = 0
    modify_index: int = 0

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
    ``Allocation`` rows materialize lazily (and are cached)."""

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
    create_index: int = 0
    modify_index: int = 0
    _offsets: object = field(default=None, repr=False, compare=False)
    _mat: dict = field(default_factory=dict, repr=False, compare=False)
    _metrics: object = field(default=None, repr=False, compare=False)

    @property
    def size(self) -> int:
        return len(self.name_indices)

    def live_size(self) -> int:
        return self.size

    def offsets(self) -> np.ndarray:
        off = self._offsets
        if off is None:
            off = self._offsets = np.concatenate(
                [[0], np.cumsum(self.counts)]).astype(np.int64)
        return off

    def row_for_pos(self, p: int) -> int:
        return int(np.searchsorted(self.offsets(), p, side="right")) - 1

    def live_rows(self):
        return range(len(self.node_ids))

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
                create_index=self.create_index,
                modify_index=self.modify_index,
            )
        return a

    def allocs_for_row(self, m: int) -> List[Allocation]:
        return [self.alloc_at(p) for p in self.positions_for_row(m)]

    def iter_allocs(self):
        for m in self.live_rows():
            yield from self.allocs_for_row(m)
