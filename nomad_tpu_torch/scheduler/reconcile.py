"""Service/batch reconciler, fresh placements only (reference
``nomad_tpu/scheduler/reconcile.py`` and the name index of
``scheduler/util.py``).

The bulk slice places the missing allocations of a group as ONE
columnar request once at least ``BULK_PLACE_MIN`` are missing. Stops,
updates, deployments, reschedules, lost or migrating allocs and small
remainders belong to later slices and raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..structs import Allocation, Job, TaskGroup, enums

BULK_PLACE_MIN = 256  # below this, per-request objects are cheap enough

_SERVER_SLICE = ("ROADMAP queue A: the Server/Worker/plan-applier slice "
                 "(stops, updates, deployments, reschedules)")
_PER_EVAL = "ROADMAP queue A, slice 4 (the per-eval general path)"


@dataclass
class BulkPlacementRequest:
    """K identical fresh placements carried as one request;
    ``name_indices[i]`` is the alloc name index of placement i."""

    task_group: TaskGroup
    name_indices: object = None  # (K,) int array
    job_id: str = ""

    @property
    def count(self) -> int:
        return len(self.name_indices)


@dataclass
class GroupResult:
    bulk_place: Optional[BulkPlacementRequest] = None
    ignore: int = 0


@dataclass
class ReconcileResults:
    groups: Dict[str, GroupResult] = field(default_factory=dict)

    def total_places(self) -> int:
        return sum(g.bulk_place.count for g in self.groups.values()
                   if g.bulk_place is not None)


class AllocNameIndex:
    """In-use alloc name indexes of a task group, so new placements take
    the lowest free "<job>.<group>[i]" names."""

    def __init__(self, allocs: List[Allocation]):
        self.used = {i for i in (a.index() for a in allocs) if i >= 0}

    def next_batch_indices(self, n: int) -> np.ndarray:
        if not self.used:
            self.used.update(range(n))
            return np.arange(n, dtype=np.int64)
        out = np.empty(n, dtype=np.int64)
        filled, i = 0, 0
        while filled < n:
            if i not in self.used:
                self.used.add(i)
                out[filled] = i
                filled += 1
            i += 1
        return out


class AllocReconciler:
    def __init__(self, job: Optional[Job], job_id: str,
                 existing: List[Allocation], snapshot, *, batch: bool = False):
        self.job = job
        self.job_id = job_id
        self.existing = existing
        self.snapshot = snapshot
        self.batch = batch

    def compute(self) -> ReconcileResults:
        results = ReconcileResults()
        live = [a for a in self.existing if not a.terminal_status()]
        if self.job is None or self.job.stopped():
            if live:
                raise NotImplementedError(f"stopping a job: {_SERVER_SLICE}")
            return results
        matrix: Dict[str, List[Allocation]] = {}
        for a in self.existing:
            matrix.setdefault(a.task_group, []).append(a)
        groups = {tg.name: tg for tg in self.job.task_groups}
        if any(name not in groups for name in matrix):
            raise NotImplementedError(
                f"a task group left the job: {_SERVER_SLICE}")
        for name, tg in groups.items():
            results.groups[name] = self._compute_group(tg,
                                                       matrix.get(name, []))
        return results

    def _compute_group(self, tg: TaskGroup,
                       allocs: List[Allocation]) -> GroupResult:
        g = GroupResult()
        if tg.update is not None:
            raise NotImplementedError(
                f"group {tg.name!r} has an update stanza (deployments): "
                f"{_SERVER_SLICE}")
        live: List[Allocation] = []
        batch_done = 0
        for a in allocs:
            if a.server_terminal():
                continue
            if self.batch and a.client_status == enums.ALLOC_CLIENT_COMPLETE:
                batch_done += 1    # finished batch work counts as placed
                continue
            node = self.snapshot.node_by_id(a.node_id)
            tainted = node is None or node.drain or node.status in (
                enums.NODE_STATUS_DOWN, enums.NODE_STATUS_DISCONNECTED)
            if (a.client_terminal() or a.job_version != self.job.version
                    or tainted):
                raise NotImplementedError(
                    f"alloc {a.id} is not a live alloc of the current job "
                    f"version on a healthy node: {_SERVER_SLICE}")
            live.append(a)
        g.ignore = len(live) + batch_done
        have = len(live) + batch_done
        if have > tg.count:
            raise NotImplementedError(f"scaling a group down: {_SERVER_SLICE}")
        missing = tg.count - have
        if missing == 0:
            return g
        if missing < BULK_PLACE_MIN:
            raise NotImplementedError(
                f"{missing} placements (< {BULK_PLACE_MIN}): {_PER_EVAL}")
        g.bulk_place = BulkPlacementRequest(
            task_group=tg, job_id=self.job_id,
            name_indices=AllocNameIndex(
                [a for a in allocs if not a.terminal_status()]
            ).next_batch_indices(missing))
        return g
