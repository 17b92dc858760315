"""Service/batch reconciler: fresh placements and the stop arm
(reference ``nomad_tpu/scheduler/reconcile.py`` and the name index of
``scheduler/util.py``).

A group missing at least ``BULK_PLACE_MIN`` allocations gets ONE
columnar request; a smaller remainder gets one ``PlacementRequest`` per
missing alloc. A stopped (or purged) job, and a task group that left the
job, stop every live alloc (reference ``reconcile.py:176-192``), allocs
of an AllocBlock included. Scale-down, canaries, replacements,
reschedules, lost or migrating allocs belong to a later slice and raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..structs import Allocation, Job, TaskGroup, alloc_name, enums

BULK_PLACE_MIN = 256  # below this, per-request objects are cheap enough

_SERVER_SLICE = ("ROADMAP queue A1c: the reconciler and scheduler "
                 "remainder (canaries, replacements, reschedules, "
                 "scaling down)")


@dataclass
class PlacementRequest:
    """One allocation that must be placed. The port's reconciler makes
    only fresh ones; a replacement (``previous_alloc``, ``reschedule``)
    or a canary raises where it is committed."""

    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    canary: bool = False
    ignore_node: str = ""  # node of a failed previous alloc (penalty)


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

    def expand(self) -> List[PlacementRequest]:
        """The per-alloc requests of this batch, for groups whose
        features rule out the count-based bulk solve."""
        tg = self.task_group
        return [PlacementRequest(
            name=alloc_name(self.job_id, tg.name, int(i)), task_group=tg)
            for i in self.name_indices]


@dataclass
class GroupResult:
    place: List[PlacementRequest] = field(default_factory=list)
    bulk_place: Optional[BulkPlacementRequest] = None
    # (alloc, desired description, client status)
    stop: List[Tuple[Allocation, str, str]] = field(default_factory=list)
    ignore: int = 0


@dataclass
class ReconcileResults:
    groups: Dict[str, GroupResult] = field(default_factory=dict)

    def total_places(self) -> int:
        return sum(len(g.place)
                   + (g.bulk_place.count if g.bulk_place is not None else 0)
                   for g in self.groups.values())


class AllocNameIndex:
    """In-use alloc name indexes of a task group, so new placements take
    the lowest free "<job>.<group>[i]" names."""

    def __init__(self, job_id: str, group: str, allocs: List[Allocation]):
        self.job_id = job_id
        self.group = group
        self.used = {i for i in (a.index() for a in allocs) if i >= 0}

    def next_batch(self, n: int) -> List[str]:
        out = []
        i = 0
        while len(out) < n:
            if i not in self.used:
                self.used.add(i)
                out.append(alloc_name(self.job_id, self.group, i))
            i += 1
        return out

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
        stopped = self.job is None or self.job.stopped()
        matrix: Dict[str, List[Allocation]] = {}
        for a in self.existing:
            matrix.setdefault(a.task_group, []).append(a)
        groups = ({} if stopped
                  else {tg.name: tg for tg in self.job.task_groups})
        # a stopped job, or a group no longer in the job: stop them all
        for name, allocs in matrix.items():
            if stopped or name not in groups:
                g = results.groups.setdefault(name, GroupResult())
                for a in allocs:
                    if not a.terminal_status():
                        g.stop.append(
                            (a, "alloc not needed due to job update", ""))
        if stopped:
            return results
        for name, tg in groups.items():
            results.groups[name] = self._compute_group(tg,
                                                       matrix.get(name, []))
        return results

    def _compute_group(self, tg: TaskGroup,
                       allocs: List[Allocation]) -> GroupResult:
        g = GroupResult()
        if tg.update is not None and tg.update.canary:
            raise NotImplementedError(
                f"group {tg.name!r} asks for canaries: {_SERVER_SLICE}")
        if tg.volumes:
            raise NotImplementedError(
                f"group {tg.name!r} claims volumes: ROADMAP queue A5b")
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
        name_index = AllocNameIndex(
            self.job_id, tg.name,
            [a for a in allocs if not a.terminal_status()])
        if missing >= BULK_PLACE_MIN:
            g.bulk_place = BulkPlacementRequest(
                task_group=tg, job_id=self.job_id,
                name_indices=name_index.next_batch_indices(missing))
            return g
        for name in name_index.next_batch(missing):
            g.place.append(PlacementRequest(name=name, task_group=tg))
        return g
