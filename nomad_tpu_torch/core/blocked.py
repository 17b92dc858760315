"""Blocked evaluations (reference ``nomad_tpu/core/blocked.py``).

Holds evals that could not place all their allocations until the
cluster changes in a way that might help: a node registration or status
change unblocks the evals whose class eligibility does not rule the node
out (or that escaped class tracking, as every eval the port's schedulers
block does). One blocked eval a job: a newer one cancels the older.
``unblock_failed`` releases the evals blocked by plan-attempt exhaustion
(the conflict retry the Server's reaper runs on a timer).
"""

from __future__ import annotations

import copy as _copy
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..structs import enums
from ..structs.evaluation import Evaluation


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[Evaluation], None],
                 persist_fn: Optional[Callable[[List[Evaluation]],
                                               None]] = None):
        """``enqueue_fn`` re-queues an unblocked eval; ``persist_fn``
        commits cancellations to the store."""
        self._enqueue = enqueue_fn
        self._persist = persist_fn
        self._lock = threading.Lock()
        self._enabled = False
        self._by_job: Dict[Tuple[str, str], Evaluation] = {}
        # evals that escaped class tracking: any node change unblocks
        self._escaped: Dict[str, Evaluation] = {}
        self._captured: Dict[str, Evaluation] = {}
        self.stats = {"blocked": 0, "unblocked": 0, "cancelled": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._by_job.clear()
                self._escaped.clear()
                self._captured.clear()

    def block(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            key = (ev.namespace, ev.job_id)
            prev = self._by_job.get(key)
            cancelled = None
            if prev is not None:
                if prev.id == ev.id:
                    return
                cancelled = _copy.copy(prev)
                cancelled.status = enums.EVAL_STATUS_CANCELLED
                cancelled.status_description = (
                    "superseded by newer blocked eval")
                self._escaped.pop(prev.id, None)
                self._captured.pop(prev.id, None)
                self.stats["cancelled"] += 1
            self._by_job[key] = ev
            if ev.escaped_computed_class or not ev.class_eligibility:
                self._escaped[ev.id] = ev
            else:
                self._captured[ev.id] = ev
            self.stats["blocked"] += 1
        if cancelled is not None and self._persist is not None:
            self._persist([cancelled])

    def untrack_job(self, namespace: str, job_id: str) -> None:
        with self._lock:
            ev = self._by_job.pop((namespace, job_id), None)
            if ev is not None:
                self._escaped.pop(ev.id, None)
                self._captured.pop(ev.id, None)

    def _release_locked(self, release: List[Evaluation]) -> None:
        for ev in release:
            self._by_job.pop((ev.namespace, ev.job_id), None)
            self._escaped.pop(ev.id, None)
            self._captured.pop(ev.id, None)
        self.stats["unblocked"] += len(release)

    def unblock(self, computed_class: str = "") -> int:
        """A node changed: release the candidate evals to the broker."""
        with self._lock:
            if not self._enabled:
                return 0
            release: List[Evaluation] = list(self._escaped.values())
            for ev in list(self._captured.values()):
                elig = ev.class_eligibility.get(computed_class)
                if elig is None or elig:
                    release.append(ev)
            self._release_locked(release)
        for ev in release:
            # the callback persists and requeues (on a copy)
            self._enqueue(ev)
        return len(release)

    def unblock_failed(self) -> int:
        """Release the evals blocked by plan-attempt exhaustion
        (reference ``blocked_evals.go`` UnblockFailed)."""
        with self._lock:
            if not self._enabled:
                return 0
            release = [ev for ev in self._by_job.values()
                       if ev.triggered_by == enums.TRIGGER_MAX_PLANS]
            self._release_locked(release)
        for ev in release:
            self._enqueue(ev)
        return len(release)

    def blocked_count(self) -> int:
        with self._lock:
            return len(self._by_job)
