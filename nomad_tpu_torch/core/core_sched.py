"""Core garbage collection (a copy of ``nomad_tpu/core/core_sched.py``
without its ACL-token passes).

A GC thread runs the collectors against the store every ``interval``
seconds, and ``force_gc`` runs them at once:

- eval GC: terminal evals past the threshold whose allocs are terminal;
- alloc GC: terminal allocs of purged jobs, and allocs both server- and
  client-terminal (``StateStore.gc_terminal_allocs``; a block position
  is marked dropped);
- volume-claim reaping: claims of terminal or vanished allocs;
- derived batch job status: a batch job whose work finished goes dead;
- job GC: dead or stopped jobs with nothing live, with their evals;
- deployment GC: orphans, and all but a live job's newest terminal one;
- node GC: down nodes with no allocs (``StateStore.delete_node``);
- the MVCC compaction (``StateStore.compact``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..structs import enums


# the age (s) past which a terminal eval, a dead job and a down node
# are collected; ``force_gc(threshold_override=...)`` sets all three
EVAL_GC_THRESHOLD = 3600.0
JOB_GC_THRESHOLD = 4 * 3600.0
NODE_GC_THRESHOLD = 24 * 3600.0


class CoreScheduler:
    def __init__(self, server, interval: float = 60.0):
        self.server = server
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes whole GC passes (a caller's force_gc against the
        # timer thread): overlapping passes would double-count and
        # double-delete
        self._gc_lock = threading.Lock()
        self.stats = {"evals": 0, "allocs": 0, "jobs": 0, "deployments": 0,
                      "nodes": 0, "rows_compacted": 0}

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="core-gc")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.force_gc()
            except Exception:
                if self.server.logger:
                    self.server.logger.exception("core gc failed")

    def force_gc(self, threshold_override: Optional[float] = None) -> dict:
        """Run every collector now (``nomad system gc``).
        ``threshold_override=0`` collects everything terminal whatever
        its age."""
        with self._gc_lock:
            return self._force_gc_locked(threshold_override)

    def _force_gc_locked(self, threshold_override: Optional[float] = None) -> dict:
        now = time.time()
        et = EVAL_GC_THRESHOLD if threshold_override is None else threshold_override
        jt = JOB_GC_THRESHOLD if threshold_override is None else threshold_override
        nt = NODE_GC_THRESHOLD if threshold_override is None else threshold_override
        store = self.server.store
        snap = store.snapshot()

        # --- eval GC ---
        gc_evals = []
        for ev in snap.evals():
            if not ev.terminal_status():
                continue
            if now - (ev.modify_time or 0) < et:
                continue
            allocs = snap.allocs_by_eval(ev.id)
            if all(a.terminal_status() or a.server_terminal() for a in allocs):
                gc_evals.append(ev.id)
        if gc_evals:
            store.delete_evals(gc_evals)
            self.stats["evals"] += len(gc_evals)

        # --- alloc GC: orphans + stopped-and-finished allocs ---
        n = store.gc_terminal_allocs(before_index=store.latest_index,
                                     before_time=now - et)
        self.stats["allocs"] += n

        # --- volume claim reaping: claims of terminal or vanished allocs
        # release, so writers free up ---
        released = store.reap_volume_claims()
        self.stats["volume_claims"] = self.stats.get("volume_claims", 0) + released

        # --- derived job status: batch work that finished goes dead, so
        # the job GC below can collect it ---
        snap = store.snapshot()
        for job in list(snap.jobs()):
            if job.type not in (enums.JOB_TYPE_BATCH, enums.JOB_TYPE_SYSBATCH):
                continue
            if job.status == enums.JOB_STATUS_DEAD or job.stopped():
                continue
            allocs = snap.allocs_by_job(job.id, job.namespace)
            if not allocs:
                continue  # nothing placed yet; leave pending
            evals = snap.evals_by_job(job.id, job.namespace)
            if any(not e.terminal_status() for e in evals):
                continue  # reschedules/blocked work still pending
            if all(a.client_terminal() or a.server_terminal() for a in allocs):
                store.update_job_status(job.id, enums.JOB_STATUS_DEAD,
                                        job.namespace)

        # --- job GC ---
        snap = store.snapshot()
        for job in list(snap.jobs()):
            dead = job.stopped() or job.status == enums.JOB_STATUS_DEAD
            if not dead:
                continue
            allocs = snap.allocs_by_job(job.id, job.namespace)
            if any(not a.terminal_status() and not a.server_terminal()
                   for a in allocs):
                continue
            evals = snap.evals_by_job(job.id, job.namespace)
            if any(not e.terminal_status() for e in evals):
                continue
            newest = max((e.modify_time or 0 for e in evals), default=0.0)
            if now - newest < jt:
                continue  # retain recently-finished history
            store.delete_job(job.id, job.namespace, purge=True)
            if evals:
                store.delete_evals([e.id for e in evals])
            self.stats["jobs"] += 1
            self.server.blocked.untrack_job(job.namespace, job.id)

        # --- deployment GC: drop orphans, and for a live job keep only
        # its newest terminal deployment ---
        snap = store.snapshot()
        newest_terminal: dict = {}
        for dep in list(snap.deployments()):
            if dep.active():
                continue
            if snap.job_by_id(dep.job_id, dep.namespace) is None:
                store.delete_deployment(dep.id)
                self.stats["deployments"] += 1
                continue
            key = (dep.namespace, dep.job_id)
            prev = newest_terminal.get(key)
            if prev is None:
                newest_terminal[key] = dep
            else:
                older = dep if dep.modify_index < prev.modify_index else prev
                newest_terminal[key] = dep if older is prev else prev
                store.delete_deployment(older.id)
                self.stats["deployments"] += 1

        # --- node GC: a down node with no allocs left is deleted ---
        snap = store.snapshot()
        for node in list(snap.nodes()):
            if node.status != enums.NODE_STATUS_DOWN:
                continue
            if now - (node.status_updated_at or 0) < nt:
                continue
            if snap.allocs_by_node(node.id):
                continue
            store.delete_node(node.id)
            self.stats["nodes"] += 1

        # --- MVCC compaction ---
        self.stats["rows_compacted"] += store.compact()
        return dict(self.stats)
