"""Deployment health and the deployment watcher (a copy of
``nomad_tpu/core/deployments.py``).

``alloc_healthy`` is the health rule the promotion endpoint and the
watcher read. ``DeploymentWatcher`` drives each active deployment: a
failed alloc, or a client's unhealthy verdict, fails it (with
``auto_revert``, the job's prior version is registered again); healthy
canaries with ``auto_promote`` are promoted; a deployment whose group
misses its progress deadline fails; one superseded by a newer job
version is cancelled; one with every group healthy succeeds; and while
the healthy count grows, a follow-up eval moves the rolling update on.
Commits that can change a verdict (``_WAKE_EVENTS``) wake the loop;
its interval is the floor of the deadline polling.
"""

from __future__ import annotations

import copy as _copy
import threading
import time
from typing import Dict

from ..structs import enums
from ..structs.evaluation import Evaluation
from ..structs.services import collect_services
from ..utils.ids import generate_uuid


def _group_has_checks(tg) -> bool:
    return any(svc.checks for _, svc in collect_services(tg))


def alloc_healthy(alloc, job, now: float) -> bool:
    """Server-side health of one alloc (reference ``deployments.py:35-61``):
    the client's explicit ``deployment_status`` verdict wins; a group
    with service checks waits for it; else every task has been running
    for the group's ``min_healthy_time``."""
    ds = alloc.deployment_status
    if isinstance(ds, dict) and ds.get("healthy") is not None:
        return bool(ds.get("healthy"))
    if alloc.client_status != enums.ALLOC_CLIENT_RUNNING:
        return False
    tg = job.lookup_task_group(alloc.task_group)
    if tg is not None and _group_has_checks(tg):
        # only the client's verdict counts: the liveness fallback would
        # declare success before the check results arrive
        return False
    min_healthy = (tg.update.min_healthy_time_s
                   if tg is not None and tg.update is not None else 10.0)
    if not alloc.task_states:
        return False
    for st in alloc.task_states.values():
        if st.state != "running" or not st.started_at:
            return False
        if now - st.started_at < min_healthy:
            return False
    return True


# the loop's poll interval (s): the floor of the deadline polling
INTERVAL = 0.2


class DeploymentWatcher:
    # store commits that can change a deployment's health verdict; any
    # of these wakes the loop at once instead of waiting out the poll
    # interval
    _WAKE_EVENTS = frozenset((
        "alloc-upsert", "alloc-client-update", "alloc-stop",
        "deployment-upsert", "job-upsert"))

    def __init__(self, server):
        self.server = server
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = None
        # deployment id -> healthy count at last follow-up eval
        self._progress: Dict[str, int] = {}
        self.stats = {"succeeded": 0, "failed": 0, "reverted": 0,
                      "auto_promoted": 0}
        # event-driven ticks: alloc-health commits wake the loop, so a
        # failure or a revert answers the write that caused it. The
        # listener runs on the store's commit path and only sets an
        # Event: it never re-enters the store (reference ``:84-90``)
        server.store.add_commit_listener(self._on_commit)

    def _on_commit(self, index: int, events: list) -> None:
        if any(kind in self._WAKE_EVENTS for kind, _ in events):
            self._wake.set()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="deployment-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # unblock the wait promptly
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            # the interval is now only the deadline-polling floor
            # (progress/min_healthy deadlines still need wall time)
            if self._wake.wait(INTERVAL):
                self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception:
                if self.server.logger:
                    self.server.logger.exception("deployment watcher tick failed")

    def _tick(self) -> None:
        snap = self.server.store.snapshot()
        now = time.time()
        for dep in list(snap.deployments()):
            if not dep.active():
                self._progress.pop(dep.id, None)
                continue
            job = snap.job_by_id(dep.job_id, dep.namespace)
            if job is None or job.version != dep.job_version:
                self._update_status(dep, enums.DEPLOYMENT_STATUS_CANCELLED,
                                    "superseded by a newer job version")
                continue

            allocs = [a for a in snap.allocs_by_job(dep.job_id, dep.namespace)
                      if a.deployment_id == dep.id]
            healthy = 0
            failed = False
            unhealthy_verdict = False
            for a in allocs:
                ds = a.deployment_status
                if a.client_status == enums.ALLOC_CLIENT_FAILED:
                    failed = True
                elif isinstance(ds, dict) and ds.get("healthy") is False:
                    # explicit client verdict (failing checks / deadline
                    # — client/allochealth): fail fast, don't wait out
                    # the progress deadline
                    unhealthy_verdict = True
                elif self._alloc_healthy(a, job, now):
                    healthy += 1

            if failed or unhealthy_verdict:
                self._fail(snap, dep, job,
                           "allocations failed" if failed
                           else "allocations unhealthy")
                continue
            deadline = min((s.require_progress_by
                            for s in dep.task_groups.values()
                            if s.require_progress_by), default=0.0)

            # canary promotion gate: the rollout pauses until every canary
            # group has its healthy canaries and is promoted
            if dep.requires_promotion():
                if dep.has_auto_promote() and self._canaries_healthy(
                        dep, job, allocs, now):
                    try:
                        self.server.promote_deployment(dep.id)
                        self.stats["auto_promoted"] += 1
                    except (ValueError, PermissionError):
                        pass
                if deadline and now > deadline:
                    self._fail(snap, dep, job, "progress deadline exceeded")
                continue

            desired = sum(s.desired_total for s in dep.task_groups.values())
            if healthy >= desired and len(allocs) >= desired:
                upd = _copy.copy(dep)
                upd.task_groups = dict(dep.task_groups)
                self._set_counts(upd, allocs, healthy)
                upd.status = enums.DEPLOYMENT_STATUS_SUCCESSFUL
                upd.status_description = "Deployment completed successfully"
                self.server.store.upsert_deployment(upd)
                self.stats["succeeded"] += 1
                self._progress.pop(dep.id, None)
                continue
            if deadline and now > deadline and healthy < desired:
                self._fail(snap, dep, job, "progress deadline exceeded")
                continue

            # rollout continuation: when new allocs turn healthy, extend
            # the progress deadline (it resets with each healthy alloc, so
            # a steady long rollout never times out) and let the
            # scheduler replace the next max_parallel batch
            last = self._progress.get(dep.id, -1)
            if healthy > last:
                self._progress[dep.id] = healthy
                if healthy > 0:
                    upd = _copy.copy(dep)
                    upd.task_groups = {}
                    for name, state in dep.task_groups.items():
                        s = _copy.copy(state)
                        if s.progress_deadline_s:
                            s.require_progress_by = now + s.progress_deadline_s
                        upd.task_groups[name] = s
                    self.server.store.upsert_deployment(upd)
                old_version_live = any(
                    a.job_version != dep.job_version and not a.terminal_status()
                    and not a.server_terminal()
                    for a in snap.allocs_by_job(dep.job_id, dep.namespace))
                if old_version_live and healthy > 0:
                    self._create_eval(job)

    def _alloc_healthy(self, alloc, job, now: float) -> bool:
        return alloc_healthy(alloc, job, now)

    def _canaries_healthy(self, dep, job, allocs, now: float) -> bool:
        for name, state in dep.task_groups.items():
            if state.desired_canaries <= 0 or state.promoted:
                continue
            healthy = sum(
                1 for a in allocs
                if a.task_group == name and a.canary
                and alloc_healthy(a, job, now))
            if healthy < state.desired_canaries:
                return False
        return True

    def _set_counts(self, dep, allocs, healthy: int) -> None:
        by_group: Dict[str, int] = {}
        for a in allocs:
            by_group[a.task_group] = by_group.get(a.task_group, 0) + 1
        for name, state in list(dep.task_groups.items()):
            s = _copy.copy(state)
            s.placed_allocs = by_group.get(name, 0)
            s.healthy_allocs = healthy  # aggregate; per-group split refined later
            dep.task_groups[name] = s

    def _fail(self, snap, dep, job, reason: str) -> None:
        self._update_status(dep, enums.DEPLOYMENT_STATUS_FAILED,
                            f"Deployment failed: {reason}")
        self.stats["failed"] += 1
        self._progress.pop(dep.id, None)
        auto_revert = any(s.auto_revert for s in dep.task_groups.values())
        if not auto_revert:
            return
        # revert to the previous job version
        prior = self.server.store.snapshot().job_version(
            dep.job_id, dep.job_version - 1, dep.namespace)
        if prior is None:
            return
        reverted = _copy.copy(prior)
        reverted.stop = False
        # count BEFORE the store write: the version bump is the revert's
        # visible signal, and no reader may see it with a stale counter
        self.stats["reverted"] += 1
        self.server.store.upsert_job(reverted)  # becomes the next version
        self._create_eval(reverted)

    def _update_status(self, dep, status: str, desc: str) -> None:
        upd = _copy.copy(dep)
        upd.status = status
        upd.status_description = desc
        self.server.store.upsert_deployment(upd)

    def _create_eval(self, job) -> None:
        ev = Evaluation(
            id=generate_uuid(),
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=enums.TRIGGER_DEPLOYMENT_WATCHER,
            job_id=job.id,
            status=enums.EVAL_STATUS_PENDING,
            create_time=time.time(),
        )
        self.server.store.upsert_evals([ev])
        self.server.broker.enqueue(ev)
