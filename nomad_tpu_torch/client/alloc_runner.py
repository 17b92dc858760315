"""Allocation runner (a copy of ``nomad_tpu/client/alloc_runner.py``;
reference client/allocrunner/alloc_runner.go:222).

Owns one allocation on the client: builds the alloc dir, mounts its
host volumes, starts task runners in lifecycle order (prestart tasks
before the main tasks, sidecars kept running, poststop after), registers
the group's and tasks' services with their checks, decides deployment
health, rolls task states up into the alloc's client status and reports
each change upward for the batched server sync.

Trimmed: CSI volumes (staged through ``plugins/volumes.py`` in the
reference) wait for ROADMAP A10.10, and an alloc that asks for one fails
its mount with a message naming it; device plugins' reservations
(``client/devices.py``, A10.10: the cards the fingerprint reports
reserve nothing in the reference either) and workload identities
(``widmgr.py``, A10.4) are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..structs import enums
from ..structs.alloc import Allocation, TaskState
from ..structs.services import collect_services
from .allocdir import AllocDir
from .task_runner import TaskRunner

PRESTART_DEADLINE_S = 300.0  # healthy_deadline analog for lifecycle hooks

LIFECYCLE_PRESTART = "prestart"
LIFECYCLE_POSTSTART = "poststart"
LIFECYCLE_POSTSTOP = "poststop"


class AllocRunner:
    def __init__(self, alloc: Allocation, node, data_dir: str,
                 on_update: Optional[Callable] = None,
                 state_db=None, restored_handles: Optional[Dict] = None,
                 prev_runner_lookup: Optional[Callable] = None,
                 services_api=None):
        self.alloc = alloc
        self.node = node
        self.data_dir = data_dir
        self.on_update = on_update
        # service registration endpoint surface (the server or an HTTP
        # facade): upsert_service_registrations / delete_services_by_alloc
        self.services_api = services_api
        self.volume_mounts: Dict[str, str] = {}  # volume name -> path
        self.check_runner = None
        self._health_thread: Optional[threading.Thread] = None
        # deployment health verdict: None until decided, else (bool, ts)
        # — synced to the server as alloc.deployment_status (reference
        # client/allochealth/tracker.go feeding the deployment watcher)
        self.deployment_health = None
        # allocwatcher (reference client/allocwatcher): lets this runner
        # wait on the previous alloc (upgrades/migrations) and pull its
        # ephemeral disk before starting tasks
        self.prev_runner_lookup = prev_runner_lookup
        # persistence (client/state_db.py): task handles write through so
        # a restarted client can re-attach; restored_handles carries the
        # live handles recovered on restore
        self.state_db = state_db
        self.restored_handles = restored_handles or {}
        self.allocdir = AllocDir(data_dir, alloc.id)
        self.task_runners: Dict[str, TaskRunner] = {}
        self.client_status = enums.ALLOC_CLIENT_PENDING
        self.client_description = ""
        self.task_states: Dict[str, TaskState] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._destroyed = False

        job = alloc.job
        self.tg = job.lookup_task_group(alloc.task_group) if job is not None else None

    # -- lifecycle --

    def run(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"alloc-{self.alloc.id[:8]}")
        self._thread.start()

    def _run(self) -> None:
        if self.tg is None or not self.tg.tasks:
            self._set_status(enums.ALLOC_CLIENT_FAILED, "no task group")
            return
        self.allocdir.build()
        self._await_previous()
        if not self._mount_volumes():
            return
        def make_runner(task) -> TaskRunner:
            td = self.allocdir.build_task_dir(task.name)
            tr = TaskRunner(self.alloc, task, self.node, td,
                            shared_dir=self.allocdir.shared,
                            on_state_change=self._on_task_state,
                            restart_policy=self.tg.restart_policy,
                            on_handle=self._on_task_handle,
                            recovered_handle=self.restored_handles.get(task.name),
                            logs_dir=self.allocdir.logs,
                            volume_mounts=self.volume_mounts)
            self.task_runners[task.name] = tr
            return tr

        restoring = bool(self.restored_handles)
        prestart = [t for t in self.tg.tasks if t.lifecycle_hook == LIFECYCLE_PRESTART]
        mains = [t for t in self.tg.tasks if t.lifecycle_hook in ("", LIFECYCLE_POSTSTART)]
        poststop = [t for t in self.tg.tasks if t.lifecycle_hook == LIFECYCLE_POSTSTOP]

        # prestart tasks: non-sidecars must complete before main tasks
        # (reference tasklifecycle coordinator). On restore, completed
        # non-sidecar prestarts don't re-run; recovered tasks re-attach —
        # and a recovered NON-sidecar still gates the mains below,
        # preserving the ordering invariant across the restart. Sidecar
        # prestarts always get a runner: one whose process died while the
        # agent was down must restart fresh, not silently vanish.
        if restoring:
            prestart = [t for t in prestart
                        if t.lifecycle_sidecar
                        or t.name in self.restored_handles]
        pre_runners = [make_runner(t) for t in prestart]
        for r in pre_runners:
            r.start()
        for t, r in zip(prestart, pre_runners):
            if not t.lifecycle_sidecar:
                finished = r.wait_dead(timeout=PRESTART_DEADLINE_S)
                if not finished or r.state.failed:
                    self._set_status(
                        enums.ALLOC_CLIENT_FAILED,
                        f"prestart task {t.name} "
                        f"{'failed' if finished else 'deadline exceeded'}")
                    self._kill_all()
                    return

        main_runners = [make_runner(t) for t in mains]
        for r in main_runners[:-1]:
            r.start()
        self._recompute_status()
        self._register_services()
        self._start_health_watch()
        # the last main task runs on this thread: a runner's thread only
        # waits for its tasks, and an agent running thousands of allocs
        # keeps one thread an alloc rather than two
        if main_runners:
            main_runners[-1].run()

        # wait for all main tasks to finish (sidecar prestarts are
        # stopped when the mains are done); a stop kills the tasks, so
        # the waits end with them, and the timeout only bounds how long
        # a stop is checked for
        for r in main_runners:
            while not r.wait_dead(timeout=5.0):
                if self._destroyed:
                    return
        for t, r in zip(prestart, pre_runners):
            if t.lifecycle_sidecar:
                r.kill()
        self._deregister_services()

        # poststop tasks run after the mains (reference poststop hooks);
        # one that overruns its deadline is killed, not waited on forever
        post_runners = [make_runner(t) for t in poststop]
        for r in post_runners:
            r.start()
        for r in post_runners:
            if not r.wait_dead(timeout=PRESTART_DEADLINE_S):
                r.kill()
        self._recompute_status()

    def _await_previous(self) -> None:
        """Block until the local previous alloc finishes, then migrate
        its ephemeral disk when the group asks for it (reference
        client/allocwatcher: prevAllocWatcher + local disk migration;
        restore passes no lookup, so re-adopted allocs skip the wait)."""
        prev_id = self.alloc.previous_allocation
        if not prev_id or self.prev_runner_lookup is None:
            return
        prev = self.prev_runner_lookup(prev_id)
        if prev is not None:
            deadline = time.time() + PRESTART_DEADLINE_S
            while (not prev.is_terminal() and prev.client_status
                    != enums.ALLOC_CLIENT_LOST and time.time() < deadline):
                if self._destroyed:
                    return
                time.sleep(0.1)
        if self.tg is not None and (self.tg.ephemeral_disk.migrate
                                    or self.tg.ephemeral_disk.sticky):
            self.allocdir.migrate_from(AllocDir(self.data_dir, prev_id))

    # -- services + check-based health (reference group/task service
    #    hooks + client/allochealth/tracker.go) --

    def _register_services(self) -> None:
        if self.services_api is None or self.tg is None:
            return
        from ..structs.services import ServiceRegistration
        from .checks import CheckRunner, service_address

        regs = []
        for task_name, svc in collect_services(self.tg):
            addr, port = service_address(self.alloc, self.node,
                                         svc.port_label)
            regs.append(ServiceRegistration(
                id=f"{self.alloc.id}/{task_name or '_group'}/{svc.name}",
                service_name=svc.name,
                namespace=self.alloc.namespace,
                node_id=self.alloc.node_id,
                job_id=self.alloc.job_id,
                alloc_id=self.alloc.id,
                task_name=task_name,
                address=addr, port=port, tags=list(svc.tags)))
        if regs:
            try:
                self.services_api.upsert_service_registrations(regs)
            except Exception:
                pass  # registration retries ride the next alloc update
        self.check_runner = CheckRunner(self.alloc, self.tg, self.node)
        self.check_runner.start()

    def _deregister_services(self) -> None:
        if self.check_runner is not None:
            self.check_runner.stop()
        if (self.services_api is None or self.tg is None
                or not collect_services(self.tg)):
            # a group without services has no registration to delete:
            # skip the store write (a stopping agent makes one an alloc)
            return
        try:
            self.services_api.delete_services_by_alloc(self.alloc.id)
        except Exception:
            pass

    def _start_health_watch(self) -> None:
        """Decide deployment health: every main task running AND every
        check passing, continuously for min_healthy_time, before
        healthy_deadline (reference client/allochealth/tracker.go)."""
        if not self.alloc.deployment_id or self.tg is None:
            return
        upd = self.tg.update
        min_healthy = upd.min_healthy_time_s if upd is not None else 10.0
        deadline_s = upd.healthy_deadline_s if upd is not None else 300.0

        def watch():
            deadline = time.time() + deadline_s
            streak_start = None
            while not self._destroyed and self.deployment_health is None:
                now = time.time()
                running = self.client_status == enums.ALLOC_CLIENT_RUNNING
                checks_ok = (self.check_runner is None
                             or not self.check_runner.has_checks()
                             or self.check_runner.all_passing())
                if self.client_status == enums.ALLOC_CLIENT_FAILED:
                    self.deployment_health = (False, now)
                    break
                if running and checks_ok:
                    if streak_start is None:
                        streak_start = now
                    elif now - streak_start >= min_healthy:
                        self.deployment_health = (True, now)
                        break
                else:
                    streak_start = None
                if now >= deadline:
                    self.deployment_health = (False, now)
                    break
                time.sleep(0.2)
            if self.deployment_health is not None and self.on_update:
                self.on_update(self)

        self._health_thread = threading.Thread(
            target=watch, daemon=True, name=f"health-{self.alloc.id[:8]}")
        self._health_thread.start()

    # -- volume mounts (reference client/allocrunner csi_hook) --

    def _mount_volumes(self) -> bool:
        """Resolve every group volume before any task starts: a host
        volume's path comes from the node's fingerprint; a CSI volume
        fails the alloc (ROADMAP A10.10). -> ok?"""
        if self.tg is None or not self.tg.volumes:
            return True
        for name, req in self.tg.volumes.items():
            if req.type == "host":
                hv = (self.node.host_volumes or {}).get(req.source)
                if hv is None:
                    self._set_status(enums.ALLOC_CLIENT_FAILED,
                                     f"host volume {req.source} "
                                     "not exposed by this node")
                    return False
                self.volume_mounts[name] = hv.path
                continue
            self._set_status(enums.ALLOC_CLIENT_FAILED,
                             f"volume {req.source} mount failed: {req.type} "
                             "volumes are not supported on this client yet "
                             "(ROADMAP A10.10)")
            return False
        return True

    def stop(self) -> None:
        """Server asked for a stop (desired_status=stop/evict)."""
        self.kill()
        self._kill_all()
        self.join()

    def kill(self) -> None:
        """The first half of ``stop``, which returns at once: deregister
        the services and signal every task to die (an agent stopping many
        allocs signals them all before it waits for any)."""
        self._destroyed = True
        self._deregister_services()
        for r in list(self.task_runners.values()):
            r.kill()

    def join(self, timeout: float = 5.0) -> None:
        """Wait for the runner's own threads: the alloc thread and the
        health watch (the task and check threads are joined by stop)."""
        for t in (self._thread, self._health_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)

    def _kill_all(self) -> None:
        for r in self.task_runners.values():
            r.kill()
        for r in self.task_runners.values():
            r.join(timeout=5.0)
        self._recompute_status()

    def _set_status(self, status: str, desc: str = "") -> None:
        with self._lock:
            self.client_status = status
            self.client_description = desc
        if self.on_update is not None:
            self.on_update(self)

    # -- status rollup (reference alloc_runner.go clientAlloc) --

    def _on_task_handle(self, task_name: str, handle_data) -> None:
        if self.state_db is not None:
            self.state_db.put_task_handle(self.alloc.id, task_name, handle_data)

    def _on_task_state(self, task_name: str, state: TaskState) -> None:
        with self._lock:
            self.task_states[task_name] = state
        self._recompute_status()

    def _recompute_status(self) -> None:
        with self._lock:
            main_names = [t.name for t in (self.tg.tasks if self.tg else [])
                          if t.lifecycle_hook in ("", LIFECYCLE_POSTSTART)]
            states = [self.task_states.get(n) for n in main_names]
            if any(s is not None and s.failed for s in self.task_states.values()):
                status = enums.ALLOC_CLIENT_FAILED
            elif any(s is None or s.state == "pending" for s in states):
                status = enums.ALLOC_CLIENT_PENDING
            elif any(s.state == "running" for s in states):
                status = enums.ALLOC_CLIENT_RUNNING
            elif all(s is not None and s.state == "dead" for s in states):
                status = enums.ALLOC_CLIENT_COMPLETE
            else:
                status = self.client_status
            changed = status != self.client_status
            self.client_status = status
        if self.on_update is not None:
            self.on_update(self)

    def finished_at(self) -> float:
        times = [s.finished_at for s in self.task_states.values() if s.finished_at]
        return max(times) if times else 0.0

    def is_terminal(self) -> bool:
        return self.client_status in (enums.ALLOC_CLIENT_COMPLETE,
                                      enums.ALLOC_CLIENT_FAILED)
