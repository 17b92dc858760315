"""Task runner (a copy of ``nomad_tpu/client/task_runner.py``; reference
client/allocrunner/taskrunner/task_runner.go).

Drives one task through its lifecycle on one thread: the task's env and
interpolated config, ``driver.start_task``, the wait, the restart
policy's decision, then again or dead. Restarts follow the reference's
restart tracker: ``attempts`` restarts within ``interval_s``; past them
the task fails (mode fail) or waits out the interval (mode delay).

Trimmed: plugins run as tasks (the ``plugin`` stanza, reference
client/dynamicplugins) wait for ROADMAP A10.10; such a task fails at
once with a message naming it, so it never runs unregistered.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..structs.alloc import TaskEvent, TaskState
from ..structs.job import RestartPolicy, Task
from . import taskenv
from .drivers import DriverError, get_driver


class TaskRunner:
    def __init__(self, alloc, task: Task, node, task_dir: str,
                 shared_dir: str = "",
                 on_state_change: Optional[Callable] = None,
                 restart_policy: Optional[RestartPolicy] = None,
                 on_handle: Optional[Callable] = None,
                 recovered_handle=None,
                 logs_dir: str = "",
                 volume_mounts=None):
        self.alloc = alloc
        self.task = task
        self.node = node
        self.task_dir = task_dir
        self.shared_dir = shared_dir
        self.logs_dir = logs_dir
        # group volume name -> host path published for this alloc
        # (client/volumes.py VolumeManager; reference taskrunner
        # volume_hook mounts)
        self.volume_mounts = volume_mounts or {}
        self.on_state_change = on_state_change
        self.policy = restart_policy or RestartPolicy()
        # persistence: on_handle(task_name, handle_data) records the
        # driver handle for restart re-attach (client/state_db.py);
        # recovered_handle is a live handle from a previous client process
        self.on_handle = on_handle
        self.recovered_handle = recovered_handle

        self.state = TaskState()
        self._handle = None
        self._killed = threading.Event()
        self._dead = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restart_times: list = []  # timestamps inside current interval

    # -- lifecycle --

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"task-{self.alloc.id[:8]}-{self.task.name}")
        self._thread.start()

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # never strand the alloc non-terminal
            self._fail(f"task runner crashed: {e!r}")

    def _run(self) -> None:
        self._event("Received", "task received by client")
        if self.task.plugin:
            self._fail("plugin tasks are not supported yet (ROADMAP A10.10)")
            return
        try:
            driver = get_driver(self.task.driver)
        except DriverError as e:
            self._fail(f"driver error: {e}")
            return

        while not self._killed.is_set():
            if self.recovered_handle is not None:
                # restart re-attach: the task is already running from a
                # previous client process; skip straight to the wait loop
                self._handle = self.recovered_handle
                self.recovered_handle = None
                self._event("Restored", "re-attached to running task")
            else:
                env = taskenv.build_env(self.alloc, self.task, self.node,
                                        self.task_dir, self.shared_dir)
                for vname, vpath in self.volume_mounts.items():
                    safe = "".join(c if c.isalnum() else "_"
                                   for c in vname).upper()
                    env[f"NOMAD_ALLOC_VOLUME_{safe}"] = vpath
                config = taskenv.interpolate_config(self.task.config or {},
                                                    self.node, env)
                run_task = _interpolated_task(self.task, config)

                try:
                    # io= is part of the driver interface (drivers.py):
                    # every driver takes it, logmon-less ones ignore it
                    self._handle = driver.start_task(run_task, env,
                                                     self.task_dir,
                                                     io=self._logmon(),
                                                     mounts=self.volume_mounts)
                except DriverError as e:
                    self._event("Driver Failure", str(e))
                    if not self._should_restart(failed_start=True):
                        self._fail(f"failed to start task: {e}")
                        return
                    continue

            if self.on_handle is not None:
                self.on_handle(self.task.name, self._handle.handle_data())

            self.state.state = "running"
            self.state.started_at = self.state.started_at or time.time()
            self._event("Started", "task started by client")
            self._notify()

            # a wakeable handle (the mock's) is waited on without a
            # timeout, and kill() wakes it; the others are polled
            poll = None if self._handle.wakeable else 0.2
            result = None
            while result is None and not self._killed.is_set():
                result = self._handle.wait(timeout=poll)
            if self._killed.is_set():
                break
            if result.oom_killed:
                # reference drivers emit TaskEventOOM ("OOM Killed")
                self._event("OOM Killed",
                            "task exceeded its memory reservation and "
                            "was killed", exit_code=result.exit_code)
            self._event("Terminated", f"exit code {result.exit_code}",
                        exit_code=result.exit_code)
            if result.successful():
                self._die(failed=False)
                return
            if not self._should_restart():
                self._event("Not Restarting", "exceeded restart policy")
                self._die(failed=True)
                return

        # killed
        if self._handle is not None:
            self._handle.kill(self.task.kill_timeout_s)
        self._event("Killed", "task killed by client")
        self._die(failed=False)

    def _logmon(self):
        """Rotated stdout/stderr capture per start attempt (reference
        client/logmon; LogConfig knobs ride the task)."""
        if not self.logs_dir:
            return None
        from .logmon import LogMon

        lc = self.task.log_config
        return LogMon(self.logs_dir, self.task.name,
                      max_files=lc.max_files,
                      max_file_size_mb=lc.max_file_size_mb)

    def kill(self) -> None:
        self._killed.set()
        handle = self._handle
        if handle is not None:
            handle.wake()

    def join(self, timeout: float = 10.0) -> None:
        t = self._thread
        if t is None:
            return
        try:
            t.join(timeout)
        except RuntimeError:
            # created-but-not-yet-started: the alloc runner's stop()
            # raced its own _run thread between make_runner() and
            # r.start() — nothing to wait for
            pass

    def wait_dead(self, timeout: float = 10.0) -> bool:
        return self._dead.wait(timeout)

    # -- restart policy (reference restarts/restarts.go) --

    def _should_restart(self, failed_start: bool = False) -> bool:
        now = time.time()
        window_start = now - self.policy.interval_s
        self._restart_times = [t for t in self._restart_times if t >= window_start]
        if len(self._restart_times) >= max(self.policy.attempts, 0):
            if self.policy.mode == "delay":
                # wait out the interval, then the window clears
                # (attempts=0 delay-mode waits a full interval each time)
                oldest = self._restart_times[0] if self._restart_times else now
                delay = max(0.0, oldest + self.policy.interval_s - now)
                if self._killed.wait(delay):
                    return False
            else:
                return False
        self._restart_times.append(time.time())
        self.state.restarts += 1
        self.state.last_restart = time.time()
        self._event("Restarting", "task restarting",
                    restart_reason="restart policy")
        self._notify()
        if self._killed.wait(self.policy.delay_s):
            return False
        return True

    # -- state plumbing --

    def _event(self, etype: str, message: str, **kw) -> None:
        self.state.events.append(TaskEvent(type=etype, time=time.time(),
                                           message=message, **kw))

    def _die(self, failed: bool) -> None:
        self.state.state = "dead"
        self.state.failed = failed
        self.state.finished_at = time.time()
        self._dead.set()
        self._notify()

    def _fail(self, message: str) -> None:
        self._event("Driver Failure", message)
        self._die(failed=True)

    def _notify(self) -> None:
        if self.on_state_change is not None:
            self.on_state_change(self.task.name, self.state)


def _interpolated_task(task: Task, config: dict) -> Task:
    """Copy of the task carrying the interpolated driver config."""
    return Task(
        name=task.name, driver=task.driver, config=config, env=task.env,
        resources=task.resources, kill_timeout_s=task.kill_timeout_s,
        user=task.user, meta=task.meta,
        volume_mounts=list(task.volume_mounts),
        plugin=task.plugin,
    )
