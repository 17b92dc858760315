"""Task drivers (a copy of ``nomad_tpu/client/drivers.py``; reference
plugins/drivers/driver.go:51 DriverPlugin and drivers/{mock,rawexec,exec}).

Drivers are in-process objects behind the interface the task runner
consumes: start_task -> TaskHandle {wait, kill, is_running}, with
``recover_task`` for a restarted agent's re-attach.

- mock:      scriptable fake (reference drivers/mock): run_for,
             exit_code, start_error, start_block_for, stdout_string;
- raw_exec:  a command under the out-of-process executor (executor.py),
             unconfined;
- exec:      the same with the executor's namespace and chroot
             isolation where the host allows it, and the reservation
             enforced by its cgroup limiter or polling watchdog;
- container: exec rooted in an image directory or tarball.

The executor runs as a plain script (``python -S executor.py -``, the
spec on stdin) in a new session: ``subprocess.Popen`` forks and execs
at once, so the agent never forks a copy of itself, which matters once
it has initialised CUDA, and a task launch imports no torch.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    err: str = ""
    oom_killed: bool = False

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


class TaskHandle:
    """A started task (reference plugins/drivers TaskHandle)."""

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        raise NotImplementedError

    def kill(self, grace_s: float = 5.0) -> None:
        raise NotImplementedError

    def is_running(self) -> bool:
        raise NotImplementedError

    def handle_data(self) -> Optional[dict]:
        """JSON-safe re-attach token persisted in the client state DB
        (reference TaskHandle serialization, plugins/drivers). None =
        this task cannot survive a client restart."""
        return None

    # a handle whose wait can be woken (``wake``) is waited on without a
    # timeout; the others are polled
    wakeable = False

    def wake(self) -> None:
        """Return a blocked ``wait`` (None) at once: its caller was
        killed. Sticky until a wait consumes it."""


def _proc_starttime(pid: int) -> Optional[int]:
    """Kernel start time of a pid (jiffies since boot, /proc/<pid>/stat
    field 22) — guards re-attach against pid reuse."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", errors="replace")
        # field 2 (comm) may contain spaces/parens: split after the last ')'
        fields = stat[stat.rindex(")") + 2:].split()
        return int(fields[19])  # starttime is field 22 overall
    except (OSError, ValueError, IndexError):
        return None


class DriverError(Exception):
    pass


def _safe_mount_dest(dest: str) -> str:
    """Normalize a job-controlled VolumeMount destination to a relative
    path that CANNOT escape the task root ('' when it would): '..'
    segments in a destination would otherwise let a job bind or symlink
    volume content over arbitrary host paths as root."""
    norm = os.path.normpath("/" + (dest or "")).lstrip("/")
    if not norm or norm == "." or norm.startswith(".."):
        return ""
    return norm


# ---------------------------------------------------------------------------
# mock driver
# ---------------------------------------------------------------------------


class _MockHandle(TaskHandle):
    """The mock task: done once ``run_for`` has passed, or killed. No
    thread of its own (the reference's runs a ``threading.Timer`` a
    task): ``wait`` sleeps on a condition until the deadline, a kill or
    a ``wake``, so an agent running thousands of mock tasks keeps no
    thread per task beyond its runner's."""

    wakeable = True

    def __init__(self, run_for: float, exit_code: int):
        self._deadline = time.monotonic() + run_for
        self._result = ExitResult(exit_code=exit_code)
        self._cond = threading.Condition()
        self._killed = False
        self._woken = False

    def _done(self) -> bool:
        return self._killed or time.monotonic() >= self._deadline

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done():
                if self._woken:
                    self._woken = False
                    return None
                now = time.monotonic()
                left = self._deadline - now
                if end is not None:
                    if now >= end:
                        return None
                    left = min(left, end - now)
                self._cond.wait(left)
            return self._result

    def kill(self, grace_s: float = 5.0) -> None:
        with self._cond:
            if not self._done():
                self._killed = True
                self._result = ExitResult(exit_code=137,
                                          signal=int(signal.SIGKILL))
            self._cond.notify_all()

    def wake(self) -> None:
        with self._cond:
            self._woken = True
            self._cond.notify_all()

    def is_running(self) -> bool:
        with self._cond:
            return not self._done()


class MockDriver:
    """Scriptable fake (reference drivers/mock): config keys
    run_for (s), exit_code, start_error, start_block_for (s)."""

    name = "mock"

    def start_task(self, task, env: Dict[str, str], task_dir: str,
                   io=None, mounts=None) -> TaskHandle:
        cfg = task.config or {}
        if io is not None:  # the task's log, as a real driver's
            io.write("stdout", str(cfg.get("stdout_string", "")).encode())
        if cfg.get("start_error"):
            raise DriverError(str(cfg["start_error"]))
        if cfg.get("start_block_for"):
            time.sleep(float(cfg["start_block_for"]))
        return _MockHandle(
            run_for=float(cfg.get("run_for", 0.0)),
            exit_code=int(cfg.get("exit_code", 0)),
        )

    def healthy(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# subprocess drivers
# ---------------------------------------------------------------------------


class _RecoveredProcHandle(TaskHandle):
    """Re-attached subprocess from a previous client process. The task
    is no longer our child, so the exit *code* is unobservable — only
    liveness is (the reference re-attaches through its executor
    subprocess and has the same constraint for orphaned tasks)."""

    def __init__(self, pid: int):
        self._pid = pid
        self._gone = threading.Event()

    def _alive(self) -> bool:
        try:
            os.kill(self._pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        deadline = None if timeout is None else time.time() + timeout
        while self._alive():
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.1)
        self._gone.set()
        # the exit status is unobservable: reporting success would turn
        # post-restart crashes into silent data loss, so surface it as a
        # failure and let the restart/reschedule policy decide
        return ExitResult(
            exit_code=0,
            err="task exited while re-attached; exit status unobservable")

    def kill(self, grace_s: float = 5.0) -> None:
        try:
            os.killpg(os.getpgid(self._pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.time() + grace_s
        while self._alive() and time.time() < deadline:
            time.sleep(0.05)
        if self._alive():
            try:
                os.killpg(os.getpgid(self._pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def is_running(self) -> bool:
        return self._alive()

    def handle_data(self) -> Optional[dict]:
        return {"pid": self._pid, "starttime": _proc_starttime(self._pid)}


def _read_status_file(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _status_to_result(path: str, missing_err: str,
                      st: Optional[dict] = None) -> ExitResult:
    """Final exit status from the executor's status file — the single
    reader the live, recovered, and restore paths all share. Callers
    that already read the file pass the dict to avoid a re-read race."""
    if st is None:
        st = _read_status_file(path)
    if st is None or "exit_code" not in st:
        return ExitResult(exit_code=1, err=missing_err)
    return ExitResult(exit_code=int(st.get("exit_code", 1)),
                      signal=int(st.get("signal", 0)),
                      oom_killed=bool(st.get("oom_killed", False)),
                      err=st.get("err", ""))


def _kill_task_group(status_file: str) -> None:
    """Backstop: SIGKILL the task's own process group (pgid == task pid,
    recorded in the status file at start) for the case where the
    executor was killed before it could escalate."""
    st = _read_status_file(status_file)
    pid = int(st.get("task_pid", 0)) if st else 0
    if pid > 0:
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class _ExecutorHandle(TaskHandle):
    """A task supervised by the out-of-process executor
    (client/executor.py; reference drivers/shared/executor). The driver
    tracks the EXECUTOR process; the real exit status comes from the
    status file the executor writes."""

    def __init__(self, proc: subprocess.Popen, status_file: str):
        self._proc = proc
        self.status_file = status_file

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        return _status_to_result(self.status_file,
                                 "executor died without writing status")

    def kill(self, grace_s: float = 5.0) -> None:
        if self._proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        try:
            self._proc.wait(grace_s + 2.0)  # executor grace + margin
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            _kill_task_group(self.status_file)
            self._proc.wait(5.0)

    def is_running(self) -> bool:
        return self._proc.poll() is None

    def handle_data(self) -> Optional[dict]:
        return {"executor_pid": self._proc.pid,
                "starttime": _proc_starttime(self._proc.pid),
                "status_file": self.status_file}


class _RecoveredExecutorHandle(_RecoveredProcHandle):
    """Re-attached executor from a previous agent process: liveness by
    pid, REAL exit status from the status file once it lands — the gap
    plain pid re-attach can't close."""

    def __init__(self, pid: int, status_file: str):
        super().__init__(pid)
        self.status_file = status_file

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        deadline = None if timeout is None else time.time() + timeout
        while self._alive():
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.1)
        return _status_to_result(self.status_file,
                                 "executor gone without writing status")

    def kill(self, grace_s: float = 5.0) -> None:
        super().kill(grace_s)
        if not self._alive():
            _kill_task_group(self.status_file)

    def handle_data(self) -> Optional[dict]:
        return {"executor_pid": self._pid,
                "starttime": _proc_starttime(self._pid),
                "status_file": self.status_file}


class _FinishedHandle(TaskHandle):
    """A task that finished while the agent was down: the recorded exit
    status replays immediately on wait()."""

    def __init__(self, result: ExitResult):
        self._result = result

    def wait(self, timeout: Optional[float] = None) -> Optional[ExitResult]:
        return self._result

    def kill(self, grace_s: float = 5.0) -> None:
        pass

    def is_running(self) -> bool:
        return False


class RawExecDriver:
    """No-isolation subprocess driver (reference drivers/rawexec).
    config: command (str), args (list). Tasks run under the
    out-of-process executor (client/executor.py), so they and their log
    capture survive agent restarts and report real exit codes across
    them."""

    name = "raw_exec"
    # raw_exec runs unconfined by contract (reference drivers/rawexec:
    # "no isolation"); exec enforces the reservation
    ENFORCE_RESOURCES = False
    ISOLATE = False

    def _build_env(self, env: Dict[str, str]) -> Dict[str, str]:
        return {**os.environ, **env}

    def start_task(self, task, env: Dict[str, str], task_dir: str,
                   io=None, mounts=None) -> TaskHandle:
        import sys

        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError(f"{self.name} requires config.command")
        argv = [str(command)] + [str(a) for a in cfg.get("args", [])]
        have_dir = os.path.isdir(task_dir)
        logs_dir = (io.log_dir if io is not None
                    else (os.path.join(task_dir, "logs") if have_dir
                          else tempfile.mkdtemp(prefix="nomad_tpu_logs_")))
        spec_dir = task_dir if have_dir else logs_dir
        spec = {
            "argv": argv,
            "env": self._build_env(env),
            "cwd": task_dir if have_dir else None,
            "task_name": task.name,
            "logs_dir": logs_dir,
            "max_files": io.max_files if io is not None else 10,
            "max_file_size_mb": (io.max_bytes // (1024 * 1024)
                                 if io is not None else 10),
            "grace_s": task.kill_timeout_s,
            "status_file": os.path.join(spec_dir, ".executor_status.json"),
        }
        if self.ENFORCE_RESOURCES and task.resources is not None:
            # the executor enforces what the scheduler fit: cgroup
            # memory/cpu limits, or its polling watchdog (executor.py)
            spec["memory_limit_mb"] = int(task.resources.memory_mb)
            spec["cpu_shares"] = int(task.resources.cpu)
        if self.ISOLATE and have_dir:
            # namespace+chroot confinement (executor.py setup_isolation);
            # the executor records the achieved level in the status file
            spec["isolation"] = True
            if task.user:
                spec["user"] = task.user
            rootfs = (task.config or {}).get("_rootfs", "")
            if rootfs:
                # container driver: root the task in this image instead
                # of host-dir binds (executor.py container flavor)
                spec["container_rootfs"] = rootfs
        if mounts and have_dir:
            # group volume mounts (client/volumes.py published paths):
            # isolated tasks get a real bind inside the chroot at the
            # task's VolumeMount destination; unconfined tasks get a
            # symlink in the task dir (the path rides the env either way,
            # NOMAD_ALLOC_VOLUME_*). On the unconfined path read_only is
            # ADVISORY (a symlink cannot enforce it) — enforcement needs
            # the exec driver's chroot binds, matching raw_exec's
            # documented no-isolation contract.
            binds = []
            for vm in (task.volume_mounts or []):
                src = mounts.get(vm.volume)
                if not src:
                    continue
                # volume NAMES are job-controlled too: the fallback must
                # go through the same traversal guard as the destination
                dest = (_safe_mount_dest(vm.destination)
                        or _safe_mount_dest(vm.volume))
                if not dest:
                    continue
                if spec.get("isolation"):
                    binds.append([os.path.realpath(src), dest,
                                  bool(vm.read_only)])
                else:
                    link = os.path.join(task_dir, dest)
                    os.makedirs(os.path.dirname(link), exist_ok=True)
                    if os.path.islink(link):
                        os.unlink(link)
                    if not os.path.exists(link):
                        os.symlink(os.path.realpath(src), link)
            if binds:
                spec["volume_binds"] = binds
        try:
            os.unlink(spec["status_file"])  # stale status from a prior run
        except OSError:
            pass
        try:
            # run the executor as a plain script under -S (skip
            # site/sitecustomize): it is stdlib-only, and accelerator-runtime
            # hooks in sitecustomize can add seconds of import latency per
            # task launch
            executor_path = os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "executor.py")
            proc = subprocess.Popen(
                [sys.executable, "-S", executor_path, "-"],
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True,  # its own group: killpg stops all
            )
            # spec over stdin: the task env (which inherits the agent's,
            # secrets included) never touches disk
            proc.stdin.write(json.dumps(spec).encode())
            proc.stdin.close()
        except OSError as e:
            raise DriverError(f"failed to start executor: {e}") from e
        return _ExecutorHandle(proc, spec["status_file"])

    def recover_task(self, handle_data: Optional[dict]) -> Optional[TaskHandle]:
        """Re-attach to a task started by a previous client process
        (reference client/state re-attach, task_runner.go:1212). The
        executor boundary makes finished-while-away tasks report their
        recorded exit status instead of vanishing."""
        if not handle_data:
            return None
        status_file = handle_data.get("status_file", "")
        pid = int(handle_data.get("executor_pid")
                  or handle_data.get("pid") or 0)
        if pid:
            alive = _RecoveredExecutorHandle(pid, status_file)
            recorded = handle_data.get("starttime")
            if alive.is_running() and (
                    recorded is None or _proc_starttime(pid) == recorded):
                return alive
        # executor gone: replay the recorded exit status if it landed
        if status_file:
            st = _read_status_file(status_file)
            if st is not None and "exit_code" in st:
                return _FinishedHandle(_status_to_result(status_file, "", st))
        return None

    def healthy(self) -> bool:
        return True


class ExecDriver(RawExecDriver):
    """Isolated subprocess driver (reference drivers/exec uses
    libcontainer namespaces/cgroups, executor_linux.go:36-42).

    Isolation matrix (executor.py setup_isolation; achieved level is
    recorded as `isolation` in the status file):
    - Linux root w/ CAP_SYS_ADMIN ("ns+chroot"): private mount + PID +
      IPC namespaces, chroot into the task dir with the system dirs
      bind-mounted read-only, a private /proc (the task is PID 1 and
      sees only its own tree), optional setuid drop to task.user;
    - anywhere else ("none"): session isolation + scrubbed env (task
      env only plus a usable PATH — the reference injects a default
      task PATH the same way).
    Either way the scheduler's memory/cpu reservation is ENFORCED by
    the executor: cgroup v2/v1 limits where the hierarchy is writable,
    else a polling watchdog that evicts the task group past its
    reservation (client/executor.py CgroupLimiter)."""

    name = "exec"
    ENFORCE_RESOURCES = True
    ISOLATE = True

    def _build_env(self, env: Dict[str, str]) -> Dict[str, str]:
        return {"PATH": os.environ.get("PATH", os.defpath), **env}


class ContainerDriver(ExecDriver):
    """Image-rooted container driver — the docker-class capability
    shape (reference drivers/docker/driver.go:306) without an image
    daemon: config.image names a rootfs DIRECTORY (or a .tar/.tar.gz
    the driver extracts once, cached by path+mtime); the executor roots
    the task in that image read-only with its own writable
    local/secrets/tmp and volume binds inside, under the same
    mount/PID/IPC namespace + cgroup envelope as the exec driver.
    Requires namespace support; unlike exec it does NOT degrade to an
    unconfined launch — a container task without isolation support
    fails to start (running an image's payload against the host root
    would be silently wrong)."""

    name = "container"

    # realpath -> (mtime, extraction dir): one live extraction per
    # image file; a rebuild at the same path (new mtime) supersedes and
    # evicts the old one instead of leaking a full rootfs in tmp
    _image_cache: Dict[str, tuple] = {}
    _image_lock = threading.Lock()

    def start_task(self, task, env: Dict[str, str], task_dir: str,
                   io=None, mounts=None) -> TaskHandle:
        cfg = task.config or {}
        image = str(cfg.get("image", ""))
        if not image:
            raise DriverError("container driver requires config.image")
        rootfs = self._resolve_image(image)
        task = _copy_task_with_config(task, dict(cfg))
        task.config["_rootfs"] = rootfs
        return super().start_task(task, env, task_dir, io=io,
                                  mounts=mounts)

    def _resolve_image(self, image: str) -> str:
        if os.path.isdir(image):
            return image
        if not os.path.isfile(image):
            raise DriverError(f"container image {image!r} not found")
        try:
            path = os.path.realpath(image)
            mtime = os.path.getmtime(image)
        except OSError as e:
            raise DriverError(f"container image {image!r}: {e}") from e
        with self._image_lock:
            cached = self._image_cache.get(path)
            if cached and cached[0] == mtime and os.path.isdir(cached[1]):
                return cached[1]
            import tarfile

            dst = tempfile.mkdtemp(prefix="nomadtpu-img-")
            try:
                with tarfile.open(image) as tar:
                    tar.extractall(dst, filter="data")
            except Exception as e:
                shutil.rmtree(dst, ignore_errors=True)
                raise DriverError(
                    f"container image {image!r} extract failed: {e}") from e
            if cached is not None:
                shutil.rmtree(cached[1], ignore_errors=True)
            self._image_cache[path] = (mtime, dst)
            return dst

    @classmethod
    def evict_image_cache(cls) -> None:
        """Drop every cached extraction (agent shutdown; also keeps
        long test runs from accumulating rootfs copies in tmp)."""
        with cls._image_lock:
            entries = list(cls._image_cache.values())
            cls._image_cache = {}
        for _mtime, dst in entries:
            shutil.rmtree(dst, ignore_errors=True)


def _copy_task_with_config(task, config: dict):
    import copy as _copy

    new = _copy.copy(task)
    new.config = config
    return new


# ---------------------------------------------------------------------------
# registry (reference client/pluginmanager/drivermanager)
# ---------------------------------------------------------------------------

_BUILTIN = {d.name: d for d in (MockDriver(), RawExecDriver(), ExecDriver(),
                                ContainerDriver())}


def get_driver(name: str):
    drv = _BUILTIN.get(name)
    if drv is None:
        raise DriverError(f"unknown driver {name!r}")
    return drv


def available_drivers() -> List[str]:
    return [name for name, d in _BUILTIN.items() if d.healthy()]
