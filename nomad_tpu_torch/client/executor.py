"""Out-of-process task executor (a copy of
``nomad_tpu/client/executor.py``; reference drivers/shared/executor/:
the re-exec'd `nomad executor` subprocess supervising every exec/rawexec
task, executor.go + grpc control plane).

The drivers run it as a plain script, `python -S executor.py -`, with
the spec on stdin: it is standard-library only and imports neither
torch nor the package, so a task launch pays no torch import and never
touches the card. `python executor.py <spec.json>` reads the spec from
a file. The executor
is its own session leader; the task runs as its child in the same
process group. It owns the task's rotated log capture and writes the
task's exit status to a status file — so, unlike in-agent supervision:

- the task AND its log capture survive client-agent restarts, and
- a re-attaching agent reads the REAL exit code of a task that finished
  while the agent was down (the in-process re-attach path can only
  observe liveness).

Control surface is the filesystem (spec in, status out, signals), not
gRPC — one supervisor per task needs nothing richer, and the driver
side stays transport-free.

Resource enforcement (reference drivers/shared/executor/
executor_linux.go:36-42, which uses libcontainer cgroups): when the
spec carries memory_limit_mb / cpu_shares, the executor places the task
in its own cgroup — v2 (memory.max, cpu.weight) when the unified
hierarchy is writable, else v1 (memory.limit_in_bytes, cpu.shares) —
and reports kernel OOM kills in the status file. Where no cgroup
hierarchy is writable, a polling watchdog sums the task process
group's RSS and SIGKILLs the group past the memory reservation, so a
placement's limits are enforced on every platform, not just ones that
grant cgroup write access.

spec.json: {argv, env, cwd, task_name, logs_dir, max_files,
            max_file_size_mb, grace_s, status_file,
            memory_limit_mb, cpu_shares}
status file (atomic rename): {exit_code, signal, oom_killed, err,
                              task_pid, finished_at}
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

_CG2_ROOT = "/sys/fs/cgroup"

# --------------------------------------------------------------------------
# Namespace + chroot isolation (reference drivers/shared/executor/
# executor_linux.go:36-42: libcontainer mount/PID/IPC namespaces + chroot;
# ours composes the same primitives from os.unshare + bind mounts + the
# util-linux `unshare` wrapper instead of vendoring a container runtime).
#
# Layering: the EXECUTOR unshares its own mount namespace and bind-mounts
# the system directories read-only into the task dir (so the host mount
# table never sees them and they vanish with the executor); the TASK then
# launches under `unshare --fork --pid --mount --ipc --root=<taskdir>
# --mount-proc` so it is PID 1 of a private PID namespace, sees only its
# own /proc, and cannot reach any host path outside the task dir. Where
# namespaces are unavailable (no CAP_SYS_ADMIN, seccomp) the executor
# degrades to plain session+cgroup supervision and records
# isolation="none" in the status file.
# --------------------------------------------------------------------------

# reference drivers/shared/executor default chroot env (executor docs
# chroot_env), plus /opt (interpreter installs live there on this image)
CHROOT_RO_DIRS = ("bin", "sbin", "usr", "lib", "lib32", "lib64", "etc",
                  "opt", "run")


def _libc_mount():
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)

    def mount(src, dst, fstype, flags, data=None):
        r = libc.mount(src.encode() if src else None, dst.encode(),
                       fstype.encode() if fstype else None, flags,
                       data.encode() if data else None)
        if r != 0:
            import ctypes as _c
            err = _c.get_errno()
            raise OSError(err, os.strerror(err), dst)
    return mount


MS_RDONLY = 0x1
MS_REMOUNT = 0x20
MS_BIND = 0x1000
MS_REC = 0x4000
MS_PRIVATE = 0x40000


def setup_isolation(spec: dict):
    """Prepare the task root and return (argv_prefix, workdir) for the
    isolated launch, or (None, cwd) when isolation can't be established.
    MUST run before any threads start (it unshares the calling process's
    mount namespace)."""
    import shutil

    task_dir = spec.get("cwd") or ""
    root = task_dir
    rootfs = spec.get("container_rootfs") or ""
    unshare_bin = shutil.which("unshare")
    if not root or unshare_bin is None or not hasattr(os, "unshare"):
        return None, spec.get("cwd")
    try:
        mount = _libc_mount()
        os.unshare(os.CLONE_NEWNS)
        # our binds must not propagate back to the host mount table
        mount(None, "/", None, MS_REC | MS_PRIVATE)
        if rootfs:
            # CONTAINER flavor (the docker-class shape minus the image
            # daemon, reference drivers/docker/driver.go:306): the task
            # roots in a provided IMAGE rootfs — read-only, with the
            # task's own writable dirs bound in — instead of the host
            # dirs. Mountpoint dirs are created in the image first (a
            # benign, idempotent normalization) because nothing can be
            # created once the view is read-only.
            image = os.path.realpath(rootfs)
            norm_dirs = ["local", "secrets", "tmp", "dev", "dev/shm",
                         "proc", "alloc"]
            # volume-mount destinations must pre-exist too: nothing can
            # be created once the view is read-only
            for _, dest, _ro in spec.get("volume_binds") or []:
                norm_dirs.append(dest.lstrip("/"))
            for d in norm_dirs:
                os.makedirs(os.path.join(image, d), exist_ok=True)
            for name in ("null", "zero", "full", "random", "urandom",
                         "tty"):
                p = os.path.join(image, "dev", name)
                if not os.path.exists(p):
                    with open(p, "w"):
                        pass
            view = os.path.join(task_dir, ".rootfs")
            os.makedirs(view, exist_ok=True)
            mount(image, view, None, MS_BIND | MS_REC)
            try:  # protect the shared image from the task
                mount(None, view, None,
                      MS_REMOUNT | MS_BIND | MS_RDONLY | MS_REC)
            except OSError:
                pass
            root = view
            for d in ("local", "secrets", "tmp"):
                src = os.path.join(task_dir, d)
                if os.path.isdir(src):
                    mount(src, os.path.join(view, d), None, MS_BIND)
        for d in () if rootfs else CHROOT_RO_DIRS:
            src = "/" + d
            if not os.path.isdir(src) or os.path.islink(src):
                # symlinked /bin -> usr/bin etc: recreate the link so
                # PATH lookups resolve inside the root
                if os.path.islink(src):
                    dst = os.path.join(root, d)
                    if not os.path.lexists(dst):
                        os.symlink(os.readlink(src), dst)
                continue
            dst = os.path.join(root, d)
            os.makedirs(dst, exist_ok=True)
            mount(src, dst, None, MS_BIND | MS_REC)
            try:  # write-protect; recursive ro needs newer kernels — best effort
                mount(None, dst, None,
                      MS_REMOUNT | MS_BIND | MS_RDONLY | MS_REC)
            except OSError:
                pass
        # devices: a MINIMAL /dev of file-binds (the reference's
        # libcontainer device allowlist is the same standard set) — a
        # recursive host-/dev bind would hand the task the host's block
        # and memory devices, a chroot escape for a root-inside task
        dev = os.path.join(root, "dev")
        os.makedirs(dev, exist_ok=True)
        for name in ("null", "zero", "full", "random", "urandom", "tty"):
            src = "/dev/" + name
            if not os.path.exists(src):
                continue
            dst = os.path.join(dev, name)
            try:
                if not os.path.exists(dst):
                    with open(dst, "w"):
                        pass
                mount(src, dst, None, MS_BIND)
            except OSError:
                continue
        os.makedirs(os.path.join(dev, "shm"), exist_ok=True)
        os.makedirs(os.path.join(root, "proc"), exist_ok=True)
        os.makedirs(os.path.join(root, "tmp"), exist_ok=True)
        # group volume mounts bind INTO the chroot at their VolumeMount
        # destinations (reference csimanager mounts + libcontainer
        # binds). Defense in depth: the driver already normalizes the
        # job-controlled destination, but re-anchor + containment-check
        # here so a traversal can never bind over host paths. read_only
        # remount: recursive ro needs a newer kernel, so fall back to a
        # non-recursive remount (covers the bind itself, not submounts)
        # before giving up; a bind left RW is recorded in the spec and
        # surfaces in the task's status file rather than degrading
        # silently.
        rootr = os.path.realpath(root)
        for src, dest, ro in spec.get("volume_binds") or []:
            dst = os.path.normpath(
                os.path.join(rootr, (dest or "").lstrip("/")))
            if dst == rootr or not dst.startswith(rootr + os.sep):
                continue
            os.makedirs(dst, exist_ok=True)
            mount(src, dst, None, MS_BIND | MS_REC)
            if ro:
                try:
                    mount(None, dst, None,
                          MS_REMOUNT | MS_BIND | MS_RDONLY | MS_REC)
                except OSError:
                    try:
                        mount(None, dst, None,
                              MS_REMOUNT | MS_BIND | MS_RDONLY)
                    except OSError:
                        spec.setdefault("_ro_degraded", []).append(
                            dest or "/")
    except OSError:
        return None, spec.get("cwd")
    prefix = [unshare_bin, "--fork", "--pid", "--mount", "--ipc",
              "--kill-child", f"--root={root}", "--wd=/",
              "--mount-proc=/proc"]
    user = spec.get("user")
    if user and os.geteuid() == 0:
        try:
            import pwd

            pw = pwd.getpwnam(user)
            setpriv = shutil.which("setpriv")
            if setpriv is None:
                raise KeyError("setpriv unavailable")
            # the task's writable dirs must follow the identity drop
            for d in ("local", "secrets", "tmp"):
                p = os.path.join(root, d)
                if os.path.isdir(p):
                    os.chown(p, pw.pw_uid, pw.pw_gid)
            prefix += [setpriv, f"--reuid={pw.pw_uid}",
                       f"--regid={pw.pw_gid}", "--clear-groups"]
            spec["_iso_user"] = user
        except (KeyError, OSError):
            # unknown user / no setpriv / chown failure: stay root
            # inside the namespaces, VISIBLY (status isolation_user)
            spec["_iso_user"] = "root"
    return prefix, None


class CgroupLimiter:
    """Best-effort cgroup memory/cpu enforcement for one task."""

    def __init__(self, task_name: str, pid: int, memory_mb: int,
                 cpu_shares: int):
        self.active = False
        self._dirs = []
        self._v2 = False
        safe = "".join(c if c.isalnum() or c in "_-" else "_"
                       for c in task_name)[:64]
        tag = f"nomadtpu-{safe}-{pid}"
        try:
            if os.path.exists(os.path.join(_CG2_ROOT, "cgroup.controllers")):
                self._setup_v2(tag, pid, memory_mb, cpu_shares)
            else:
                self._setup_v1(tag, pid, memory_mb, cpu_shares)
        except OSError:
            self.cleanup()
            self.active = False

    @staticmethod
    def _write(path: str, value: str) -> None:
        with open(path, "w") as f:
            f.write(value)

    def _setup_v2(self, tag: str, pid: int, memory_mb: int,
                  cpu_shares: int) -> None:
        d = os.path.join(_CG2_ROOT, tag)
        os.makedirs(d, exist_ok=True)
        self._dirs.append(d)
        if memory_mb:
            self._write(os.path.join(d, "memory.max"),
                        str(memory_mb * 1024 * 1024))
            try:  # one OOM kills the whole task group, like the reference
                self._write(os.path.join(d, "memory.oom.group"), "1")
            except OSError:
                pass
        if cpu_shares:
            # map cpu MHz shares onto cpu.weight's [1, 10000] like
            # systemd maps shares: weight = shares/10240*10000 clamped
            w = max(1, min(10000, cpu_shares * 10000 // 10240))
            try:
                self._write(os.path.join(d, "cpu.weight"), str(w))
            except OSError:
                pass
        self._write(os.path.join(d, "cgroup.procs"), str(pid))
        self._v2 = True
        self.active = True

    def _setup_v1(self, tag: str, pid: int, memory_mb: int,
                  cpu_shares: int) -> None:
        if memory_mb:
            d = os.path.join(_CG2_ROOT, "memory", tag)
            os.makedirs(d, exist_ok=True)
            self._dirs.append(d)
            self._write(os.path.join(d, "memory.limit_in_bytes"),
                        str(memory_mb * 1024 * 1024))
            self._write(os.path.join(d, "cgroup.procs"), str(pid))
            self.active = True
        if cpu_shares:
            d = os.path.join(_CG2_ROOT, "cpu", tag)
            try:
                os.makedirs(d, exist_ok=True)
                self._dirs.append(d)
                self._write(os.path.join(d, "cpu.shares"), str(cpu_shares))
                self._write(os.path.join(d, "cgroup.procs"), str(pid))
                self.active = True
            except OSError:
                pass

    def add_group(self, pgid: int) -> None:
        """Sweep every live member of the task's process group into the
        cgroup (the isolated launch interposes an `unshare` wrapper, so
        the real task is a grandchild that may have forked before the
        wrapper pid was written)."""
        try:
            pids = [p for p in os.listdir("/proc") if p.isdigit()]
        except OSError:
            return
        for p in pids:
            try:
                with open(f"/proc/{p}/stat", "rb") as f:
                    fields = f.read().split(b") ")[-1].split()
                if int(fields[2]) != pgid:
                    continue
            except (OSError, ValueError, IndexError):
                continue
            for d in self._dirs:
                try:
                    self._write(os.path.join(d, "cgroup.procs"), p)
                except OSError:
                    pass

    def oom_killed(self, sigkilled: bool = True) -> bool:
        """Did the kernel OOM-kill inside this cgroup? The v1 failcnt
        fallback only counts when the task actually died by SIGKILL —
        a nonzero failcnt alone can just mean reclaim pressure."""
        for d in self._dirs:
            try:
                if self._v2:
                    with open(os.path.join(d, "memory.events")) as f:
                        for line in f:
                            k, _, v = line.partition(" ")
                            if k == "oom_kill" and int(v) > 0:
                                return True
                elif os.path.basename(os.path.dirname(d)) == "memory":
                    saw_counter = False
                    with open(os.path.join(d, "memory.oom_control")) as f:
                        for line in f:
                            k, _, v = line.partition(" ")
                            if k == "oom_kill":
                                saw_counter = True
                                if int(v) > 0:
                                    return True
                    # only kernels too old to expose the oom_kill
                    # counter fall back to failcnt — and only for a
                    # SIGKILL death (a brushed limit that reclaim
                    # satisfied is not an OOM kill)
                    if not saw_counter and sigkilled:
                        with open(os.path.join(d, "memory.failcnt")) as f:
                            if int(f.read().strip() or 0) > 0:
                                return True
            except (OSError, ValueError):
                continue
        return False

    def cleanup(self) -> None:
        # SIGKILL delivery is asynchronous: dying members keep the
        # cgroup busy briefly, so retry before giving up (a swallowed
        # EBUSY would leak one cgroup per task run)
        for d in self._dirs:
            for _ in range(10):
                try:
                    os.rmdir(d)
                    break
                except FileNotFoundError:
                    break
                except OSError:
                    time.sleep(0.05)
        self._dirs = []


def group_rss_bytes(pgid: int) -> int:
    """Total resident memory of the task's process group (the polling
    watchdog's view when no cgroup is writable). Prefers per-process
    PSS (smaps_rollup) so shared/CoW pages sum correctly across a
    forking task instead of being counted once per child; falls back
    to stat RSS where smaps_rollup is unavailable."""
    total = 0
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return 0
    for p in pids:
        try:
            with open(f"/proc/{p}/stat", "rb") as f:
                fields = f.read().split(b") ")[-1].split()
            # after stripping "pid (comm)": field[2] is pgrp,
            # field[21] is rss pages
            if int(fields[2]) != pgid:
                continue
            rss = int(fields[21]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            continue
        try:
            with open(f"/proc/{p}/smaps_rollup", "rb") as f:
                for line in f:
                    if line.startswith(b"Pss:"):
                        rss = int(line.split()[1]) * 1024
                        break
        except (OSError, ValueError, IndexError):
            pass  # no smaps_rollup: stat RSS stands
        total += rss
    return total


def _write_status(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run(spec_path: str) -> int:
    if spec_path == "-":
        # spec over stdin: agent secrets in the env never touch disk
        spec = json.load(sys.stdin)
    else:
        with open(spec_path) as f:
            spec = json.load(f)

    # isolation must be established before ANY thread exists (it
    # unshares this process's mount namespace and bind-mounts the task
    # root); LogMon starts reader threads
    iso_prefix, iso_cwd = None, spec.get("cwd")
    if spec.get("isolation"):
        iso_prefix, iso_cwd = setup_isolation(spec)
    if spec.get("container_rootfs") and iso_prefix is None:
        # a container task must not silently run against the host root
        _write_status(spec["status_file"], {
            "exit_code": 127, "signal": 0, "isolation": "none",
            "err": "container driver requires namespace support",
            "task_pid": 0, "finished_at": time.time()})
        return 1

    try:
        from .logmon import LogMon
    except ImportError:
        # spawned as a plain script (python -S executor.py): the script
        # dir is on sys.path, the package is not
        from logmon import LogMon

    lm = LogMon(spec["logs_dir"], spec["task_name"],
                max_files=int(spec.get("max_files", 10)),
                max_file_size_mb=int(spec.get("max_file_size_mb", 10)))
    stdout_fd = lm.stream_fd("stdout")
    stderr_fd = lm.stream_fd("stderr")
    status_file = spec["status_file"]
    grace = float(spec.get("grace_s", 5.0))

    argv = spec["argv"]
    if iso_prefix is not None:
        argv = iso_prefix + argv
    # the task gets ITS OWN process group (pgid == task pid) so
    # escalation can killpg the whole task tree — including
    # TERM-trapping grandchildren — without nuking the executor before
    # it records the exit status. process_group (3.11+) rather than a
    # preexec_fn: the logmon reader threads are already running and
    # fork+preexec with live threads can deadlock. Pre-3.11, setsid
    # (start_new_session, C-level, thread-safe) gives the same
    # pgid == task pid property via a fresh session.
    if sys.version_info >= (3, 11):
        group_kw = {"process_group": 0}
    else:
        group_kw = {"start_new_session": True}
    try:
        proc = subprocess.Popen(
            argv,
            env=spec.get("env") or None,
            cwd=iso_cwd or None,
            stdout=stdout_fd, stderr=stderr_fd,
            **group_kw,
        )
    except OSError as e:
        lm.close_parent_fds()
        _write_status(status_file, {"exit_code": 127, "signal": 0,
                                    "err": f"failed to start: {e}",
                                    "task_pid": 0,
                                    "finished_at": time.time()})
        return 1
    lm.close_parent_fds()
    _write_status(status_file, {"task_pid": proc.pid})

    mem_mb = int(spec.get("memory_limit_mb") or 0)
    cpu_shares = int(spec.get("cpu_shares") or 0)
    limiter = None
    oom = {"killed": False}
    if (mem_mb or cpu_shares) and not spec.get("disable_cgroups"):
        # disable_cgroups exists so tests can exercise the polling
        # watchdog on hosts where cgroups ARE writable
        limiter = CgroupLimiter(spec["task_name"], proc.pid, mem_mb,
                                cpu_shares)
        if limiter.active and iso_prefix is not None:
            # the task is the unshare wrapper's CHILD and may have been
            # forked before the wrapper pid landed in cgroup.procs;
            # sweep the whole process group in to close the race
            limiter.add_group(proc.pid)
        if not limiter.active:
            limiter = None
    # watchdog margin: the polling path can't account as precisely as
    # the kernel, so allow 10% + 16MB of slack before evicting
    watchdog_limit = (mem_mb * 1024 * 1024 * 11 // 10 + (16 << 20)
                      if mem_mb and limiter is None else 0)

    stopping = {"flag": False}

    def on_term(_sig, _frm):
        stopping["flag"] = True
        try:
            os.killpg(proc.pid, signal.SIGTERM)  # forward to the task tree
        except (ProcessLookupError, PermissionError):
            pass

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    code = None
    deadline = None
    next_poll = 0.0
    while code is None:
        try:
            code = proc.wait(timeout=0.2)
        except subprocess.TimeoutExpired:
            # memory polls on a 1s cadence — the 0.2s loop exists for
            # stop/grace responsiveness, and a full /proc walk at 5Hz
            # per task would tax busy nodes
            if watchdog_limit and not stopping["flag"] \
                    and time.monotonic() >= next_poll:
                next_poll = time.monotonic() + 1.0
                if group_rss_bytes(proc.pid) > watchdog_limit:
                    oom["killed"] = True
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        proc.kill()
            if stopping["flag"]:
                if deadline is None:
                    deadline = time.monotonic() + grace
                elif time.monotonic() >= deadline:
                    try:  # escalate on the whole task group
                        os.killpg(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        proc.kill()
    # the task group may still hold TERM-trapping descendants even after
    # the leader exited; sweep them so nothing leaks
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    # the group is gone, so its pipes are at EOF: let the log readers
    # (daemon threads) drain them before the status says the task is
    # over and this process exits under them (the reference's executor
    # does not wait, and can lose a task's last output)
    lm.join(timeout=5.0)
    status = {"task_pid": proc.pid, "finished_at": time.time()}
    if code < 0:
        status.update(exit_code=128 - code, signal=-code)
    else:
        status.update(exit_code=code, signal=0)
    if limiter is not None:
        # an executor-initiated stop escalation is never an OOM, even
        # if the task once brushed its limit
        if not stopping["flag"] and \
                limiter.oom_killed(code < 0 and -code == signal.SIGKILL):
            oom["killed"] = True
        limiter.cleanup()
    if oom["killed"]:
        status["oom_killed"] = True
        status["err"] = "task exceeded its memory reservation"
    if spec.get("isolation"):
        status["isolation"] = ("ns+chroot" if iso_prefix is not None
                               else "none")
        if spec.get("user"):
            # the identity the task ACTUALLY ran as — a requested drop
            # that couldn't be applied must be visible, not silent
            status["isolation_user"] = spec.get("_iso_user", "root")
        if spec.get("_ro_degraded"):
            # read_only volume binds the kernel would not remount ro
            # (even non-recursively): the task ran with these WRITABLE
            status["readonly_degraded"] = list(spec["_ro_degraded"])
    _write_status(status_file, status)
    return 0


def main() -> int:
    if len(sys.argv) != 2:
        print("usage: python -S executor.py <spec.json | ->",
              file=sys.stderr)
        return 2
    return run(sys.argv[1])


if __name__ == "__main__":
    sys.exit(main())
