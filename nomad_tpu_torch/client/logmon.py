"""Per-task log capture with rotation (a copy of
``nomad_tpu/client/logmon.py``; reference client/logmon/).

The capture is a pipe drained by a reader thread into
`<alloc>/logs/<task>.{stdout,stderr}.<n>` files rotated by size with a
bounded file count (Task.LogConfig max_files/max_file_size_mb). Rotation
state is derived from the files on disk, so a restarted agent appends to
the newest file instead of clobbering history.

The executor (executor.py) imports this module as a plain script beside
it, so it stays standard-library only: it imports neither torch nor the
package.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict


class _Rotator:
    """Append bytes into <prefix>.<n>, advancing n at max_bytes and
    pruning to max_files (reference logmon/logging/rotator.go)."""

    def __init__(self, prefix: str, max_files: int, max_bytes: int):
        self.prefix = prefix
        self.max_files = max(1, max_files)
        self.max_bytes = max(1, max_bytes)
        self._idx = self._newest_index()
        # unbuffered: a live `alloc logs -f` / UI tail must see output
        # as the task emits it, not when an 8KB userspace buffer fills
        self._file = open(self._path(self._idx), "ab", buffering=0)
        # finish any prune a crash interrupted: files at or below the
        # persisted through_index are already counted in the pruned base
        _, through = _read_pruned(prefix)
        for n in range(max(0, self._idx - self.max_files), through + 1):
            try:
                os.unlink(self._path(n))
            except OSError:
                pass

    def _path(self, n: int) -> str:
        return f"{self.prefix}.{n}"

    def _newest_index(self) -> int:
        base = os.path.basename(self.prefix)
        rx = re.compile(re.escape(base) + r"\.(\d+)$")
        best = 0
        try:
            for name in os.listdir(os.path.dirname(self.prefix)):
                m = rx.fullmatch(name)
                if m:
                    best = max(best, int(m.group(1)))
        except OSError:
            pass
        return best

    def write(self, data: bytes) -> None:
        self._file.write(data)
        if self._file.tell() >= self.max_bytes:
            self._file.close()
            self._idx += 1
            self._file = open(self._path(self._idx), "ab", buffering=0)
            drop = self._idx - self.max_files
            if drop >= 0:
                # account the dropped bytes BEFORE unlinking so logical
                # offsets stay stable across pruning (readers paging with
                # a returned offset must not see positions shift down).
                # A crash between the persist and the unlink leaves a
                # counted-but-present file; readers skip indexes <=
                # through_index and __init__ retries the unlink.
                try:
                    dropped = os.path.getsize(self._path(drop))
                    _bump_pruned(self.prefix, dropped, drop)
                    os.unlink(self._path(drop))
                except OSError:
                    pass

    def close(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass


def _pruned_path(prefix: str) -> str:
    return f"{prefix}.pruned"


def _read_pruned(prefix: str) -> tuple:
    """-> (bytes, through_index): cumulative bytes removed by pruning —
    the logical offset of the oldest surviving byte — and the highest
    file index those bytes cover. Persisted (atomically, fsync'd) so
    pagination survives rotation AND agent restarts. Readers must treat
    any surviving file with index <= through_index as already counted:
    the counter is persisted BEFORE the unlink, so a crash between the
    two leaves a counted-but-present file behind."""
    try:
        with open(_pruned_path(prefix), "r") as f:
            parts = f.read().split()
            return int(parts[0]), int(parts[1]) if len(parts) > 1 else -1
    except (OSError, ValueError, IndexError):
        return 0, -1


def _bump_pruned(prefix: str, n: int, through_index: int) -> None:
    total, _ = _read_pruned(prefix)
    try:
        atomic_write_text(_pruned_path(prefix), f"{total + n} {through_index}")
    except OSError:
        pass


class LogMon:
    """One task's stdout/stderr capture. `stream_fd(kind)` hands back a
    pipe write-end for the child process; a reader thread drains it into
    the rotator until EOF (child exit)."""

    def __init__(self, log_dir: str, task_name: str,
                 max_files: int = 10, max_file_size_mb: int = 10):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.task_name = task_name
        self.max_files = max_files
        self.max_bytes = max_file_size_mb * 1024 * 1024
        self._write_fds: Dict[str, int] = {}
        self._threads: list = []

    def stream_fd(self, kind: str) -> int:
        """-> write fd to wire into Popen(stdout=/stderr=). Call
        close_parent_fds() after the child is spawned."""
        rfd, wfd = os.pipe()
        self._write_fds[kind] = wfd
        rot = _Rotator(os.path.join(self.log_dir, f"{self.task_name}.{kind}"),
                       self.max_files, self.max_bytes)

        def drain():
            try:
                while True:
                    chunk = os.read(rfd, 65536)
                    if not chunk:
                        return
                    rot.write(chunk)
            except OSError:
                pass
            finally:
                rot.close()
                try:
                    os.close(rfd)
                except OSError:
                    pass

        t = threading.Thread(target=drain, daemon=True,
                             name=f"logmon-{self.task_name}-{kind}")
        t.start()
        self._threads.append(t)
        return wfd

    def join(self, timeout: float = 5.0) -> None:
        """Wait, at most ``timeout`` in all, for the readers to drain
        their pipes to EOF (every writer of the task's output exited)."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def write(self, kind: str, data: bytes) -> None:
        """Append ``data`` to a stream's rotated files at once, with no
        pipe and no reader thread (output the agent itself produces,
        such as the mock driver's)."""
        rot = _Rotator(os.path.join(self.log_dir, f"{self.task_name}.{kind}"),
                       self.max_files, self.max_bytes)
        try:
            rot.write(data)
        finally:
            rot.close()

    def close_parent_fds(self) -> None:
        """Drop the parent's write-ends so readers see EOF when the
        child's copies close on exit."""
        for fd in self._write_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._write_fds.clear()


def read_log(log_dir: str, task_name: str, kind: str = "stdout",
             offset: int = 0, limit: int = 64 * 1024) -> Dict:
    """Read across the rotated file sequence as one logical stream
    (the `nomad alloc logs` read path; reference client fs API).
    Negative offset = from the end."""
    prefix = os.path.join(log_dir, f"{task_name}.{kind}")
    rx = re.compile(re.escape(f"{task_name}.{kind}") + r"\.(\d+)$")
    # snapshot base -> sizes -> base again; a prune racing the listing
    # would otherwise double-count the dropped file (counted in the new
    # base AND present in the stale size list)
    for _ in range(3):
        base, through = _read_pruned(prefix)
        pieces = []
        try:
            names = os.listdir(log_dir)
        except OSError:
            names = []
        for name in names:
            m = rx.fullmatch(name)
            if m and int(m.group(1)) > through:
                pieces.append(int(m.group(1)))
        pieces.sort()
        sizes = []
        for n in pieces:
            try:
                sizes.append((n, os.path.getsize(f"{prefix}.{n}")))
            except OSError:
                sizes.append((n, 0))
        if _read_pruned(prefix)[0] == base:
            break
    total = base + sum(s for _, s in sizes)
    if offset < 0:
        offset = max(0, total + offset)
    # positions below `base` were pruned away; clamp forward so a reader
    # paging from an old offset resumes at the oldest surviving byte
    offset = max(offset, base)
    out = bytearray()
    pos = base
    for n, size in sizes:
        if len(out) >= limit:
            break
        file_start, file_end = pos, pos + size
        pos = file_end
        if file_end <= offset:
            continue
        start_in_file = max(0, offset - file_start)
        want = limit - len(out)
        try:
            with open(f"{prefix}.{n}", "rb") as f:
                f.seek(start_in_file)
                out.extend(f.read(want))
        except OSError:
            continue
    return {"data": bytes(out), "offset": offset, "size": total}


def atomic_write_text(path: str, payload: str) -> None:
    """Write-temp + fsync + rename (the package's ``utils/files.py`` one,
    kept here: this module runs without the package)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
