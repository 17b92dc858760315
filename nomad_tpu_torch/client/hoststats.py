"""Host resource stats (a copy of ``nomad_tpu/client/hoststats.py``;
reference client/hoststats/): cpu utilisation from /proc/stat deltas,
memory from /proc/meminfo, disk from the data dir's filesystem, uptime
and load, sampled on an interval; the latest sample serves
/v1/client/stats."""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple


def _read_proc_stat() -> Optional[Tuple[float, float]]:
    """-> (busy_jiffies, total_jiffies) summed over all cpus."""
    try:
        with open("/proc/stat") as f:
            line = f.readline()
        parts = [float(x) for x in line.split()[1:]]
        total = sum(parts)
        idle = parts[3] + (parts[4] if len(parts) > 4 else 0.0)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def _read_meminfo() -> Dict[str, float]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                try:
                    out[key.strip()] = float(rest.split()[0]) / 1024.0  # MB
                except (ValueError, IndexError):
                    pass
    except OSError:
        pass
    return out


class HostStatsCollector:
    def __init__(self, data_dir: str = "/", interval: float = 10.0):
        self.data_dir = data_dir or "/"
        self.interval = interval
        self._prev_cpu: Optional[Tuple[float, float]] = None
        self._latest: Dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Dict:
        now = time.time()
        cpu_pct = 0.0
        with self._lock:  # _prev_cpu read-modify-write must not interleave
            cur = _read_proc_stat()
            if cur is not None and self._prev_cpu is not None:
                dbusy = cur[0] - self._prev_cpu[0]
                dtotal = cur[1] - self._prev_cpu[1]
                if dtotal > 0:
                    cpu_pct = 100.0 * dbusy / dtotal
            self._prev_cpu = cur

        mem = _read_meminfo()
        try:
            du = shutil.disk_usage(self.data_dir)
            disk = {"total_mb": du.total / 1e6, "free_mb": du.free / 1e6,
                    "used_mb": du.used / 1e6}
        except OSError:
            disk = {}
        try:
            with open("/proc/uptime") as f:
                uptime = float(f.read().split()[0])
        except (OSError, ValueError):
            uptime = 0.0
        try:
            load1, load5, load15 = os.getloadavg()
        except OSError:
            load1 = load5 = load15 = 0.0

        stats = {
            "timestamp": now,
            "cpu_percent": round(cpu_pct, 2),
            "memory": {"total_mb": mem.get("MemTotal", 0.0),
                       "available_mb": mem.get("MemAvailable", 0.0)},
            "disk": disk,
            "uptime_s": uptime,
            "load": [load1, load5, load15],
        }
        with self._lock:
            self._latest = stats
        return stats

    def latest(self) -> Dict:
        with self._lock:
            if self._latest:
                return dict(self._latest)
        return self.sample()

    def start(self) -> "HostStatsCollector":
        self.sample()  # prime the cpu delta
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hoststats")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
