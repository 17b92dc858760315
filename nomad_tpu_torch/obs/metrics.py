"""Named metrics registry (reference ``nomad_tpu/core/metrics.py``):
process-wide counters, timing samples, gauges and bounded-reservoir
histograms under the reference's names (``nomad.plan.evaluate``,
``nomad.plan.submit``, ``nomad.plan.node_rejected``,
``nomad.worker.invoke_scheduler_<type>``, ``nomad.preempt.*``,
``nomad.solver.*``, ``nomad.eval.phase.<span>``, ``nomad.reads.*``),
and ``prometheus_text``, the text exposition ``/v1/metrics?format=
prometheus`` serves (reference ``core/metrics.py:205-235``). It sits in
``obs/`` beside the tracer, a leaf the tensor layer reports to without
importing the core."""

from __future__ import annotations

import threading
import time
from typing import Dict


class _Sample:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0


class _Timer:
    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg, name):
        self._reg = reg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._reg.sample(self._name, time.perf_counter() - self._t0)


class _Histogram:
    """The most recent ``capacity`` observations in a ring; p50 / p99
    over them."""

    __slots__ = ("count", "total_s", "max_s", "_ring", "_capacity", "_next")

    def __init__(self, capacity: int = 2048):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self._ring: list = []
        self._capacity = capacity
        self._next = 0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds
        if len(self._ring) < self._capacity:
            self._ring.append(seconds)
        else:
            self._ring[self._next] = seconds
            self._next = (self._next + 1) % self._capacity

    def snapshot(self) -> tuple:
        """(count, total_s, max_s, ring copy), unsorted: the sort runs
        outside the registry lock."""
        return self.count, self.total_s, self.max_s, list(self._ring)


def _pct(data: list, q: float) -> float:
    """q-percentile of a sorted list (0.0 if empty)."""
    if not data:
        return 0.0
    k = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
    return data[k]


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._samples: Dict[str, _Sample] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}

    def incr(self, name: str, n: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def sample(self, name: str, seconds: float) -> None:
        with self._lock:
            s = self._samples.get(name)
            if s is None:
                s = self._samples[name] = _Sample()
            s.count += 1
            s.total_s += seconds
            if seconds > s.max_s:
                s.max_s = seconds

    def set_gauge(self, name: str, value: float) -> None:
        """Last write wins."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        """Record into a percentile histogram."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = _Histogram()
            h.observe(seconds)

    def percentile(self, name: str, q: float) -> float:
        """A histogram's q-percentile in seconds, 0.0 if empty."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                return 0.0
            data = list(h._ring)
        data.sort()
        return _pct(data, q)

    def get(self, name: str, default: float = 0.0) -> float:
        """A counter's or gauge's current value (counters win)."""
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def time(self, name: str) -> "_Timer":
        """Context manager: times the block into ``name``."""
        return _Timer(self, name)

    def reset(self, name: str = None) -> None:
        """Drop one metric (all families) or, with no name, everything."""
        with self._lock:
            if name is None:
                self._counters.clear()
                self._samples.clear()
                self._gauges.clear()
                self._histograms.clear()
            else:
                self._counters.pop(name, None)
                self._samples.pop(name, None)
                self._gauges.pop(name, None)
                self._histograms.pop(name, None)

    def dump(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            for name, s in self._samples.items():
                out[name] = {"count": s.count,
                             "mean_ms": (1000.0 * s.total_s / s.count
                                         if s.count else 0.0),
                             "max_ms": 1000.0 * s.max_s}
            hsnaps = {name: h.snapshot()
                      for name, h in self._histograms.items()}
        for name, (count, total_s, max_s, ring) in hsnaps.items():
            ring.sort()
            out[name] = {"count": count,
                         "mean_ms": (1000.0 * total_s / count
                                     if count else 0.0),
                         "p50_ms": 1000.0 * _pct(ring, 0.50),
                         "p99_ms": 1000.0 * _pct(ring, 0.99),
                         "max_ms": 1000.0 * max_s}
        return out


def prometheus_text(metrics: dict, prefix: str = "") -> str:
    """Flatten a metrics dict into the prometheus text exposition: dots
    and dashes become underscores, a timing sample expands to
    ``_count`` / ``_mean_ms`` / ``_max_ms``."""
    lines = []

    def name_of(*parts) -> str:
        raw = "_".join(p for p in parts if p)
        return "".join(c if c.isalnum() or c == "_" else "_" for c in raw)

    def walk(prefix_parts, value):
        if isinstance(value, dict):
            if set(value) == {"count", "mean_ms", "max_ms"}:
                for k, v in value.items():
                    n = name_of(*prefix_parts, k)
                    lines.append(f"# TYPE {n} gauge")
                    lines.append(f"{n} {float(v)}")
                return
            for k, v in value.items():
                walk(prefix_parts + [str(k)], v)
            return
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            n = name_of(*prefix_parts)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {float(value)}")

    walk([prefix] if prefix else [], metrics)
    return "\n".join(lines) + "\n"


REGISTRY = Registry()
