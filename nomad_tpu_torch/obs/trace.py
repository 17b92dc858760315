"""Eval-lifecycle spans (reference ``nomad_tpu/obs/trace.py``).

A process-global ``Tracer`` records named spans into per-thread bounded
rings. Each ring has one writer, its owning thread, so an append is a
plain list operation under the GIL; the registry of rings takes a lock
only when a ring is created and when ``spans()`` copies them. Every span
exit also feeds its duration into ``obs.metrics.REGISTRY`` under
``nomad.eval.phase.<name>``.

A span record is a tuple (see the ``R_*`` indexes):

    (name, trace, parent, span_id, t0, t1, thread, args)

``trace`` ties a span to one evaluation (``Evaluation.trace()``, the
eval id unless stamped). Spans that cover several evals at once (a
worker batch's shared snapshot, a commit round) carry ``traces=[...]``
in ``args`` instead.

A tracer made with ``enabled=False`` records nothing: ``span()`` returns
the shared no-op ``NULL_SPAN`` and ``event`` / ``add_span`` return before
reading a clock. Clock: ``time.time()``.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List

from .metrics import REGISTRY

# record tuple layout
R_NAME, R_TRACE, R_PARENT, R_ID, R_T0, R_T1, R_THREAD, R_ARGS = range(8)

# per-thread ring capacity (records)
RING_CAP = 8192

_ids = itertools.count(1)  # one span-id sequence; next() is GIL-atomic


class _NullSpan:
    """The disabled tracer's span and bind: a stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kv) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Ring:
    """Bounded record ring with a single writer."""

    __slots__ = ("buf", "cap", "idx")

    def __init__(self, cap: int):
        self.buf: list = []
        self.cap = cap
        self.idx = 0  # next overwrite position once full

    def append(self, rec: tuple) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(rec)
        else:
            self.buf[self.idx] = rec
            self.idx = (self.idx + 1) % self.cap

    def snapshot(self) -> list:
        buf = list(self.buf)
        if len(buf) < self.cap:
            return buf
        i = self.idx
        return buf[i:] + buf[:i]


class _Span:
    """One open span; records itself into the calling thread's ring on
    exit."""

    __slots__ = ("_tr", "name", "trace", "args", "_parent", "sid", "t0")

    def __init__(self, tr: "Tracer", name: str, trace, args: dict):
        self._tr = tr
        self.name = name
        self.trace = trace
        self.args = args
        self._parent = 0
        self.sid = 0
        self.t0 = 0.0

    def __enter__(self):
        tl = self._tr._tl()
        stack = tl.stack
        if self.trace is None:
            if stack and stack[-1][1] is not None:
                self.trace = stack[-1][1]
            elif tl.bound:
                self.trace = tl.bound[-1]
        self._parent = stack[-1][0] if stack else 0
        self.sid = next(_ids)
        stack.append((self.sid, self.trace))
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        tl = self._tr._tl()
        if tl.stack and tl.stack[-1][0] == self.sid:
            tl.stack.pop()
        tl.ring.append((self.name, self.trace, self._parent, self.sid,
                        self.t0, t1, tl.tid, self.args))
        REGISTRY.observe("nomad.eval.phase." + self.name, t1 - self.t0)
        return False

    def set(self, **kv) -> None:
        """Attach args found mid-span."""
        self.args.update(kv)


class _Bind:
    """Thread-local trace binding: spans opened inside inherit the bound
    trace id unless they name one."""

    __slots__ = ("_tr", "trace")

    def __init__(self, tr: "Tracer", trace):
        self._tr = tr
        self.trace = trace

    def __enter__(self):
        self._tr._tl().bound.append(self.trace)
        return self

    def __exit__(self, *exc):
        bound = self._tr._tl().bound
        if bound:
            bound.pop()
        return False


class Tracer:
    def __init__(self, enabled: bool = True, ring_cap: int = RING_CAP):
        self.enabled = enabled
        self.ring_cap = ring_cap
        self._local = threading.local()
        # ring registry, written once a thread generation under the
        # lock; _epoch bumps on clear() so a thread's stale ring is
        # replaced on its next record and cleared records never return
        self._reg_lock = threading.Lock()
        self._rings: dict = {}  # id(ring) -> _Ring
        self._epoch = 0

    def _tl(self):
        tl = self._local
        if getattr(tl, "ring", None) is None or tl.epoch != self._epoch:
            tl.ring = _Ring(self.ring_cap)
            tl.stack = getattr(tl, "stack", None) or []
            tl.bound = getattr(tl, "bound", None) or []
            tl.tid = threading.current_thread().name
            tl.epoch = self._epoch
            with self._reg_lock:
                self._rings[id(tl.ring)] = tl.ring
        return tl

    def span(self, name: str, trace=None, **args):
        """A named span as a context manager; ``trace`` defaults to the
        enclosing span's or ``bind()``'s."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, trace, args)

    def bind(self, trace):
        """Spans opened inside (on this thread) inherit ``trace``."""
        if not self.enabled:
            return NULL_SPAN
        return _Bind(self, trace)

    def add_span(self, name: str, t0: float, t1: float, trace=None,
                 **args) -> None:
        """Record a span from timestamps taken elsewhere."""
        if not self.enabled:
            return
        tl = self._tl()
        tl.ring.append((name, trace, 0, next(_ids), t0, t1, tl.tid, args))
        REGISTRY.observe("nomad.eval.phase." + name, max(0.0, t1 - t0))

    def event(self, name: str, trace=None, **args) -> None:
        """Record an instant (a zero-length span)."""
        if not self.enabled:
            return
        tl = self._tl()
        now = time.time()
        tl.ring.append((name, trace, 0, next(_ids), now, now, tl.tid, args))

    def spans(self) -> List[tuple]:
        """Every thread's ring, merged and sorted by start time."""
        with self._reg_lock:
            rings = list(self._rings.values())
        out: List[tuple] = []
        for r in rings:
            out.extend(r.snapshot())
        out.sort(key=lambda rec: rec[R_T0])
        return out

    def clear(self) -> None:
        """Drop every recorded span."""
        with self._reg_lock:
            self._rings.clear()
            self._epoch += 1


TRACER = Tracer()
