"""The store-index waiter table behind blocking queries (a trimmed copy of
``nomad_tpu/state/watch.py``).

A blocking query parks in a min-heap keyed by the store index it waits
for; one commit pops exactly the waiters whose threshold it passed and
wakes them with one timestamp (no poll loop, no thundering herd). Each
parked HTTP handler owns its thread, so it enforces its own deadline
with ``Event.wait(timeout)`` and cancels its heap entry on the way out
(lazy removal). The commit/deadline race is settled under the table
lock: a waiter that times out re-checks its event there, so a wakeup
that raced the deadline is never lost.

Trimmed: the admission controller's shedding of parks and its brownout
coalescing window (the port has no ``loadctl``). ``teardown`` (the
owning Server's stop) wakes every parked waiter at the current index,
so no handler thread outlives the server it waits on.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import List, Optional, Tuple

from ..obs import REGISTRY


class _Waiter:
    __slots__ = ("event", "index", "wake_ts", "cancelled", "claimed")

    def __init__(self):
        self.event = threading.Event()
        self.index = 0        # the committed index that woke it
        self.wake_ts = 0.0    # that commit's publish time
        self.cancelled = False
        self.claimed = False  # popped by a commit: its wakeup is imminent


class WatchTable:
    """Parked blocking queries of one store, woken by its commit
    listener (every replica wakes its own as it applies)."""

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()
        self._heap: List[Tuple[int, int, _Waiter]] = []
        self._tie = 0       # FIFO within one threshold
        self._parked = 0    # live (not cancelled) waiters
        self._gauge_ts = 0.0
        store.add_commit_listener(self._on_commit)

    def _publish_gauge(self, now: Optional[float] = None) -> None:
        """The parked gauge, at most every 50 ms (under ``_lock``): a
        scrape-rate observable, not an exact count."""
        if now is None:
            now = time.time()
        if now - self._gauge_ts >= 0.05:
            self._gauge_ts = now
            REGISTRY.set_gauge("nomad.reads.parked", self._parked)

    def parked(self) -> int:
        with self._lock:
            return self._parked

    def teardown(self) -> None:
        """The owning server's stop: wake every parked waiter at the
        current index (a blocking query may return before its index
        moved; its client asks again)."""
        with self._lock:
            batch = [w for _, _, w in self._heap if not w.cancelled]
            for w in batch:
                w.claimed = True
            self._heap = []
            self._parked = 0
            self._publish_gauge(now=float("inf"))
        if batch:
            self._wake(batch, self._store.latest_index)

    def wait_min_index(self, index: int, timeout: Optional[float] = None
                       ) -> Tuple[int, Optional[float]]:
        """Park until the store publishes ``latest_index >= index`` or
        the timeout expires. Returns ``(observed index, wake_ts)``;
        ``wake_ts`` is the waking commit's publish time, None when the
        store was already past the threshold or the wait timed out."""
        latest = self._store.latest_index
        if latest >= index:
            return latest, None
        w = _Waiter()
        with self._lock:
            # re-check under the lock _on_commit takes too: a commit
            # between the check above and the push is sure to pop it
            latest = self._store.latest_index
            if latest >= index:
                return latest, None
            self._tie += 1
            heapq.heappush(self._heap, (index, self._tie, w))
            self._parked += 1
            self._publish_gauge()
        if not w.event.wait(timeout):
            with self._lock:
                if not w.event.is_set() and not w.claimed:
                    # the deadline won: cancel in place
                    w.cancelled = True
                    self._parked -= 1
                    self._publish_gauge()
                    return self._store.latest_index, None
            # a commit claimed it under the lock: its wakeup is imminent
            w.event.wait(1.0)
        return w.index, w.wake_ts

    def _on_commit(self, index: int, events: list) -> None:
        """One commit, one timestamped batch: heap pops and
        ``Event.set`` only, on the store's commit path."""
        batch: List[_Waiter] = []
        with self._lock:
            heap = self._heap
            while heap and heap[0][0] <= index:
                _, _, w = heapq.heappop(heap)
                if w.cancelled:
                    continue
                w.claimed = True
                batch.append(w)
            if batch:
                self._parked -= len(batch)
                self._publish_gauge()
        if batch:
            self._wake(batch, index)

    def _wake(self, batch: List[_Waiter], index: int) -> None:
        now = time.time()
        for w in batch:
            w.index = index
            w.wake_ts = now
            w.event.set()
        REGISTRY.incr("nomad.reads.wakeups", len(batch))
        REGISTRY.observe("nomad.reads.wakeup_batch", float(len(batch)))
