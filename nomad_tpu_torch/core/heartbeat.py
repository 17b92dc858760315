"""Node heartbeats (a copy of ``nomad_tpu/core/heartbeat.py``): a
server-side TTL a node. A node that misses its TTL is marked down
through the Server's ``mark_nodes_down``, with one eval a job of its
allocs.

Timers are sharded over timer-wheel shards, each a deadline map and a
lazy min-heap drained by one expiry thread, so arming a heartbeat is a
dict store and a heap push under a shard's lock, and expiry is batched
into one ``mark_nodes_down`` call. A token-bucket expiry-rate limiter
turns a mass expiry into a paced trickle of mark-down batches.
``restore`` arms every node of a store the server starts on and grants
each a full TTL to check in before any expiry fires (the grace
horizon clamps earlier deadlines forward). ``expiry_snapshot`` keeps,
for each expiry, when its TTL was armed and when it fired.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..obs import REGISTRY, TRACER

DEFAULT_TTL = 10.0


class HeartbeatPlaneInactive(RuntimeError):
    """Raised to a heartbeating client when this server cannot arm its
    TTL (it is stopping): an acked heartbeat that armed no timer would
    become a false mark-down."""


DEFAULT_SHARDS = 8
# the most due nodes one shard's pass marks down together
DEFAULT_EXPIRY_BATCH = 256
# missed-TTL mark-downs a second across all shards, the Server's rate
EXPIRY_RATE = 512.0


class _Shard:
    """One timer-wheel shard: deadline map + lazy min-heap, drained by a
    dedicated expiry thread. All fields are guarded by `cond`."""

    __slots__ = ("cond", "deadlines", "heap", "thread", "stop", "grace_until")

    def __init__(self):
        self.cond = threading.Condition()
        self.deadlines: Dict[str, float] = {}    # node_id -> armed deadline
        self.heap: List[Tuple[float, str]] = []  # lazy min-heap of (deadline, id)
        self.thread: Optional[threading.Thread] = None
        self.stop = True            # True == shard disabled / thread exiting
        self.grace_until = 0.0      # post-failover grace horizon (monotonic)


class HeartbeatManager:
    def __init__(self, server, ttl: float = DEFAULT_TTL,
                 shards: int = DEFAULT_SHARDS,
                 expiry_rate: float = 0.0):
        self.server = server
        self.ttl = ttl
        self.expiry_rate = float(expiry_rate)   # expiries/s; <= 0 = unlimited
        self._shards = [_Shard() for _ in range(max(1, int(shards)))]
        self._lifecycle = threading.Lock()      # serializes set_enabled
        self._stats_lock = threading.Lock()     # guards stats + expiry log
        self.stats = {"invalidated": 0, "rate_limited": 0, "mark_failed": 0}
        # every expiry records when its TTL was armed and when it fired
        # (monotonic clock)
        self._expiry_log: deque = deque(maxlen=8192)
        # token bucket for the expiry-rate limiter
        self._bucket_lock = threading.Lock()
        self._burst = max(1.0, self.expiry_rate)
        self._tokens = self._burst
        self._bucket_ts = self._now()

    def _now(self) -> float:
        return time.monotonic()

    @property
    def enabled(self) -> bool:
        """True when the expiry plane is live (the server is started).
        All shards flip together under the lifecycle lock, so the first
        shard's flag speaks for the manager."""
        shard = self._shards[0]
        with shard.cond:
            return not shard.stop

    def _shard_for(self, node_id: str) -> _Shard:
        return self._shards[hash(node_id) % len(self._shards)]

    # -- lifecycle --

    def set_enabled(self, enabled: bool) -> None:
        with self._lifecycle:
            if enabled:
                for i, shard in enumerate(self._shards):
                    with shard.cond:
                        if not shard.stop:
                            continue
                        shard.stop = False
                    t = threading.Thread(target=self._run_shard, args=(shard,),
                                         daemon=True,
                                         name=f"heartbeat-shard-{i}")
                    shard.thread = t
                    t.start()
                return
            for shard in self._shards:
                with shard.cond:
                    shard.stop = True
                    shard.deadlines.clear()
                    shard.heap.clear()
                    shard.cond.notify_all()
            for shard in self._shards:
                t, shard.thread = shard.thread, None
                if t is not None:
                    t.join()
            REGISTRY.set_gauge("nomad.heartbeat.active", 0)

    # -- arming --

    def reset(self, node_id: str) -> float:
        """(Re)arm the TTL for a node; returns the TTL the client should
        heartbeat within (node register / UpdateStatus path)."""
        shard = self._shard_for(node_id)
        with shard.cond:
            if shard.stop:
                return self.ttl
            self._arm_locked(shard, node_id, self._now() + self.ttl)
        return self.ttl

    def _arm_locked(self, shard: _Shard, node_id: str, deadline: float) -> None:
        if deadline < shard.grace_until:
            deadline = shard.grace_until
        prev_min = shard.heap[0][0] if shard.heap else None
        shard.deadlines[node_id] = deadline
        heapq.heappush(shard.heap, (deadline, node_id))
        # the expiry thread sleeps until the shard's min deadline; only
        # an EARLIER minimum requires a wakeup (resets arm now+ttl which
        # is always the latest, so the hot path almost never notifies)
        if prev_min is None or deadline < prev_min:
            shard.cond.notify_all()

    def restore(self, node_ids) -> int:
        """Arm TTLs for the nodes of a store the server starts on
        (reference ``heartbeat.py:144-172``): a node that went silent
        while no server watched it must still time out. Every node gets
        one full TTL to check in before ANY expiry fires (the grace
        horizon clamps earlier deadlines too). Duplicate and empty ids
        are ignored. Returns the number of timers armed."""
        now = self._now()
        grace = now + self.ttl
        for shard in self._shards:
            with shard.cond:
                if not shard.stop and shard.grace_until < grace:
                    shard.grace_until = grace
        armed = 0
        seen = set()
        for node_id in node_ids:
            if not node_id or node_id in seen:
                continue
            seen.add(node_id)
            shard = self._shard_for(node_id)
            with shard.cond:
                if shard.stop:
                    continue
                self._arm_locked(shard, node_id, grace)
                armed += 1
        REGISTRY.set_gauge("nomad.heartbeat.active", self.active())
        return armed

    def remove(self, node_id: str) -> None:
        shard = self._shard_for(node_id)
        with shard.cond:
            # heap entry becomes stale and is discarded lazily on pop
            shard.deadlines.pop(node_id, None)

    def armed(self, node_id: str) -> bool:
        """True if a live TTL timer exists for the node (i.e. it has
        heartbeated and not yet expired or been removed)."""
        shard = self._shard_for(node_id)
        with shard.cond:
            return node_id in shard.deadlines

    def _invalidate(self, node_id: str) -> None:
        """Force-expire one node now (test/compat surface for the old
        per-node timer callback)."""
        shard = self._shard_for(node_id)
        with shard.cond:
            if shard.stop:
                return
            deadline = shard.deadlines.pop(node_id, None)
            if deadline is None:
                return
        self._record_expiries([(node_id, deadline)])
        # mark down + create per-job evals (node_endpoint.go:541,1645)
        self.server.mark_node_down(node_id, reason="heartbeat missed")

    # -- expiry --

    def _run_shard(self, shard: _Shard) -> None:
        while True:
            with shard.cond:
                expired: List[Tuple[str, float]] = []
                while not shard.stop:
                    now = self._now()
                    expired = self._collect_due_locked(shard, now)
                    if expired:
                        break
                    timeout = None
                    if shard.heap:
                        timeout = max(0.0, shard.heap[0][0] - now)
                    shard.cond.wait(timeout)
                if shard.stop:
                    return
                depth = len(shard.deadlines)
            REGISTRY.set_gauge("nomad.heartbeat.shard_depth", depth)
            self._expire(expired)

    def _collect_due_locked(self, shard: _Shard, now: float
                            ) -> List[Tuple[str, float]]:
        """Pop due deadlines (up to one batch), applying the grace
        clamp and the expiry-rate budget. Over-budget nodes are re-armed
        a pacing delay out instead of expiring — a mark-down storm
        degrades to a paced trickle."""
        heap, deadlines = shard.heap, shard.deadlines
        due: List[Tuple[str, float]] = []
        while heap and heap[0][0] <= now and len(due) < DEFAULT_EXPIRY_BATCH:
            deadline, node_id = heap[0]
            if deadlines.get(node_id) != deadline:
                heapq.heappop(heap)          # stale: removed or re-armed
                continue
            if deadline < shard.grace_until:
                # failover grace: give the node a full TTL to check in
                heapq.heappop(heap)
                deadlines[node_id] = shard.grace_until
                heapq.heappush(heap, (shard.grace_until, node_id))
                continue
            heapq.heappop(heap)
            due.append((node_id, deadline))
        if not due:
            return []
        granted, delay = self._take_tokens(len(due), now)
        if granted < len(due):
            for node_id, _deadline in due[granted:]:
                nd = now + delay
                deadlines[node_id] = nd
                heapq.heappush(heap, (nd, node_id))
            limited = len(due) - granted
            with self._stats_lock:
                self.stats["rate_limited"] += limited
            REGISTRY.incr("nomad.heartbeat.rate_limited", limited)
            due = due[:granted]
        for node_id, _deadline in due:
            del deadlines[node_id]
        return due

    def _take_tokens(self, want: int, now: float) -> Tuple[int, float]:
        """-> (granted, pacing delay for the remainder)."""
        if self.expiry_rate <= 0:
            return want, 0.0
        with self._bucket_lock:
            self._tokens = min(
                self._burst,
                self._tokens + (now - self._bucket_ts) * self.expiry_rate)
            self._bucket_ts = now
            granted = min(want, int(self._tokens))
            self._tokens -= granted
            delay = max(0.01, (1.0 - self._tokens) / self.expiry_rate)
            return granted, delay

    def _expire(self, expired: List[Tuple[str, float]]) -> None:
        self._record_expiries(expired)
        node_ids = [node_id for node_id, _deadline in expired]
        with TRACER.span("heartbeat.expire", count=len(node_ids)):
            try:
                mark_batch = getattr(self.server, "mark_nodes_down", None)
                if mark_batch is not None:
                    mark_batch(node_ids, reason="heartbeat missed")
                else:
                    for node_id in node_ids:
                        self.server.mark_node_down(node_id,
                                                   reason="heartbeat missed")
            except Exception:
                # the mark failed (the store refused it): the node stays
                # ready, and a restart re-arms it through restore()
                with self._stats_lock:
                    self.stats["mark_failed"] += 1

    def _record_expiries(self, expired: List[Tuple[str, float]]) -> None:
        now = self._now()
        with self._stats_lock:
            self.stats["invalidated"] += len(expired)
            for node_id, deadline in expired:
                # armed_at reconstructed from the deadline: every armed
                # deadline is exactly one TTL past the last check-in
                self._expiry_log.append((node_id, deadline - self.ttl, now))
        REGISTRY.incr("nomad.heartbeat.expiries", len(expired))

    # -- introspection --

    def active(self) -> int:
        return sum(self.shard_depths())

    def shard_depths(self) -> List[int]:
        depths = []
        for shard in self._shards:
            with shard.cond:
                depths.append(len(shard.deadlines))
        return depths

    def expiry_snapshot(self) -> List[Tuple[str, float, float]]:
        """Recent expiries as (node_id, armed_at, expired_at) monotonic
        tuples: the record a false mark-down is audited against."""
        with self._stats_lock:
            return list(self._expiry_log)
