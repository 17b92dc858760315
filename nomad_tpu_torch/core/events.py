"""Sharded event broker (a trimmed copy of ``nomad_tpu/core/events.py``).

The state store's commit listener turns every commit into topic-tagged
events; subscribers read them from their own cursors, filtered by topic
and key. The broker is sharded by topic hash (``crc32``): each shard
owns a ring of ``ring_size`` events, its lock and a dense sequence
counter. A subscriber that falls behind a ring
does not block the writer: the ring drops its oldest events, and every
cursor it passed sees ``truncated`` (the incremental feed answers with
a full resync).

Kept: what the incremental feed and the HTTP API read (``subscribe``,
``Subscription.next_events`` / ``truncated`` / ``close``, the commit
listener, ``TOPIC_FOR_KIND``), the ``nomad.events.alloc_deltas``
counter, the blocking read (``next_events(timeout)``: a subscription
parks one wake event on each of its shards and a publish wakes a shard's
parked readers in one walk; ``waiter_count`` is the parked gauge
``/v1/metrics`` reads), and the restore sentinel: a commit of a
``RESYNC_KINDS`` kind (the store's ``restore``, which replaced every
table) truncates every ring (``_truncate_all``), so every subscription,
caught up or not, sees ``truncated`` and resyncs. Left out: direct
publishes (``publish``), the broker-wide cursors (``last_seq``,
``events_after``) and the ownership hooks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional
from zlib import crc32

from ..obs import REGISTRY

TOPIC_FOR_KIND = {
    "node-upsert": "Node", "node-status": "Node", "node-eligibility": "Node",
    "node-drain": "Node", "node-delete": "Node",
    "job-upsert": "Job", "job-delete": "Job", "job-status": "Job",
    "eval-upsert": "Evaluation", "eval-delete": "Evaluation",
    "alloc-upsert": "Allocation", "alloc-stop": "Allocation",
    "alloc-preempt": "Allocation", "alloc-client-update": "Allocation",
    "alloc-transition": "Allocation",
    "alloc-block-upsert": "Allocation",  # one event per columnar batch
    "alloc-gc": "Allocation",            # payload: list of dead alloc ids
    "deployment-upsert": "Deployment", "deployment-update": "Deployment",
    "deployment-delete": "Deployment",
}

# commit kinds that invalidate every topic at once (a restore replaced
# the whole store): the answer is a full ring truncation
RESYNC_KINDS = ("restore",)

DEFAULT_SHARDS = 8


class Event:
    __slots__ = ("seq", "index", "topic", "type", "key", "payload")

    def __init__(self, seq: int, index: int, topic: str, etype: str, key: str,
                 payload):
        self.seq = seq      # dense per-shard cursor (ring bookkeeping)
        self.index = index  # the store's index of the commit
        self.topic = topic
        self.type = etype
        self.key = key
        self.payload = payload


class _Shard:
    __slots__ = ("lock", "ring", "seq", "evicted", "waiters")

    def __init__(self, ring_size: int):
        self.lock = threading.Lock()
        self.ring: deque = deque(maxlen=ring_size)
        self.seq = 0       # dense per-shard event counter
        self.evicted = 0   # highest seq dropped off this ring
        # parked subscriptions, id(sub) -> wake event; a publish drains
        # the whole table and a woken reader registers again to park
        self.waiters: Dict[int, threading.Event] = {}


class Subscription:
    def __init__(self, broker: "EventBroker",
                 topics: Optional[Dict[str, List[str]]] = None):
        self._broker = broker
        # topic -> keys ("*" = all); empty = every topic
        self.topics = topics or {}
        if self.topics and "*" not in self.topics:
            self._shard_ids = sorted({broker.shard_of(t)
                                      for t in self.topics})
        else:
            self._shard_ids = list(range(len(broker._shards)))
        self._cursors = {}
        for sid in self._shard_ids:
            sh = broker._shards[sid]
            with sh.lock:
                self._cursors[sid] = sh.seq
        self._wake = threading.Event()
        self.truncated = False
        self.closed = False

    def _wants(self, ev: Event) -> bool:
        if not self.topics:
            return True
        keys = self.topics.get(ev.topic)
        if keys is None:
            keys = self.topics.get("*")
        if keys is None:
            return False
        return "*" in keys or ev.key in keys

    def _collect(self) -> List[Event]:
        """Every event of the subscription's shards past its cursors
        (non-blocking); the cursors move past all of them, filtering
        happens in next_events."""
        out: List[Event] = []
        shards = self._broker._shards
        for sid in self._shard_ids:
            sh = shards[sid]
            cur = self._cursors[sid]
            if sh.seq <= cur:   # racy fast path: seq only grows
                continue
            with sh.lock:
                if sh.evicted > cur:
                    self.truncated = True
                ring = sh.ring
                if ring and ring[-1].seq > cur:
                    out.extend(e for e in ring if e.seq > cur)
                    self._cursors[sid] = ring[-1].seq
                else:
                    self._cursors[sid] = sh.seq
        if len(self._shard_ids) > 1 and out:
            # the store's index is the global order; the stable sort keeps
            # each shard's publish order
            out.sort(key=lambda e: e.index)
        return out

    def _park(self, remaining: Optional[float]) -> None:
        """Register one wake event on every shard of the subscription,
        re-check for a publish that raced the registration, then wait."""
        self._wake.clear()
        shards = self._broker._shards
        me = id(self)
        for sid in self._shard_ids:
            sh = shards[sid]
            with sh.lock:
                sh.waiters[me] = self._wake
        try:
            for sid in self._shard_ids:
                if shards[sid].seq > self._cursors[sid]:
                    return
            self._wake.wait(remaining)
        finally:
            for sid in self._shard_ids:
                sh = shards[sid]
                with sh.lock:
                    sh.waiters.pop(me, None)

    def next_events(self, timeout: Optional[float] = 0.0) -> List[Event]:
        """Events past the cursors, filtered by the subscription's topics
        and keys. With ``timeout`` 0 (the incremental feed's read) it
        never blocks; otherwise it parks until any event passes the
        cursors (possibly [] after filtering), the timeout expires or
        ``close``."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not self.closed:
            evs = self._collect()
            if evs:
                return [e for e in evs if self._wants(e)]
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return []
            self._park(remaining)
        return []

    def close(self) -> None:
        """Unpark, and drop the waiter registrations."""
        self.closed = True
        me = id(self)
        for sid in self._shard_ids:
            sh = self._broker._shards[sid]
            with sh.lock:
                sh.waiters.pop(me, None)
        self._wake.set()


class EventBroker:
    def __init__(self, store, ring_size: int = 4096,
                 shards: int = DEFAULT_SHARDS):
        self._shards = [_Shard(ring_size) for _ in range(max(1, shards))]
        store.add_commit_listener(self._on_commit)

    def shard_of(self, topic: str) -> int:
        # stable across processes (hash() is salted)
        return crc32(topic.encode()) % len(self._shards)

    def subscribe(self, topics: Optional[Dict[str, List[str]]] = None
                  ) -> Subscription:
        return Subscription(self, topics)

    def waiter_count(self) -> int:
        """Parked subscriptions across the shards (the
        ``nomad.reads.event_waiters`` gauge)."""
        n = 0
        for sh in self._shards:
            with sh.lock:
                n += len(sh.waiters)
        return n

    def _on_commit(self, index: int, events: list) -> None:
        """The store's commit listener: on the writer's thread and under
        its lock, so it only appends to rings."""
        if any(kind in RESYNC_KINDS for kind, _ in events):
            self._truncate_all()
            return
        by_shard: Dict[int, list] = {}
        alloc_deltas = 0
        for kind, payload in events:
            topic = TOPIC_FOR_KIND.get(kind)
            if topic is None:
                continue
            if topic == "Allocation":
                alloc_deltas += 1
            key = getattr(payload, "id", "") if payload is not None else ""
            by_shard.setdefault(self.shard_of(topic), []).append(
                (topic, kind, key, payload))
        if alloc_deltas:
            REGISTRY.incr("nomad.events.alloc_deltas", alloc_deltas)
        for sid, items in by_shard.items():
            self._publish_shard(sid, items, index)

    def _publish_shard(self, sid: int, items, index: int) -> None:
        sh = self._shards[sid]
        with sh.lock:
            ring = sh.ring
            cap = ring.maxlen
            for topic, kind, key, payload in items:
                sh.seq += 1
                if len(ring) == cap:
                    sh.evicted = ring[0].seq
                ring.append(Event(sh.seq, index, topic, kind, key, payload))
            waiters = list(sh.waiters.values())
            sh.waiters.clear()
        for ev in waiters:
            ev.set()

    def _truncate_all(self) -> None:
        """A restore replaced the whole store: every ring is stale. Each
        shard's seq moves past every cursor and counts as evicted, so all
        subscriptions observe the truncation."""
        for sh in self._shards:
            with sh.lock:
                sh.ring.clear()
                sh.seq += 1
                sh.evicted = sh.seq
                waiters = list(sh.waiters.values())
                sh.waiters.clear()
            for ev in waiters:
                ev.set()
