"""Delta alloc sync and batched client alloc updates (a copy of
``nomad_tpu/core/allocsync.py``; reference client.go:2281
watchAllocations and :2198 allocSync).

``AllocSyncHub``: one pump thread reads the event broker's Allocation
topic and routes each changed alloc to the subscriptions of its node. A
subscription that falls off the broker's ring is flagged for a full
resync instead of silently missing updates; an ``alloc-block-upsert``
(a columnar batch over many nodes) is folded into the resync path too,
so its nodes' clients re-read their allocs from a snapshot.

``ClientUpdateBatcher``: clients' status writes are coalesced, combiner
style: an uncontended caller commits its own round at once, and every
caller arriving while that command is in flight parks its updates for
the next single ``update_allocs_from_client``. A round that fails falls
back to one commit a caller, so one bad update cannot fail the others.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import REGISTRY


class NodeAllocSub:
    """Per-subscriber mailbox of changed allocs for a set of nodes."""

    def __init__(self, hub: "AllocSyncHub", node_ids: Tuple[str, ...]):
        self._hub = hub
        self.node_ids = node_ids
        self._cond = threading.Condition()
        self._pending: Dict[str, object] = {}   # alloc_id -> latest alloc
        self._resync = False
        self._closed = False

    def poll(self, timeout: float = 1.0):
        """-> (changed allocs, needs_full_resync). Blocks up to timeout
        for activity. After a True resync flag the caller must re-read
        its full alloc set from a snapshot — deltas delivered before the
        gap may have been lost."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (not self._pending and not self._resync
                   and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch = list(self._pending.values())
            self._pending.clear()
            resync, self._resync = self._resync, False
            return batch, resync

    def _push(self, allocs: List) -> None:
        with self._cond:
            if self._closed:
                return
            for alloc in allocs:
                prev = self._pending.get(alloc.id)
                if prev is None or alloc.modify_index >= prev.modify_index:
                    self._pending[alloc.id] = alloc
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def _mark_resync(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._pending.clear()
            self._resync = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._hub._unsubscribe(self)


class AllocSyncHub:
    """Routes the broker's Allocation change-stream to per-node
    subscriptions. Works on any replica: the broker is fed by the
    store's commit listener, which under raft fires during FSM apply on
    followers too."""

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._by_node: Dict[str, List[NodeAllocSub]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.running = False
        self.stats = {"events": 0, "deltas": 0, "resyncs": 0}
        self._stats_lock = threading.Lock()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self.running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="alloc-sync-pump")
        self._thread.start()

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            subs = [s for lst in self._by_node.values() for s in lst]
            self._by_node.clear()
        for s in subs:
            with s._cond:
                s._closed = True
                s._cond.notify_all()

    def subscribe(self, node_ids) -> NodeAllocSub:
        """Subscribe for one node id or an iterable of them (a swarm
        driver holds ONE sub covering its whole node slice)."""
        if isinstance(node_ids, str):
            node_ids = (node_ids,)
        sub = NodeAllocSub(self, tuple(node_ids))
        with self._lock:
            for nid in sub.node_ids:
                self._by_node.setdefault(nid, []).append(sub)
        return sub

    def _unsubscribe(self, sub: NodeAllocSub) -> None:
        with self._lock:
            for nid in sub.node_ids:
                lst = self._by_node.get(nid)
                if not lst:
                    continue
                if sub in lst:
                    lst.remove(sub)
                if not lst:
                    del self._by_node[nid]

    def _run(self) -> None:
        broker_sub = self.server.events.subscribe({"Allocation": ["*"]})
        try:
            self._pump(broker_sub)
        finally:
            broker_sub.close()

    def _pump(self, broker_sub) -> None:
        while not self._stop.is_set():
            events = broker_sub.next_events(timeout=0.25)
            if self._stop.is_set():
                return
            if broker_sub.truncated:
                # subscription gap: the ring evicted events this pump
                # never saw — every subscriber must full-resync
                broker_sub.truncated = False
                self._mark_all_resync()
            if not events:
                continue
            by_node: Dict[str, List] = {}
            resync_nodes = set()
            for ev in events:
                payload = ev.payload
                if ev.type == "alloc-block-upsert":
                    # columnar batch covering many nodes: cheaper to
                    # have affected subscribers re-read the snapshot
                    # (which materializes block rows) than to promote
                    # every position here
                    resync_nodes.update(getattr(payload, "node_ids", ()))
                    continue
                nid = getattr(payload, "node_id", "")
                if nid:
                    by_node.setdefault(nid, []).append(payload)
            with self._stats_lock:
                self.stats["events"] += len(events)
            self._deliver(by_node, resync_nodes)

    def _deliver(self, by_node: Dict[str, List], resync_nodes) -> None:
        with self._lock:
            targets = []
            for nid, allocs in by_node.items():
                for sub in self._by_node.get(nid, ()):
                    targets.append((sub, allocs, False))
            for nid in resync_nodes:
                for sub in self._by_node.get(nid, ()):
                    targets.append((sub, None, True))
        delivered = 0
        resyncs = 0
        for sub, allocs, resync in targets:
            if resync:
                sub._mark_resync()
                resyncs += 1
            else:
                sub._push(allocs)
                delivered += len(allocs)
        if delivered or resyncs:
            with self._stats_lock:
                self.stats["deltas"] += delivered
                self.stats["resyncs"] += resyncs
            REGISTRY.incr("nomad.allocsync.deltas", delivered)
            if resyncs:
                REGISTRY.incr("nomad.allocsync.resyncs", resyncs)

    def _mark_all_resync(self) -> None:
        with self._lock:
            subs = {s for lst in self._by_node.values() for s in lst}
        for s in subs:
            s._mark_resync()
        with self._stats_lock:
            self.stats["resyncs"] += len(subs)


class _Waiter:
    __slots__ = ("_event", "error")

    def __init__(self):
        self._event = threading.Event()
        self.error = None

    def done(self, error) -> None:
        self.error = error
        self._event.set()

    def wait(self, timeout: float = 30.0) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError("client alloc update batch did not commit")
        if self.error is not None:
            raise self.error


class ClientUpdateBatcher:
    """Coalesces concurrent `update_allocs_from_client` calls into one
    FSM command per round (the PR-5 plan-commit batching shape applied
    to the node plane), combiner-style: an uncontended caller commits
    its own round synchronously — zero added latency — and every caller
    arriving while that command is in flight parks its updates, which
    the in-flight leader drains into the next single command. Callers
    block until their round commits."""

    def __init__(self, store, batch: bool = True):
        self._store = store
        self.batch_enabled = batch
        self._cond = threading.Condition()   # guards pending/flags/stats
        self._pending: List[Tuple[List, _Waiter]] = []
        self._committing = False
        self.running = False
        self.stats = {"rounds": 0, "batched_updates": 0, "fallbacks": 0}

    def start(self) -> None:
        if not self.batch_enabled:
            return
        with self._cond:
            self.running = True

    def stop(self) -> None:
        with self._cond:
            if not self.running:
                return
            self.running = False
            # drain: the in-flight leader finishes every parked round
            deadline = time.monotonic() + 5.0
            while self._committing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)

    def submit(self, updates: List) -> None:
        """Commit a client status batch; blocks until it is durable (or
        raises the per-caller failure). Falls through to a direct store
        commit when batching is off or stopped."""
        if not updates:
            return
        lead = False
        with self._cond:
            if not self.running:
                w = None
            else:
                w = _Waiter()
                self._pending.append((list(updates), w))
                if not self._committing:
                    self._committing = True
                    lead = True
        if w is None:
            self._store.update_allocs_from_client(list(updates))
            return
        if lead:
            self._drain()
        w.wait()

    def _drain(self) -> None:
        """Commit rounds until no caller is parked, then hand off the
        leader role. Runs in the leading caller's thread."""
        while True:
            with self._cond:
                pending, self._pending = self._pending, []
                if not pending:
                    self._committing = False
                    self._cond.notify_all()
                    return
            flat = [u for updates, _w in pending for u in updates]
            try:
                self._store.update_allocs_from_client(flat)
                for _updates, w in pending:
                    w.done(None)
                with self._cond:
                    self.stats["rounds"] += 1
                    self.stats["batched_updates"] += len(flat)
                REGISTRY.incr("nomad.allocsync.ack_batched", len(flat))
            except Exception:
                # poisoned round: isolate per caller so one bad update
                # cannot fail everyone else's commit
                with self._cond:
                    self.stats["fallbacks"] += 1
                for updates, w in pending:
                    try:
                        self._store.update_allocs_from_client(updates)
                        w.done(None)
                    except Exception as e:  # noqa: BLE001
                        w.done(e)
