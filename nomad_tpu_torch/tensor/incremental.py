"""The incremental usage feed and its device twin (a trimmed copy of
``nomad_tpu/tensor/incremental.py:83-720``).

One :class:`IncrementalFeed` per store subscribes to the event broker's
Allocation and Node topics and folds each delta into a host base of
per-node usage (f64, rows in a ClusterStatic's order), so

- ``ClusterTensors.refresh_usage`` takes the fed base as a shared
  read-only view instead of gathering the store's usage matrix;
- the solver service's resync starts from a twin of the base that lives
  on the device (:meth:`IncrementalFeed.device_used`): an f32
  ``(n_pad, D)`` tensor, or on a ``NodeMesh`` the list of its shards'
  row blocks, caught up with the base by ONE scatter launch over the
  pending rows of the epoch's delta log (B4, ``tensor/scatter.py``; on a
  mesh B15's adds, ``sharding.state_scatter_sharded``).

The feed is pull-only: deltas drain when a build, a resync or a verify
asks, under the feed's own lock, never on the store's commit path.

Consistency: a RESYNC rebuilds the base from one MVCC snapshot and pins
``position = snap.index``; every drained event with ``index <=
position`` is already inside it and is skipped. A lapped ring
(``Subscription.truncated``) resyncs; nothing is patched. Resource
values are integral and below 2^24, so f64 folds and the twin's f32
adds are exact in any order: :meth:`IncrementalFeed.force_verify`
compares the base with a gen-bounded rebuild, and each flushed twin with
``base.astype(float32)``, with no tolerance.

``NOMAD_TPU_INCR=0`` turns the feed off at every call site (read at call
time): builds and resyncs take the exact legacy routes.

Core GC's writes fold too (reference ``incremental.py:364-435``): an
``alloc-gc`` pops the dead rows (every GC'd alloc is terminal, so no
usage row moves) and records the block positions the store quietly
re-puts as dropped (``gc_dropped``: no event carries that re-put), and a
``node-delete`` of a node in the layout marks the epoch stale, so the
next build resyncs onto the new layout instead of folding onto the old
one.

A restore (a raft snapshot install, a restart from a data directory)
replaces the whole store; the event broker answers its ``restore``
commit by truncating every ring, and the next drain sees ``truncated``
and resyncs (reference ``incremental.py:335-338``): a replica that
installs a snapshot rebuilds its base and its twin, never folds deltas
onto the stale ones.

Trimmed: the sanitizer's periodic parity digests (``PARITY_EVERY``,
``StateTracker.install``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..obs import REGISTRY
from ..state.deltas import ALLOC_ROW_KINDS
from ..structs.resources import RESOURCE_DIMS
from .scatter import scatter_add
from .sharding import state_scatter_sharded
from .solver import upload

FEED_TOPICS = {"Allocation": ["*"], "Node": ["*"]}

# a log grown past this multiple of n_pad drops every twin and resets
LOG_CAP_MULT = 4


def incr_enabled() -> bool:
    """The kill switch, read at call time."""
    return os.environ.get("NOMAD_TPU_INCR", "1") != "0"


class Violation:
    __slots__ = ("kind", "message")

    def __init__(self, kind: str, message: str):
        self.kind = kind
        self.message = message

    def render(self) -> str:
        return f"[{self.kind}] {self.message}"


class _Twin:
    """One device copy of the base (one a device, or one a mesh), caught
    up to ``cursor`` entries of the epoch's delta log.

    Streams: the twin is fenced with events, not tied to a stream.
    ``ready`` holds, per card, the event recorded after the last call
    that wrote or handed out the twin; every later use (a flush, the
    verify's read, the caller's read of what ``device_used`` returns)
    first makes its card's current stream wait on it. The index and
    delta copies of a flush are queued on the same current stream as the
    launch. A caller that keeps the returned tensor reads it before
    another stream's caller may flush it: in the Server the solver
    service's resync, on the service's one stream, is the only caller, so
    its reads and the flushes run in stream order."""

    __slots__ = ("arr", "cursor", "cards", "ready")

    def __init__(self, arr, cursor: int, cards):
        self.arr = arr
        self.cursor = cursor
        self.cards = cards      # the CUDA devices the twin lies on
        self.ready = {}

    def wait(self) -> None:
        for dev, ev in self.ready.items():
            torch.cuda.current_stream(dev).wait_event(ev)

    def mark(self) -> None:
        ready = {}
        for dev in self.cards:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ready[dev] = ev
        self.ready = ready

    def host(self) -> np.ndarray:
        """The twin as one (n_pad, D) float32 host array."""
        self.wait()
        if isinstance(self.arr, list):
            return np.concatenate([p.cpu().numpy() for p in self.arr])
        return self.arr.cpu().numpy()


class _Epoch:
    """Feed state bound to one node LAYOUT (the ordered id tuple). A new
    static with the same membership and order keeps the epoch."""

    __slots__ = ("layout", "node_index", "n_pad", "base", "base_view",
                 "position", "rows", "blocks", "gc_dropped", "stale",
                 "devlog", "twins", "static_ref")

    def __init__(self, layout: tuple, node_index: Dict[str, int],
                 n_pad: int, position: int):
        self.layout = layout
        self.node_index = node_index
        self.n_pad = n_pad
        self.base = np.zeros((n_pad, RESOURCE_DIMS))
        self.base_view = self.base.view()
        self.base_view.setflags(write=False)
        self.position = position
        # alloc id -> (node_id, counted, vec) for REAL rows only; block
        # positions stay columnar (their implied row computed on demand)
        self.rows: Dict[str, tuple] = {}
        self.blocks: Dict[str, object] = {}
        # block id -> positions GC dropped after this epoch took the block
        self.gc_dropped: Dict[str, Set[int]] = {}
        # a node of the layout was deleted: resync before serving
        self.stale = False
        # append-only (row, f64 delta) log the twins consume
        self.devlog: List[tuple] = []
        self.twins: Dict[object, _Twin] = {}
        self.static_ref = None


class IncrementalFeed:
    """Delta-fed usage state for one (store, broker) pair. Every entry
    point takes ``self._lock``; nothing here runs on the commit path."""

    def __init__(self, store, broker, tracker: "StateTracker"):
        self.store = store
        self.tracker = tracker
        self.sub = broker.subscribe(dict(FEED_TOPICS))
        self._lock = threading.Lock()
        self._epoch: Optional[_Epoch] = None
        self._builds = 0
        self._fast_hits = 0
        self._resyncs = 0
        self._deltas_applied = 0
        self._parity_checks = 0
        self._twin_uploads = 0
        self._twin_flushes = 0
        self._alloc_uncounted = 0
        self._gauge_pub = None

    # -- public surface ------------------------------------------------

    def base_for(self, static) -> Optional[np.ndarray]:
        """The fed usage base in ``static``'s row order, as a read-only
        (n_pad, D) f64 view, or None (the kill switch): do the legacy
        build."""
        return self._base(static, take=False)[0]

    def base_for_build(self, static) -> Tuple[Optional[np.ndarray],
                                              Optional[int]]:
        """``base_for`` and ``take_build_delta_count`` under ONE
        acquisition of the lock, the drain that both need done once: a
        tensor build's first usage read. (None, None) with the kill
        switch."""
        return self._base(static, take=True)

    def _base(self, static, take: bool):
        if not incr_enabled() or static is None:
            return None, None
        with self._lock:
            self._builds += 1
            ep = self._epoch_for_locked(static)
            self._fast_hits += 1
            self._gauges()
            taken = None
            if take:
                taken, self._alloc_uncounted = self._alloc_uncounted, 0
            return ep.base_view, taken

    def device_used(self, static, device: torch.device, mesh=None):
        """The base's f32 twin on ``device`` (on ``mesh``: the list of its
        shards' row blocks, each on its shard's device), caught up by one
        scatter launch; None (the kill switch): take the host route."""
        if not incr_enabled() or static is None:
            return None
        with self._lock:
            ep = self._epoch_for_locked(static)
            return self._twin_locked(ep, device, mesh).arr

    def take_build_delta_count(self) -> int:
        """Allocation deltas since the previous take (the per-build
        number of ``nomad.worker.changed_allocs_per_build``). Drains
        first, so queued deltas land in this build's count."""
        with self._lock:
            ep = self._epoch
            if ep is not None and not ep.stale:
                self._drain_locked(ep)
            out, self._alloc_uncounted = self._alloc_uncounted, 0
            return out

    def force_verify(self) -> bool:
        """Drain and compare the base (and each flushed twin) with a
        gen-bounded rebuild now. Builds an epoch over the store's node
        set first if there is none."""
        from .cluster import _pad_pow2  # cluster imports this module

        if not incr_enabled():
            return True
        with self._lock:
            if self._epoch is None or self._epoch.stale:
                snap = self.store.snapshot()
                try:
                    ids = sorted(n.id for n in snap.nodes())
                finally:
                    snap.close()
                self._resync_locked(tuple(ids),
                                    {nid: i for i, nid in enumerate(ids)},
                                    _pad_pow2(max(len(ids), 1)))
            return self._verify_locked()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"builds": self._builds, "fast_hits": self._fast_hits,
                    "resyncs": self._resyncs,
                    "deltas_applied": self._deltas_applied,
                    "parity_checks": self._parity_checks,
                    "twin_uploads": self._twin_uploads,
                    "twin_flushes": self._twin_flushes}

    # -- epoch lifecycle ----------------------------------------------

    def _epoch_for_locked(self, static) -> _Epoch:
        ep = self._epoch
        if ep is not None and ep.stale:
            ep = None
        if ep is not None:
            if ep.static_ref is not static:
                if ep.layout != tuple(static.node_index):
                    ep = None
                else:
                    # a new static, same membership and order: adopt it,
                    # keep the base (no usage row moved)
                    ep.static_ref = static
                    ep.node_index = static.node_index
            if ep is not None:
                self._drain_locked(ep)
                ep = self._epoch          # the drain may have resynced
        if ep is None or ep.stale:
            self._resync_locked(tuple(static.node_index), static.node_index,
                                static.n_pad)
            ep = self._epoch
            ep.static_ref = static
        return ep

    def _resync_locked(self, layout: tuple, node_index: Dict[str, int],
                       n_pad: int) -> None:
        """Rebuild everything from one MVCC snapshot. Every event with
        index <= snap.index is inside the rebuilt base."""
        # the backlog predates the snapshot taken next: all of it is in
        # the base
        evs = self.sub.next_events()
        self.sub.truncated = False
        self._alloc_uncounted += sum(1 for e in evs
                                     if e.topic == "Allocation")
        store = self.store
        snap = store.snapshot()
        try:
            ep = _Epoch(layout, node_index, n_pad, snap.index)
            gen = snap.index
            usage = store._node_usage
            for nid, i in node_index.items():
                vec = usage.get(nid, gen)
                if vec is not None:
                    ep.base[i] = vec[:RESOURCE_DIMS]
            for aid, a in store._allocs.iterate(gen):
                ep.rows[aid] = (a.node_id, not a.terminal_status(),
                                a.allocated_vec)
            for bid, block in store._alloc_blocks.iterate(gen):
                ep.blocks[bid] = block
        finally:
            snap.close()
        self._epoch = ep
        self._resyncs += 1
        self._gauges()

    # -- drain + fold --------------------------------------------------

    def _drain_locked(self, ep: _Epoch) -> None:
        evs = self.sub.next_events()
        if self.sub.truncated:
            # a lapped ring or the restore sentinel: the answer is a
            # full resync, never incremental patching
            self._resync_locked(ep.layout, ep.node_index, ep.n_pad)
            self._epoch.static_ref = ep.static_ref
            return
        for e in evs:
            if e.topic == "Allocation":
                self._alloc_uncounted += 1
            if e.index <= ep.position:
                continue        # already inside the resync base
            self._fold(ep, e)
        # ep.position stays the resync floor: one commit emits many
        # events under one index, and the subscription's cursor already
        # delivers each event past it once

    def _fold(self, ep: _Epoch, e) -> None:
        kind, p = e.type, e.payload
        if kind in ALLOC_ROW_KINDS:
            self._fold_alloc_row(ep, p)
        elif kind == "alloc-block-upsert":
            self._fold_block(ep, p)
        elif kind == "alloc-gc":
            self._fold_gc(ep, p)
        elif kind == "node-delete":
            if p is not None and p.id in ep.node_index:
                # the node set changed mid-epoch: the next build's static
                # carries the new layout; serve nothing until then
                ep.stale = True
        # other Node kinds move no usage row

    def _fold_alloc_row(self, ep: _Epoch, a) -> None:
        new = (a.node_id, not a.terminal_status(), a.allocated_vec)
        prev = ep.rows.get(a.id)
        if prev is None:
            prev = self._virtual_row(ep, a.id)
        ep.rows[a.id] = new
        if prev is not None:
            pn, pc, pv = prev
            if (pc and new[1] and pn == new[0] and pv is not None
                    and new[2] is not None and np.array_equal(pv, new[2])):
                return          # a rewrite that moves no usage
            if pc and pv is not None:
                self._add(ep, pn, pv, -1.0)
        if new[1] and new[2] is not None:
            self._add(ep, new[0], new[2], 1.0)

    def _fold_block(self, ep: _Epoch, block) -> None:
        if block.id in ep.blocks:
            ep.blocks[block.id] = block     # the store emits a block once
            return
        ep.blocks[block.id] = block
        vec = block.allocated_vec
        for m in block.live_rows():
            c = int(block.counts[m])
            self._add(ep, block.node_ids[m], vec * c if c != 1 else vec, 1.0)

    def _fold_gc(self, ep: _Epoch, ids) -> None:
        from ..structs.alloc import BLOCK_SEP

        for aid in ids:
            # a GC'd alloc is terminal: it pops bookkeeping, moves nothing
            ep.rows.pop(aid, None)
            sep = aid.rfind(BLOCK_SEP)
            if sep > 0:
                try:
                    pos = int(aid[sep + 1:])
                except ValueError:
                    continue
                ep.gc_dropped.setdefault(aid[:sep], set()).add(pos)

    def _virtual_row(self, ep: _Epoch, aid: str) -> Optional[tuple]:
        """A block position's implied row, over the block the epoch holds
        (the feed's side of the store's ``_block_alloc``), with
        ``gc_dropped`` standing in for the store's quiet re-puts."""
        from ..structs.alloc import BLOCK_SEP

        sep = aid.rfind(BLOCK_SEP)
        if sep < 0:
            return None
        block = ep.blocks.get(aid[:sep])
        if block is None:
            return None
        try:
            pos = int(aid[sep + 1:])
        except ValueError:
            return None
        if not 0 <= pos < block.size or not block.visible(pos):
            return None
        if pos in ep.gc_dropped.get(aid[:sep], ()):
            return None
        return (block.node_ids[block.row_for_pos(pos)], True,
                block.allocated_vec)

    def _add(self, ep: _Epoch, node_id: str, vec, sign: float) -> None:
        row = ep.node_index.get(node_id)
        if row is None:
            return
        delta = vec[:RESOURCE_DIMS] if sign > 0 else -vec[:RESOURCE_DIMS]
        ep.base[row] += delta
        self._deltas_applied += 1
        if ep.twins:
            ep.devlog.append((row, delta))
            if len(ep.devlog) > LOG_CAP_MULT * ep.n_pad:
                # no consumer drains it: re-uploading the base is cheaper
                # than replaying this much
                ep.devlog.clear()
                ep.twins.clear()

    # -- device twins --------------------------------------------------

    def _twin_locked(self, ep: _Epoch, device: torch.device, mesh) -> _Twin:
        key = mesh if mesh is not None else device
        tw = ep.twins.get(key)
        if tw is not None and len(ep.devlog) - tw.cursor > ep.n_pad:
            tw = None               # lagged past a full base: re-upload
        if tw is None:
            base = np.ascontiguousarray(ep.base, dtype=np.float32)
            if mesh is None:
                arr, devs = upload(base, device), (device,)
            else:
                n_loc = mesh.n_loc(ep.n_pad)
                arr = [upload(base[s * n_loc:(s + 1) * n_loc], dev)
                       for s, dev in enumerate(mesh.devices)]
                devs = mesh.distinct
            tw = ep.twins[key] = _Twin(
                arr, len(ep.devlog), [d for d in devs if d.type == "cuda"])
            self._twin_uploads += 1
        else:
            tw.wait()
            if tw.cursor < len(ep.devlog):
                self._flush_twin(ep, tw, device, mesh)
                tw.cursor = len(ep.devlog)
        tw.mark()
        if all(t.cursor == len(ep.devlog) for t in ep.twins.values()):
            for t in ep.twins.values():
                t.cursor = 0
            ep.devlog.clear()
        return tw

    def _flush_twin(self, ep: _Epoch, tw: _Twin, device: torch.device,
                    mesh) -> None:
        """ONE launch adds every pending delta to the twin in place: B4,
        or on a mesh B15's adds. Exactly the pending rows go: the
        reference pads them to power-of-two buckets only to keep XLA's
        compiled shapes few, and the port's kernels take any row count."""
        entries = ep.devlog[tw.cursor:]
        idx = np.fromiter((row for row, _ in entries), dtype=np.int32,
                          count=len(entries))
        delta = np.stack([vec for _, vec in entries]).astype(np.float32)
        if mesh is None:
            scatter_add(tw.arr, upload(idx, device), upload(delta, device))
        else:
            dev0 = mesh.devices[0]
            state_scatter_sharded(mesh, tw.arr, upload(idx, dev0),
                                  upload(delta, dev0))
        self._twin_flushes += 1

    # -- parity --------------------------------------------------------

    def _verify_locked(self) -> bool:
        """Compare the base (and each flushed twin) with a gen-bounded
        rebuild. Draining under the store's write lock pins an index at
        which the subscription is complete, so the compare is exact. A
        mismatch records a violation and forces a resync."""
        ep = self._epoch
        if ep is None or ep.stale:
            return True
        store = self.store
        with store._write_lock:
            evs = self.sub.next_events()
            truncated = self.sub.truncated
            self.sub.truncated = False
            snap = store.snapshot()
        try:
            self._alloc_uncounted += sum(1 for e in evs
                                         if e.topic == "Allocation")
            if truncated:
                self._resync_locked(ep.layout, ep.node_index, ep.n_pad)
                self._epoch.static_ref = ep.static_ref
                return True
            for e in evs:
                if e.index > ep.position:
                    self._fold(ep, e)
            gen = snap.index
            truth = np.zeros((ep.n_pad, RESOURCE_DIMS))
            usage = store._node_usage
            for nid, i in ep.node_index.items():
                vec = usage.get(nid, gen)
                if vec is not None:
                    truth[i] = vec[:RESOURCE_DIMS]
        finally:
            snap.close()
        self._parity_checks += 1
        n = len(ep.layout)
        ok = np.array_equal(ep.base, truth)
        if ok:
            want = ep.base.astype(np.float32)
            for key, tw in ep.twins.items():
                if tw.cursor < len(ep.devlog):
                    continue        # unflushed: checked after its flush
                if not np.array_equal(tw.host(), want):
                    ok = False
                    self.tracker.record(Violation(
                        "state-divergence",
                        f"device twin on {key} diverged from the host base "
                        f"(n={n}, index {gen})"))
                    break
        else:
            bad = [ep.layout[i] for i in
                   np.nonzero(~np.all(ep.base[:n] == truth[:n],
                                      axis=1))[0][:8]]
            self.tracker.record(Violation(
                "state-divergence",
                f"incremental base diverged from the snapshot rebuild at "
                f"index {gen} ({self._resyncs} resync(s), "
                f"{self._deltas_applied} delta(s)): node(s) {bad}"))
        if not ok:
            self._epoch = None      # repair by resync
        self._gauges()
        return ok

    def _gauges(self) -> None:
        # base_for calls this on every build: write the registry only
        # when a counter moved
        vals = (self._resyncs, self._deltas_applied, self._parity_checks)
        if vals == self._gauge_pub:
            return
        self._gauge_pub = vals
        REGISTRY.set_gauge("nomad.state.resyncs", float(self._resyncs))
        REGISTRY.set_gauge("nomad.state.deltas_applied",
                           float(self._deltas_applied))
        REGISTRY.set_gauge("nomad.state.parity_checks",
                           float(self._parity_checks))


class StateTracker:
    """Attaches one feed a store and collects the feeds' parity
    violations."""

    def __init__(self):
        self._ilock = threading.Lock()
        self.violations: List[Violation] = []

    def attach(self, store, broker) -> IncrementalFeed:
        existing = getattr(store, "_incremental_feed", None)
        if existing is not None:
            return existing
        feed = IncrementalFeed(store, broker, self)
        store._incremental_feed = feed
        return feed

    def record(self, v: Violation) -> None:
        with self._ilock:
            self.violations.append(v)

    def check(self) -> None:
        if self.violations:
            raise AssertionError(
                "incremental state violations:\n"
                + "\n".join(v.render() for v in self.violations))


GLOBAL = StateTracker()


def maybe_attach(store, broker) -> IncrementalFeed:
    """The Server's hook: one feed a (store, broker) pair, idempotent."""
    return GLOBAL.attach(store, broker)


def feed_for(store) -> Optional[IncrementalFeed]:
    return (getattr(store, "_incremental_feed", None) if store is not None
            else None)


def device_used_fn(store, static):
    """A ``(device, mesh=None) -> twin`` closure for the solver service's
    resync, or None when no feed serves this store or the feed is off."""
    feed = feed_for(store)
    if feed is None or static is None or not incr_enabled():
        return None

    def fn(device, mesh=None):
        return feed.device_used(static, device, mesh)

    return fn
