"""Batched bulk-solve service: one device launch for many evals
(reference ``nomad_tpu/tensor/solver.py:95-965``).

Racing scheduler workers enqueue solve requests here and block on a
future while ONE service thread batches them (up to ``G_PAD`` per launch,
demand-driven: whatever queued while the previous launch ran forms the
next batch) into a single call whose usage carry stays on the device
between launches: :func:`kernels.solve_bulk_multi` for "tpu-binpack"
requests, :func:`batch_solver.solve_batch` (the joint auction) for
"tpu-solve" ones. The two tiers never share a launch.

"tpu-solve" workers that process a dequeued batch of evals together
open a :class:`BatchContext` sized to it and run each member inside
:class:`batch_member`; the service then holds a launch, at most
``JOINT_WAIT_S``, while members that may still submit have not, so the
whole batch lands in one joint launch.

The carry is an optimistic overlay: the store usage at the last resync
plus every solve since. Drift is repaired, not tolerated:

- every solve opens a LEDGER entry (per-node counts + ask);
- the plan's post-apply hook calls :meth:`confirm`: a committed solve
  closes its entry, rejected nodes queue NEGATIVE corrections that the
  next launch scatter-adds into the carry;
- a resync (every ``RESYNC_SOLVES`` solves, on a node-set change, or when
  the correction queue overflows) rebuilds the carry as committed store
  usage plus the still-open ledger entries. Where the request carries a
  ``used_dev_fn`` (the store has an incremental feed,
  ``incremental.py``), the base is the feed's device twin, cloned and
  folded by ONE B4 launch (on a mesh one B15 adds call): the twin
  route. Otherwise (no feed, ``NOMAD_TPU_INCR=0``, or the feed hands out
  no twin) committed usage is gathered and folded on the host and
  uploaded once: the host route. Both are counted (``twin_resyncs``,
  ``host_resyncs``; ``twin_misses`` the host resyncs of a request that
  had a ``used_dev_fn``).

On CUDA every launch runs on the service's own stream and records an
event. Launches chain through the carry in stream order. The fetch waits
on the launch's event and makes one ``.cpu()`` copy of the (G, N) int16
counts, the launch's only host sync. Double buffer: launch i
is fetched only after launch i+1 is queued, so i's workers commit while
the device solves i+1.

Node mesh (reference ``solver.py:332-363, 837-850``): when the process
sees more than one CUDA device, the service shards the carry, capacity,
masks and boosts over a power-of-two :class:`sharding.NodeMesh` of them
(capped by ``NOMAD_TPU_MESH_DEVICES``), and every launch goes through
:func:`sharding.solve_bulk_multi_sharded` ("tpu-binpack") or
:func:`sharding.solve_batch_sharded` ("tpu-solve"). With one card it
resolves to no mesh. An explicit ``mesh`` overrides the resolution; its
device list may repeat one device, S shards on one card. A sharded
launch is two host calls (the correction fold, then one cooperative
launch a card that runs every round on the device) and reads nothing
back at dispatch, so the double buffer overlaps on a mesh as off one.
Its fetch puts the shards' counts together in the one copy back.

Spans and counters (reference ``solver.py:401, 864-958``): a worker's
wait for its counts is ``solver.wait`` (on the eval's trace); each
launch records ``solver.launch`` (dispatch to fetch, no trace: one
launch serves many evals), on a mesh also ``solver.shard`` (dispatch)
and ``solver.allgather`` (the fetch), and a ``solver`` / ``launch``
flight-recorder event; the service's stats are mirrored into the
Registry as ``nomad.solver.*``.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..obs import RECORDER, REGISTRY, TRACER
from .batch_solver import solve_batch
from .kernels import solve_bulk_multi
from .overlay import INFLIGHT
from .scatter import scatter_add
from .sharding import (NodeMesh, gather_rows, shard_mesh,
                       solve_batch_sharded, solve_bulk_multi_sharded,
                       state_scatter_sharded)

_STOP = object()


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> a fresh tensor on ``device``. On CUDA the copy is
    staged through pinned memory and queued on the current stream without
    a host sync."""
    t = torch.from_numpy(np.array(arr))  # a private, writable copy
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _resident(device: torch.device, hit):
    """A cached (tensor, upload event): the caller's current stream waits
    on the event, and the tensor records that stream for the allocator."""
    t, ready = hit
    if ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        t.record_stream(stream)
    return t


def _upload_cached(da, key, host, device: torch.device):
    hit = da.get(key)
    if hit is None:
        t = upload(host, device)
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        hit = da[key] = (t, ready)
    return _resident(device, hit)


def ensure_resident(static, feas_base, aff, device: torch.device,
                    mesh: Optional[NodeMesh] = None):
    """Device copies of (capacity, mask, affinity) for one static,
    uploaded once and cached in ``static.device_arrays``, masks and boosts
    keyed by host-array identity (the static's caches hold the strong
    refs, so ids are not recycled); reference solver.py:170-205. The ONE
    place the cache-key protocol lives: the service's launches and the
    placer's fused bulk solve both read through it. With a ``mesh`` each
    is a list of the shards' node-row parts, under a cache tag of the
    mesh's layout.

    On CUDA an upload is queued on the uploading thread's current stream
    and records an event; every caller's current stream waits on the
    events of the copies it gets (and the copies record that stream for
    the allocator), so the service's stream and a worker's stream share
    the copies without a host sync and without reading one in flight."""
    da = static.device_arrays
    arrays = ((("avail",), lambda: static.available.astype(np.float32)),
              (("m", id(feas_base)), lambda: feas_base),
              (("a", id(aff)), lambda: aff.astype(np.float32)))
    if mesh is None:
        tag = str(device)
        return tuple(_upload_cached(da, key + (tag,), host(), device)
                     for key, host in arrays)
    n_loc = mesh.n_loc(static.n_pad)
    out = []
    for key, host in arrays:
        full = None
        parts = []
        for s, dev in enumerate(mesh.devices):
            pkey = key + ("mesh", repr(mesh), s)
            if pkey not in da and full is None:
                full = host()
            rows = None if full is None else full[s * n_loc:(s + 1) * n_loc]
            parts.append(_upload_cached(da, pkey, rows, dev))
        out.append(parts)
    return tuple(out)


class BatchContext:
    """Rendezvous for one worker batch under "tpu-solve": a member is
    settled once it submitted its first joint solve (it is in the queue)
    or its run returned without one; the service holds a joint launch
    only while some member of a request's context is unsettled."""

    __slots__ = ("_lock", "_pending")

    def __init__(self, expected: int):
        self._lock = threading.Lock()
        self._pending = expected

    def settle(self) -> None:
        with self._lock:
            self._pending -= 1

    def pending(self) -> int:
        with self._lock:
            return self._pending


_batch_tls = threading.local()


def current_batch() -> Optional[BatchContext]:
    return getattr(_batch_tls, "ctx", None)


def open_batch(expected: int) -> BatchContext:
    return BatchContext(expected)


class batch_member:
    """Run by each member eval's thread: binds the BatchContext to the
    thread, so the placer's solve call finds it, and settles the member
    on exit if it never submitted a joint solve."""

    def __init__(self, ctx: Optional[BatchContext]):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            _batch_tls.ctx = self._ctx
            _batch_tls.settled = False
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            if not getattr(_batch_tls, "settled", True):
                self._ctx.settle()
            _batch_tls.ctx = None
            _batch_tls.settled = True
        return False


def _settle_current_member() -> None:
    """Mark the calling thread's member settled: its first joint solve is
    in the queue."""
    ctx = current_batch()
    if ctx is not None and not getattr(_batch_tls, "settled", True):
        _batch_tls.settled = True
        ctx.settle()


class _Request:
    __slots__ = ("static", "feas_base", "aff", "ask", "k", "tg_count",
                 "seed", "used_fn", "used_dev_fn", "future", "token",
                 "joint", "batch_ctx")

    def __init__(self, static, feas_base, aff, ask, k, tg_count, seed,
                 used_fn, joint=False, batch_ctx=None, used_dev_fn=None):
        self.static = static
        self.feas_base = feas_base
        self.aff = aff
        self.ask = ask
        self.k = k
        self.tg_count = tg_count
        self.seed = seed
        # called at RESYNC time for a fresh committed-usage base: a base
        # captured at enqueue time goes stale under queue depth
        self.used_fn = used_fn
        # optional (device, mesh) -> the feed's device twin of committed
        # usage, or None: the resync's twin route (incremental.py)
        self.used_dev_fn = used_dev_fn
        self.future = Future()
        self.token = 0
        self.joint = joint          # solve through the joint auction tier
        self.batch_ctx = batch_ctx  # the worker batch's rendezvous, or None


class _LedgerEntry:
    """One in-flight solve: where its placements went, awaiting the plan
    outcome."""

    __slots__ = ("static", "idx", "counts", "ask", "born")

    def __init__(self, static, idx, counts, ask, born):
        self.static = static
        self.idx = idx        # (M,) node rows with placements
        self.counts = counts  # (M,) placement counts per row
        self.ask = ask        # (D,) per-placement usage
        self.born = born


class _Inflight:
    """One dispatched-but-unfetched launch."""

    __slots__ = ("rs", "static", "counts", "event", "g", "g_pad", "sharded",
                 "t0", "t_dispatched")

    def __init__(self, rs, static, counts, event, g, g_pad, sharded, t0,
                 t_dispatched):
        self.rs = rs
        self.static = static
        # (G_pad, N) int16 on the device, followed by a joint launch's
        # (6,) f32 info row (12 int16 words) and, on a mesh, the launch's
        # all-gathers (a joint launch's int32 count, a greedy launch's
        # (G_pad,) int32 rounds), so one copy reads them all back
        self.counts = counts
        self.event = event              # CUDA event after the launch
        self.g = g
        self.g_pad = g_pad
        self.sharded = sharded
        self.t0 = t0
        self.t_dispatched = t_dispatched


class BulkSolverService:
    G_PAD = 16          # evals per launch (padded; k=0 rows are no-ops)
    MAX_K = 32767       # int16 counts ceiling per eval
    RESYNC_SOLVES = 64  # overlay refresh cadence
    CORRECTIONS = 64    # sparse correction slots per launch
    LEDGER_TTL = 60.0   # s before an unconfirmed solve is presumed dead
    JOINT_WAIT_S = 0.25  # max hold for worker-batch rendezvous members

    def __init__(self, device: DeviceLike = None,
                 mesh: Optional[NodeMesh] = None):
        self.device = resolve(device)
        # the node mesh: explicit, or resolved at the first dispatch
        self._mesh = mesh
        self._mesh_resolved = mesh is not None
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # (static, used carry on the device, solves since the resync)
        self._state = None
        self._token = 0
        self._ledger: Dict[int, _LedgerEntry] = {}
        self._corrections: List[tuple] = []  # (node_row, delta_vec)
        self._stream = None
        self.stats = {"launches": 0, "solves": 0, "resyncs": 0,
                      "launch_s": 0.0, "corrections": 0, "pipelined": 0,
                      "overlap_s": 0.0, "busy_s": 0.0,
                      "joint_launches": 0, "joint_solves": 0,
                      "auction_won": 0, "auction_rounds": 0,
                      "joint_score": 0.0, "greedy_score": 0.0,
                      "sharded": 0, "allgathers": 0,
                      "twin_resyncs": 0, "host_resyncs": 0,
                      "twin_misses": 0,
                      "mesh_devices": 0 if mesh is None else mesh.size}
        # the one dispatched-but-unfetched launch (service thread only)
        self._inflight: Optional[_Inflight] = None

    def _resolve_mesh(self, n_pad: int) -> Optional[NodeMesh]:
        """The mesh for a static of ``n_pad`` rows, or None: an explicit
        mesh as given; else, once, the largest power of two of the
        visible CUDA devices, capped by NOMAD_TPU_MESH_DEVICES (1 forces
        one device), and no mesh below two. A mesh is used only when its
        size divides ``n_pad``."""
        if not self._mesh_resolved:
            self._mesh_resolved = True
            n = 0
            if self.device.type == "cuda":
                n = torch.cuda.device_count()
                cap = int(os.environ.get("NOMAD_TPU_MESH_DEVICES", "0") or 0)
                if cap > 0:
                    n = min(n, cap)
            if n > 1:
                n = 1 << (n.bit_length() - 1)
                self._mesh = shard_mesh(n, self.device)
                with self._lock:
                    self.stats["mesh_devices"] = n
        mesh = self._mesh
        if mesh is None or n_pad % mesh.size:
            return None
        return mesh

    # -- caller side (scheduler worker threads) --

    def solve(self, *, static, feas_base, aff, ask, k, tg_count, seed,
              used_fn, joint: bool = False, used_dev_fn=None):
        """Blocking solve of one fresh-placement bulk eval ->
        ((N_pad,) int64 per-node counts in canonical order, token). The
        caller arranges for confirm(token, rejected_node_ids) to run
        once the plan holding these placements is applied. With
        ``joint`` ("tpu-solve") the request goes through the joint
        auction with every joint request of its launch, and the calling
        thread's BatchContext, if any, rides along. ``used_dev_fn``, where
        given, is the resync's twin route (``incremental.device_used_fn``)."""
        if not 0 <= int(k) <= self.MAX_K:
            raise ValueError(f"k={k} outside [0, {self.MAX_K}]")
        req = _Request(static, feas_base, aff,
                       np.asarray(ask, dtype=np.float32), int(k),
                       float(tg_count), int(np.uint32(seed)), used_fn,
                       joint=joint,
                       batch_ctx=current_batch() if joint else None,
                       used_dev_fn=used_dev_fn)
        # put BEFORE ensure: the service thread clears its slot before
        # the final stop-drain, so a request racing stop() is either
        # drained (failed, answered) or starts a fresh thread
        self._q.put(req)
        self._ensure_thread()
        if req.batch_ctx is not None:
            # settle AFTER the put: the service may launch without a
            # member whose request it has, never the reverse
            _settle_current_member()
        # on the worker's thread, inside the eval's trace bind: the
        # queue, the rendezvous and the launch land on the eval's chain
        with TRACER.span("solver.wait", k=int(k), joint=bool(joint)):
            result = req.future.result()
        return result, req.token

    def confirm(self, token: int, rejected_node_ids) -> None:
        """Plan outcome for one solve: close its ledger entry and queue
        negative corrections for the placements on rejected nodes."""
        with self._lock:
            entry = self._ledger.pop(token, None)
            if entry is None or not rejected_node_ids:
                return
            rows = {entry.static.node_index.get(nid)
                    for nid in rejected_node_ids}
            for i, row in enumerate(entry.idx):
                if row in rows:
                    self._corrections.append(
                        (row, -float(entry.counts[i]) * entry.ask))
                    self.stats["corrections"] += 1

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="bulk-solver", daemon=True)
                self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            self._q.put(_STOP)
            t.join(timeout=10.0)

    # -- service thread --

    def _retire(self) -> None:
        with self._lock:
            self._thread = None

    def _run(self) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                # every worker that could feed the next batch may be
                # blocked on the in-flight launch: fetch it before parking
                self._fetch_inflight()
                req = self._q.get()
            if req is _STOP:
                self._fetch_inflight()
                self._retire()
                self._drain_failed()
                return
            batch = [req]
            deadline = None
            while len(batch) < self.G_PAD:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    # rendezvous: members of an open BatchContext that
                    # have not settled may still submit; hold the launch
                    # (bounded) so the whole worker batch solves jointly
                    if not any(r.batch_ctx is not None
                               and r.batch_ctx.pending() > 0
                               for r in batch):
                        break
                    # meanwhile the in-flight launch's workers commit
                    self._fetch_inflight()
                    if deadline is None:
                        deadline = time.monotonic() + self.JOINT_WAIT_S
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=min(remain, 0.01))
                    except queue.Empty:
                        continue
                if nxt is _STOP:
                    self._retire()
                    self._flush(batch)
                    self._fetch_inflight()
                    self._drain_failed()
                    return
                batch.append(nxt)
            self._flush(batch)

    def _drain_failed(self) -> None:
        """Fail any request that raced the stop sentinel into the queue."""
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return
            if nxt is not _STOP and not nxt.future.done():
                nxt.future.set_exception(
                    RuntimeError("bulk solver service stopped"))

    def _flush(self, batch: List[_Request]) -> None:
        # one launch per distinct (static, tier): mixed statics happen
        # only across a node-set version change, and a greedy request
        # never goes through the auction
        groups: Dict[tuple, List[_Request]] = {}
        for r in batch:
            groups.setdefault((id(r.static), r.joint), []).append(r)
        for rs in groups.values():
            try:
                inflight = self._dispatch_group(rs)
            except Exception as e:  # propagate to every blocked worker
                # the carry may be half-updated: resync on the next solve
                self._state = None
                self._fetch_inflight()
                for r in rs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            # double buffer: fetch launch i only once i+1 is queued
            self._fetch_inflight(pipelined=True)
            self._inflight = inflight

    def _fetch_inflight(self, pipelined: bool = False) -> None:
        """Drain the one unfetched launch, if any. Must run before
        anything that rebuilds the carry from the ledger: an unfetched
        launch has no ledger entries yet."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        try:
            self._fetch(inf, pipelined=pipelined)
        except Exception as e:
            self._state = None
            for r in inf.rs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _stream_ctx(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _resync_base(self, r: _Request, static, ledger_entries,
                     mesh: Optional[NodeMesh] = None):
        """Fresh carry: committed usage + open ledger entries. The twin
        route (reference ``solver.py:597-625``) takes the feed's device
        twin and folds on the device. A None from ``used_dev_fn`` is a
        miss with a cause (the kill switch flipped after the request was
        made) and takes the exact host route, counted; a failed launch
        raises, as on every route. The host route folds on the host and
        uploads once (on a mesh, each shard's rows to its device)."""
        if r.used_dev_fn is not None:
            dev_base = r.used_dev_fn(self.device, mesh)
            if dev_base is not None:
                with self._lock:
                    self.stats["twin_resyncs"] += 1
                REGISTRY.incr("nomad.solver.twin_resyncs")
                return self._fold_base_scatter(dev_base, static,
                                               ledger_entries, mesh)
            with self._lock:
                self.stats["twin_misses"] += 1
            REGISTRY.incr("nomad.solver.twin_misses")
        with self._lock:
            self.stats["host_resyncs"] += 1
        REGISTRY.incr("nomad.solver.host_resyncs")
        base = np.asarray(r.used_fn(), dtype=np.float32).copy()
        for idx, counts, ask in ledger_entries:
            base[idx] += counts[:, None].astype(np.float32) * ask[None, :]
        if mesh is None:
            return upload(base, self.device)
        n_loc = mesh.n_loc(base.shape[0])
        return [upload(base[s * n_loc:(s + 1) * n_loc], dev)
                for s, dev in enumerate(mesh.devices)]

    def _fold_base_scatter(self, dev_base, static, ledger_entries,
                           mesh: Optional[NodeMesh] = None):
        """The twin route's carry (reference ``solver.py:627-680``): a
        clone of the twin with the open ledger entries and the per-eval
        in-flight overlay added by ONE B4 launch (on a mesh one B15 adds
        call). The clone is what protects the twin: B1's fold and fill
        and the joint solve write their carry in place, and the twin must
        survive the solve. The rows go unpadded (the reference pads for
        XLA's shape cache; no rows, no launch)."""
        d = static.available.shape[1]
        rows_list, delta_list = [], []
        for idx, counts, ask in ledger_entries:
            rows_list.append(np.asarray(idx, dtype=np.int32))
            delta_list.append(counts[:, None].astype(np.float32)
                              * np.asarray(ask, np.float32)[None, :])
        tmp = np.zeros((static.n_pad, d), dtype=np.float32)
        INFLIGHT.fold(tmp[: len(static.nodes)], static.node_index)
        nz = np.nonzero(np.any(tmp != 0.0, axis=1))[0]
        if nz.size:
            rows_list.append(nz.astype(np.int32))
            delta_list.append(tmp[nz])
        idx = (np.concatenate(rows_list) if rows_list
               else np.zeros(0, dtype=np.int32))
        delta = (np.concatenate(delta_list) if delta_list
                 else np.zeros((0, d), dtype=np.float32))
        if mesh is None:
            base = dev_base.clone()
            scatter_add(base, upload(idx, self.device),
                        upload(delta, self.device))
            return base
        base = [p.clone() for p in dev_base]
        dev0 = mesh.devices[0]
        state_scatter_sharded(mesh, base, upload(idx, dev0),
                              upload(delta, dev0))
        return base

    def _device_arrays(self, static, rs: List[_Request],
                       mesh: Optional[NodeMesh] = None):
        """Resident capacity + stacked (G_pad, N) mask/affinity rows (on a
        mesh, lists of the shards' parts); the stacks of uniform batches
        (every row the same mask/aff, the common shape) are cached by the
        underlying host-array ids."""
        rows_m, rows_a = [], []
        avail = None
        for r in rs:
            avail, m, a = ensure_resident(static, r.feas_base, r.aff,
                                           self.device, mesh)
            rows_m.append((id(r.feas_base), m))
            rows_a.append((id(r.aff), a))
        # joint launches always take the full padded width (k=0 rows
        # are no-ops), so every joint launch has one shape
        g_pad = (self.G_PAD if rs[0].joint
                 else 1 if len(rs) == 1 else self.G_PAD)
        while len(rows_m) < g_pad:
            rows_m.append(rows_m[0])
            rows_a.append(rows_a[0])
        uniform = (all(i == rows_m[0][0] for i, _ in rows_m)
                   and all(i == rows_a[0][0] for i, _ in rows_a))
        tag = str(self.device) if mesh is None else repr(mesh)
        skey = ("stack", tag, g_pad, rows_m[0][0], rows_a[0][0])
        da = static.device_arrays
        stacked = da.get(skey) if uniform else None
        if stacked is None:
            if mesh is None:
                stacked = (torch.stack([m for _, m in rows_m]),
                           torch.stack([a for _, a in rows_a]))
            else:
                stacked = tuple(
                    [torch.stack([row[s] for _, row in rows])
                     for s in range(mesh.size)]
                    for rows in (rows_m, rows_a))
            if uniform:
                da[skey] = stacked
        return avail, stacked[0], stacked[1], g_pad

    def _dispatch_group(self, rs: List[_Request]) -> _Inflight:
        """Build the launch inputs, ship them and queue the solve,
        returning the device handles, without a host sync."""
        t0 = time.perf_counter()
        static = rs[0].static
        d = static.available.shape[1]
        mesh = self._resolve_mesh(static.n_pad)
        state = self._state
        used_dev, since = None, 0
        if state is not None and state[0] is static:
            used_dev, since = state[1], state[2]

        with self._lock:
            need_resync = (used_dev is None
                           or since >= self.RESYNC_SOLVES
                           or len(self._corrections) > self.CORRECTIONS)
        if need_resync:
            # the base is committed usage + OPEN ledger entries; an
            # unfetched launch has no entries yet, so drain it first
            self._fetch_inflight()

        now = time.time()
        with self._lock:
            # unconfirmed solves past the TTL belong to evals that died
            # between solve and submit: stop re-applying them at resync
            for t in [t for t, e in self._ledger.items()
                      if now - e.born > self.LEDGER_TTL]:
                del self._ledger[t]
            if need_resync:
                # the rebuild has no phantoms, so queued corrections go
                self._corrections.clear()
                ledger_entries = [(e.idx, e.counts, e.ask)
                                  for e in self._ledger.values()
                                  if e.static is static]
                corrections = []
            else:
                # at most one launch's worth; leftovers trip the overflow
                # check on the next dispatch
                corrections = self._corrections[:self.CORRECTIONS]
                self._corrections = self._corrections[self.CORRECTIONS:]

        cidx = np.zeros(self.CORRECTIONS, dtype=np.int32)
        cdelta = np.zeros((self.CORRECTIONS, d), dtype=np.float32)
        for i, (row, delta) in enumerate(corrections):
            cidx[i] = row
            cdelta[i] = delta

        with self._stream_ctx():
            if need_resync:
                used_dev = self._resync_base(rs[0], static, ledger_entries,
                                             mesh)
                since = 0
                with self._lock:
                    self.stats["resyncs"] += 1
            avail, feas, aff, g_pad = self._device_arrays(static, rs, mesh)
            g = len(rs)
            ask = np.zeros((g_pad, d), dtype=np.float32)
            k = np.zeros(g_pad, dtype=np.int32)
            tgc = np.ones(g_pad, dtype=np.float32)
            seeds = np.zeros(g_pad, dtype=np.int64)
            for i, r in enumerate(rs):
                ask[i] = r.ask
                k[i] = r.k
                tgc[i] = r.tg_count
                seeds[i] = r.seed
            joint = rs[0].joint
            if mesh is None:
                solve = solve_batch if joint else solve_bulk_multi
                out = solve(used_dev, avail, feas, aff,
                            *(upload(a, self.device)
                              for a in (ask, k, tgc, seeds, cidx, cdelta)),
                            g=g_pad)
                tail = [out[2]] if joint else []
            else:
                solve = (solve_batch_sharded if joint
                         else solve_bulk_multi_sharded)
                dev0 = mesh.devices[0]
                out = solve(mesh, used_dev, avail, feas, aff,
                            *(upload(a, dev0)
                              for a in (ask, k, seeds, cidx, cdelta)),
                            g=g_pad)
                tail = list(out[2:]) if joint else [out[2]]
            used_dev = out[0]
            counts = (out[1] if mesh is None
                      else gather_rows(out[1], dim=1))
            counts = torch.cat([counts.reshape(-1)] + [
                x.reshape(-1).view(torch.int16) for x in tail])
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        self._state = (static, used_dev, since + g)
        t1 = time.perf_counter()
        if mesh is not None:
            wall = time.time()
            TRACER.add_span("solver.shard", wall - (t1 - t0), wall, g=g,
                            joint=bool(joint), mesh_devices=mesh.size)
        RECORDER.record("solver", "launch", g=g, joint=bool(joint),
                        sharded=mesh is not None, resync=need_resync)
        return _Inflight(rs=rs, static=static, counts=counts, event=event,
                         g=g, g_pad=g_pad, sharded=mesh is not None, t0=t0,
                         t_dispatched=t1)

    def _fetch(self, inf: _Inflight, pipelined: bool = False) -> None:
        """The launch's ONLY host sync: wait for its event, copy the
        counts (and a joint launch's info row) back once, register ledger
        entries, resolve the futures."""
        t_f0 = time.perf_counter()
        if inf.event is not None:
            inf.event.synchronize()
        words = inf.counts.cpu().numpy()
        n_counts = inf.g_pad * inf.static.n_pad
        counts_np = words[:n_counts].reshape(inf.g_pad, inf.static.n_pad)
        tail = words[n_counts:]
        info_np = None
        allg = 0
        if inf.rs[0].joint:
            info_np = tail[:12].view(np.float32)
            if inf.sharded:
                allg = int(tail[12:14].view(np.int32)[0])
        elif inf.sharded:
            allg = int(tail.view(np.int32)[:inf.g].sum())
        t_f1 = time.perf_counter()
        born = time.time()
        TRACER.add_span("solver.launch", born - (t_f1 - inf.t0), born,
                        g=inf.g, joint=info_np is not None,
                        sharded=inf.sharded, pipelined=pipelined)
        if inf.sharded:
            TRACER.add_span("solver.allgather", born - (t_f1 - t_f0), born,
                            gathers=allg, per_eval=allg / max(inf.g, 1))
        with self._lock:
            self.stats["launches"] += 1
            self.stats["solves"] += inf.g
            # host cost only: dispatch + fetch
            self.stats["launch_s"] += ((inf.t_dispatched - inf.t0)
                                       + (t_f1 - t_f0))
            self.stats["overlap_s"] += max(0.0, t_f0 - inf.t_dispatched)
            self.stats["busy_s"] += max(0.0, t_f1 - inf.t_dispatched)
            if pipelined:
                self.stats["pipelined"] += 1
            if inf.sharded:
                self.stats["sharded"] += 1
                self.stats["allgathers"] += allg
            if info_np is not None:
                won = info_np[5] > 0.5
                self.stats["joint_launches"] += 1
                self.stats["joint_solves"] += inf.g
                self.stats["auction_won"] += int(won)
                self.stats["auction_rounds"] += int(info_np[4])
                self.stats["joint_score"] += float(
                    info_np[0] if won else info_np[1])
                self.stats["greedy_score"] += float(info_np[1])
            for i, r in enumerate(inf.rs):
                row = counts_np[i]
                idx = np.nonzero(row)[0]
                self._token += 1
                r.token = self._token
                self._ledger[r.token] = _LedgerEntry(
                    inf.static, idx, row[idx].astype(np.int64), r.ask, born)
            occupancy = (self.stats["overlap_s"] / self.stats["busy_s"]
                         if self.stats["busy_s"] > 0 else 0.0)
        # the Registry's lock is a leaf: taken after self._lock is dropped
        REGISTRY.incr("nomad.solver.launches")
        REGISTRY.incr("nomad.solver.solves", inf.g)
        if allg:
            REGISTRY.incr("nomad.solver.allgathers", allg)
        REGISTRY.set_gauge("nomad.solver.overlap_occupancy", occupancy)
        if info_np is not None:
            won = info_np[5] > 0.5
            REGISTRY.incr("nomad.solver.auction_won", int(won))
            REGISTRY.incr("nomad.solver.auction_rounds", int(info_np[4]))
            REGISTRY.incr("nomad.solver.joint_score",
                          float(info_np[0] if won else info_np[1]))
            REGISTRY.incr("nomad.solver.greedy_score", float(info_np[1]))
        for i, r in enumerate(inf.rs):
            r.future.set_result(counts_np[i].astype(np.int64))


_services: Dict[str, BulkSolverService] = {}
_service_lock = threading.Lock()


def get_service(device: DeviceLike = None) -> BulkSolverService:
    """The process's solver service for ``device`` (created on first
    use)."""
    dev = resolve(device)
    key = str(dev)
    svc = _services.get(key)
    if svc is None:
        with _service_lock:
            svc = _services.get(key)
            if svc is None:
                svc = _services[key] = BulkSolverService(dev)
    return svc
