"""Plan queue and the serialized plan applier (reference
``nomad_tpu/core/plan_apply.py``).

Scheduler workers race against stale snapshots and submit plans; one
applier thread is the only writer of placement results. Per plan:

1. wait until the store has reached the plan's snapshot index;
2. re-check every touched node against the latest state with the fit
   predicate the scheduler used (``_evaluate``: one numpy comparison for
   nodes that only receive fresh placements without ports, devices or
   cores, the per-node walk ``_node_plan_valid`` with the port-collision,
   core-overlap and device checks of ``allocs_fit`` for the rest). A node whose plan no longer fits
   (a concurrent plan won the race) is rejected whole; a block's rows on
   it are marked rejected (``AllocBlock.without_nodes``);
3. commit what survived and hand the scheduler a refresh index so it
   places the remainder against fresher state. The plan's post-apply
   hooks run with the commit: the solver service's ``confirm`` gets the
   rejected node ids and corrects its carry once per solve.

Commits are batched: a commit thread lands every verified plan and eval
update waiting for it in one ``upsert_plan_results_batch``, while the
next plan verifies against an overlay of the results still in flight.
The fit re-check is host numpy, as in the reference: no device program.

Not ported: the reference's unbatched arm (``batch=False``,
``ServerConfig.plan_commit_batching``: one commit a plan on a one-thread
pool, ``_commit_task``) and its verify pool (``pool_workers``,
``PARALLEL_THRESHOLD``, which its own default keeps off), both kept
there for A/B runs; the overlapping commit rounds of a raft store
(``_run_commit_pipelined``, ``_begin_round``, ``_finish_round``: the
port's store commits synchronously), the CSI volume claim re-check
(``_volume_rejections``: the port places no volumes), plan deadlines
(``loadctl``) and the plan normalization that strips jobs for the raft
log.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import RECORDER, REGISTRY, TRACER
from ..structs import enums
from ..structs.funcs import allocs_fit
from ..structs.plan import Plan, PlanResult
from ..structs.resources import RESOURCE_DIMS


class PendingPlan:
    """A submitted plan awaiting the applier (reference ``:45``)."""

    __slots__ = ("plan", "_event", "result", "error")

    def __init__(self, plan: Plan):
        self.plan = plan
        self._event = threading.Event()
        self.result: Optional[PlanResult] = None
        self.error: Optional[Exception] = None

    def respond(self, result: Optional[PlanResult],
                error: Optional[Exception]) -> None:
        self.result = result
        self.error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> PlanResult:
        if not self._event.wait(timeout):
            raise TimeoutError("plan apply timed out")
        if self.error is not None:
            raise self.error
        return self.result


class PlanQueue:
    """Priority queue of pending plans (reference ``:76``)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._enabled = False
        self._heap: List[Tuple[int, int, PendingPlan]] = []
        self._seq = itertools.count()

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for _, _, p in self._heap:
                    p.respond(None, RuntimeError("plan queue disabled"))
                self._heap.clear()
            self._lock.notify_all()

    def enqueue(self, plan: Plan) -> PendingPlan:
        pending = PendingPlan(plan)
        with self._lock:
            if not self._enabled:
                pending.respond(None, RuntimeError("plan queue disabled"))
                return pending
            heapq.heappush(self._heap,
                           (-plan.priority, next(self._seq), pending))
            self._lock.notify_all()
        return pending

    def dequeue(self, timeout: Optional[float] = None
                ) -> Optional[PendingPlan]:
        # while disabled, wait rather than return: the applier polls in a
        # loop, and an instant None would spin it
        with self._lock:
            while True:
                if self._enabled and self._heap:
                    return heapq.heappop(self._heap)[2]
                if not self._lock.wait(timeout):
                    return None

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)


class BadNodeTracker:
    """Windowed per-node plan-rejection scoring (reference ``:124``): a
    node with ``threshold`` rejections inside ``window`` seconds is
    reported once a window."""

    def __init__(self, threshold: int = 15, window: float = 300.0,
                 on_bad_node=None):
        self.threshold = threshold
        self.window = window
        self.on_bad_node = on_bad_node
        self._lock = threading.Lock()
        self._events: Dict[str, List[float]] = {}
        self.stats = {"bad_nodes": 0}

    def add(self, node_id: str, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.time()
        fire = False
        with self._lock:
            events = self._events.setdefault(node_id, [])
            events.append(now)
            cutoff = now - self.window
            while events and events[0] < cutoff:
                events.pop(0)
            if len(events) >= self.threshold:
                events.clear()  # report once, then a fresh window
                fire = True
                self.stats["bad_nodes"] += 1
        if fire and self.on_bad_node is not None:
            try:
                self.on_bad_node(node_id)
            except Exception:  # noqa: BLE001 - a report must not fail a plan
                pass
        return fire


class _OverlaySnapshot:
    """In-flight plan results layered over a snapshot, oldest first,
    with the reads ``_evaluate`` makes (reference ``:161``): a new plan
    verifies against the state every pending commit will leave.

    A result stays in flight until its commit round is answered, so the
    snapshot may already hold it. Single allocs net out by id; an
    AllocBlock the snapshot holds is skipped whole. The reference adds
    every in-flight block's rows, counting a landed block twice and
    rejecting plans that fit (ROADMAP §C3)."""

    def __init__(self, snap, results: List[PlanResult]):
        self._snap = snap
        self._replaced: Dict[str, dict] = {}
        self._usage_deltas: Dict[str, object] = {}
        # node id -> [(block, row)] of in-flight columnar placements
        self._block_rows: Dict[str, list] = {}
        for result in results:  # later results override earlier ones
            for node_id in (set(result.node_allocation)
                            | set(result.node_update)
                            | set(result.node_preemptions)):
                by_id = self._replaced.setdefault(node_id, {})
                for bucket in (result.node_update, result.node_preemptions,
                               result.node_allocation):
                    for a in bucket.get(node_id, ()):
                        by_id[a.id] = a
            for block in result.alloc_blocks:
                if snap.alloc_block_by_id(block.id) is not None:
                    continue  # landed: the snapshot counts it
                for m in block.live_rows():
                    self._block_rows.setdefault(
                        block.node_ids[m], []).append((block, m))

    def node_by_id(self, node_id):
        return self._snap.node_by_id(node_id)

    def node_usage(self, node_id):
        """The usage row with the in-flight results' net effect."""
        base = self._snap.node_usage(node_id)
        by_id = self._replaced.get(node_id)
        rows = self._block_rows.get(node_id)
        if not by_id and not rows:
            return base
        delta = self._usage_deltas.get(node_id)
        if delta is None:
            delta = 0.0
            for aid, a in (by_id or {}).items():
                if not a.terminal_status():
                    delta = delta + a.allocated_vec
                base_a = self._snap.alloc_by_id(aid)
                if base_a is not None and not base_a.terminal_status():
                    delta = delta - base_a.allocated_vec
            for block, m in rows or ():
                delta = delta + block.allocated_vec * int(block.counts[m])
            self._usage_deltas[node_id] = delta
        if base is None:
            return delta
        return base + delta

    def allocs_by_node(self, node_id):
        overlay = self._replaced.get(node_id)
        rows = self._block_rows.get(node_id)
        base = self._snap.allocs_by_node(node_id)
        if not overlay and not rows:
            return base
        out = ([overlay.get(a.id, a) for a in base] if overlay
               else list(base))
        if overlay:
            have = {a.id for a in base}
            out.extend(a for aid, a in overlay.items() if aid not in have)
        for block, m in rows or ():
            out.extend(block.allocs_for_row(m))
        return out

    def alloc_by_id(self, alloc_id):
        for by_id in self._replaced.values():
            if alloc_id in by_id:
                return by_id[alloc_id]
        return self._snap.alloc_by_id(alloc_id)


class _CommitEntry:
    """One verified plan waiting on the commit thread, or with
    ``plan=None`` a bare eval-status update riding the same round."""

    __slots__ = ("plan", "result", "rejected", "verify_gen", "cell",
                 "future", "error", "payload", "trace", "t0")

    def __init__(self, plan, result, rejected, verify_gen, cell, future,
                 payload=None):
        self.plan = plan
        self.result = result
        self.rejected = rejected
        self.verify_gen = verify_gen
        self.cell = cell
        self.future = future
        self.error: Optional[Exception] = None
        self.payload = payload
        # the eval whose plan this is, and the entry's birth: _respond
        # records the plan.commit span from them
        self.trace = getattr(plan, "eval_id", None) or None
        self.t0 = time.time()


class PlanApplier:
    """The serialized applier (reference ``:281``)."""

    # verified plans a commit round lands at most
    COMMIT_BATCH_MAX = 64
    # nodes that only receive fresh resource-only placements verify in
    # one numpy pass at or above this many (below it the loop wins)
    VECTOR_THRESHOLD = 16

    def __init__(self, store, queue: PlanQueue, logger=None,
                 bad_node_tracker: Optional[BadNodeTracker] = None):
        self.store = store
        self.queue = queue
        self.logger = logger
        self._thread: Optional[threading.Thread] = None
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_q: "deque[_CommitEntry]" = deque()
        self._commit_cond = threading.Condition()
        self._stop = threading.Event()
        self.stats = {"applied": 0, "nodes_rejected": 0, "partial_commits": 0,
                      "commit_batches": 0, "batched_commits": 0,
                      "batched_eval_updates": 0}
        self._stats_lock = threading.Lock()
        self.bad_nodes = bad_node_tracker or BadNodeTracker()
        # poison generation of the pipelined overlay: bumped when a
        # commit fails or a commit-time re-check rewrites a result later
        # plans' overlays already included; a plan verified at an older
        # generation re-verifies before its commit
        self._poison_gen = 0

    def start(self) -> None:
        self._stop.clear()
        self._commit_thread = threading.Thread(
            target=self._run_commit, daemon=True, name="plan-commit")
        self._commit_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="plan-applier")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.queue.set_enabled(False)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._commit_thread is not None:
            with self._commit_cond:
                self._commit_cond.notify_all()
            self._commit_thread.join(timeout=5.0)
            # answer anything that raced in after the commit thread's
            # last look, in the same lock hold that retires the thread
            with self._commit_cond:
                stranded = list(self._commit_q)
                self._commit_q.clear()
                self._commit_thread = None
            for entry in stranded:
                if not entry.future.done():
                    entry.future.set_exception(
                        RuntimeError("plan applier stopped"))

    def _run(self) -> None:
        # every submitted-but-unlanded commit, oldest first; each cell
        # holds the result its overlay readers see (seqlock with
        # _poison_gen: writers update the cell, then bump; readers read
        # the generation, then the cells)
        inflight: List[Tuple[Future, dict]] = []
        while not self._stop.is_set():
            pending = self.queue.dequeue(timeout=0.2)
            REGISTRY.set_gauge("nomad.plan.queue_depth", self.queue.depth())
            if pending is None:
                continue
            try:
                inflight = [(f, c) for f, c in inflight if not f.done()]
                verify_gen = self._poison_gen
                overlays = [c["result"] for _, c in inflight]
                result, rejected = self._verify(pending.plan, overlays)
                cell = {"result": result}
                fut: Future = Future()
                fut.add_done_callback(self._responder(pending))
                entry = _CommitEntry(pending.plan, result, rejected,
                                     verify_gen, cell, fut)
                with self._commit_cond:
                    if self._stop.is_set() and self._commit_thread is None:
                        raise RuntimeError("plan applier stopped")
                    self._commit_q.append(entry)
                    self._commit_cond.notify()
                inflight.append((fut, cell))
            except Exception as e:  # noqa: BLE001 - answer the submitter
                if self.logger:
                    self.logger.exception("plan apply failed")
                pending.respond(None, e)

    @staticmethod
    def _responder(pending: PendingPlan):
        def done(fut: Future) -> None:
            err = fut.exception()
            if err is not None:
                pending.respond(None, err)
            else:
                pending.respond(fut.result(), None)
        return done

    # -- verify --

    def _verify(self, plan, overlay=None):
        with REGISTRY.time("nomad.plan.evaluate"), \
                TRACER.span("plan.verify",
                            trace=getattr(plan, "eval_id", None) or None):
            if plan.snapshot_index:
                snap = self.store.snapshot_min_index(plan.snapshot_index)
            else:
                snap = self.store.snapshot()
            if overlay:
                snap = _OverlaySnapshot(snap, overlay)
            return self._evaluate(snap, plan)

    @staticmethod
    def _result_equal(r1: PlanResult, rej1: List[str],
                      r2: PlanResult, rej2: List[str]) -> bool:
        if sorted(rej1) != sorted(rej2):
            return False
        for attr in ("node_allocation", "node_update", "node_preemptions"):
            d1, d2 = getattr(r1, attr), getattr(r2, attr)
            if set(d1) != set(d2):
                return False
            for k in d1:
                if [a.id for a in d1[k]] != [a.id for a in d2[k]]:
                    return False
        b1 = {(b.id, b.rejected_rows) for b in r1.alloc_blocks}
        b2 = {(b.id, b.rejected_rows) for b in r2.alloc_blocks}
        return b1 == b2

    # -- the batching commit thread --

    def _run_commit(self) -> None:
        """Group commit: drain every verified-and-waiting entry and land
        the lot as one ``upsert_plan_results_batch``, in submission
        order."""
        while True:
            with self._commit_cond:
                while not self._commit_q and not self._stop.is_set():
                    self._commit_cond.wait(0.2)
                if not self._commit_q:
                    if self._stop.is_set():
                        return
                    continue
                entries = []
                while self._commit_q and len(entries) < self.COMMIT_BATCH_MAX:
                    entries.append(self._commit_q.popleft())
            try:
                self._commit_entries(entries)
            except Exception as e:  # noqa: BLE001 - answer every submitter
                if self.logger:
                    self.logger.exception("plan commit batch failed")
                for entry in entries:
                    if not entry.future.done():
                        entry.future.set_exception(e)

    def _commit_entries(self, entries: List[_CommitEntry]) -> None:
        plans = self._round_prologue(entries)
        # 1: stale entries re-verify against the store overlaid with
        # their in-round predecessors (they land atomically with them)
        self._reverify_stale(plans, [])
        # 2: one transaction for the whole round
        writers = self._writers_for(entries)
        if writers:
            with TRACER.span("plan.commit_round", n=len(writers),
                             traces=[e.trace for e in entries if e.trace]):
                try:
                    index = self.store.upsert_plan_results_batch(
                        [p for _, p in writers])
                    for e, _ in writers:
                        if e.result is not None:
                            e.result.alloc_index = index
                except Exception:  # noqa: BLE001 - retried per plan
                    if self.logger:
                        self.logger.exception(
                            "batched plan commit failed; retrying per plan")
                    self._commit_fallback(writers)
        # 3: respond in order
        self._respond(entries)

    def _round_prologue(self, entries: List[_CommitEntry]
                        ) -> List[_CommitEntry]:
        plans = [e for e in entries if e.plan is not None]
        REGISTRY.set_gauge("nomad.plan.commit_batch_size", len(entries))
        with self._stats_lock:
            self.stats["commit_batches"] += 1
            self.stats["batched_commits"] += len(plans)
            self.stats["batched_eval_updates"] += len(entries) - len(plans)
        return plans

    def _poison(self, cell: Optional[dict], result: PlanResult) -> None:
        """Rewrite an overlay cell, then bump the generation."""
        with self._stats_lock:
            if cell is not None:
                cell["result"] = result
            self._poison_gen += 1

    def _reverify_stale(self, plans: List[_CommitEntry],
                        prior: List[_CommitEntry]) -> None:
        done: List[_CommitEntry] = list(prior)
        for e in plans:
            if self._poison_gen != e.verify_gen:
                overlays = [p.cell["result"] for p in done] or None
                new_result, new_rejected = self._verify(e.plan, overlays)
                if not self._result_equal(e.result, e.rejected,
                                          new_result, new_rejected):
                    self._poison(e.cell, new_result)
                e.result, e.rejected = new_result, new_rejected
            done.append(e)

    def _writers_for(self, entries: List[_CommitEntry]
                     ) -> List[Tuple[_CommitEntry, dict]]:
        payloads = [e.payload if e.plan is None
                    else self._payload_for(e.plan, e.result)
                    for e in entries]
        return [(e, p) for e, p in zip(entries, payloads) if p is not None]

    def _respond(self, entries: List[_CommitEntry]) -> None:
        for e in entries:
            if e.error is not None:
                self._poison(e.cell, PlanResult())  # nothing of e landed
                e.future.set_exception(e.error)
            elif e.plan is None:
                e.future.set_result(None)
            else:
                e.future.set_result(
                    self._finalize(e.plan, e.result, e.rejected))
            if e.trace is not None:
                TRACER.add_span("plan.commit", e.t0, time.time(),
                                trace=e.trace,
                                rejected=len(e.rejected or ()),
                                failed=e.error is not None)

    def _commit_fallback(self, writers: List[Tuple[_CommitEntry, dict]]
                         ) -> None:
        """The round's transaction failed (nothing landed): land each
        plan alone; after a failure later plans re-verify first."""
        dirty = False
        for e, payload in writers:
            try:
                if dirty and e.plan is not None:
                    new_result, new_rejected = self._verify(e.plan, None)
                    if not self._result_equal(e.result, e.rejected,
                                              new_result, new_rejected):
                        self._poison(e.cell, new_result)
                    e.result, e.rejected = new_result, new_rejected
                    payload = self._payload_for(e.plan, e.result)
                if payload is not None:
                    index = self.store.upsert_plan_results(**payload)
                    if e.result is not None:
                        e.result.alloc_index = index
            except Exception as err:  # noqa: BLE001 - this entry fails alone
                e.error = err
                dirty = True

    @staticmethod
    def _payload_for(plan: Plan, result: PlanResult) -> Optional[dict]:
        """The store-write keywords of one verified plan, or None when
        nothing is left to write."""
        placements, stops, preemptions = [], [], []
        for allocs in result.node_allocation.values():
            placements.extend(allocs)
        for allocs in result.node_update.values():
            stops.extend(allocs)
        for allocs in result.node_preemptions.values():
            preemptions.extend(allocs)
        if not (placements or stops or preemptions or result.alloc_blocks
                or result.deployment is not None or plan.eval_updates):
            return None
        return {"result_allocs": placements, "stopped_allocs": stops,
                "preempted_allocs": preemptions,
                "deployment": result.deployment,
                "evals": list(plan.eval_updates),
                "alloc_blocks": list(result.alloc_blocks)}

    def _commit(self, plan: Plan, result: PlanResult,
                rejected: List[str]) -> PlanResult:
        payload = self._payload_for(plan, result)
        if payload is not None:
            result.alloc_index = self.store.upsert_plan_results(**payload)
        return self._finalize(plan, result, rejected)

    def _finalize(self, plan: Plan, result: PlanResult,
                  rejected: List[str]) -> PlanResult:
        with self._stats_lock:
            self.stats["applied"] += 1
            if rejected:
                self.stats["nodes_rejected"] += len(rejected)
                self.stats["partial_commits"] += 1
        REGISTRY.incr("nomad.plan.submit")
        if rejected:
            REGISTRY.incr("nomad.plan.node_rejected", len(rejected))
            result.refresh_index = self.store.latest_index
            result.rejected_nodes = rejected
            RECORDER.record("plan", "partial_reject",
                            eval=(plan.eval_id or "")[:8],
                            nodes=[n[:8] for n in rejected[:4]],
                            n=len(rejected))
        else:
            RECORDER.record("plan", "applied",
                            eval=(plan.eval_id or "")[:8])
        # post-apply hooks run here, with the commit: the solver
        # service's confirm() must close its ledger entry as the usage
        # lands, or a resync in between counts the placements twice
        for hook in plan.post_apply_hooks:
            try:
                hook(result)
            except Exception:  # noqa: BLE001 - the commit already landed
                if self.logger:
                    self.logger.exception("post-apply hook failed")
        return result

    def submit_eval_updates(self, evals) -> Future:
        """Persist eval status updates in the next commit round; the
        future resolves (to None) once they are committed."""
        fut: Future = Future()
        entry = _CommitEntry(None, None, (), 0, None, fut,
                             payload={"evals": list(evals)})
        with self._commit_cond:
            if self._stop.is_set() or self._commit_thread is None:
                raise RuntimeError("plan applier not running")
            self._commit_q.append(entry)
            self._commit_cond.notify()
        return fut

    def apply(self, plan: Plan) -> PlanResult:
        """Synchronous verify and commit (tests and direct callers)."""
        result, rejected = self._verify(plan, None)
        return self._commit(plan, result, rejected)

    # -- the fit re-check (reference :971-1187) --

    def _evaluate(self, snap, plan: Plan) -> Tuple[PlanResult, List[str]]:
        """Per-node re-verification; an all_at_once plan commits fully or
        not at all. Nodes touched only by fresh resource-only placements
        (the whole bulk shape, blocks included) verify in one numpy
        comparison (``_vector_verdicts``); the rest walk their allocs
        (``_node_plan_valid``)."""
        result = PlanResult()
        rejected: List[str] = []
        block_delta: Dict[str, object] = {}
        block_nodes: set = set()
        for block in plan.alloc_blocks:
            vec = block.allocated_vec
            for m in block.live_rows():
                nid = block.node_ids[m]
                block_nodes.add(nid)
                prev = block_delta.get(nid)
                d = vec * int(block.counts[m])
                block_delta[nid] = d if prev is None else prev + d
        nodes = sorted(set(plan.node_allocation) | set(plan.node_update)
                       | set(plan.node_preemptions) | block_nodes)
        fast: List[str] = []
        exact: List[str] = []
        for nid in nodes:
            if nid in plan.node_update or nid in plan.node_preemptions:
                exact.append(nid)
                continue
            # exact ports, devices and cores need the per-alloc walk
            if all(a.create_index == 0 and not a.allocated_ports
                   and not a.allocated_devices and not a.allocated_cores
                   for a in plan.node_allocation.get(nid, ())):
                fast.append(nid)
            else:
                exact.append(nid)
        if len(fast) < self.VECTOR_THRESHOLD and not block_nodes:
            exact.extend(fast)
            fast = []
        verdict: Dict[str, bool] = {}
        if fast:
            verdict.update(self._vector_verdicts(snap, plan, fast,
                                                 block_delta))
        for nid in exact:
            verdict[nid] = self._node_plan_valid(snap, plan, nid)
        for node_id in nodes:
            if verdict[node_id]:
                for attr in ("node_allocation", "node_update",
                             "node_preemptions"):
                    bucket = getattr(plan, attr)
                    if node_id in bucket:
                        getattr(result, attr)[node_id] = bucket[node_id]
            else:
                rejected.append(node_id)
                self.bad_nodes.add(node_id)
        if rejected and plan.all_at_once:
            result.node_allocation.clear()
            result.node_update.clear()
            result.node_preemptions.clear()
            return result, sorted(nodes)
        if plan.alloc_blocks:
            rej_set = set(rejected) & block_nodes
            for block in plan.alloc_blocks:
                sliced = block.without_nodes(rej_set) if rej_set else block
                if any(True for _ in sliced.live_rows()):
                    result.alloc_blocks.append(sliced)
        result.deployment = plan.deployment
        return result, rejected

    def _vector_verdicts(self, snap, plan: Plan, node_ids: List[str],
                         block_delta: Optional[Dict[str, object]] = None,
                         ) -> Dict[str, bool]:
        """One (M, D) numpy comparison for M nodes that only receive
        fresh placements: usage row + the plan's vectors <= available."""
        m = len(node_ids)
        used = np.zeros((m, RESOURCE_DIMS))
        avail = np.zeros((m, RESOURCE_DIMS))
        ok = np.ones(m, dtype=bool)
        for i, nid in enumerate(node_ids):
            node = snap.node_by_id(nid)
            if node is None or node.status != enums.NODE_STATUS_READY \
                    or node.drain:
                ok[i] = False
                continue
            base = snap.node_usage(nid)
            if base is not None:
                used[i] = base
            for a in plan.node_allocation.get(nid, ()):
                used[i] += a.allocated_vec
            if block_delta:
                d = block_delta.get(nid)
                if d is not None:
                    used[i] += d
            avail[i] = node.available_vec()
        ok &= (used <= avail).all(axis=1)
        return dict(zip(node_ids, ok.tolist()))

    def _node_plan_valid(self, snap, plan: Plan, node_id: str) -> bool:
        node = snap.node_by_id(node_id)
        all_allocation = plan.node_allocation.get(node_id, [])
        if plan.alloc_blocks:
            block_allocs = plan.block_allocs_for_node(node_id)
            if block_allocs:
                all_allocation = list(all_allocation) + block_allocs
        # placement or update by id on the node, terminal allocs included
        all_node = snap.allocs_by_node(node_id)
        existing = [a for a in all_node if not a.terminal_status()]
        existing_ids = {a.id for a in all_node}
        # only new placements need a ready node; stops and updates land
        # on down or draining nodes too
        placements = [a for a in all_allocation if a.id not in existing_ids]
        if node is None:
            return not placements
        if placements and (node.status != enums.NODE_STATUS_READY
                           or node.drain):
            return False
        if not placements:
            return True
        removed = {a.id for a in plan.node_update.get(node_id, ())}
        removed |= {a.id for a in plan.node_preemptions.get(node_id, ())}
        proposed = [a for a in existing if a.id not in removed]
        updated_ids = {a.id for a in all_allocation}
        proposed = [a for a in proposed if a.id not in updated_ids]
        proposed.extend(all_allocation)
        check_devices = any(a.allocated_devices for a in proposed)
        fit, _, _ = allocs_fit(node, proposed, check_devices=check_devices)
        return fit
