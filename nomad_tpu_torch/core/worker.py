"""Scheduler workers (reference ``nomad_tpu/core/worker.py``).

Each worker loops: dequeue evals from the broker, wait for the store to
reach the eval's modify index, run the eval's scheduler against that
snapshot on the server's device, then ack (or nack on failure). The
worker is also the scheduler's planner: a plan goes through the plan
queue and the call blocks on the applier's verdict; a partial commit
hands back a fresher snapshot so the scheduler retries in-process.

Batched mode (``ServerConfig.eval_batch_size`` > 1): a worker drains up
to K ready evals at once, takes ONE snapshot at the batch's highest
modify index and runs the members concurrently on a per-worker pool, so
their commits and eval updates coalesce at the applier's commit thread.
Under "tpu-solve" the batch opens a ``tensor.solver.BatchContext`` sized
to it and every member runs inside ``batch_member``, so the solver
service solves the batch's bulk groups in one joint launch. A batch is
left settling on the pool while the worker dequeues the next one (the
double buffer, ``_drain_prev``).

Spans, at the reference's points: ``worker.snapshot``,
``worker.schedule``, ``plan.submit``, ``eval.persist``. Not ported: the
per-batch gauges of the feed's build routes
(``nomad.worker.batch_state_*``; the feed's own ``stats()`` count them),
the scheduler event hook and the cross-eval constraint caches.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..obs import REGISTRY, TRACER
from ..scheduler.scheduler import NewScheduler
from ..structs import enums
from ..structs.evaluation import Evaluation
from ..structs.plan import Plan

ALL_SCHED_TYPES = [
    enums.JOB_TYPE_SERVICE, enums.JOB_TYPE_BATCH,
    enums.JOB_TYPE_SYSTEM, enums.JOB_TYPE_SYSBATCH,
]


class _EvalRun:
    """One eval's processing state and its planner; confined to the one
    thread that runs it, so batch members never share scheduler state
    (reference ``:40``)."""

    def __init__(self, worker: "Worker", ev: Evaluation, token: str,
                 snapshot=None):
        self.worker = worker
        self.server = worker.server
        self.ev = ev
        self.token = token
        self.snapshot = snapshot

    def run(self):
        """Process the eval; ack on success, nack on failure. Returns
        the snapshot the eval ended on, or None on failure."""
        ev, server = self.ev, self.server
        try:
            with TRACER.bind(ev.trace()):
                snap = self.snapshot
                if snap is None or snap.index < ev.modify_index:
                    with TRACER.span("worker.snapshot",
                                     index=ev.modify_index):
                        snap = server.store.snapshot_min_index(
                            ev.modify_index)
                self.snapshot = snap
                sched = NewScheduler(ev.type, snap, self,
                                     sched_config=server.sched_config,
                                     device=server.device)
                with REGISTRY.time(
                        f"nomad.worker.invoke_scheduler_{ev.type}"), \
                        TRACER.span("worker.schedule", type=ev.type):
                    sched.process(ev)
                server.broker.ack(ev.id, self.token)
            self.worker._count("processed")
            return self.snapshot
        except Exception:  # noqa: BLE001 - the eval is redelivered
            if server.logger:
                server.logger.exception("eval %s failed", ev.id)
            self.worker._count("nacked")
            try:
                server.broker.nack(ev.id, self.token)
            except ValueError:
                pass  # the nack timer already fired
            return None

    # -- planner interface --

    def submit_plan(self, plan: Plan):
        plan.snapshot_index = getattr(self.snapshot, "index", 0) or 0
        with TRACER.span("plan.submit"):
            pending = self.server.plan_queue.enqueue(plan)
            # bounded well inside the broker's nack timer
            result = pending.wait(
                timeout=max(10.0, self.server.config.nack_timeout / 2.0))
        if result.refresh_index:
            # partial commit: hand the scheduler a fresher snapshot
            new_snap = self.server.store.snapshot_min_index(
                result.refresh_index)
            self.snapshot = new_snap
            return result, new_snap
        return result, None

    def _persist_eval(self, ev: Evaluation) -> None:
        """Commit one eval's status before acting on it, in the
        applier's next commit round."""
        with TRACER.span("eval.persist"):
            try:
                fut = self.server.plan_applier.submit_eval_updates([ev])
            except RuntimeError:
                # the applier stopped mid-eval: write directly
                self.server.store.upsert_evals([ev])
                return
            fut.result(timeout=max(
                10.0, self.server.config.nack_timeout / 2.0))

    def update_eval(self, ev: Evaluation) -> None:
        self._persist_eval(ev)
        if ev.should_block():
            self.server.blocked.block(ev)

    def create_eval(self, ev: Evaluation) -> None:
        self._persist_eval(ev)
        if ev.should_block():
            self.server.blocked.block(ev)
        elif ev.should_enqueue():
            self.server.broker.enqueue(ev)

    def reblock_eval(self, ev: Evaluation) -> None:
        self._persist_eval(ev)
        self.server.blocked.block(ev)


class Worker:
    """A scheduler worker thread (reference ``:160``)."""

    def __init__(self, server, worker_id: int = 0,
                 sched_types: Optional[List[str]] = None):
        self.server = server
        self.id = worker_id
        self.sched_types = sched_types or list(ALL_SCHED_TYPES)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"processed": 0, "nacked": 0}
        self._stats_lock = threading.Lock()
        self._batch_pool: Optional[ThreadPoolExecutor] = None
        # the previous batch, still settling on the pool:
        # (futures, publish) -- see process_batch
        self._prev_batch = None

    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    # -- lifecycle --

    def start(self) -> None:
        self._stop.clear()
        batch_size = self.server.config.eval_batch_size
        if batch_size > 1 and self._batch_pool is None:
            # 2x: one batch committing and one solving at any moment
            self._batch_pool = ThreadPoolExecutor(
                max_workers=2 * batch_size,
                thread_name_prefix=f"worker-{self.id}-eval")
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"worker-{self.id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self._batch_pool is not None:
            self._batch_pool.shutdown(wait=True)
            self._batch_pool = None

    # -- the loop --

    def run(self) -> None:
        while not self._stop.is_set():
            batch_size = self.server.config.eval_batch_size
            if batch_size > 1:
                batch = self.server.broker.dequeue_batch(
                    self.sched_types, max_batch=batch_size, timeout=0.2)
                if not batch:
                    self._drain_prev()
                    continue
                self.process_batch(batch)
            else:
                ev, token = self.server.broker.dequeue(
                    self.sched_types, timeout=0.2)
                if ev is None:
                    continue
                self.process_one(ev, token)
        self._drain_prev()

    def _drain_prev(self) -> None:
        """Wait for the previous batch and publish its preemption split
        (the worker thread only)."""
        prev = self._prev_batch
        if prev is None:
            return
        self._prev_batch = None
        futs, publish = prev
        for f in futs:
            try:
                f.result()
            except Exception:  # noqa: BLE001 - _EvalRun.run never raises
                pass
        publish()

    def process_batch(self, batch: List) -> None:
        """Run a drained batch of evals against ONE shared snapshot
        (reference ``:252``); members ack or nack on their own."""
        from ..tensor.placer import preempt_stats

        REGISTRY.set_gauge("nomad.worker.eval_batch_size", len(batch))
        # the batch's preemption split (the counters are cumulative)
        preempt_before = preempt_stats()
        snap = None
        try:
            target = max(ev.modify_index for ev, _ in batch)
            with TRACER.span("worker.snapshot", index=target,
                             traces=[ev.trace() for ev, _ in batch]):
                snap = self.server.store.snapshot_min_index(target)
        except Exception:  # noqa: BLE001 - members snapshot on their own
            snap = None

        def publish_preempt_delta():
            post = preempt_stats()
            for key in ("kernel_preempted", "host_preempted"):
                delta = post[key] - preempt_before[key]
                if delta:
                    REGISTRY.set_gauge(f"nomad.worker.batch_{key}", delta)

        pool = self._batch_pool
        if len(batch) == 1 or pool is None:
            self._drain_prev()  # the inline path stays strictly ordered
            for ev, token in batch:
                if self._stop.is_set():
                    break  # shutting down: the nack timers redeliver
                snap = self.process_one(ev, token, snapshot=snap) or snap
            publish_preempt_delta()
            return
        # "tpu-solve": a rendezvous sized to this batch, so the solver
        # service solves every member's bulk group in one joint launch
        batch_ctx = None
        sched_config = self.server.sched_config
        if (sched_config is not None and sched_config.scheduler_algorithm
                == enums.SCHED_ALG_TPU_SOLVE):
            from ..tensor.solver import open_batch

            batch_ctx = open_batch(len(batch))
        futs = []
        try:
            for ev, token in batch:
                futs.append(pool.submit(
                    self._run_member, batch_ctx,
                    _EvalRun(self, ev, token, snapshot=snap)))
        except RuntimeError:
            # the pool shut down mid-batch: settle the members that never
            # ran so the service does not hold its launch for them
            if batch_ctx is not None:
                for _ in range(len(batch) - len(futs)):
                    batch_ctx.settle()
        # double buffer: settle the previous batch, leave this one on
        # the pool and go back to the broker
        self._drain_prev()
        self._prev_batch = (futs, publish_preempt_delta)

    @staticmethod
    def _run_member(batch_ctx, eval_run):
        if batch_ctx is None:
            return eval_run.run()
        from ..tensor.solver import batch_member

        with batch_member(batch_ctx):
            return eval_run.run()

    def process_one(self, ev: Evaluation, token: str, snapshot=None):
        """Process one eval on the calling thread."""
        return _EvalRun(self, ev, token, snapshot=snapshot).run()
