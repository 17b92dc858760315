"""Server: the scheduling core of the control plane (a trimmed copy of
``nomad_tpu/core/server.py``).

Wires the MVCC state store to the eval broker, the blocked-evals
tracker, the plan queue and applier, the scheduler workers, the event
broker (``events``) and the incremental usage feed it feeds
(``tensor/incremental.py``; ``NOMAD_TPU_INCR=0`` turns it off at call
time), on one device: ``ServerConfig.device`` (resolved by
``device.resolve``: the card by default, raising without one; the CPU
only when asked) is threaded down Server -> Worker -> scheduler ->
``TorchPlacer`` ->
``tensor.solver.get_service(device)``. The calls it serves:
``register_job``, ``deregister_job``, ``register_node(s)``,
``create_eval``; ``wait_for_idle`` for tests and benchmarks. Use it as a
context manager (``with Server(...) as srv:``): ``stop`` leaves no worker,
applier, broker or reaper thread running.

Trimmed, and left to ROADMAP A10 (each is an attribute or method of the
reference the port does not have): the heartbeat manager
(``heartbeats``, ``heartbeat``, ``heartbeat_batch``, ``mark_node(s)_down``,
``_restore_heartbeats``), the deployment watcher
(``deployment_watcher``, ``promote_deployment``, ``fail_deployment``),
the drainer (``drainer``, ``update_node_drain``), periodic and
parameterized jobs (``periodic``, ``dispatch_job``), core GC
(``core_gc``, ``force_gc``), the event broker's direct publishes (the
bad-node quarantine publishes nothing) and its sizing knobs
(``event_ring_size``, ``event_shards``: the broker keeps its defaults,
rings of 4,096 events in 8 shards), the shadow replica
(``shadow.maybe_attach``, ROADMAP A8), client alloc sync (``alloc_sync``,
``client_updates``, ``update_allocs_from_client``, ``stop_alloc``),
ACLs, identities and variables (``acl_*``, ``encrypter``,
``sign_workload_identity``, ``*_variable``), federation and ACL
replication (``region*``, ``_run_acl_replication``), the overload
controller (``loadctl``, the ``_tiered`` admission decorator, poison-eval
quarantine), namespaces, node pools, volumes and service registrations
(``_check_namespace``, ``upsert_node_pool``, ``register_volume``, ...),
the scheduler-config replication (``set_scheduler_config``), dry-run
plans (``plan_job``), job scaling and reverts, and the unbatched
plan-commit arm (``plan_commit_batching``; the applier always batches,
see core/plan_apply.py).
"""

from __future__ import annotations

import copy as _copy
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..device import DeviceLike, resolve
from ..state import StateStore
from ..structs import enums
from ..structs.evaluation import Evaluation
from ..structs.job import Job
from ..structs.node import Node
from ..structs.operator import SchedulerConfiguration
from ..tensor import incremental
from ..utils.ids import generate_uuid
from .blocked import BlockedEvals
from .broker import FAILED_QUEUE, EvalBroker
from .events import EventBroker
from .plan_apply import BadNodeTracker, PlanApplier, PlanQueue
from .worker import Worker


@dataclass
class ServerConfig:
    num_workers: int = 2
    nack_timeout: float = 60.0
    eval_delivery_limit: int = 3
    # evals a worker drains a dequeue and runs on one snapshot
    eval_batch_size: int = 8
    # backoff before a delivery-limited eval's follow-up runs
    failed_eval_followup_delay: float = 60.0
    # cadence of the retry of evals blocked by plan-attempt exhaustion
    failed_eval_unblock_interval: float = 60.0
    # bad-node quarantine: a node rejecting this many plans inside the
    # window is marked ineligible (off by default, as the reference)
    plan_rejection_tracker_enabled: bool = False
    plan_rejection_threshold: int = 100
    plan_rejection_window: float = 300.0
    sched_config: SchedulerConfiguration = field(
        default_factory=SchedulerConfiguration)
    # where the placer's tensors and kernels run: None is the card
    device: DeviceLike = None


class Server:
    def __init__(self, config: Optional[ServerConfig] = None,
                 store: Optional[StateStore] = None, logger=None):
        self.config = config or ServerConfig()
        self.device = resolve(self.config.device)
        self.store = store if store is not None else StateStore()
        self.logger = logger or logging.getLogger("nomad_tpu_torch.server")
        self.sched_config = self.config.sched_config
        self.broker = EvalBroker(
            nack_timeout=self.config.nack_timeout,
            delivery_limit=self.config.eval_delivery_limit)
        self.blocked = BlockedEvals(self._requeue_unblocked,
                                    persist_fn=self.store.upsert_evals)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(
            self.store, self.plan_queue, self.logger,
            bad_node_tracker=BadNodeTracker(
                threshold=self.config.plan_rejection_threshold,
                window=self.config.plan_rejection_window,
                on_bad_node=self._on_bad_node))
        self.workers: List[Worker] = [
            Worker(self, i) for i in range(self.config.num_workers)]
        self.events = EventBroker(self.store)
        # the incremental usage feed reads this event stream (always
        # attached; NOMAD_TPU_INCR=0 is its call-time kill switch)
        incremental.maybe_attach(self.store, self.events)
        self._running = False
        self._reaper: Optional[threading.Thread] = None
        # commit listeners fire on the store's write path; unblocking
        # writes through the store, so events go through a queue to the
        # commit pump's thread (reference :225-237)
        self._commit_q: "queue.Queue" = queue.Queue()
        self.store.add_commit_listener(
            lambda index, events: self._commit_q.put((index, events)))
        self._commit_pump: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._commit_pump = threading.Thread(
            target=self._run_commit_pump, daemon=True, name="commit-pump")
        self._commit_pump.start()
        self.plan_queue.set_enabled(True)
        self.plan_applier.start()
        self.broker.set_enabled(True)
        self.blocked.set_enabled(True)
        self._restore_evals()
        for w in self.workers:
            w.start()
        self._reaper = threading.Thread(target=self._run_reaper,
                                        daemon=True, name="eval-reaper")
        self._reaper.start()

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        for w in self.workers:
            w.stop()
        for w in self.workers:
            w.join()
        self.blocked.set_enabled(False)
        self.broker.set_enabled(False)
        self.plan_applier.stop()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        self._commit_q.put(None)
        if self._commit_pump is not None:
            self._commit_pump.join(timeout=5.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _restore_evals(self) -> None:
        """Re-enqueue pending evals and re-block blocked ones of a store
        the server starts on (reference :426)."""
        for ev in self.store.snapshot().evals():
            if ev.should_enqueue():
                self.broker.enqueue(ev)
            elif ev.should_block():
                self.blocked.block(ev)

    # -- commit listener: unblock blocked evals on cluster changes --

    def _run_commit_pump(self) -> None:
        while True:
            item = self._commit_q.get()
            if item is None:
                return
            try:
                self._on_commit(*item)
            except Exception:  # noqa: BLE001 - the pump must keep running
                if self.logger:
                    self.logger.exception("commit listener failed")

    def _on_commit(self, index: int, events: list) -> None:
        """The reference's unblock rules (:452-475); other kinds, such as
        ``alloc-upsert`` and ``alloc-block-upsert``, unblock nothing."""
        for kind, payload in events:
            if kind in ("node-upsert", "node-status", "node-eligibility",
                        "node-drain"):
                if payload is not None and payload.ready():
                    self.blocked.unblock(payload.computed_class)
            elif kind in ("alloc-stop", "alloc-preempt",
                          "alloc-client-update", "alloc-transition"):
                # capacity freed by a terminal alloc can unblock evals
                if payload is not None and (payload.terminal_status()
                                            or payload.server_terminal()):
                    self.blocked.unblock("")

    def _on_bad_node(self, node_id: str) -> None:
        """A node crossed the plan-rejection threshold: mark it
        ineligible so schedulers stop spending retries on it."""
        if not self.config.plan_rejection_tracker_enabled:
            return
        if self.logger:
            self.logger.warning(
                "node %s exceeded the plan rejection threshold; "
                "marking ineligible", node_id)
        try:
            self.store.update_node_eligibility(
                node_id, enums.NODE_SCHED_INELIGIBLE)
        except KeyError:
            pass  # the node vanished

    def _requeue_unblocked(self, ev: Evaluation) -> None:
        """An unblocked eval re-enters the broker as pending, on a copy
        (store snapshots share the object)."""
        upd = _copy.copy(ev)
        upd.status = enums.EVAL_STATUS_PENDING
        upd.wait_until = 0.0
        self.store.upsert_evals([upd])
        self.broker.enqueue(upd)

    # -- failed-eval reaper (reference :507) --

    def _run_reaper(self) -> None:
        next_unblock_failed = (time.time()
                               + self.config.failed_eval_unblock_interval)
        while self._running:
            self.broker.wait_for_reaper_work(
                timeout=max(0.05, next_unblock_failed - time.time()))
            if not self._running:
                return
            cancelled = self.broker.drain_cancelled()
            if cancelled:
                self.store.upsert_evals(cancelled)
            # conflict-stranded (max-plan) blocked evals retry on a timer
            if time.time() >= next_unblock_failed:
                self.blocked.unblock_failed()
                next_unblock_failed = (
                    time.time() + self.config.failed_eval_unblock_interval)
            # delivery-limited evals: mark failed, schedule a follow-up
            ev, token = self.broker.dequeue([FAILED_QUEUE], timeout=0)
            if ev is None:
                continue
            failed = _copy.copy(ev)
            failed.status = enums.EVAL_STATUS_FAILED
            failed.status_description = "evaluation reached delivery limit"
            followup = Evaluation(
                id=generate_uuid(), namespace=ev.namespace,
                priority=ev.priority, type=ev.type,
                triggered_by=enums.TRIGGER_FAILED_FOLLOW_UP,
                job_id=ev.job_id, status=enums.EVAL_STATUS_PENDING,
                wait_until=(time.time()
                            + self.config.failed_eval_followup_delay),
                previous_eval=ev.id, create_time=time.time())
            self.store.upsert_evals([failed, followup])
            try:
                self.broker.ack(ev.id, token)
            except ValueError:
                pass
            self.broker.enqueue(followup)

    # -- job calls --

    def register_job(self, job: Job) -> str:
        """Job.Register: upsert the job and create its eval; returns the
        eval id."""
        self.store.upsert_job(job)
        return self._create_job_eval(job, enums.TRIGGER_JOB_REGISTER)

    def deregister_job(self, job_id: str, namespace: str = "default",
                       purge: bool = False) -> str:
        """Job.Deregister: mark the job stopped (or purge it) and create
        the eval whose plan stops its allocs."""
        job = self.store.snapshot().job_by_id(job_id, namespace)
        self.store.delete_job(job_id, namespace, purge=purge)
        self.blocked.untrack_job(namespace, job_id)
        if job is None:
            return ""
        return self._create_job_eval(job, enums.TRIGGER_JOB_DEREGISTER,
                                     namespace=namespace)

    def _create_job_eval(self, job: Job, trigger: str,
                         namespace: Optional[str] = None) -> str:
        ev = Evaluation(
            id=generate_uuid(), namespace=namespace or job.namespace,
            priority=job.priority, type=job.type, triggered_by=trigger,
            job_id=job.id, status=enums.EVAL_STATUS_PENDING,
            create_time=time.time())
        # upsert_evals stamps the indexes in its transaction
        self.store.upsert_evals([ev])
        self.broker.enqueue(ev)
        return ev.id

    def create_eval(self, ev: Evaluation) -> str:
        self.store.upsert_evals([ev])
        if ev.should_enqueue():
            self.broker.enqueue(ev)
        return ev.id

    # -- node calls --

    def register_node(self, node: Node) -> None:
        """Node.Register; a ready node gets the evals of the system jobs
        and of the jobs with allocs on it."""
        if not node.id:
            raise ValueError("node registration requires node.id")
        if not node.computed_class:
            node.compute_class()
        self.store.upsert_node(node)
        if node.ready():
            self._create_node_evals_batch([node.id])

    def register_nodes(self, nodes: List[Node]) -> None:
        """Many nodes in one store write and one eval pass."""
        for node in nodes:
            if not node.id:
                raise ValueError("node registration requires node.id")
            if not node.computed_class:
                node.compute_class()
        if not nodes:
            return
        self.store.upsert_nodes(list(nodes))
        ready = [n.id for n in nodes if n.ready()]
        if ready:
            self._create_node_evals_batch(ready)

    def _create_node_evals_batch(self, node_ids: List[str]) -> List[str]:
        """One eval a (job, node) pair off one snapshot: the jobs with
        live allocs on the node and, for a ready node, the system jobs
        (reference :909)."""
        snap = self.store.snapshot()
        now = time.time()
        sys_jobs: Optional[List[Job]] = None
        out, evals = [], []
        for node_id in node_ids:
            node = snap.node_by_id(node_id)
            jobs: Dict[tuple, Job] = {}
            for alloc in snap.allocs_by_node(node_id):
                if alloc.terminal_status():
                    continue
                job = snap.job_by_id(alloc.job_id, alloc.namespace)
                if job is not None:
                    jobs[(alloc.namespace, alloc.job_id)] = job
            if node is not None and node.ready():
                if sys_jobs is None:
                    sys_jobs = [j for j in snap.jobs() if j.type in
                                (enums.JOB_TYPE_SYSTEM,
                                 enums.JOB_TYPE_SYSBATCH)]
                for job in sys_jobs:
                    jobs[(job.namespace, job.id)] = job
            for job in jobs.values():
                ev = Evaluation(
                    id=generate_uuid(), namespace=job.namespace,
                    priority=job.priority, type=job.type,
                    triggered_by=enums.TRIGGER_NODE_UPDATE, job_id=job.id,
                    node_id=node_id, status=enums.EVAL_STATUS_PENDING,
                    create_time=now)
                evals.append(ev)
                out.append(ev.id)
        if evals:
            self.store.upsert_evals(evals)
            self.broker.enqueue_all(evals)
        return out

    # -- tests and benchmarks --

    def wait_for_idle(self, timeout: float = 10.0,
                      include_delayed: bool = True) -> bool:
        """Block until no eval is ready, in flight, pending or (by
        default) delayed, and no plan is queued."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if (self.broker.ready_count() == 0
                    and self.broker.inflight() == 0
                    and self.broker.pending_count() == 0
                    and (not include_delayed
                         or self.broker.delayed_count() == 0)
                    and self.plan_queue.depth() == 0):
                return True
            time.sleep(0.01)
        return False
