"""Server: the scheduling core of the control plane (a trimmed copy of
``nomad_tpu/core/server.py``).

Wires the MVCC state store to the eval broker, the blocked-evals
tracker, the plan queue and applier, the scheduler workers, the event
broker (``events``) and the incremental usage feed it feeds
(``tensor/incremental.py``; ``NOMAD_TPU_INCR=0`` turns it off at call
time), on one device: ``ServerConfig.device`` (resolved by
``device.resolve``: the card by default, raising without one; the CPU
only when asked) is threaded down Server -> Worker -> scheduler ->
``TorchPlacer`` -> ``tensor.solver.get_service(device)``.

The lifecycle runs on its own: ``start`` starts four background actors
beside the workers, and ``stop`` joins them. A stopped Server starts
again (leadership can come back to a replica): ``start`` restores the
evals, the heartbeat timers and the replicated scheduler config
(``_restore_scheduler_config``) from the store it runs on. Under raft
(``raft/cluster.py``) the store is a ``RaftStore`` facade, every write
goes through the replicated log, and only the leader's Server runs.

- ``heartbeats`` (core/heartbeat.py): a TTL a registered node, armed by
  ``register_node(s)``, ``heartbeat`` and ``heartbeat_batch`` and, for
  the nodes of the store the server starts on, by
  ``_restore_heartbeats``; a node that misses it goes through
  ``mark_nodes_down``, which skips a node whose TTL a heartbeat re-armed
  meanwhile;
- ``deployment_watcher`` (core/deployments.py): progress deadlines,
  failure with auto-revert, auto-promotion, superseded deployments,
  follow-up evals;
- ``drainer`` (core/drainer.py): paced migrate marks off draining
  nodes;
- ``core_gc`` (core/core_sched.py): every ``gc_interval`` seconds, and
  at once through ``force_gc``.

The calls it serves: ``register_job`` (into a registered namespace; a
parameterized job is a template and gets no eval), ``deregister_job``,
``create_job_eval`` (a forced evaluation), ``scale_job`` (held to the
group's scaling bounds, with a scaling event), ``scaling_policies``,
``revert_job``, ``plan_job`` (the dry run: the real scheduler on a
snapshot with the planned job overlaid, through a planner that commits
nothing and marks every planned node rejected, so a bulk solve's
correction leaves the solver service's carry), ``upsert_namespace`` /
``delete_namespace``, ``upsert_node_pool`` / ``delete_node_pool``,
``register_node(s)``, ``deregister_node``, ``heartbeat``,
``heartbeat_batch``, ``create_eval``, ``register_volume``,
``deregister_volume``, ``force_gc``, and the allocation lifecycle's
(reference ``server.py:819-1114``): ``mark_nodes_down`` (down, or
disconnected where an alloc of the node tolerates it, with a node-update
eval for every job with live allocs there), ``update_node_status``,
``update_node_drain``, ``update_node_eligibility``, ``stop_alloc``,
``update_allocs_from_client`` (a retry-failed-alloc eval a job with a
failed alloc), ``update_alloc_desired_transitions`` (the drainer's
write with its evals), ``promote_deployment`` and ``fail_deployment``;
``set_scheduler_config`` (the operator's config as replicated state: a
replica applies it from its commit listener, and a restore's config
governs the running server too); ``wait_for_idle`` for tests and
benchmarks; the client plane's (reference ``:221-226``, ``:984-994``,
``:1284-1294``): ``alloc_sync`` (core/allocsync.py ``AllocSyncHub``,
the per-node alloc deltas a client watches), ``client_updates``
(``ClientUpdateBatcher``, which ``update_allocs_from_client`` submits
through while it runs; ``ServerConfig.client_update_batching``), and
``upsert_service_registrations``, ``delete_service_registrations`` and
``delete_services_by_alloc``. A caller that plays the
watcher or the drainer itself holds the actor off before ``start``
(``srv.drainer.start = lambda: None``). Use it as a context manager
(``with Server(...) as srv:``): ``stop`` leaves no worker, applier,
broker, reaper, heartbeat, watcher, drainer or GC thread running.

Trimmed (each is an attribute or method of the reference the port does
not have), and left to ROADMAP A10: periodic jobs and dispatch
(``periodic``, ``dispatch_job``), the event broker's direct publishes
(the bad-node quarantine publishes nothing) and its sizing knobs
(``event_ring_size``, ``event_shards``: the broker keeps its defaults,
rings of 4,096 events in 8 shards), the heartbeat manager's
(``heartbeat_shards``, ``heartbeat_expiry_rate``: 8 timer-wheel shards,
512 mark-downs a second, core/heartbeat.py), the shadow replica
(``shadow.maybe_attach``, ROADMAP A8), ACLs, identities and variables
(``acl_*``, ``encrypter``, ``sign_workload_identity``, ``*_variable``,
and core GC's token passes), federation and ACL replication (``region*``,
``_run_acl_replication``), the overload controller (``loadctl``, the
``_tiered`` admission decorator, poison-eval quarantine; the heartbeat
calls are not tiered), the operator's
``reject_job_registration`` and ``pause_eval_broker`` switches, and the
unbatched plan-commit arm
(``plan_commit_batching``; the applier always batches, see
core/plan_apply.py).
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
from ..structs.alloc import DesiredTransition
from ..structs.evaluation import Evaluation
from ..structs.job import Job
from ..structs.node import Node
from ..structs.operator import SchedulerConfiguration
from ..tensor import incremental
from ..utils.ids import generate_uuid
from .allocsync import AllocSyncHub, ClientUpdateBatcher
from .blocked import BlockedEvals
from .broker import FAILED_QUEUE, EvalBroker
from .core_sched import CoreScheduler
from .deployments import DeploymentWatcher, alloc_healthy
from .drainer import NodeDrainer
from .events import EventBroker
from .heartbeat import (EXPIRY_RATE, HeartbeatManager,
                        HeartbeatPlaneInactive)
from .plan_apply import BadNodeTracker, PlanApplier, PlanQueue
from .worker import Worker


@dataclass
class ServerConfig:
    num_workers: int = 2
    # a node that does not heartbeat within this many seconds is marked
    # down; a caller that never heartbeats (a benchmark, a test that
    # outlasts the TTL) passes 3600
    heartbeat_ttl: float = 10.0
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
    # seconds between core GC passes (force_gc runs one at once)
    gc_interval: float = 60.0
    sched_config: SchedulerConfiguration = field(
        default_factory=SchedulerConfiguration)
    # where the placer's tensors and kernels run: None is the card
    device: DeviceLike = None
    # coalesce concurrent clients' status writes into one store write a
    # round (core/allocsync.py ClientUpdateBatcher)
    client_update_batching: bool = True


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
        self.heartbeats = HeartbeatManager(
            self, ttl=self.config.heartbeat_ttl, expiry_rate=EXPIRY_RATE)
        self.deployment_watcher = DeploymentWatcher(self)
        self.drainer = NodeDrainer(self)
        self.core_gc = CoreScheduler(self, interval=self.config.gc_interval)
        self.events = EventBroker(self.store)
        # the incremental usage feed reads this event stream (always
        # attached; NOMAD_TPU_INCR=0 is its call-time kill switch)
        incremental.maybe_attach(self.store, self.events)
        # delta alloc push to clients and batched client status writes
        self.alloc_sync = AllocSyncHub(self)
        self.client_updates = ClientUpdateBatcher(
            self.store, batch=self.config.client_update_batching)
        self._running = False
        self._reaper: Optional[threading.Thread] = None
        # commit listeners fire on the store's write path; unblocking
        # writes through the store, so events go through a queue to the
        # commit pump's thread (reference :225-237)
        self._commit_q: "queue.Queue" = queue.Queue()
        self.store.add_commit_listener(self._on_store_commit)
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
        self.alloc_sync.start()
        self.client_updates.start()
        self.heartbeats.set_enabled(True)
        self._restore_heartbeats()
        self._restore_scheduler_config()
        self._restore_evals()
        for w in self.workers:
            w.start()
        self.deployment_watcher.start()
        self.drainer.start()
        self.core_gc.start()
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
        self.core_gc.stop()
        self.drainer.stop()
        self.deployment_watcher.stop()
        self.heartbeats.set_enabled(False)
        self.client_updates.stop()
        self.alloc_sync.stop()
        self.blocked.set_enabled(False)
        self.broker.set_enabled(False)
        self.plan_applier.stop()
        # parked blocking queries return: no handler outlives the server
        self.store.watches.teardown()
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

    def _restore_scheduler_config(self) -> None:
        """Apply the replicated scheduler config, when an operator set
        one (reference ``:411-415``); else the boot-time one stays."""
        cfg = self.store.snapshot().scheduler_configuration()
        if cfg is not None:
            self._apply_scheduler_config(cfg)

    def set_scheduler_config(self, cfg: SchedulerConfiguration) -> None:
        """The operator's scheduler config, stored as replicated state:
        every replica applies it from its commit listener, so a failover
        keeps it (reference ``:663-670``)."""
        self.store.set_scheduler_configuration(cfg)
        self._apply_scheduler_config(cfg)

    def _apply_scheduler_config(self, cfg: SchedulerConfiguration) -> None:
        # one reference swap: a worker mid-eval reads either config
        self.sched_config = cfg
        self.config.sched_config = cfg

    def _restore_heartbeats(self) -> None:
        """Arm the TTL of every ready node of the store the server starts
        on (reference ``:416-424``): a node that went silent while no
        server watched it is still timed out."""
        ready = [n.id for n in self.store.snapshot().nodes()
                 if n.status == enums.NODE_STATUS_READY]
        self.heartbeats.restore(ready)

    def _restore_evals(self) -> None:
        """Re-enqueue pending evals and re-block blocked ones of a store
        the server starts on (reference :426)."""
        for ev in self.store.snapshot().evals():
            if ev.should_enqueue():
                self.broker.enqueue(ev)
            elif ev.should_block():
                self.blocked.block(ev)

    # -- commit listener: unblock blocked evals on cluster changes --

    def _on_store_commit(self, index: int, events: list) -> None:
        # a stopped server (a follower replica) unblocks nothing: drop
        # its commits rather than queue them
        if self._running:
            self._commit_q.put((index, events))

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
            if kind == "scheduler-config" and payload is not None:
                # idempotent: the writer applied its own already
                self._apply_scheduler_config(payload)
            elif kind == "restore":
                # the whole store was replaced: its config governs
                self._restore_scheduler_config()
            elif kind in ("node-upsert", "node-status", "node-eligibility",
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
        eval id ("" for a parameterized template, which never
        schedules)."""
        self._check_namespace(job.namespace)
        self.store.upsert_job(job)
        if job.is_parameterized:
            return ""
        return self._create_job_eval(job, enums.TRIGGER_JOB_REGISTER)

    def create_job_eval(self, job: Job,
                        trigger: str = enums.TRIGGER_JOB_REGISTER) -> str:
        """Job.Evaluate: a forced evaluation of a registered job."""
        return self._create_job_eval(job, trigger)

    def _check_namespace(self, namespace: str) -> None:
        if self.store.snapshot().namespace(namespace) is None:
            raise ValueError(f"namespace {namespace!r} does not exist")

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

    def scale_job(self, job_id: str, task_group: str, count: int,
                  namespace: str = "default") -> str:
        """Job.Scale: register a new version with the group's count
        changed, so the scheduler applies it through the count math
        (reference ``server.py:1096-1114``; its eval is the register's)."""
        job = self.store.snapshot().job_by_id(job_id, namespace)
        if job is None or job.stopped():
            raise KeyError(f"job {job_id} not found")
        if job.is_parameterized:
            raise ValueError("cannot scale periodic or parameterized jobs")
        tg = job.lookup_task_group(task_group)
        if tg is None:
            raise ValueError(f"task group {task_group!r} not found")
        if count < 0:
            raise ValueError("count must be >= 0")
        if tg.scaling is not None and tg.scaling.enabled:
            if count < tg.scaling.min or (tg.scaling.max
                                          and count > tg.scaling.max):
                raise ValueError(
                    f"count {count} outside scaling bounds "
                    f"[{tg.scaling.min}, "
                    f"{tg.scaling.max or 'unbounded'}]")
        updated = _copy.deepcopy(job)
        updated.lookup_task_group(task_group).count = count
        eval_id = self.register_job(updated)
        self.store.append_scaling_event(job_id, namespace, {
            "task_group": task_group, "count": count,
            "previous_count": tg.count, "eval_id": eval_id,
            "time": time.time()})
        return eval_id

    def scaling_policies(self, namespace: Optional[str] = None) -> List[dict]:
        """Every scaling stanza of a live job as a policy row (the
        policies live on the job spec)."""
        out = []
        for job in self.store.snapshot().jobs():
            if namespace is not None and job.namespace != namespace:
                continue
            if job.stopped():
                continue
            for tg in job.task_groups:
                if tg.scaling is None:
                    continue
                out.append({
                    "id": f"{job.namespace}/{job.id}/{tg.name}",
                    "namespace": job.namespace,
                    "target": {"job": job.id, "group": tg.name},
                    "min": tg.scaling.min, "max": tg.scaling.max,
                    "enabled": tg.scaling.enabled,
                    "policy": tg.scaling.policy,
                })
        return out

    def revert_job(self, job_id: str, job_version: int,
                   namespace: str = "default") -> str:
        """Job.Revert: re-register a prior version's spec as the newest
        version."""
        snap = self.store.snapshot()
        current = snap.job_by_id(job_id, namespace)
        if current is None:
            raise KeyError(f"job {job_id} not found")
        if current.is_parameterized:
            raise ValueError("cannot revert periodic or parameterized jobs")
        if job_version == current.version:
            raise ValueError("cannot revert to the current version")
        old = snap.job_version(job_id, job_version, namespace)
        if old is None:
            raise KeyError(f"job {job_id} has no version {job_version}")
        revived = _copy.deepcopy(old)
        revived.stop = False
        return self.register_job(revived)

    def plan_job(self, job: Job) -> Dict:
        """Job.Plan, the dry run: the real scheduler against the current
        snapshot with the planned job overlaid, through a planner that
        commits nothing. Every planned node is reported rejected to the
        plan's post-apply hooks, so a bulk solve's ledger entry is
        corrected out of the solver service's usage carry. Returns the
        groups' desired updates, the spec diff against the running
        version and the failed placements."""
        from ..scheduler.scheduler import NewScheduler
        from ..structs.job import spec_diff
        from ..structs.plan import PlanResult

        snap = self.store.snapshot()
        prev = snap.job_by_id(job.id, job.namespace)
        planned = _copy.copy(job)
        planned.version = (prev.version + 1) if prev is not None else 0
        planned.create_index = prev.create_index if prev is not None else 0

        class _PlanSnapshot:
            """The snapshot with the planned job overlaid."""

            def __init__(self, base):
                self._base = base

            def job_by_id(self, job_id, namespace="default"):
                if job_id == planned.id and namespace == planned.namespace:
                    return planned
                return self._base.job_by_id(job_id, namespace)

            def __getattr__(self, name):
                return getattr(self._base, name)

        logger = self.logger

        class _DryRunPlanner:
            def __init__(self):
                self.plans = []
                self.evals = []

            def submit_plan(self, plan):
                self.plans.append(plan)
                result = PlanResult(
                    node_allocation=plan.node_allocation,
                    node_update=plan.node_update,
                    node_preemptions=plan.node_preemptions,
                    alloc_index=snap.index)
                rejected = set(plan.node_allocation)
                for b in plan.alloc_blocks:
                    rejected.update(b.node_ids)
                result.rejected_nodes = sorted(rejected)
                for hook in plan.post_apply_hooks:
                    try:
                        hook(result)
                    except Exception:  # noqa: BLE001 - as the applier's
                        if logger:
                            logger.exception("dry-run hook failed")
                return result, None

            def update_eval(self, ev):
                self.evals.append(ev)

            def create_eval(self, ev):
                self.evals.append(ev)

            def reblock_eval(self, ev):
                self.evals.append(ev)

        planner = _DryRunPlanner()
        sched = NewScheduler(planned.type, _PlanSnapshot(snap), planner,
                             sched_config=self.sched_config,
                             device=self.device)
        ev = Evaluation(
            id=generate_uuid(), namespace=planned.namespace,
            priority=planned.priority, type=planned.type,
            triggered_by=enums.TRIGGER_JOB_REGISTER, job_id=planned.id,
            status=enums.EVAL_STATUS_PENDING)
        sched.process(ev)
        return {
            "job_id": planned.id,
            "job_version": planned.version,
            "annotations": getattr(sched, "annotations", {}),
            "diff": spec_diff(prev, planned),
            "failed_tg_allocs": {
                name: {"nodes_filtered": m.nodes_filtered,
                       "nodes_exhausted": m.nodes_exhausted,
                       "coalesced_failures": m.coalesced_failures}
                for name, m in sched.failed_tg_allocs.items()},
        }

    # -- namespaces and node pools --

    def upsert_namespace(self, ns) -> None:
        if not ns.name:
            raise ValueError("namespace name is required")
        self.store.upsert_namespace(ns)

    def delete_namespace(self, name: str) -> None:
        self.store.delete_namespace(name)

    # -- service registrations (reference ``:1284-1294``) --

    def upsert_service_registrations(self, regs) -> None:
        for reg in regs:
            if not reg.service_name or not reg.id:
                raise ValueError("service registrations require id and name")
        self.store.upsert_service_registrations(regs)

    def delete_service_registrations(self, ids) -> None:
        self.store.delete_service_registrations(list(ids))

    def delete_services_by_alloc(self, alloc_id: str) -> None:
        self.store.delete_services_by_alloc(alloc_id)

    def upsert_node_pool(self, pool) -> None:
        from ..structs.operator import BUILTIN_NODE_POOLS

        if pool.name in BUILTIN_NODE_POOLS:
            raise ValueError(f"cannot modify built-in node pool {pool.name!r}")
        if not pool.name:
            raise ValueError("node pool name is required")
        self.store.upsert_node_pool(pool)

    def delete_node_pool(self, name: str) -> None:
        self.store.delete_node_pool(name)

    # -- deployments --

    def promote_deployment(self, dep_id: str,
                           groups: Optional[List[str]] = None) -> str:
        """Deployment.Promote: every selected canary group must have its
        desired count of healthy canaries; flips ``promoted`` and
        enqueues a deployment-watcher eval that rolls the old allocs
        (reference ``server.py:1024-1073``)."""
        snap = self.store.snapshot()
        dep = snap.deployment_by_id(dep_id)
        if dep is None:
            raise KeyError(f"deployment {dep_id} not found")
        if not dep.active():
            raise ValueError(
                f"deployment {dep_id} is {dep.status}, not promotable")
        if not dep.requires_promotion():
            raise ValueError(
                f"deployment {dep_id} has no canaries awaiting promotion")
        job = snap.job_by_id(dep.job_id, dep.namespace)
        if job is None:
            raise ValueError(f"job {dep.job_id} not found")
        allocs = [a for a in snap.allocs_by_job(dep.job_id, dep.namespace)
                  if a.deployment_id == dep.id]
        now = time.time()
        upd = _copy.deepcopy(dep)
        for name, state in upd.task_groups.items():
            if state.desired_canaries <= 0 or state.promoted:
                continue
            if groups is not None and name not in groups:
                continue
            healthy = sum(1 for a in allocs
                          if a.task_group == name and a.canary
                          and alloc_healthy(a, job, now))
            if healthy < state.desired_canaries:
                raise ValueError(
                    f"group {name!r} has {healthy}/"
                    f"{state.desired_canaries} healthy canaries; "
                    "promotion refused")
            state.promoted = True
        upd.status_description = "Deployment is promoted"
        self.store.upsert_deployment(upd)
        return self.create_eval(Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=dep.eval_priority, type=job.type,
            triggered_by=enums.TRIGGER_DEPLOYMENT_WATCHER, job_id=job.id,
            deployment_id=dep.id, status=enums.EVAL_STATUS_PENDING,
            create_time=time.time()))

    def fail_deployment(self, dep_id: str) -> None:
        """Deployment.Fail: an operator's forced failure; the watcher's
        failure handling (auto-revert) does not run for it (reference
        ``:1077-1091``)."""
        dep = self.store.snapshot().deployment_by_id(dep_id)
        if dep is None:
            raise KeyError(f"deployment {dep_id} not found")
        if not dep.active():
            raise ValueError(f"deployment {dep_id} is already {dep.status}")
        upd = _copy.copy(dep)
        upd.status = enums.DEPLOYMENT_STATUS_FAILED
        upd.status_description = "Deployment marked as failed by operator"
        self.store.upsert_deployment(upd)

    # -- volumes and GC --

    def register_volume(self, vol) -> None:
        self._check_namespace(vol.namespace)
        self.store.upsert_volume(vol)

    def deregister_volume(self, vol_id: str, namespace: str = "default",
                          force: bool = False) -> None:
        self.store.delete_volume(vol_id, namespace, force=force)

    def force_gc(self) -> Dict:
        """``nomad system gc``: every collector, whatever the age."""
        return self.core_gc.force_gc(threshold_override=0)

    # -- allocation calls --

    def stop_alloc(self, alloc_id: str) -> str:
        """Alloc.Stop: mark the alloc for reschedule and evaluate; it
        stops where it is and a replacement lands elsewhere. Returns the
        eval id (reference ``server.py:955-982``)."""
        snap = self.store.snapshot()
        alloc = snap.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id} not found")
        if alloc.terminal_status():
            raise ValueError(f"alloc {alloc_id} is already terminal")
        job = snap.job_by_id(alloc.job_id, alloc.namespace)
        ev = Evaluation(
            id=generate_uuid(), namespace=alloc.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else enums.JOB_TYPE_SERVICE,
            triggered_by=enums.TRIGGER_ALLOC_STOP, job_id=alloc.job_id,
            status=enums.EVAL_STATUS_PENDING)
        self.update_alloc_desired_transitions(
            {alloc_id: DesiredTransition(reschedule=True)}, [ev])
        return ev.id

    def update_alloc_desired_transitions(self, transitions: Dict,
                                         evals: List[Evaluation] = ()
                                         ) -> int:
        """Write desired transitions with their evals in one generation
        and enqueue the evals: the drainer's mark (reference
        ``drainer.py:120-145``) and an alloc stop's."""
        index = self.store.update_alloc_desired_transitions(
            transitions, list(evals))
        self.broker.enqueue_all(list(evals))
        return index

    def update_allocs_from_client(self, updates: List) -> None:
        """Node.UpdateAlloc: client alloc status sync, coalesced with the
        other clients' in-flight rounds while the batcher runs; a job
        with a failed alloc gets a retry-failed-alloc eval (reference
        ``server.py:984-1021``)."""
        if not updates:
            return
        if self.client_updates.running:
            self.client_updates.submit(updates)
        else:
            self.store.update_allocs_from_client(updates)
        snap = self.store.snapshot()
        seen = set()
        evals = []
        for upd in updates:
            if upd.client_status != enums.ALLOC_CLIENT_FAILED:
                continue
            key = (upd.namespace, upd.job_id)
            if key in seen:
                continue
            seen.add(key)
            job = snap.job_by_id(upd.job_id, upd.namespace)
            if job is None:
                continue
            evals.append(Evaluation(
                id=generate_uuid(), namespace=job.namespace,
                priority=job.priority, type=job.type,
                triggered_by=enums.TRIGGER_RETRY_FAILED_ALLOC,
                job_id=job.id, status=enums.EVAL_STATUS_PENDING,
                create_time=time.time()))
        if evals:
            self.store.upsert_evals(evals)
            self.broker.enqueue_all(evals)

    # -- node calls --

    def register_node(self, node: Node) -> float:
        """Node.Register -> the heartbeat TTL; a ready node gets the evals
        of the system jobs and of the jobs with allocs on it."""
        if not node.id:
            raise ValueError("node registration requires node.id")
        if not node.computed_class:
            node.compute_class()
        self.store.upsert_node(node)
        if node.ready():
            self._create_node_evals_batch([node.id])
        return self.heartbeats.reset(node.id)

    def register_nodes(self, nodes: List[Node]) -> float:
        """Many nodes in one store write and one eval pass; each TTL is
        armed. Returns the TTL."""
        for node in nodes:
            if not node.id:
                raise ValueError("node registration requires node.id")
            if not node.computed_class:
                node.compute_class()
        if not nodes:
            return self.config.heartbeat_ttl
        self.store.upsert_nodes(list(nodes))
        ready = [n.id for n in nodes if n.ready()]
        if ready:
            self._create_node_evals_batch(ready)
        for node in nodes:
            self.heartbeats.reset(node.id)
        return self.config.heartbeat_ttl

    def heartbeat(self, node_id: str) -> float:
        """Node.UpdateStatus(ready) from a live client (reference
        ``:750-778``): a node marked down comes back to ready; an unknown
        node raises KeyError rather than arm a TTL for no row."""
        if not self.heartbeats.enabled:
            raise HeartbeatPlaneInactive(
                "heartbeat plane is not active on this server")
        node = self.store.snapshot().node_by_id(node_id)
        if node is None:
            raise KeyError(f"node {node_id} is not registered")
        if node.status != enums.NODE_STATUS_READY:
            self.update_node_status(node_id, enums.NODE_STATUS_READY)
            return self.config.heartbeat_ttl
        ttl = self.heartbeats.reset(node_id)
        # re-read AFTER arming: a mark-down that committed while this
        # call was in flight must not survive an acked heartbeat
        node = self.store.snapshot().node_by_id(node_id)
        if node is not None and node.status != enums.NODE_STATUS_READY:
            self.update_node_status(node_id, enums.NODE_STATUS_READY)
        return ttl

    def heartbeat_batch(self, node_ids: List[str]) -> float:
        """Heartbeats of many nodes (reference ``:780-817``): a ready
        node's is a timer re-arm with no store write; nodes coming back
        from down or disconnected flip to ready in one write; unknown ids
        are dropped. Refused whole while the server is stopped."""
        if not self.heartbeats.enabled:
            raise HeartbeatPlaneInactive(
                "heartbeat plane is not active on this server")
        snap = self.store.snapshot()
        known: List[str] = []
        stale: List[str] = []
        for node_id in node_ids:
            node = snap.node_by_id(node_id)
            if node is None:
                continue
            known.append(node_id)
            if node.status != enums.NODE_STATUS_READY:
                stale.append(node_id)
            else:
                self.heartbeats.reset(node_id)
        if known:
            # re-read AFTER arming: a mark-down that committed meanwhile
            # saw none of these timers armed; revive those nodes too
            snap2 = self.store.snapshot()
            seen = set(stale)
            for node_id in known:
                node = snap2.node_by_id(node_id)
                if (node is not None and node_id not in seen
                        and node.status != enums.NODE_STATUS_READY):
                    stale.append(node_id)
        if stale:
            self.store.update_nodes_status(stale, enums.NODE_STATUS_READY,
                                           ts=time.time())
            for node_id in stale:
                self.heartbeats.reset(node_id)
            self._create_node_evals_batch(stale)
        return self.config.heartbeat_ttl

    def update_node_status(self, node_id: str, status: str) -> None:
        """A node's status flip, with the evals of its jobs (reference
        ``server.py:819-826``); down or disconnected drops its TTL, ready
        re-arms it."""
        self.store.update_node_status(node_id, status, ts=time.time())
        if status in (enums.NODE_STATUS_DOWN, enums.NODE_STATUS_DISCONNECTED):
            self.heartbeats.remove(node_id)
            self._create_node_evals_batch([node_id])
        elif status == enums.NODE_STATUS_READY:
            self.heartbeats.reset(node_id)
            self._create_node_evals_batch([node_id])

    def mark_node_down(self, node_id: str, reason: str = "") -> None:
        self.mark_nodes_down([node_id], reason=reason)

    def mark_nodes_down(self, node_ids: List[str], reason: str = "") -> None:
        """Missed-TTL handler for a batch of nodes (reference
        ``server.py:835-889``): a node goes ``disconnected`` when a live
        alloc on it belongs to a group with ``max_client_disconnect``
        (its allocs turn unknown), else ``down`` (its allocs are lost);
        one status write a class and one eval pass for the batch. A node
        whose TTL is armed again (it heartbeated after its expiry was
        collected) is skipped, and one whose heartbeat re-armed it while
        the mark committed flips straight back to ready: marking a node
        that checked in would be a false mark-down."""
        snap = self.store.snapshot()
        down: List[str] = []
        disconnected: List[str] = []
        for node_id in node_ids:
            if self.heartbeats.armed(node_id):
                continue
            if snap.node_by_id(node_id) is None:
                # deleted while its TTL was in flight
                self.heartbeats.remove(node_id)
                continue
            status = enums.NODE_STATUS_DOWN
            for alloc in snap.allocs_by_node(node_id):
                if alloc.terminal_status():
                    continue
                job = snap.job_by_id(alloc.job_id, alloc.namespace)
                tg = job.lookup_task_group(alloc.task_group) if job else None
                if tg is not None and tg.max_client_disconnect_s is not None:
                    status = enums.NODE_STATUS_DISCONNECTED
                    break
            (down if status == enums.NODE_STATUS_DOWN
             else disconnected).append(node_id)
        ts = time.time()
        revived: List[str] = []
        for group, status in ((down, enums.NODE_STATUS_DOWN),
                              (disconnected, enums.NODE_STATUS_DISCONNECTED)):
            if not group:
                continue
            self.store.update_nodes_status(group, status, ts=ts)
            for node_id in group:
                if self.heartbeats.armed(node_id):
                    revived.append(node_id)
                else:
                    self.heartbeats.remove(node_id)
        if revived:
            self.store.update_nodes_status(
                revived, enums.NODE_STATUS_READY, ts=time.time())
        if down or disconnected:
            self._create_node_evals_batch(down + disconnected)

    def deregister_node(self, node_id: str) -> None:
        """Node.Deregister: drop the node and reschedule its work."""
        self.heartbeats.remove(node_id)
        self.store.delete_node(node_id)
        self._create_node_evals_batch([node_id])

    def update_node_drain(self, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> None:
        """Start (or end) a node's drain, with the evals of its jobs
        (reference ``server.py:896-899``); the drainer then paces the
        migrate marks."""
        self.store.update_node_drain(node_id, drain_strategy, mark_eligible)
        self._create_node_evals_batch([node_id])

    def update_node_eligibility(self, node_id: str, eligibility: str) -> None:
        self.store.update_node_eligibility(node_id, eligibility)

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
