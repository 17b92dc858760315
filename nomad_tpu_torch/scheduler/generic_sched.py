"""Service + batch scheduler: fresh placements and stops (reference
``nomad_tpu/scheduler/generic_sched.py:31-488``).

Retry loop: reconcile -> open a deployment for a fresh job version ->
place -> submit plan -> on a partial commit retry against the fresher
snapshot (zero-progress attempts are capped at 5 for service jobs, 2 for
batch). Unplaced allocations produce a blocked evaluation. Placements
commit per request (``commit(req, option)``, with the victims the
option evicts), on the per-request bulk path per node
(``commit.commit_many``) or, on the columnar bulk path, as one
AllocBlock per group (``commit.commit_block``).
"""

from __future__ import annotations

import copy as _copy
import time
from typing import Optional

from ..structs import enums
from ..structs.alloc import AllocBlock, Allocation
from ..structs.deployment import Deployment, DeploymentState
from ..structs.evaluation import Evaluation
from ..utils.ids import generate_uuid
from .context import EvalContext
from .placer import placer_for_algorithm
from .reconcile import AllocReconciler

MAX_SERVICE_ATTEMPTS = 5
MAX_BATCH_ATTEMPTS = 2

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENT_DESC = "created to place remaining allocations"


class GenericScheduler:
    def __init__(self, state, planner, *, batch: bool = False,
                 sched_config=None, placer=None, device=None):
        self.state = state
        self.planner = planner
        self.batch = batch
        self.sched_config = sched_config
        self.device = device
        algorithm = (sched_config.scheduler_algorithm
                     if sched_config is not None else enums.SCHED_ALG_BINPACK)
        # an injected placer turns the per-node-pool algorithm override
        # off, as the reference does (generic_sched.go:44-46, 264-271)
        self._placer_injected = placer is not None
        self._base_algorithm = algorithm
        self.placer = (placer if placer is not None
                       else placer_for_algorithm(algorithm, device=device))
        self.max_attempts = MAX_BATCH_ATTEMPTS if batch else MAX_SERVICE_ATTEMPTS

        self.eval: Optional[Evaluation] = None
        self.plan = None
        self.deployment = None
        self.failed_tg_allocs = {}
        self.queued_allocs = {}
        self.blocked: Optional[Evaluation] = None

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        try:
            self._process_with_retries()
        except Exception as e:
            self._set_status(enums.EVAL_STATUS_FAILED, str(e))
            raise

    def _process_with_retries(self) -> None:
        # the budget counts only zero-progress retries: a partial commit
        # resets it
        attempt = 0
        fruitless = 0
        while fruitless < self.max_attempts:
            self._progress = False
            if self._attempt(attempt):
                return
            attempt += 1
            fruitless = 0 if self._progress else fruitless + 1
        self._create_blocked_eval(max_plan=True)
        self._set_status(enums.EVAL_STATUS_FAILED, "maximum attempts reached")

    def _attempt(self, attempt: int) -> bool:
        ev = self.eval
        self.failed_tg_allocs = {}
        self.queued_allocs = {}
        job = self.state.job_by_id(ev.job_id, ev.namespace)
        self.plan = ev.make_plan(job)
        ctx = EvalContext(self.state, self.plan, eval_id=ev.id)
        if job is not None:
            ctx.eligibility.set_job(job)

        all_allocs = self.state.allocs_by_job(ev.job_id, ev.namespace)
        results = AllocReconciler(job, ev.job_id, all_allocs, self.state,
                                  batch=self.batch).compute()
        self._open_deployment(job, results)
        for g in results.groups.values():
            for alloc, desc, client_status in g.stop:
                self.plan.append_stopped_alloc(alloc, desc, client_status)

        requests = []
        for g in results.groups.values():
            requests.extend(g.place)
            if g.bulk_place is not None:
                requests.append(g.bulk_place)
        if requests and job is not None:
            self._compute_placements(ctx, job, requests, attempt)

        if self.plan.is_no_op() and not self.failed_tg_allocs:
            self._finish_success()
            return True

        # the planner runs plan.post_apply_hooks synchronously with its
        # commit, so the solver-service ledger closes in lockstep with
        # the store write
        result, new_state = self.planner.submit_plan(self.plan)
        self._progress = bool(result.node_allocation or result.node_update
                              or result.node_preemptions
                              or result.alloc_blocks
                              or result.deployment is not None)
        if new_state is not None:
            self.state = new_state
            full, _expected, _actual = result.full_commit(self.plan)
            if not full:
                return False
        self._finish_success()
        return True

    def _open_deployment(self, job, results) -> None:
        """A new job version with an update stanza and placements opens a
        deployment (reference generic_sched.go:120-175). As there, only a
        group with per-request placements gets a DeploymentState: a group
        placed through ``bulk_place`` alone has an empty ``place`` and no
        state, and a deployment without states is not opened."""
        self.deployment = None
        if self.batch or job is None or job.stopped():
            return
        ev = self.eval
        latest = self.state.latest_deployment_by_job(ev.job_id, ev.namespace)
        has_update = any(tg.update is not None for tg in job.task_groups)
        changes = results.total_places() > 0
        if has_update and changes and (
                latest is None or latest.job_version != job.version):
            dep = Deployment(id=generate_uuid(), namespace=job.namespace,
                             job_id=job.id, job_version=job.version,
                             eval_priority=ev.priority)
            now0 = time.time()
            for tg in job.task_groups:
                if tg.update is None:
                    continue
                tgr = results.groups.get(tg.name)
                if tgr is None or not tgr.place:
                    continue
                wants_canaries = any(p.canary for p in tgr.place)
                dep.task_groups[tg.name] = DeploymentState(
                    auto_revert=tg.update.auto_revert,
                    auto_promote=tg.update.auto_promote,
                    desired_canaries=(tg.update.canary if wants_canaries
                                      else 0),
                    desired_total=tg.count,
                    progress_deadline_s=tg.update.progress_deadline_s,
                    require_progress_by=(now0
                                         + tg.update.progress_deadline_s))
            if dep.task_groups:
                self.deployment = dep
                self.plan.deployment = dep
        elif (latest is not None and latest.active()
              and latest.job_version == job.version):
            self.deployment = latest

    def _compute_placements(self, ctx: EvalContext, job, requests,
                            attempt: int) -> None:
        ev = self.eval
        nodes = self.state.ready_nodes_in_pool(job.datacenters, job.node_pool)
        # per-node-pool scheduler-config overrides
        effective = self.sched_config
        placer = self.placer
        if effective is not None:
            effective = effective.with_node_pool(
                self.state.node_pool(job.node_pool))
            if (not self._placer_injected
                    and effective.scheduler_algorithm != self._base_algorithm):
                placer = placer_for_algorithm(effective.scheduler_algorithm,
                                              device=self.device)
        preemption_enabled = (effective.preemption_enabled_for(job.type)
                              if effective is not None else False)
        now = time.time()

        def dep_id(tg) -> str:
            return (self.deployment.id if self.deployment is not None
                    and tg.update is not None else "")

        def commit(req, option):
            """Per-request commit: a failure coalesces per task group, a
            success appends one Allocation to the plan, after the
            evictions it needs (reference generic_sched.py:340-342)."""
            tg = req.task_group
            if option is None:
                m = ctx.metrics
                prev = self.failed_tg_allocs.get(tg.name)
                if prev is None:
                    self.failed_tg_allocs[tg.name] = m
                else:
                    prev.coalesced_failures += 1
                self.queued_allocs[tg.name] = self.queued_allocs.get(
                    tg.name, 0)
                return
            if req.canary or req.reschedule or req.previous_alloc is not None:
                raise NotImplementedError(
                    "canary and replacement placements: ROADMAP queue A1")
            alloc = Allocation(
                id=generate_uuid(),
                eval_id=ev.id,
                deployment_id=dep_id(tg),
                name=req.name,
                namespace=job.namespace,
                node_id=option.node.id,
                node_name=option.node.name,
                job_id=job.id,
                job=job,
                job_version=job.version,
                task_group=tg.name,
                allocated_vec=ctx.tg_vec(tg),
                allocated_ports=list(option.allocated_ports),
                allocated_devices=dict(option.allocated_devices),
                allocated_cores=list(option.allocated_cores),
                desired_status=enums.ALLOC_DESIRED_RUN,
                client_status=enums.ALLOC_CLIENT_PENDING,
                metrics=ctx.metrics,
                allocated_at=now,
            )
            for victim in option.preempted_allocs or ():
                self.plan.append_preempted_alloc(victim, alloc.id)
            self.plan.append_alloc(alloc)
            self.queued_allocs[tg.name] = self.queued_allocs.get(
                tg.name, 0) + 1

        def commit_many(tg, node, reqs, mean_score):
            """Bulk per-request commit (reference generic_sched.py:
            346-382): the success arm of ``commit`` for fresh placements
            (no canary, no previous alloc, no ports, devices or cores: the
            placer's bulk eligibility) of ``reqs`` on one node, with the
            per-request constants hoisted out of the loop."""
            bucket = self.plan.node_allocation.setdefault(node.id, [])
            deployment_id = dep_id(tg)
            vec = ctx.tg_vec(tg)
            metrics = ctx.metrics
            if metrics is not None:
                metrics.scores.setdefault("bulk.normalized-score",
                                          mean_score)
            for req in reqs:
                bucket.append(Allocation(
                    id=generate_uuid(),
                    eval_id=ev.id,
                    deployment_id=deployment_id,
                    name=req.name,
                    namespace=job.namespace,
                    node_id=node.id,
                    node_name=node.name,
                    job_id=job.id,
                    job=job,
                    job_version=job.version,
                    task_group=tg.name,
                    allocated_vec=vec,
                    desired_status=enums.ALLOC_DESIRED_RUN,
                    client_status=enums.ALLOC_CLIENT_PENDING,
                    metrics=metrics,
                    allocated_at=now,
                ))
            self.queued_allocs[tg.name] = (
                self.queued_allocs.get(tg.name, 0) + len(reqs))

        def commit_block(tg, node_ids, node_names, counts, name_indices,
                         mean_score):
            """Columnar bulk commit: ONE AllocBlock rides the plan for K
            placements; per-alloc ids/names materialize lazily."""
            block = AllocBlock(
                id=generate_uuid(),
                eval_id=ev.id,
                namespace=job.namespace,
                job_id=job.id,
                job=job,
                job_version=job.version,
                task_group=tg.name,
                deployment_id=dep_id(tg),
                name_indices=name_indices,
                node_ids=list(node_ids),
                node_names=list(node_names),
                counts=counts,
                allocated_vec=ctx.tg_vec(tg),
                mean_score=float(mean_score),
                allocated_at=now,
            )
            if ctx.metrics is not None:
                ctx.metrics.scores.setdefault("bulk.normalized-score",
                                              float(mean_score))
            self.plan.append_block(block)
            self.queued_allocs[tg.name] = (
                self.queued_allocs.get(tg.name, 0) + block.size)

        def fail_bulk(tg, n):
            """Coalesced failure accounting for n unplaced bulk
            requests."""
            if n <= 0:
                return
            m = ctx.metrics
            prev = self.failed_tg_allocs.get(tg.name)
            if prev is None:
                m.coalesced_failures += n - 1
                self.failed_tg_allocs[tg.name] = m
            else:
                prev.coalesced_failures += n
            self.queued_allocs.setdefault(tg.name, 0)

        commit.commit_many = commit_many
        commit.commit_block = commit_block
        commit.fail_bulk = fail_bulk
        placer.place(ctx, job, requests, nodes, commit, batch=self.batch,
                     preemption_enabled=preemption_enabled, attempt=attempt)

    def _finish_success(self) -> None:
        if self.failed_tg_allocs:
            self._create_blocked_eval(max_plan=False)
            self._set_status(enums.EVAL_STATUS_COMPLETE,
                             "complete with failed placements")
        else:
            self._set_status(enums.EVAL_STATUS_COMPLETE, "")

    def _create_blocked_eval(self, max_plan: bool) -> None:
        ev = self.eval
        if (ev.status == enums.EVAL_STATUS_BLOCKED
                or ev.triggered_by == enums.TRIGGER_QUEUED_ALLOCS):
            reblocked = _copy.copy(ev)
            reblocked.status = enums.EVAL_STATUS_BLOCKED
            self.planner.reblock_eval(reblocked)
            self.blocked = reblocked
            return
        blocked = Evaluation(
            id=generate_uuid(),
            namespace=ev.namespace,
            priority=ev.priority,
            type=ev.type,
            triggered_by=(enums.TRIGGER_MAX_PLANS if max_plan
                          else enums.TRIGGER_QUEUED_ALLOCS),
            job_id=ev.job_id,
            status=enums.EVAL_STATUS_BLOCKED,
            status_description=(BLOCKED_EVAL_MAX_PLAN_DESC if max_plan
                                else BLOCKED_EVAL_FAILED_PLACEMENT_DESC),
            previous_eval=ev.id,
        )
        self.planner.create_eval(blocked)
        self.blocked = blocked

    def _set_status(self, status: str, desc: str) -> None:
        ev = _copy.copy(self.eval)
        ev.status = status
        ev.status_description = desc
        ev.failed_tg_allocs = self.failed_tg_allocs
        ev.queued_allocations = dict(self.queued_allocs)
        if self.blocked is not None:
            ev.blocked_eval = self.blocked.id
        self.planner.update_eval(ev)
