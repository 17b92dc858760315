"""Service + batch scheduler, the fresh bulk-placement subset (reference
``nomad_tpu/scheduler/generic_sched.py:31-488``).

Retry loop: reconcile -> place -> submit plan -> on a partial commit
retry against the fresher snapshot (zero-progress attempts are capped at
5 for service jobs, 2 for batch). Unplaced allocations produce a blocked
evaluation.
"""

from __future__ import annotations

import copy as _copy
import time
from typing import Optional

from ..structs import enums
from ..structs.alloc import AllocBlock
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

        all_allocs = self.state.allocs_by_job(ev.job_id, ev.namespace)
        results = AllocReconciler(job, ev.job_id, all_allocs, self.state,
                                  batch=self.batch).compute()
        requests = [g.bulk_place for g in results.groups.values()
                    if g.bulk_place is not None]
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
                              or result.alloc_blocks)
        if new_state is not None:
            self.state = new_state
            full, _expected, _actual = result.full_commit(self.plan)
            if not full:
                return False
        self._finish_success()
        return True

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

        placer.place(ctx, job, requests, nodes, commit_block, fail_bulk,
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
