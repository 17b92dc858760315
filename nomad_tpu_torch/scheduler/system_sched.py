"""System scheduler for a fresh system job (reference
``nomad_tpu/scheduler/system_sched.py:20-194``, itself Nomad's
scheduler_system.go): one alloc of each task group on every feasible
ready node, each node ranked by the host ``NodeScorer``, which assigns
the group's ports, device instances and cores on the node and takes the
preemption arm where the node is full and preemption is enabled; the
victims ride the plan as evictions.

A job that already has live allocs to stop, migrate or update (tainted
or lost nodes, a new job version, a removed group, a stopped job) is
ROADMAP queue A1, and so is sysbatch; both raise. System jobs create no
blocked evals: failures are recorded on the eval.
"""

from __future__ import annotations

import copy as _copy
import time
from typing import Optional

from ..structs import enums
from ..structs.alloc import Allocation, alloc_name
from ..structs.evaluation import Evaluation
from ..utils.ids import generate_uuid
from .context import EvalContext
from .rank import NodeScorer, _class_feasible

UNPORTED_A1 = "ROADMAP queue A1 (the Server/Worker slice)"


class SystemScheduler:
    def __init__(self, state, planner, *, sched_config=None):
        self.state = state
        self.planner = planner
        self.sched_config = sched_config
        self.eval: Optional[Evaluation] = None
        self.plan = None
        self.failed_tg_allocs = {}
        self.queued_allocs = {}

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        for attempt in range(2):
            if self._attempt(attempt):
                return
        self._set_status(enums.EVAL_STATUS_FAILED, "maximum attempts reached")

    def _attempt(self, attempt: int) -> bool:
        ev = self.eval
        self.failed_tg_allocs = {}
        job = self.state.job_by_id(ev.job_id, ev.namespace)
        self.plan = ev.make_plan(job)
        ctx = EvalContext(self.state, self.plan, eval_id=ev.id)

        stopped = job is None or job.stopped()
        nodes = ([] if stopped else
                 self.state.ready_nodes_in_pool(job.datacenters,
                                                job.node_pool))
        node_ids = {n.id for n in nodes}
        groups = {} if stopped else {tg.name: tg for tg in job.task_groups}
        live = set()
        for a in self.state.allocs_by_job(ev.job_id, ev.namespace):
            if a.terminal_status():
                continue
            if (a.task_group not in groups or a.node_id not in node_ids
                    or a.job_version != job.version):
                raise NotImplementedError(
                    f"system job {ev.job_id!r} has allocs to stop, migrate "
                    f"or update: {UNPORTED_A1}")
            live.add((a.node_id, a.task_group))

        if not stopped:
            ctx.eligibility.set_job(job)
            preemption_enabled = (
                self.sched_config.preemption_enabled_for(job.type)
                if self.sched_config is not None else True)
            now = time.time()
            for tg in job.task_groups:
                scorer = NodeScorer(ctx, job, tg,
                                    preemption_enabled=preemption_enabled,
                                    current_priority=job.priority)
                for node in nodes:
                    if (node.id, tg.name) in live:
                        continue  # in place and current
                    metrics = ctx.new_metrics()
                    metrics.nodes_evaluated += 1
                    if not _class_feasible(ctx, job, tg, node):
                        self._record_failure(tg.name, ctx)
                        continue
                    option = scorer.rank(node)
                    if option is None:
                        self._record_failure(tg.name, ctx)
                        continue
                    alloc = Allocation(
                        id=generate_uuid(),
                        eval_id=ev.id,
                        name=alloc_name(job.id, tg.name, 0),
                        namespace=job.namespace,
                        node_id=node.id,
                        node_name=node.name,
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
                        metrics=metrics,
                        allocated_at=now,
                    )
                    for victim in option.preempted_allocs or ():
                        self.plan.append_preempted_alloc(victim, alloc.id)
                    self.plan.append_alloc(alloc)
                    self.queued_allocs[tg.name] = (
                        self.queued_allocs.get(tg.name, 0) + 1)

        if self.plan.is_no_op() and not self.failed_tg_allocs:
            self._set_status(enums.EVAL_STATUS_COMPLETE, "")
            return True

        result, new_state = self.planner.submit_plan(self.plan)
        if new_state is not None:
            self.state = new_state
            full, _, _ = result.full_commit(self.plan)
            if not full:
                return False
        self._set_status(enums.EVAL_STATUS_COMPLETE, "")
        return True

    def _record_failure(self, tg_name: str, ctx: EvalContext) -> None:
        prev = self.failed_tg_allocs.get(tg_name)
        if prev is None:
            self.failed_tg_allocs[tg_name] = ctx.metrics
        else:
            prev.coalesced_failures += 1

    def _set_status(self, status: str, desc: str) -> None:
        ev = _copy.copy(self.eval)
        ev.status = status
        ev.status_description = desc
        ev.failed_tg_allocs = self.failed_tg_allocs
        ev.queued_allocations = dict(self.queued_allocs)
        self.planner.update_eval(ev)
