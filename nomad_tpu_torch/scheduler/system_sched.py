"""System and sysbatch scheduler (reference
``nomad_tpu/scheduler/system_sched.py:20-194``, itself Nomad's
scheduler_system.go): one alloc of each task group on every feasible
ready node, each node ranked by the host ``NodeScorer``, which assigns
the group's ports, device instances and cores on the node and takes the
preemption arm where the node is full and preemption is enabled; the
victims ride the plan as evictions.

Diff-based, no reconciler: the live allocs of down nodes are marked
lost; an alloc of a stopped job, of a removed group, or on a node that
left the job's datacenters or pool stops, while one on a node of the
pool that is merely not ready (ineligible, draining) keeps running; an
alloc of an older job version is stopped and replaced on its node. A
sysbatch job does not rerun a group that completed on a node at the
current version. System jobs create no blocked evals: failures are
recorded on the eval.
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
from .util import tainted_nodes, update_non_terminal_allocs_to_lost


class SystemScheduler:
    def __init__(self, state, planner, *, sysbatch: bool = False,
                 sched_config=None):
        self.state = state
        self.planner = planner
        self.sysbatch = sysbatch
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

        all_allocs = self.state.allocs_by_job(ev.job_id, ev.namespace)
        tainted = tainted_nodes(self.state, all_allocs)
        update_non_terminal_allocs_to_lost(self.plan, tainted, all_allocs)

        stopped = job is None or job.stopped()
        nodes = ([] if stopped else
                 self.state.ready_nodes_in_pool(job.datacenters,
                                                job.node_pool))
        node_ids = {n.id for n in nodes}
        # the live alloc of each (node, task group)
        live = {}
        for a in all_allocs:
            if not a.terminal_status():
                live[(a.node_id, a.task_group)] = a
        groups = set() if job is None else {tg.name for tg in job.task_groups}
        for (node_id, tg_name), a in live.items():
            if node_id in tainted:
                continue  # the lost marking above, or a drain's turn
            if stopped or tg_name not in groups:
                self.plan.append_stopped_alloc(a, "alloc not needed")
                continue
            if node_id in node_ids:
                continue
            node = self.state.node_by_id(node_id)
            if (node is not None
                    and node.in_pool(job.datacenters, job.node_pool)):
                # not ready (ineligible) but in the pool: it keeps running
                continue
            self.plan.append_stopped_alloc(a, "alloc not needed")

        if not stopped:
            ctx.eligibility.set_job(job)
            preemption_enabled = (
                self.sched_config.preemption_enabled_for(job.type)
                if self.sched_config is not None else True)
            now = time.time()
            # sysbatch: (node, group) pairs that completed this version
            done = ({(a.node_id, a.task_group) for a in all_allocs
                     if a.client_status == enums.ALLOC_CLIENT_COMPLETE
                     and a.job_version == job.version}
                    if self.sysbatch else set())
            for tg in job.task_groups:
                scorer = NodeScorer(ctx, job, tg,
                                    preemption_enabled=preemption_enabled,
                                    current_priority=job.priority)
                for node in nodes:
                    existing = live.get((node.id, tg.name))
                    if existing is not None:
                        if existing.job_version == job.version:
                            continue  # in place and current
                        self.plan.append_stopped_alloc(
                            existing,
                            "alloc is being updated due to job update")
                    if (node.id, tg.name) in done:
                        continue  # sysbatch work done on this node
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
                    if existing is not None:
                        alloc.previous_allocation = existing.id
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
