"""In-process scheduler harness (reference ``nomad_tpu/testing.py:20-130``,
itself the port of Nomad's scheduler/testing.go): a real state store and
a planner that applies plans straight to it (stops, evictions,
allocations, alloc blocks and the deployment a plan opens), driving the same scheduler -> placer
-> kernels -> plan -> store path the Server's workers drive."""

from __future__ import annotations

import threading
from typing import List, Optional

from .device import DeviceLike, resolve
from .scheduler.scheduler import NewScheduler
from .state import StateStore
from .structs.evaluation import Evaluation
from .structs.plan import Plan, PlanResult


class Harness:
    def __init__(self, store: Optional[StateStore] = None,
                 device: DeviceLike = None):
        self.store = store if store is not None else StateStore()
        self.device = resolve(device)
        self.plans: List[Plan] = []
        self.evals: List[Evaluation] = []
        self.created_evals: List[Evaluation] = []
        self.reblocked_evals: List[Evaluation] = []
        self.reject_plan = False
        self._lock = threading.Lock()

    # -- Planner interface --

    def submit_plan(self, plan: Plan):
        with self._lock:
            self.plans.append(plan)
            if self.reject_plan:
                # nothing committed: every planned node counts as
                # rejected, so solver-ledger hooks correct their usage
                nodes = set(plan.node_allocation)
                for b in plan.alloc_blocks:
                    nodes.update(b.node_ids)
                result = PlanResult(refresh_index=self.store.latest_index,
                                    rejected_nodes=sorted(nodes))
                self._run_hooks(plan, result)
                return result, self.store.snapshot()
            placements, stops, preemptions = [], [], []
            for allocs in plan.node_allocation.values():
                placements.extend(allocs)
            for allocs in plan.node_update.values():
                stops.extend(allocs)
            for allocs in plan.node_preemptions.values():
                preemptions.extend(allocs)
            index = self.store.upsert_plan_results(
                result_allocs=placements,
                alloc_blocks=list(plan.alloc_blocks),
                deployment=plan.deployment, stopped_allocs=stops,
                preempted_allocs=preemptions)
            result = PlanResult(node_allocation=plan.node_allocation,
                                node_update=plan.node_update,
                                node_preemptions=plan.node_preemptions,
                                alloc_blocks=list(plan.alloc_blocks),
                                alloc_index=index)
            self._run_hooks(plan, result)
            return result, None

    @staticmethod
    def _run_hooks(plan: Plan, result: PlanResult) -> None:
        """Planner contract: post-apply hooks fire synchronously with the
        commit. A failing hook must not fail the commit it reports on."""
        for hook in plan.post_apply_hooks:
            try:
                hook(result)
            except Exception:  # noqa: BLE001 - the commit already landed
                pass

    def update_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.evals.append(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.created_evals.append(evaluation)

    def reblock_eval(self, evaluation: Evaluation) -> None:
        with self._lock:
            self.reblocked_evals.append(evaluation)

    # -- helpers --

    def snapshot(self):
        return self.store.snapshot()

    def process(self, evaluation: Evaluation, sched_config=None,
                placer=None) -> None:
        """Instantiate the right scheduler and process one eval."""
        sched = NewScheduler(evaluation.type, self.store.snapshot(), self,
                             sched_config=sched_config, placer=placer,
                             device=self.device)
        sched.process(evaluation)
