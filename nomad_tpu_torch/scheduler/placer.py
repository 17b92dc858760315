"""Placement backends (reference ``nomad_tpu/scheduler/placer.py``).

- :class:`HostPlacer`: the per-request greedy select of the host oracle
  (``scheduler/rank.py``), behind "binpack", "spread" and every other
  algorithm that is not a device tier;
- "tpu-binpack" and "tpu-solve" map to the port's
  :class:`~nomad_tpu_torch.tensor.placer.TorchPlacer` (under
  "tpu-solve" its bulk solves go to the joint auction tier).
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..structs import Job, Node, enums
from .context import EvalContext
from .rank import NodeScorer, select_best_node
from .reconcile import BulkPlacementRequest


class HostPlacer:
    """Greedy per-placement selection: the reference semantics. It runs
    no device code."""

    def __init__(self, algorithm: str = enums.SCHED_ALG_BINPACK):
        self.algorithm = algorithm

    def place(self, ctx: EvalContext, job: Job, requests, nodes: Sequence[Node],
              commit, *, batch: bool = False,
              preemption_enabled: bool = False, attempt: int = 0) -> None:
        """Select a node for each request and call ``commit(req, option)``
        right after each decision: the commit appends the alloc to the
        plan, which is how later selections see earlier ones through
        ``ctx.proposed_allocs``."""
        # the host path has no columnar shape: a bulk request becomes its
        # per-alloc requests
        if any(isinstance(r, BulkPlacementRequest) for r in requests):
            flat = []
            for r in requests:
                flat.extend(r.expand() if isinstance(r, BulkPlacementRequest)
                            else [r])
            requests = flat
        scorers: Dict[str, NodeScorer] = {}
        for req in requests:
            tg = req.task_group
            scorer = scorers.get(tg.name)
            if scorer is None:
                scorer = scorers[tg.name] = NodeScorer(
                    ctx, job, tg, algorithm=self.algorithm,
                    preemption_enabled=preemption_enabled)
            penalty = (frozenset({req.ignore_node}) if req.ignore_node
                       else frozenset())
            option = select_best_node(
                ctx, job, tg, nodes, batch=batch, algorithm=self.algorithm,
                preemption_enabled=preemption_enabled, penalty_nodes=penalty,
                scorer=scorer, attempt=attempt)
            if option is not None:
                scorer.record_placement(option.node)
            commit(req, option)


def placer_for_algorithm(algorithm: str, device=None):
    """The placer of ``SchedulerConfiguration.scheduler_algorithm``.
    ``device`` is where a TorchPlacer runs; the HostPlacer ignores it."""
    if algorithm == enums.SCHED_ALG_TPU_BINPACK:
        from ..tensor.placer import TorchPlacer

        return TorchPlacer(device=device)
    if algorithm == enums.SCHED_ALG_TPU_SOLVE:
        from ..tensor.placer import TorchPlacer

        return TorchPlacer(algorithm=enums.SCHED_ALG_TPU_SOLVE, device=device)
    return HostPlacer(algorithm=algorithm)
