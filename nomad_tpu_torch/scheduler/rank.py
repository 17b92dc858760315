"""Ranking and selection on the host (reference
``nomad_tpu/scheduler/rank.py:52-511``): the per-placement oracle.

shuffled nodes -> class-memoized feasibility -> distinct hosts/property
-> binpack fit -> job anti-affinity -> rescheduling penalty -> node
affinity -> spread -> mean of the sub-scores present -> limit(log2 n,
skip <= 3 at or below 0.0) -> max score.

The placer runs it for groups of at most ``HOST_CUTOVER`` placements,
and the tests hold the score kernel against it. Preemption, ports,
device instances and cores are not modelled here: a group that asks for
them is refused upstream, and a node that does not fit while preemption
is enabled raises (ROADMAP queue A4).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence

from ..structs import Job, Node, TaskGroup, enums
from ..structs.alloc import Allocation
from ..structs.funcs import (BINPACK_MAX_FIT_SCORE, allocs_fit,
                             score_fit_binpack, score_fit_spread)
from .context import EvalContext
from .feasible import (check_constraint, distinct_hosts_mask,
                       distinct_property_mask, driver_mask,
                       node_meets_constraint, resolve_target)
from .spread import SpreadScorer

SKIP_SCORE_THRESHOLD = 0.0
MAX_SKIP = 3


@dataclass
class RankedNode:
    node: Node
    scores: List[float] = field(default_factory=list)
    score_meta: Dict[str, float] = field(default_factory=dict)
    final_score: float = 0.0
    preempted_allocs: Optional[List[Allocation]] = None

    def add_score(self, name: str, value: float) -> None:
        self.scores.append(value)
        self.score_meta[name] = value

    def normalize(self) -> None:
        """Mean of the sub-scores present."""
        if self.scores:
            self.final_score = sum(self.scores) / len(self.scores)
        self.score_meta["normalized-score"] = self.final_score


class NodeScorer:
    """Scores one candidate node for one task-group placement, holding
    the per-(job, tg) state of one evaluation: merged affinities, spread
    property sets, penalty nodes."""

    def __init__(self, ctx: EvalContext, job: Job, tg: TaskGroup, *,
                 algorithm: str = enums.SCHED_ALG_BINPACK,
                 preemption_enabled: bool = False):
        self.ctx = ctx
        self.job = job
        self.tg = tg
        self.algorithm = algorithm
        self.preemption_enabled = preemption_enabled
        self.ask_vec = tg.combined_resources().vec()
        self.affinities = (list(job.affinities) + list(tg.affinities)
                           + [a for t in tg.tasks for a in t.affinities])
        self.sum_affinity_weight = sum(abs(a.weight) for a in self.affinities)
        self.spread = SpreadScorer(job, tg, ctx.snapshot)
        self.penalty_nodes: FrozenSet[str] = frozenset()

    def has_affinities_or_spreads(self) -> bool:
        return bool(self.affinities) or self.spread.has_spreads()

    def rank(self, node: Node) -> Optional[RankedNode]:
        """A scored RankedNode, or None if the node is exhausted."""
        option = RankedNode(node=node)
        proposed = self.ctx.proposed_allocs(node.id)
        placement = Allocation(
            id="_candidate", allocated_vec=self.ask_vec, job_id=self.job.id,
            task_group=self.tg.name, client_status=enums.ALLOC_CLIENT_PENDING)
        fit, dim, used = allocs_fit(node, proposed + [placement])
        if not fit:
            if self.preemption_enabled:
                raise NotImplementedError(
                    "preemption on the host oracle: ROADMAP queue A4")
            if self.ctx.metrics is not None:
                self.ctx.metrics.exhaust_node(dim)
            return None

        available = node.available_vec()
        if self.algorithm == enums.SCHED_ALG_SPREAD:
            fitness = score_fit_spread(available, used)
        else:
            fitness = score_fit_binpack(available, used)
        option.add_score("binpack", fitness / BINPACK_MAX_FIT_SCORE)

        collisions = sum(1 for a in proposed if a.job_id == self.job.id
                         and a.task_group == self.tg.name)
        if collisions > 0 and self.tg.count > 0:
            option.add_score("job-anti-affinity",
                             -float(collisions + 1) / self.tg.count)

        if node.id in self.penalty_nodes:
            option.add_score("node-reschedule-penalty", -1.0)

        if self.affinities:
            total = 0.0
            for aff in self.affinities:
                lval, lok = resolve_target(aff.ltarget, node)
                rval, rok = resolve_target(aff.rtarget, node)
                if check_constraint(aff.operand, lval, rval, lok, rok,
                                    self.ctx.regex_cache):
                    total += aff.weight
            if total != 0.0:
                option.add_score("node-affinity",
                                 total / self.sum_affinity_weight)

        sboost = self.spread.score(node)
        if sboost is not None:
            option.add_score("allocation-spread", sboost)

        option.normalize()
        return option

    def record_placement(self, node: Node) -> None:
        self.spread.record_placement(node)


def _class_feasible(ctx: EvalContext, job: Job, tg: TaskGroup,
                    node: Node) -> bool:
    """Class-memoized job and group feasibility for one node: job
    constraints, then drivers and group/task constraints. Device, network
    mode and volume checks are not modelled (such groups are refused
    before placement)."""
    klass = node.computed_class
    elig = ctx.eligibility
    ok = elig.job_status(klass)
    if ok is None:
        ok = all(node_meets_constraint(c, node, ctx.regex_cache)
                 for c in job.constraints)
        elig.set_job_status(klass, ok)
    if not ok:
        if ctx.metrics is not None:
            ctx.metrics.filter_node("job constraints")
        return False
    ok = elig.tg_status(tg.name, klass)
    if ok is None:
        tg_cons = (list(tg.constraints)
                   + [c for t in tg.tasks for c in t.constraints])
        ok = (bool(driver_mask(tg, [node])[0])
              and all(node_meets_constraint(c, node, ctx.regex_cache)
                      for c in tg_cons))
        elig.set_tg_status(tg.name, klass, ok)
    if not ok:
        if ctx.metrics is not None:
            ctx.metrics.filter_node("task group constraints")
        return False
    return True


def _plan_aware_job_allocs(ctx: EvalContext, job: Job) -> List[Allocation]:
    """The job's allocs as they would look if the in-progress plan
    committed: state minus planned stops/evictions plus placements."""
    out = list(ctx.snapshot.allocs_by_job(job.id, job.namespace))
    if ctx.plan is None:
        return out
    removed = set()
    for allocs in ctx.plan.node_update.values():
        removed.update(a.id for a in allocs)
    for allocs in ctx.plan.node_preemptions.values():
        removed.update(a.id for a in allocs)
    out = [a for a in out if a.id not in removed]
    for allocs in ctx.plan.node_allocation.values():
        out.extend(a for a in allocs if a.job_id == job.id)
    return out


def select_best_node(ctx: EvalContext, job: Job, tg: TaskGroup,
                     nodes: Sequence[Node], *, batch: bool = False,
                     algorithm: str = enums.SCHED_ALG_BINPACK,
                     preemption_enabled: bool = False,
                     penalty_nodes: FrozenSet[str] = frozenset(),
                     scorer: Optional[NodeScorer] = None,
                     attempt: int = 0) -> Optional[RankedNode]:
    """One placement: shuffle, filter, rank up to the limit (2 for
    batch, else ceil(log2 n) floored at 2, widened to max(count, 100)
    with affinities or spreads), keep the best."""
    t0 = time.perf_counter()
    metrics = ctx.new_metrics()
    metrics.nodes_in_pool = len(nodes)
    if not nodes:
        return None
    if scorer is None:
        scorer = NodeScorer(ctx, job, tg, algorithm=algorithm,
                            preemption_enabled=preemption_enabled)
    scorer.penalty_nodes = penalty_nodes

    n = len(nodes)
    if batch:
        limit = 2
    else:
        limit = max(2, int(math.ceil(math.log2(n))) if n > 1 else 2)
    if scorer.has_affinities_or_spreads():
        limit = max(tg.count, 100)

    best: Optional[RankedNode] = None
    seen = 0
    skipped: List[RankedNode] = []
    for node in ctx.shuffled_nodes(list(nodes), attempt):
        if seen >= limit:
            break
        metrics.nodes_evaluated += 1
        if not _class_feasible(ctx, job, tg, node):
            continue
        if not distinct_hosts_mask(job, tg, [node], ctx.proposed_allocs)[0]:
            metrics.filter_node("distinct_hosts")
            continue
        if not distinct_property_mask(job, tg, [node],
                                      _plan_aware_job_allocs(ctx, job),
                                      ctx.snapshot.node_by_id)[0]:
            metrics.filter_node("distinct_property")
            continue
        option = scorer.rank(node)
        if option is None:
            continue
        # up to MAX_SKIP low-scoring options are set aside in hope of
        # better ones
        if (option.final_score <= SKIP_SCORE_THRESHOLD
                and len(skipped) < MAX_SKIP):
            skipped.append(option)
            continue
        seen += 1
        if best is None or option.final_score > best.final_score:
            best = option
    for option in skipped:
        if seen >= limit:
            break
        seen += 1
        if best is None or option.final_score > best.final_score:
            best = option

    metrics.allocation_time_s = time.perf_counter() - t0
    if best is not None:
        for name, val in best.score_meta.items():
            metrics.scores[f"{best.node.id}.{name}"] = val
    return best


def score_nodes(ctx: EvalContext, job: Job, tg: TaskGroup,
                nodes: Sequence[Node],
                algorithm: str = enums.SCHED_ALG_BINPACK,
                preemption_enabled: bool = False) -> List[RankedNode]:
    """Score every feasible node, with no limit and no shuffle: the
    oracle the score kernel is held against."""
    ctx.new_metrics()
    scorer = NodeScorer(ctx, job, tg, algorithm=algorithm,
                        preemption_enabled=preemption_enabled)
    out = []
    for node in nodes:
        if not _class_feasible(ctx, job, tg, node):
            continue
        option = scorer.rank(node)
        if option is not None:
            out.append(option)
    return out
