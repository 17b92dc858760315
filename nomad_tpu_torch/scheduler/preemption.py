"""Preemption victim selection on the host (reference
``nomad_tpu/scheduler/preemption.py``, itself Nomad's
scheduler/preemption.go):

- only allocations at least ``PRIORITY_DELTA`` below the asking job's
  priority are evictable;
- candidates are taken in ascending priority groups, within a group by
  resource distance to what is still missing plus the migrate
  max_parallel penalty, until the ask fits; then victims that are no
  longer needed are dropped (filterSuperset);
- ``preempt_for_network`` frees conflicting reserved ports and
  ``preempt_for_device`` device-group instances (reference
  ``preemption.py:178-295``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..structs.alloc import Allocation
from ..structs.funcs import allocs_fit
from ..structs.resources import RESOURCE_DIMS
from .devices import matching_groups

# preemption.go:26: allocs within a priority delta of 10 are skipped
PRIORITY_DELTA = 10
# preemption.go:16 maxParallelPenalty
MAX_PARALLEL_PENALTY = 50.0


def is_preemptible(alloc: Allocation, current_priority: int) -> bool:
    return (alloc.job is not None
            and current_priority - alloc.job.priority >= PRIORITY_DELTA
            and alloc.should_count_for_usage())


def victim_candidates(proposed: Sequence[Allocation],
                      current_priority: int) -> List[Allocation]:
    """The eligible victims in the canonical column order that the
    kernel's prefix rule consumes: priority ascending, alloc id
    ascending within a priority."""
    cands = [a for a in proposed if is_preemptible(a, current_priority)]
    cands.sort(key=lambda a: (a.job.priority, a.id))
    return cands


def victim_holds_exact_resources(alloc: Allocation) -> bool:
    """True when evicting the alloc frees port numbers or device
    instances, which the dense victim columns cannot model; a kernel row
    that selects one is flagged for the exact host scanner."""
    return bool(alloc.allocated_ports) or bool(alloc.allocated_devices)


def basic_resource_distance(need: np.ndarray, have: np.ndarray) -> float:
    """Euclidean distance between normalized resource vectors
    (preemption.go basicResourceDistance)."""
    d = 0.0
    for i in range(RESOURCE_DIMS):
        if need[i] > 0:
            d += ((have[i] - need[i]) / need[i]) ** 2
    return float(np.sqrt(d))


def _max_parallel_penalty(alloc: Allocation, counts: Dict[tuple, int]) -> float:
    """Score penalty once a victim's task group is at its migrate
    max_parallel in this selection (scoreForTaskGroup)."""
    job = alloc.job
    if job is None:
        return 0.0
    tg = job.lookup_task_group(alloc.task_group)
    if tg is None or tg.migrate is None:
        return 0.0
    max_parallel = tg.migrate.max_parallel
    if max_parallel <= 0:
        return 0.0
    n = counts.get((alloc.namespace, alloc.job_id, alloc.task_group), 0)
    if n < max_parallel:
        return 0.0
    return float((n + 1) - max_parallel) * MAX_PARALLEL_PENALTY


def preempt_for_task_group(
    node,
    proposed: Sequence[Allocation],
    ask_vec: np.ndarray,
    current_priority: int,
    check_devices: bool = False,
    ask_devices=(),
    preempted_counts: Optional[Dict[tuple, int]] = None,
) -> Optional[List[Allocation]]:
    """A minimal set of lower-priority allocs whose removal lets the ask
    fit (preemption.go:127 PreemptForTaskGroup), or None. With
    ``check_devices`` the candidate holds ``ask_devices``' counts too.
    ``preempted_counts`` carries the evictions already in the plan per
    (namespace, job, task group), so max_parallel penalties span the
    eval."""
    candidates = victim_candidates(proposed, current_priority)
    if not candidates:
        return None

    counts: Dict[tuple, int] = dict(preempted_counts or {})
    victims: List[Allocation] = []
    victim_ids = set()
    placement = Allocation(
        id="_cand", allocated_vec=ask_vec,
        allocated_devices={d.name: ["?"] * d.count for d in ask_devices}
        if check_devices else {})

    def fits_now() -> bool:
        remaining = [a for a in proposed if a.id not in victim_ids]
        fit, _, _ = allocs_fit(node, remaining + [placement],
                               check_devices=check_devices)
        return fit

    if fits_now():
        return None

    i = 0
    while i < len(candidates):
        prio = candidates[i].job.priority
        group = []
        while i < len(candidates) and candidates[i].job.priority == prio:
            group.append(candidates[i])
            i += 1
        # within the group, repeatedly take the best match to the
        # remaining need
        while group:
            used = np.zeros(RESOURCE_DIMS)
            for a in proposed:
                if a.id not in victim_ids and a.should_count_for_usage():
                    used += a.allocated_vec
            need = np.maximum(used + ask_vec - node.available_vec(), 0.0)
            group.sort(key=lambda a: (
                basic_resource_distance(need, a.allocated_vec)
                + _max_parallel_penalty(a, counts)))
            pick = group.pop(0)
            victims.append(pick)
            victim_ids.add(pick.id)
            ckey = (pick.namespace, pick.job_id, pick.task_group)
            counts[ckey] = counts.get(ckey, 0) + 1
            if fits_now():
                # drop every victim that is no longer needed
                for v in sorted(victims, key=lambda a: -a.job.priority):
                    victim_ids.discard(v.id)
                    if not fits_now():
                        victim_ids.add(v.id)
                return [v for v in victims if v.id in victim_ids]
    return None


def preempt_for_network(
    node,
    proposed: Sequence[Allocation],
    ask,
    current_priority: int,
    preempted_counts: Optional[Dict[tuple, int]] = None,
) -> Optional[List[Allocation]]:
    """Free conflicting reserved ports (reference preemption.go:30
    PreemptForNetwork). The reference also preempts on bandwidth
    (networkResourceDistance over mbits); this model's allocations
    record ports but not per-alloc bandwidth, so the network dimension
    here is reserved-port conflicts — victims are taken in ascending
    priority groups, direct holders of a needed port first, with the
    migrate max_parallel penalty applied (scoreForNetwork)."""
    needed_ports = {p[1] for p in ask.reserved_port_asks()}
    if not needed_ports:
        return None

    counts: Dict[tuple, int] = dict(preempted_counts or {})

    def alloc_ports(a: Allocation) -> set:
        return {p.value for p in a.allocated_ports}

    candidates = [a for a in proposed if is_preemptible(a, current_priority)
                  and alloc_ports(a) & needed_ports]
    if not candidates:
        return None

    victims: List[Allocation] = []
    victim_ids = set()

    def satisfied() -> bool:
        for a in proposed:
            if a.id in victim_ids or not a.should_count_for_usage():
                continue
            if alloc_ports(a) & needed_ports:
                return False
        return True

    if satisfied():
        return None

    candidates.sort(key=lambda a: a.job.priority)
    i = 0
    while i < len(candidates):
        prio = candidates[i].job.priority
        group = []
        while i < len(candidates) and candidates[i].job.priority == prio:
            group.append(candidates[i])
            i += 1
        while group:
            group.sort(key=lambda a: (
                -len(alloc_ports(a) & needed_ports)
                + _max_parallel_penalty(a, counts)))
            pick = group.pop(0)
            victims.append(pick)
            victim_ids.add(pick.id)
            ckey = (pick.namespace, pick.job_id, pick.task_group)
            counts[ckey] = counts.get(ckey, 0) + 1
            if satisfied():
                return victims
    return None


def preempt_for_device(
    node,
    proposed: Sequence[Allocation],
    ask_devices,
    current_priority: int,
) -> Optional[List[Allocation]]:
    """Free device-group instances (reference preemption.go:16
    PreemptForDevice + selectBestAllocs): per unsatisfied ask, victims
    come from ascending priority groups, largest instance holders first,
    until enough instances are free."""
    victims: List[Allocation] = []
    victim_ids = set()

    for ask in ask_devices:
        groups = matching_groups(node, ask, {}, {})
        group_ids = {g.id for g in groups}
        capacity = sum(len(g.instance_ids) for g in groups)

        def held_instances(a: Allocation) -> int:
            return sum(len(inst)
                       for name, inst in (a.allocated_devices or {}).items()
                       if name in group_ids)

        def free_now() -> int:
            used = 0
            for a in proposed:
                if a.id in victim_ids or not a.should_count_for_usage():
                    continue
                used += held_instances(a)
            return capacity - used

        needed = ask.count - free_now()
        if needed <= 0:
            continue
        candidates = [a for a in proposed
                      if is_preemptible(a, current_priority)
                      and held_instances(a) > 0]
        if not candidates:
            return None
        # ascending priority, then largest holders first within a group
        # (reference selectBestAllocs sorts descending by instance count)
        candidates.sort(key=lambda a: (a.job.priority, -held_instances(a)))
        freed = 0
        for a in candidates:
            if freed >= needed:
                break
            victims.append(a)
            victim_ids.add(a.id)
            freed += held_instances(a)
        if freed < needed:
            return None
    return victims or None
