"""Spread scoring (reference ``nomad_tpu/scheduler/spread.py``): score
boosts in [-1, 1] per spread attribute, weighted when explicit targets
exist, even-spread delta scoring otherwise."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..structs import Job, Node, Spread, TaskGroup
from .feasible import resolve_target

IMPLICIT_TARGET = "*"


def combined_spreads(job: Job, tg: TaskGroup) -> List[Spread]:
    return list(tg.spreads) + list(job.spreads)


class SpreadInfo:
    """Desired counts per attribute value: percent/100 * tg.count, the
    remainder to "*"."""

    def __init__(self, spread: Spread, total_count: int):
        self.attribute = spread.attribute
        self.weight = spread.weight
        self.desired_counts: Dict[str, float] = {}
        total = 0.0
        for st in spread.targets:
            want = (st.percent / 100.0) * total_count
            self.desired_counts[st.value] = want
            total += want
        if 0 < total < total_count:
            self.desired_counts[IMPLICIT_TARGET] = total_count - total


class PropertySet:
    """Existing + proposed usage counts per value of one attribute for
    one task group."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.existing: Dict[str, int] = {}
        self.proposed: Dict[str, int] = {}

    def populate_existing(self, allocs, node_by_id,
                          tg_name: Optional[str] = None) -> None:
        for a in allocs:
            if a.terminal_status():
                continue
            if tg_name is not None and a.task_group != tg_name:
                continue
            node = node_by_id(a.node_id)
            if node is None:
                continue
            val, ok = resolve_target(self.attribute, node)
            if ok:
                self.existing[val] = self.existing.get(val, 0) + 1

    def add_proposed(self, node: Node) -> None:
        val, ok = resolve_target(self.attribute, node)
        if ok:
            self.proposed[val] = self.proposed.get(val, 0) + 1

    def combined(self) -> Dict[str, int]:
        out = dict(self.existing)
        for k, v in self.proposed.items():
            out[k] = out.get(k, 0) + v
        return out

    def used_count(self, node: Node) -> Tuple[str, bool, int]:
        val, ok = resolve_target(self.attribute, node)
        if not ok:
            return val, False, 0
        return val, True, self.combined().get(val, 0)


def even_spread_boost(pset: PropertySet, node: Node) -> float:
    """The even-spread boost: how far the node's value lags behind the
    most-used value, relative to the least-used one."""
    combined = pset.combined()
    if not combined:
        return 0.0
    val, ok = resolve_target(pset.attribute, node)
    if not ok:
        return -1.0
    current = combined.get(val, 0)
    counts = list(combined.values())
    min_count, max_count = min(counts), max(counts)
    if current != min_count:
        if min_count == 0:
            return -1.0
        return float(min_count - current) / float(min_count)
    if min_count == max_count:
        return -1.0
    if min_count == 0:
        return 1.0
    return float(max_count - min_count) / float(min_count)


class SpreadScorer:
    """Per-(job, tg) spread scoring state shared across the placements of
    one evaluation (property sets accumulate proposed placements)."""

    def __init__(self, job: Job, tg: TaskGroup, snapshot):
        self.spreads = combined_spreads(job, tg)
        self.infos: Dict[str, SpreadInfo] = {}
        self.psets: Dict[str, PropertySet] = {}
        self.sum_weights = 0.0
        self.lowest_boost = -1.0
        if not self.spreads:
            return
        existing = snapshot.allocs_by_job(job.id, job.namespace)
        for s in self.spreads:
            self.infos[s.attribute] = SpreadInfo(s, tg.count)
            self.sum_weights += abs(s.weight)
            pset = PropertySet(s.attribute)
            pset.populate_existing(existing, snapshot.node_by_id, tg.name)
            self.psets[s.attribute] = pset

    def has_spreads(self) -> bool:
        return bool(self.spreads)

    def score(self, node: Node) -> Optional[float]:
        """Total spread boost for placing on ``node``, or None when there
        are no spreads or the total is zero (no sub-score then)."""
        if not self.spreads:
            return None
        total = 0.0
        for attr, pset in self.psets.items():
            val, ok, used = pset.used_count(node)
            used += 1  # include this placement
            if not ok:
                total -= 1.0
                continue
            info = self.infos[attr]
            if not info.desired_counts:
                total += even_spread_boost(pset, node)
                continue
            desired = info.desired_counts.get(val)
            if desired is None:
                desired = info.desired_counts.get(IMPLICIT_TARGET)
            if desired is None:
                total -= 1.0
                continue
            weight = info.weight / self.sum_weights if self.sum_weights else 0.0
            if desired == 0:
                total += self.lowest_boost
                continue
            boost = ((desired - used) / desired) * weight
            total += boost
            if boost < self.lowest_boost:
                self.lowest_boost = boost
        return total if total != 0.0 else None

    def record_placement(self, node: Node) -> None:
        for pset in self.psets.values():
            pset.add_proposed(node)
