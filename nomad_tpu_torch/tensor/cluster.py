"""Tensorization for the bulk path: snapshot + in-progress plan -> dense
arrays (reference ``nomad_tpu/tensor/cluster.py:40-350, 423-457,
746-829``).

``ClusterStatic`` holds what depends only on the node set (capacity,
index maps, feasibility masks, affinity vectors, device-resident
copies), cached per store node-set version and shared by every eval and
worker. ``ClusterTensors`` adds one eval's usage view. Spread, device
and distinct-property tables are not built here: the bulk shape has
none, and a group that asks for them raises for the per-eval slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..scheduler.context import EvalContext
from ..scheduler.feasible import (check_constraint, distinct_hosts_flags,
                                  feasible_mask_static, has_distinct_property,
                                  resolve_target, tg_mask_signature)
from ..structs import Job, Node, TaskGroup, enums
from ..structs.resources import RESOURCE_DIMS

_PER_EVAL = "ROADMAP queue A, slice 4 (the per-eval general path)"


def _pad_pow2(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


class ClusterStatic:
    """Canonical per-(node-set version, node list) arrays shared across
    evals and workers: capacity, the node index map, feasibility masks,
    affinity vectors, and ``device_arrays``, the per-device copies the
    solver service uploads once."""

    __slots__ = ("nodes", "n_pad", "available", "node_index", "usage_rows",
                 "version", "mask_cache", "aff_cache", "device_arrays")

    def __init__(self, nodes: Sequence[Node], store=None, version=None):
        n = len(nodes)
        self.nodes = list(nodes)
        self.n_pad = _pad_pow2(n)
        self.version = version
        self.available = np.zeros((self.n_pad, RESOURCE_DIMS))
        self.node_index: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            self.available[i] = node.available_vec()
            self.node_index[node.id] = i
        self.usage_rows = (store.usage_rows_for([n.id for n in nodes])
                           if store is not None and n else None)
        self.mask_cache: Dict[tuple, np.ndarray] = {}
        self.aff_cache: Dict[tuple, np.ndarray] = {}
        self.device_arrays: Dict = {}


# one build at a time: builds are keyed per (version, node set) and
# idempotent, so racing workers share ONE ClusterStatic
_static_build_lock = threading.Lock()


def _static_for(ctx: EvalContext, nodes: Sequence[Node]):
    """Cached ClusterStatic when ``nodes`` is the store's canonical
    ready-node list (StateSnapshot.ready_nodes_in_pool); None otherwise."""
    store = getattr(ctx.snapshot, "_store", None)
    if store is None:
        return None
    version = getattr(nodes, "canonical_version", None)
    if version is None or version != store.node_set_version:
        return None
    statics = getattr(store, "_tensor_statics", None)
    if statics is None:
        statics = store._tensor_statics = {}
    key = (version, getattr(nodes, "canonical_key", None))
    static = statics.get(key)
    if static is None:
        with _static_build_lock:
            static = statics.get(key)
            if static is None:
                for k in [k for k in list(statics) if k[0] != version]:
                    statics.pop(k, None)
                static = statics[key] = ClusterStatic(nodes, store=store,
                                                      version=version)
    return static


@dataclass
class ClusterTensors:
    """Per-eval view: the shared ClusterStatic + this eval's usage."""

    nodes: List[Node]
    n_pad: int
    available: np.ndarray          # (Np, D), shared with the static
    used: np.ndarray               # (Np, D) proposed usage, per eval
    node_index: Dict[str, int]
    static: "ClusterStatic" = None
    _store: object = None

    @classmethod
    def build(cls, ctx: EvalContext, nodes: Sequence[Node]) -> "ClusterTensors":
        static = _static_for(ctx, nodes)
        if static is None:
            static = ClusterStatic(nodes)  # per-eval, uncached
        t = cls(nodes=static.nodes, n_pad=static.n_pad,
                available=static.available, used=None,
                node_index=static.node_index, static=static,
                _store=getattr(ctx.snapshot, "_store", None))
        t.refresh_usage(ctx)
        return t

    def refresh_usage(self, ctx: EvalContext) -> None:
        """Proposed usage (state - evictions + placements). The base is
        one gather from the store's dense LATEST usage matrix when the
        static has its rows, else per-node snapshot rows; nodes the
        in-progress plan touches are recomputed from ctx.proposed_allocs."""
        n = len(self.nodes)
        used = self.used = np.zeros((self.n_pad, RESOURCE_DIMS))
        rows = self.static.usage_rows if self.static is not None else None
        if rows is not None and self._store is not None:
            used[:n] = self._store._usage_mat[rows]
        else:
            for i, node in enumerate(self.nodes):
                u = ctx.snapshot.node_usage(node.id)
                if u is not None:
                    used[i] = u
        plan = ctx.plan
        if plan is None:
            return
        touched = (set(plan.node_update) | set(plan.node_preemptions)
                   | set(plan.node_allocation))
        for node_id in touched:
            i = self.node_index.get(node_id)
            if i is None:
                continue
            used[i] = 0.0
            for a in ctx.proposed_allocs(node_id):
                if not a.client_terminal():
                    used[i] += a.allocated_vec

    def latest_usage(self) -> np.ndarray:
        """Freshly gathered LATEST committed usage, (n_pad, D) float32.
        The solver service calls it at RESYNC time, not solve time, so
        usage committed while the request queued is not lost."""
        rows = self.static.usage_rows if self.static is not None else None
        if rows is not None and self._store is not None:
            mat = self._store._usage_mat
            out = np.zeros((self.n_pad, RESOURCE_DIMS), dtype=np.float32)
            out[: len(self.nodes)] = mat[rows]
            return out
        return self.used.astype(np.float32)

    def placement_counts(self, job: Job, tg: TaskGroup,
                         ctx: EvalContext) -> Tuple[np.ndarray, np.ndarray]:
        """(placed_tg, placed_job) int32 vectors counting this job's
        proposed allocs per node (the anti-affinity input)."""
        ptg = np.zeros(self.n_pad, dtype=np.int32)
        pjob = np.zeros(self.n_pad, dtype=np.int32)
        plan = ctx.plan
        removed: set = set()
        placed_ids: set = set()
        if plan is not None:
            for allocs in plan.node_update.values():
                removed.update(a.id for a in allocs)
            for allocs in plan.node_preemptions.values():
                removed.update(a.id for a in allocs)
            for allocs in plan.node_allocation.values():
                placed_ids.update(a.id for a in allocs)
        for a in ctx.snapshot.allocs_by_job(job.id, job.namespace):
            if a.terminal_status() or a.id in removed or a.id in placed_ids:
                continue
            i = self.node_index.get(a.node_id)
            if i is None:
                continue
            pjob[i] += 1
            if a.task_group == tg.name:
                ptg[i] += 1
        if plan is not None:
            for node_id, allocs in plan.node_allocation.items():
                i = self.node_index.get(node_id)
                if i is None:
                    continue
                for a in allocs:
                    if a.job_id != job.id or a.namespace != job.namespace:
                        continue
                    pjob[i] += 1
                    if a.task_group == tg.name:
                        ptg[i] += 1
        return ptg, pjob


@dataclass
class TaskGroupTensors:
    """What the bulk solve needs for one task group. The spread, device
    and distinct-property tables of the reference are zero-width for the
    bulk shape and kept as such."""

    ask: np.ndarray                 # (D,)
    feasible: np.ndarray            # (Np,) bool
    affinity_boost: np.ndarray      # (Np,)
    placed_tg: np.ndarray           # (Np,) int32
    placed_job: np.ndarray          # (Np,) int32
    spread_val_id: np.ndarray       # (0, Np) int32
    tg_count: float
    dh_job: bool
    dh_tg: bool
    spread_alg: bool
    extra_ask: np.ndarray           # (0,)
    dp_val_id: np.ndarray           # (0, Np) int32
    # the SHARED cached mask when `feasible` is exactly the static mask:
    # its identity keys the device-resident copy
    feas_base: np.ndarray = None


def _affinity_vector(ctx: EvalContext, job: Job, tg: TaskGroup,
                     cluster: ClusterTensors) -> np.ndarray:
    """Node-affinity boost per node, sum(matched weight)/sum|weight|,
    cached on the ClusterStatic by affinity signature (a stable zero
    instance when there are none, so the device cache keys on identity)."""
    nodes, n_pad = cluster.nodes, cluster.n_pad
    affinities = (list(job.affinities) + list(tg.affinities)
                  + [a for t in tg.tasks for a in t.affinities])
    static = cluster.static
    sig = tuple((a.ltarget, a.operand, a.rtarget, a.weight)
                for a in affinities)
    hit = static.aff_cache.get(sig)
    if hit is not None:
        return hit
    out = np.zeros(n_pad)
    if affinities:
        total_weight = sum(abs(a.weight) for a in affinities) or 1.0
        for i, node in enumerate(nodes):
            total = 0.0
            for aff in affinities:
                lval, lok = resolve_target(aff.ltarget, node)
                rval, rok = resolve_target(aff.rtarget, node)
                if check_constraint(aff.operand, lval, rval, lok, rok,
                                    ctx.regex_cache):
                    total += aff.weight
            out[i] = total / total_weight
    static.aff_cache[sig] = out
    return out


def build_task_group_tensors(ctx: EvalContext, job: Job, tg: TaskGroup,
                             cluster: ClusterTensors, *,
                             algorithm: str = enums.SCHED_ALG_BINPACK
                             ) -> TaskGroupTensors:
    nodes, n_pad = cluster.nodes, cluster.n_pad
    res = ctx.tg_resources(tg)
    if job.spreads or tg.spreads:
        raise NotImplementedError(f"spread tables: {_PER_EVAL}")
    if res.devices or res.cores:
        raise NotImplementedError(f"device/core columns: {_PER_EVAL}")
    if has_distinct_property(job, tg):
        raise NotImplementedError(f"distinct_property tables: {_PER_EVAL}")
    static = cluster.static
    sig = tg_mask_signature(job, tg)
    base = static.mask_cache.get(sig)
    if base is None:
        base = np.zeros(n_pad, dtype=bool)
        base[: len(nodes)] = feasible_mask_static(job, tg, nodes,
                                                  ctx.regex_cache)
        base.setflags(write=False)
        static.mask_cache[sig] = base
    placed_tg, placed_job = cluster.placement_counts(job, tg, ctx)
    dh_job, dh_tg = distinct_hosts_flags(job, tg)
    return TaskGroupTensors(
        ask=ctx.tg_vec(tg),
        feasible=base,
        affinity_boost=_affinity_vector(ctx, job, tg, cluster),
        placed_tg=placed_tg,
        placed_job=placed_job,
        spread_val_id=np.zeros((0, n_pad), dtype=np.int32),
        tg_count=float(max(tg.count, 1)),
        dh_job=dh_job,
        dh_tg=dh_tg,
        spread_alg=(algorithm == enums.SCHED_ALG_SPREAD),
        extra_ask=np.zeros(0),
        dp_val_id=np.zeros((0, n_pad), dtype=np.int32),
        feas_base=base,
    )
