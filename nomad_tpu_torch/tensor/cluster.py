"""Tensorization: snapshot + in-progress plan -> dense arrays (reference
``nomad_tpu/tensor/cluster.py:40-350, 423-457, 499-609, 696-829``).

``ClusterStatic`` holds what depends only on the node set (capacity,
index maps, feasibility masks, affinity vectors, interned attribute
values, device-resident copies), cached per store node-set version and
shared by every eval and worker. ``ClusterTensors`` adds one eval's
usage view, with racing evals' in-flight placements folded in
(``overlay.py``). ``build_task_group_tensors`` lowers one task group:
feasibility, affinity, anti-affinity counts, spread tables and
distinct_property tables. Device and core columns and port asks are the
rest of ROADMAP queue A5 and raise.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..scheduler.context import EvalContext
from ..scheduler.feasible import (UNPORTED_A5, check_constraint,
                                  distinct_hosts_flags,
                                  distinct_property_constraints,
                                  distinct_property_limit,
                                  feasible_mask_static, resolve_target,
                                  tg_mask_signature)
from ..scheduler.spread import IMPLICIT_TARGET, SpreadInfo, combined_spreads
from ..structs import Job, Node, TaskGroup, enums
from ..structs.resources import RESOURCE_DIMS
from .overlay import INFLIGHT


def _pad_pow2(n: int, floor: int = 8) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


class ClusterStatic:
    """Canonical per-(node-set version, node list) arrays shared across
    evals and workers: capacity, the node index map, feasibility masks,
    affinity vectors, interned attribute values, and ``device_arrays``,
    the per-device copies the solver service uploads once."""

    __slots__ = ("nodes", "n_pad", "available", "node_index", "usage_rows",
                 "version", "mask_cache", "aff_cache", "intern_cache",
                 "device_arrays")

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
        self.intern_cache: Dict[tuple, tuple] = {}
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
        in-progress plan touches are recomputed from ctx.proposed_allocs;
        racing evals' in-flight placements are added last.

        The in-flight entries are read BEFORE the store: an entry closes
        only after its plan is in the store, so every racing solve is
        then counted at least once. Read after the store, a plan that
        commits and closes its entry in between would be counted nowhere
        and its nodes filled twice (the harness commits without
        re-checking fit)."""
        n = len(self.nodes)
        pending = np.zeros((n, RESOURCE_DIMS))
        INFLIGHT.fold(pending, self.node_index, exclude_plan=ctx.plan)
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
        if plan is not None:
            touched = (set(plan.node_update) | set(plan.node_preemptions)
                       | set(plan.node_allocation))
            for node_id in touched:
                i = self.node_index.get(node_id)
                if i is None:
                    continue
                used[i] = 0.0
                for a in ctx.proposed_allocs(node_id):
                    if a.should_count_for_usage():
                        used[i] += a.allocated_vec
        used[:n] += pending

    def latest_usage(self) -> np.ndarray:
        """Freshly gathered LATEST committed usage, (n_pad, D) float32.
        The solver service calls it at RESYNC time, not solve time, so
        usage committed while the request queued is not lost."""
        rows = self.static.usage_rows if self.static is not None else None
        if rows is not None and self._store is not None:
            mat = self._store._usage_mat
            # per-eval in-flight placements are neither in the store nor
            # in the service's ledger yet; read before the store, as in
            # refresh_usage
            pending = np.zeros((len(self.nodes), RESOURCE_DIMS))
            INFLIGHT.fold(pending, self.node_index)
            out = np.zeros((self.n_pad, RESOURCE_DIMS), dtype=np.float32)
            out[: len(self.nodes)] = mat[rows] + pending
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
    """Everything the solve of one task group needs. The spread and
    distinct_property tables are zero-width when the group has none."""

    ask: np.ndarray                 # (D,)
    feasible: np.ndarray            # (Np,) bool
    affinity_boost: np.ndarray      # (Np,)
    placed_tg: np.ndarray           # (Np,) int32
    placed_job: np.ndarray          # (Np,) int32
    spread_val_id: np.ndarray       # (S, Np) int32
    spread_val_ok: np.ndarray       # (S, Np) bool
    spread_counts: np.ndarray       # (S, V) int32
    spread_desired: np.ndarray      # (S, V) float (NaN = no target)
    spread_has_targets: np.ndarray  # (S,) bool
    spread_weight: np.ndarray       # (S,)
    tg_count: float
    dh_job: bool
    dh_tg: bool
    spread_alg: bool
    extra_ask: np.ndarray           # (0,): device/core columns raise
    dev_affinity: np.ndarray        # (Np,) zeros: no device asks
    dp_val_id: np.ndarray           # (P, Np) int32
    dp_val_ok: np.ndarray           # (P, Np) bool
    dp_counts: np.ndarray           # (P, Vd) int32
    dp_limit: np.ndarray            # (P,)
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


def _interned_attr(cluster: ClusterTensors, attribute: str):
    """-> (vocab, val_id (Np,), val_ok (Np,)) for one node attribute,
    cached on the ClusterStatic. The vocab only grows (values of off-pool
    nodes are interned by callers), so cached val_id rows stay valid."""
    static = cluster.static
    key = ("attr", attribute)
    hit = static.intern_cache.get(key)
    if hit is not None:
        return hit
    vocab: Dict[str, int] = {}
    val_id = np.zeros(cluster.n_pad, dtype=np.int32)
    val_ok = np.zeros(cluster.n_pad, dtype=bool)
    for i, node in enumerate(cluster.nodes):
        v, ok = resolve_target(attribute, node)
        if ok:
            val_id[i] = vocab.setdefault(v, len(vocab))
            val_ok[i] = True
    out = static.intern_cache[key] = (vocab, val_id, val_ok)
    return out


_intern_lock = threading.Lock()


def _intern(vocab: Dict[str, int], v: str) -> int:
    """Append-only interning, safe under workers sharing a cached vocab."""
    vid = vocab.get(v)
    if vid is None:
        with _intern_lock:
            vid = vocab.get(v)
            if vid is None:
                vid = vocab[v] = len(vocab)
    return vid


def _spread_tensors(ctx: EvalContext, job: Job, tg: TaskGroup,
                    cluster: ClusterTensors):
    """Interned spread-attribute values, existing counts per value (the
    group's live allocs in the snapshot), desired counts and weights."""
    n_pad = cluster.n_pad
    spreads = combined_spreads(job, tg)
    s = len(spreads)
    if s == 0:
        return (np.zeros((0, n_pad), dtype=np.int32),
                np.zeros((0, n_pad), dtype=bool),
                np.zeros((0, 1), dtype=np.int32), np.full((0, 1), np.nan),
                np.zeros(0, dtype=bool), np.zeros(0))
    sum_weights = sum(abs(sp.weight) for sp in spreads) or 1.0
    existing = [a for a in ctx.snapshot.allocs_by_job(job.id, job.namespace)
                if not a.terminal_status() and a.task_group == tg.name]
    vocabs: List[Dict[str, int]] = []
    val_ids = np.zeros((s, n_pad), dtype=np.int32)
    val_ok = np.zeros((s, n_pad), dtype=bool)
    counts_list: List[Dict[int, int]] = []
    for si, sp in enumerate(spreads):
        vocab, vid_row, vok_row = _interned_attr(cluster, sp.attribute)
        val_ids[si] = vid_row
        val_ok[si] = vok_row
        counts: Dict[int, int] = {}
        for a in existing:
            anode = ctx.snapshot.node_by_id(a.node_id)
            if anode is None:
                continue
            v, ok = resolve_target(sp.attribute, anode)
            if ok:
                vid = _intern(vocab, v)
                counts[vid] = counts.get(vid, 0) + 1
        vocabs.append(vocab)
        counts_list.append(counts)
    # one stable copy of the (shared, growing) vocabs bounds v_pad
    vocab_items = [list(v.items()) for v in vocabs]
    v_pad = _pad_pow2(max(max(len(v) for v in vocab_items), 1), floor=1)
    spread_counts = np.zeros((s, v_pad), dtype=np.int32)
    spread_desired = np.full((s, v_pad), np.nan)
    has_targets = np.zeros(s, dtype=bool)
    weights = np.zeros(s)
    for si, sp in enumerate(spreads):
        weights[si] = sp.weight / sum_weights
        for vid, c in counts_list[si].items():
            spread_counts[si, vid] = c
        if not sp.targets:
            continue
        has_targets[si] = True
        desired = SpreadInfo(sp, tg.count).desired_counts
        implicit = desired.get(IMPLICIT_TARGET)
        for val, vid in vocab_items[si]:
            if val in desired:
                spread_desired[si, vid] = desired[val]
            elif implicit is not None:
                spread_desired[si, vid] = implicit
    return val_ids, val_ok, spread_counts, spread_desired, has_targets, weights


def _distinct_property_tensors(ctx: EvalContext, job: Job, tg: TaskGroup,
                               cluster: ClusterTensors):
    """Interned distinct_property values, proposed counts per value (the
    job's live allocs as the in-progress plan would leave them) and
    limits."""
    from ..scheduler.rank import _plan_aware_job_allocs

    n_pad = cluster.n_pad
    constraints = distinct_property_constraints(job, tg)
    p = len(constraints)
    if p == 0:
        return (np.zeros((0, n_pad), dtype=np.int32),
                np.zeros((0, n_pad), dtype=bool),
                np.zeros((0, 1), dtype=np.int32), np.zeros(0))
    live = [a for a in _plan_aware_job_allocs(ctx, job)
            if not a.terminal_status()]
    val_ids = np.zeros((p, n_pad), dtype=np.int32)
    val_ok = np.zeros((p, n_pad), dtype=bool)
    limits = np.zeros(p)
    counts_list = []
    vocabs = []
    for pi, c in enumerate(constraints):
        limits[pi] = distinct_property_limit(c)
        vocab, vid_row, vok_row = _interned_attr(cluster, c.ltarget)
        val_ids[pi] = vid_row
        val_ok[pi] = vok_row
        counts: Dict[int, int] = {}
        for a in live:
            anode = ctx.snapshot.node_by_id(a.node_id)
            if anode is None:
                continue
            v, ok = resolve_target(c.ltarget, anode)
            if ok and v in vocab:
                counts[vocab[v]] = counts.get(vocab[v], 0) + 1
        vocabs.append(vocab)
        counts_list.append(counts)
    v_pad = _pad_pow2(max(max(len(v) for v in vocabs), 1), floor=1)
    dp_counts = np.zeros((p, v_pad), dtype=np.int32)
    for pi, counts in enumerate(counts_list):
        for vid, cnt in counts.items():
            dp_counts[pi, vid] = cnt
    return val_ids, val_ok, dp_counts, limits


def build_task_group_tensors(ctx: EvalContext, job: Job, tg: TaskGroup,
                             cluster: ClusterTensors, *,
                             algorithm: str = enums.SCHED_ALG_BINPACK
                             ) -> TaskGroupTensors:
    nodes, n_pad = cluster.nodes, cluster.n_pad
    res = ctx.tg_resources(tg)
    if res.devices or res.cores:
        raise NotImplementedError(f"device/core columns: {UNPORTED_A5}")
    if res.reserved_port_asks() or res.dynamic_port_count():
        raise NotImplementedError(f"port asks: {UNPORTED_A5}")
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
    (val_id, val_ok, counts, desired,
     has_targets, weights) = _spread_tensors(ctx, job, tg, cluster)
    dh_job, dh_tg = distinct_hosts_flags(job, tg)
    dp_val_id, dp_val_ok, dp_counts, dp_limit = _distinct_property_tensors(
        ctx, job, tg, cluster)
    return TaskGroupTensors(
        ask=ctx.tg_vec(tg),
        feasible=base,
        affinity_boost=_affinity_vector(ctx, job, tg, cluster),
        placed_tg=placed_tg,
        placed_job=placed_job,
        spread_val_id=val_id,
        spread_val_ok=val_ok,
        spread_counts=counts,
        spread_desired=desired,
        spread_has_targets=has_targets,
        spread_weight=weights,
        tg_count=float(max(tg.count, 1)),
        dh_job=dh_job,
        dh_tg=dh_tg,
        spread_alg=(algorithm == enums.SCHED_ALG_SPREAD),
        extra_ask=np.zeros(0),
        dev_affinity=np.zeros(n_pad),
        dp_val_id=dp_val_id,
        dp_val_ok=dp_val_ok,
        dp_counts=dp_counts,
        dp_limit=dp_limit,
        feas_base=base,
    )
