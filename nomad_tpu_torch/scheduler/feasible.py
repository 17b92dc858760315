"""Feasibility, trimmed to the bulk and per-eval paths (reference
``nomad_tpu/scheduler/feasible.py``): node-attribute constraints and
drivers, evaluated once per unique attribute value into a boolean mask
over the node list, and the distinct_hosts / distinct_property masks of
the host oracle. Version and semver operators, device asks, network
modes and host volumes are the rest of ROADMAP queue A5 and raise
here."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..structs import Constraint, Job, Node, TaskGroup, enums

# what the per-eval path does not model yet, named in every such raise
UNPORTED_A5 = ("ROADMAP queue A5 (ports, devices/NUMA columns, "
               "version/semver constraints)")


def is_class_escaped(target: str) -> bool:
    """Whether a constraint target defeats computed-class memoization
    (anything node-unique)."""
    return ("${node.unique." in target or "${attr.unique." in target
            or "${meta.unique." in target)


def resolve_target(target: str, node: Node) -> Tuple[str, bool]:
    """Resolve an interpolation target like "${attr.kernel.name}" against
    a node -> (value, found). Non-${...} strings are literals."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target == "${node.pool}":
        return node.node_pool, True
    if target.startswith("${attr."):
        val = node.attributes.get(target[len("${attr."):-1])
        return ("" if val is None else str(val)), val is not None
    if target.startswith("${meta."):
        val = node.meta.get(target[len("${meta."):-1])
        return ("" if val is None else str(val)), val is not None
    return "", False


_num_int = re.compile(r"^[+-]?\d+$")


def _check_order(operand: str, l: str, r: str) -> bool:
    """Integer comparison if both parse, else float, else lexical."""
    if _num_int.match(l) and _num_int.match(r):
        li, ri = int(l), int(r)
    else:
        try:
            li, ri = float(l), float(r)
        except ValueError:
            li, ri = l, r
    return {"<": li < ri, "<=": li <= ri, ">": li > ri,
            ">=": li >= ri}[operand]


def _split_set(s: str) -> set:
    return {part.strip() for part in s.split(",")}


def check_constraint(operand: str, lval: str, rval: str, lfound: bool,
                     rfound: bool, regex_cache: Optional[dict] = None) -> bool:
    """The reference's checkConstraint semantics for the operators the
    bulk path meets."""
    if operand in (enums.CONSTRAINT_DISTINCT_HOSTS,
                   enums.CONSTRAINT_DISTINCT_PROPERTY):
        return True  # handled by the dedicated masks below
    if operand in ("=", "==", "is"):
        return lfound and rfound and lval == rval
    if operand in ("!=", "not"):
        if not lfound and not rfound:
            return False
        if lfound != rfound:
            return True
        return lval != rval
    if operand in ("<", "<=", ">", ">="):
        return lfound and rfound and _check_order(operand, lval, rval)
    if operand == enums.CONSTRAINT_IS_SET:
        return lfound
    if operand == enums.CONSTRAINT_IS_NOT_SET:
        return not lfound
    if operand == enums.CONSTRAINT_REGEX:
        if not (lfound and rfound):
            return False
        rx = regex_cache.get(rval) if regex_cache is not None else None
        if rx is None:
            try:
                rx = re.compile(rval)
            except re.error:
                rx = False
            if regex_cache is not None:
                regex_cache[rval] = rx
        return rx is not False and rx.search(lval) is not None
    if operand in (enums.CONSTRAINT_SET_CONTAINS,
                   enums.CONSTRAINT_SET_CONTAINS_ALL):
        return (lfound and rfound
                and all(w in _split_set(lval) for w in _split_set(rval)))
    if operand == enums.CONSTRAINT_SET_CONTAINS_ANY:
        return (lfound and rfound
                and any(w in _split_set(lval) for w in _split_set(rval)))
    if operand in (enums.CONSTRAINT_VERSION, enums.CONSTRAINT_SEMVER):
        raise NotImplementedError(
            f"constraint operand {operand!r}: {UNPORTED_A5}")
    return False


def node_meets_constraint(c: Constraint, node: Node,
                          regex_cache: Optional[dict] = None) -> bool:
    lval, lfound = resolve_target(c.ltarget, node)
    rval, rfound = resolve_target(c.rtarget, node)
    return check_constraint(c.operand, lval, rval, lfound, rfound,
                            regex_cache)


def constraint_mask(c: Constraint, nodes: Sequence[Node],
                    regex_cache: Optional[dict] = None) -> np.ndarray:
    """One constraint over a node list, evaluated once per unique
    (lval, rval) pair."""
    out = np.empty(len(nodes), dtype=bool)
    memo: Dict[tuple, bool] = {}
    for i, node in enumerate(nodes):
        lval, lfound = resolve_target(c.ltarget, node)
        rval, rfound = resolve_target(c.rtarget, node)
        key = (lval, lfound, rval, rfound)
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = check_constraint(c.operand, lval, rval, lfound,
                                               rfound, regex_cache)
        out[i] = hit
    return out


def driver_mask(tg: TaskGroup, nodes: Sequence[Node]) -> np.ndarray:
    """Every task's driver must be healthy on the node (or fingerprinted
    as a truthy ``driver.<name>`` attribute)."""
    drivers = {t.driver for t in tg.tasks}
    out = np.empty(len(nodes), dtype=bool)
    for i, node in enumerate(nodes):
        out[i] = all(
            node.drivers.get(d)
            or str(node.attributes.get(f"driver.{d}", "")).lower()
            in ("1", "true")
            for d in drivers)
    return out


def job_constraints(job: Job, tg: TaskGroup) -> List[Constraint]:
    out = list(job.constraints) + list(tg.constraints)
    for t in tg.tasks:
        out.extend(t.constraints)
    return out


def _network_modes(tg: TaskGroup) -> set:
    modes = {net.mode or "host" for net in tg.networks}
    for t in tg.tasks:
        modes |= {net.mode or "host" for net in t.resources.networks}
    return modes - {"host"}


def feasible_mask_static(job: Job, tg: TaskGroup, nodes: Sequence[Node],
                         regex_cache: Optional[dict] = None) -> np.ndarray:
    """The node-attribute-only feasibility mask: drivers + constraints.
    Cacheable per (task-group signature, node-set version)."""
    if any(t.resources.devices for t in tg.tasks):
        raise NotImplementedError(f"device asks: {UNPORTED_A5}")
    if _network_modes(tg):
        raise NotImplementedError(f"network modes: {UNPORTED_A5}")
    if tg.volumes:
        raise NotImplementedError(f"volumes: {UNPORTED_A5}")
    mask = driver_mask(tg, nodes)
    for c in job_constraints(job, tg):
        if not mask.any():
            break
        mask &= constraint_mask(c, nodes, regex_cache)
    return mask


def tg_mask_signature(job: Job, tg: TaskGroup) -> tuple:
    """Cache key capturing every input of feasible_mask_static other
    than the node set itself."""
    drivers = tuple(sorted({t.driver for t in tg.tasks}))
    cons = tuple((c.ltarget, c.operand, c.rtarget)
                 for c in job_constraints(job, tg))
    return (drivers, cons)


def _truthy(rtarget: str) -> bool:
    return rtarget in ("", "true", "True", "1")


def distinct_hosts_flags(job: Job, tg: TaskGroup) -> Tuple[bool, bool]:
    """(job_level, tg_level) distinct_hosts enablement."""
    job_level = any(c.operand == enums.CONSTRAINT_DISTINCT_HOSTS
                    and _truthy(c.rtarget) for c in job.constraints)
    tg_level = any(c.operand == enums.CONSTRAINT_DISTINCT_HOSTS
                   and _truthy(c.rtarget) for c in tg.constraints)
    return job_level, tg_level


def distinct_property_constraints(job: Job, tg: TaskGroup) -> List[Constraint]:
    return [c for c in list(job.constraints) + list(tg.constraints)
            if c.operand == enums.CONSTRAINT_DISTINCT_PROPERTY]


def distinct_hosts_mask(job: Job, tg: TaskGroup, nodes: Sequence[Node],
                        proposed_by_node) -> np.ndarray:
    """Mask out nodes already carrying an alloc of this job (job-level)
    or of this task group (group-level)."""
    job_level, tg_level = distinct_hosts_flags(job, tg)
    out = np.ones(len(nodes), dtype=bool)
    if not job_level and not tg_level:
        return out
    for i, node in enumerate(nodes):
        for alloc in proposed_by_node(node.id):
            if alloc.job_id != job.id or alloc.namespace != job.namespace:
                continue
            if job_level or (tg_level and alloc.task_group == tg.name):
                out[i] = False
                break
    return out


def distinct_property_limit(c: Constraint) -> int:
    """The allocs allowed per property value: rtarget, default 1."""
    try:
        return int(c.rtarget) if c.rtarget else 1
    except ValueError:
        return 1


def distinct_property_mask(job: Job, tg: TaskGroup, nodes: Sequence[Node],
                           all_job_allocs, node_by_id) -> np.ndarray:
    """Limit allocs per distinct value of a node property: a node is out
    when it lacks the property or its value is at the limit."""
    constraints = distinct_property_constraints(job, tg)
    out = np.ones(len(nodes), dtype=bool)
    if not constraints:
        return out
    live = [a for a in all_job_allocs if not a.terminal_status()]
    for c in constraints:
        limit = distinct_property_limit(c)
        counts: Dict[str, int] = {}
        for alloc in live:
            anode = node_by_id(alloc.node_id)
            if anode is None:
                continue
            val, found = resolve_target(c.ltarget, anode)
            if found:
                counts[val] = counts.get(val, 0) + 1
        for i, node in enumerate(nodes):
            val, found = resolve_target(c.ltarget, node)
            if not found or counts.get(val, 0) >= limit:
                out[i] = False
    return out
