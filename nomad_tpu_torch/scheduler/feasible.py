"""Feasibility (reference ``nomad_tpu/scheduler/feasible.py``):
node-attribute constraints (version and semver included), drivers and
device counts, evaluated once per unique attribute value into a boolean
mask over the node list; the reserved-ports mask; and the distinct_hosts
/ distinct_property masks of the host oracle. Network modes other than
"host" and volumes are ROADMAP queue A5b and raise here."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..structs import Constraint, Job, Node, TaskGroup, enums
from ..structs.network import NetworkIndex

# what the port does not model yet, named in every such raise
UNPORTED_A5B = "ROADMAP queue A5b (network modes, host and CSI volumes)"


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


class _Version:
    """A go-version-style version: dotted numeric segments with an
    optional -prerelease suffix, which sorts before the release
    (reference ``feasible.py:93-146``)."""

    __slots__ = ("segments", "prerelease", "written")

    def __init__(self, s: str):
        s = s.strip().lstrip("v")
        if "+" in s:  # build metadata is ignored
            s = s.split("+", 1)[0]
        if "-" in s:
            base, self.prerelease = s.split("-", 1)
        else:
            base, self.prerelease = s, ""
        segs = []
        for part in base.split("."):
            if not _num_int.match(part):
                raise ValueError(f"bad version segment {part!r} in {s!r}")
            segs.append(int(part))
        self.written = len(segs)  # the segments written ("~>" reads it)
        while len(segs) < 3:
            segs.append(0)
        self.segments = tuple(segs)

    def cmp(self, o: "_Version") -> int:
        if self.segments != o.segments:
            return -1 if self.segments < o.segments else 1
        # equal segments: release > prerelease; prereleases lexically
        if self.prerelease == o.prerelease:
            return 0
        if self.prerelease == "":
            return 1
        if o.prerelease == "":
            return -1
        return -1 if self.prerelease < o.prerelease else 1


_ver_con = re.compile(r"^\s*(~>|>=|<=|!=|=|>|<)?\s*(.+?)\s*$")


def check_version_constraint(version_str: str, constraint_str: str,
                             cache: Optional[dict] = None) -> bool:
    """A comma-separated AND of "<op> <version>" clauses, the pessimistic
    "~>" included (reference ``feasible.py:149-196``). Parsed clauses,
    and parse failures, are cached per constraint string."""
    try:
        ver = _Version(version_str)
    except ValueError:
        return False
    clauses = cache.get(constraint_str) if cache is not None else None
    if clauses is None:
        clauses = []
        try:
            for raw in constraint_str.split(","):
                m = _ver_con.match(raw)
                if not m or not m.group(2):
                    return False
                clauses.append((m.group(1) or "=", _Version(m.group(2))))
        except ValueError:
            clauses = False
        if cache is not None:
            cache[constraint_str] = clauses
    if clauses is False:
        return False
    for op, target in clauses:
        c = ver.cmp(target)
        if op == "=" and c != 0:
            return False
        if op == "!=" and c == 0:
            return False
        if op == ">" and c != 1:
            return False
        if op == ">=" and c == -1:
            return False
        if op == "<" and c != -1:
            return False
        if op == "<=" and c == 1:
            return False
        if op == "~>":
            # >= target and < target with the second-to-last written
            # segment bumped: "~> 1.2" -> < 2.0.0, "~> 1.2.3" -> < 1.3.0
            if c == -1:
                return False
            upper = list(target.segments)
            bump = max(0, target.written - 2)
            upper[bump] += 1
            for i in range(bump + 1, len(upper)):
                upper[i] = 0
            if ver.cmp(_Version(".".join(map(str, upper)))) != -1:
                return False
    return True


def _split_set(s: str) -> set:
    return {part.strip() for part in s.split(",")}


def check_constraint(operand: str, lval: str, rval: str, lfound: bool,
                     rfound: bool, regex_cache: Optional[dict] = None,
                     version_cache: Optional[dict] = None) -> bool:
    """The reference's checkConstraint semantics."""
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
        return lfound and rfound and check_version_constraint(
            lval, rval, version_cache)
    return False


def node_meets_constraint(c: Constraint, node: Node,
                          regex_cache: Optional[dict] = None,
                          version_cache: Optional[dict] = None) -> bool:
    lval, lfound = resolve_target(c.ltarget, node)
    rval, rfound = resolve_target(c.rtarget, node)
    return check_constraint(c.operand, lval, rval, lfound, rfound,
                            regex_cache, version_cache)


def constraint_mask(c: Constraint, nodes: Sequence[Node],
                    regex_cache: Optional[dict] = None,
                    version_cache: Optional[dict] = None) -> np.ndarray:
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
                                               rfound, regex_cache,
                                               version_cache)
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


def device_mask(tg: TaskGroup, nodes: Sequence[Node]) -> np.ndarray:
    """Enough instances of each requested device on the node, usage
    aside (reference ``feasible.py:311``; usage is fitted in ranking)."""
    asks = [d for t in tg.tasks for d in t.resources.devices]
    if not asks:
        return np.ones(len(nodes), dtype=bool)
    out = np.empty(len(nodes), dtype=bool)
    for i, node in enumerate(nodes):
        out[i] = all(
            sum(len(g.instance_ids) for g in node.resources.devices
                if g.matches(ask.name)) >= ask.count
            for ask in asks)
    return out


def _network_modes(tg: TaskGroup) -> set:
    modes = {net.mode or "host" for net in tg.networks}
    for t in tg.tasks:
        modes |= {net.mode or "host" for net in t.resources.networks}
    return modes


def network_mask(tg: TaskGroup, nodes: Sequence[Node]) -> np.ndarray:
    """The requested network modes on the node (reference
    ``feasible.py:336``): "host" (and "", the default) is on every node;
    any other mode raises."""
    other = _network_modes(tg) - {"host"}
    if other:
        raise NotImplementedError(
            f"network modes {sorted(other)}: {UNPORTED_A5B}")
    return np.ones(len(nodes), dtype=bool)


def reserved_ports_mask(tg: TaskGroup, nodes: Sequence[Node],
                        proposed_allocs_fn) -> np.ndarray:
    """Every reserved port the group asks for is free on the node given
    its proposed allocs (reference ``feasible.py:423``)."""
    asks = tg.combined_resources().reserved_port_asks()
    if not asks:
        return np.ones(len(nodes), dtype=bool)
    want = [p for _, p in asks]
    out = np.empty(len(nodes), dtype=bool)
    for i, node in enumerate(nodes):
        idx = NetworkIndex(node)
        idx.add_allocs(proposed_allocs_fn(node.id))
        out[i] = not any(p in idx.used for p in want)
    return out


def job_constraints(job: Job, tg: TaskGroup) -> List[Constraint]:
    out = list(job.constraints) + list(tg.constraints)
    for t in tg.tasks:
        out.extend(t.constraints)
    return out


def feasible_mask_static(job: Job, tg: TaskGroup, nodes: Sequence[Node],
                         regex_cache: Optional[dict] = None,
                         version_cache: Optional[dict] = None
                         ) -> np.ndarray:
    """The node-attribute-only feasibility mask: drivers, device counts,
    network modes, constraints. Cacheable per (task-group signature,
    node-set version)."""
    if tg.volumes:
        raise NotImplementedError(f"volumes: {UNPORTED_A5B}")
    mask = driver_mask(tg, nodes)
    if not mask.any():
        return mask
    mask &= device_mask(tg, nodes)
    mask &= network_mask(tg, nodes)
    for c in job_constraints(job, tg):
        if not mask.any():
            break
        mask &= constraint_mask(c, nodes, regex_cache, version_cache)
    return mask


def tg_mask_signature(job: Job, tg: TaskGroup) -> tuple:
    """Cache key capturing every input of feasible_mask_static other
    than the node set itself."""
    drivers = tuple(sorted({t.driver for t in tg.tasks}))
    devs = tuple(sorted((d.name, d.count)
                        for t in tg.tasks for d in t.resources.devices))
    cons = tuple((c.ltarget, c.operand, c.rtarget)
                 for c in job_constraints(job, tg))
    return (drivers, devs, tuple(sorted(_network_modes(tg))), cons)


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
