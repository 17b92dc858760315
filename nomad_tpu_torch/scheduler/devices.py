"""Device instance assignment and NUMA-aware core selection (reference
``nomad_tpu/scheduler/devices.py``, itself Nomad's scheduler/device.go
deviceAllocator and numa_ce.go coreSelector).

The kernels fit device and core counts as extra dense resource columns
(``tensor/cluster.py`` appends them per task group); the concrete
instance ids and core ids are assigned here, on the host, per chosen
node, as ports are (``structs/network.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..structs import Node
from ..structs.resources import NodeDeviceResource, RequestedDevice
from .feasible import check_constraint


def resolve_device_target(target: str, group: NodeDeviceResource) -> Tuple[str, bool]:
    """Resolve "${device.*}" interpolation against one device group
    (reference structs/devices.go device constraint targets)."""
    if not target.startswith("${device."):
        return target, True  # literal
    key = target[len("${device."):-1]
    if key == "vendor":
        return group.vendor, True
    if key == "type":
        return group.type, True
    if key in ("model", "name"):
        return group.name, True
    if key.startswith("attr."):
        val = group.attributes.get(key[len("attr."):])
        return ("" if val is None else str(val)), val is not None
    return "", False


def group_meets_constraints(group: NodeDeviceResource, ask: RequestedDevice,
                            regex_cache=None, version_cache=None) -> bool:
    for c in ask.constraints:
        lval, lok = resolve_device_target(c.ltarget, group)
        rval, rok = resolve_device_target(c.rtarget, group)
        if not check_constraint(c.operand, lval, rval, lok, rok,
                                regex_cache, version_cache):
            return False
    return True


def matching_groups(node: Node, ask: RequestedDevice,
                    regex_cache=None, version_cache=None) -> List[NodeDeviceResource]:
    """Device groups satisfying the ask's selector and constraints."""
    return [g for g in node.resources.devices
            if g.matches(ask.name)
            and group_meets_constraints(g, ask, regex_cache, version_cache)]


def group_affinity_score(group: NodeDeviceResource, ask: RequestedDevice,
                         regex_cache=None, version_cache=None) -> float:
    """Normalized affinity score of one group for one ask
    (reference device.go createOffer affinity scoring)."""
    if not ask.affinities:
        return 0.0
    total, weights = 0.0, 0.0
    for aff in ask.affinities:
        weights += abs(aff.weight)
        lval, lok = resolve_device_target(aff.ltarget, group)
        rval, rok = resolve_device_target(aff.rtarget, group)
        if check_constraint(aff.operand, lval, rval, lok, rok,
                            regex_cache, version_cache):
            total += aff.weight
    return total / weights if weights else 0.0


def groups_capacity(groups: Sequence[NodeDeviceResource]) -> int:
    """Single definition of a device-group set's instance capacity — the
    kernel's count columns and the host DeviceIndex must agree on it."""
    return sum(len(g.instance_ids) for g in groups)


def device_capacity(node: Node, ask: RequestedDevice,
                    regex_cache=None, version_cache=None) -> int:
    """Total instances on the node that could serve this ask (usage-blind;
    usage rides the dense used column / DeviceIndex)."""
    return groups_capacity(matching_groups(node, ask, regex_cache, version_cache))


def accumulate_dev_usage(row: Dict[str, int], alloc, sign: int = 1) -> None:
    """Fold one alloc's device instances + reserved cores into a usage
    row ({device_group_id: n, "cores": n}) — the single definition of the
    row schema shared by the store's derived rows, snapshot restore, and
    the tensor layer's touched-node recompute."""
    for gid, instances in (alloc.allocated_devices or {}).items():
        row[gid] = row.get(gid, 0) + sign * len(instances)
    if alloc.allocated_cores:
        row["cores"] = row.get("cores", 0) + sign * len(alloc.allocated_cores)


class DeviceIndex:
    """Per-node instance bookkeeping for one placement pass: which
    concrete instances are taken by proposed allocs plus this group's
    earlier placements (reference device.go deviceAllocator state)."""

    def __init__(self, node: Node, proposed_allocs: Sequence = ()):
        self.node = node
        self.used: Dict[str, set] = {}
        for a in proposed_allocs:
            self.add_alloc(a)

    def add_alloc(self, alloc) -> None:
        for dev_id, instances in (alloc.allocated_devices or {}).items():
            self.used.setdefault(dev_id, set()).update(instances)

    def assign(self, asks: Sequence[RequestedDevice],
               regex_cache=None, version_cache=None) -> Optional[Dict[str, List[str]]]:
        """Pick concrete instances for every ask, preferring the
        highest-affinity group then the emptiest (spread within a node is
        irrelevant; the reference prefers score then fit). Returns
        {device group id: [instance ids]} or None; commits the picks into
        `used` only if the whole set assigns."""
        staged: Dict[str, List[str]] = {}
        staged_used: Dict[str, set] = {}
        for ask in asks:
            candidates = []
            for g in matching_groups(self.node, ask, regex_cache, version_cache):
                taken = self.used.get(g.id, set()) | staged_used.get(g.id, set())
                free = [i for i in g.instance_ids if i not in taken]
                if free:
                    score = group_affinity_score(g, ask, regex_cache, version_cache)
                    candidates.append((score, len(free), g, free))
            remaining = ask.count
            picks: List[Tuple[NodeDeviceResource, List[str]]] = []
            for score, _, g, free in sorted(
                    candidates, key=lambda c: (-c[0], -c[1], c[2].id)):
                take = free[:remaining]
                picks.append((g, take))
                remaining -= len(take)
                if remaining <= 0:
                    break
            if remaining > 0:
                return None
            for g, take in picks:
                staged.setdefault(g.id, []).extend(take)
                staged_used.setdefault(g.id, set()).update(take)
        for gid, instances in staged.items():
            self.used.setdefault(gid, set()).update(instances)
        return staged


def device_affinity_boost(node: Node, asks: Sequence[RequestedDevice],
                          regex_cache=None, version_cache=None) -> float:
    """Node-level device affinity sub-score: the best reachable group
    score per ask, averaged over asks that have affinities (feeds the
    rank normalizer next to node affinity; reference rank.go folds the
    deviceAllocator's offer score into the node score)."""
    total, n = 0.0, 0
    for ask in asks:
        if not ask.affinities:
            continue
        n += 1
        groups = matching_groups(node, ask, regex_cache, version_cache)
        if groups:
            total += max(group_affinity_score(g, ask, regex_cache, version_cache)
                         for g in groups)
    return total / n if n else 0.0


# ---------------------------------------------------------------------------
# NUMA-aware core selection (reference scheduler/numa_ce.go coreSelector)
# ---------------------------------------------------------------------------


def combined_numa_affinity(tg) -> str:
    """Strictest task policy wins when the group's asks are summed."""
    order = {"none": 0, "prefer": 1, "require": 2}
    best = "none"
    for t in tg.tasks:
        pol = t.resources.numa_affinity or "none"
        if order.get(pol, 0) > order[best]:
            best = pol
    return best


def used_cores(proposed_allocs: Sequence) -> set:
    out: set = set()
    for a in proposed_allocs:
        out.update(a.allocated_cores or ())
    return out


def select_cores(node: Node, proposed_allocs: Sequence, k: int,
                 numa_affinity: str = "none",
                 taken: Optional[set] = None) -> Optional[List[int]]:
    """Pick k free core ids. With NUMA topology: "require" means all k
    from a single domain (fail otherwise), "prefer" packs into as few
    domains as possible, "none" takes the lowest free ids. Packing picks
    the fullest-fitting domain first — binpack for cores, keeping big
    contiguous domains free (reference numa_ce.go is a CE stub that
    randomizes; the enterprise selector packs, and packing is strictly
    better for future require-asks). Callers tracking their own used-core
    set pass `taken` directly instead of the alloc list."""
    if k <= 0:
        return []
    if taken is None:
        taken = used_cores(proposed_allocs)
    domains = node.resources.numa
    if not domains:
        free = [c for c in range(int(node.resources.total_cores)) if c not in taken]
        return sorted(free)[:k] if len(free) >= k else None

    free_by_domain = []
    for d in domains:
        free = sorted(c for c in d.cores if c not in taken)
        free_by_domain.append((d.id, free))

    if numa_affinity == "require":
        fitting = [(len(f), did, f) for did, f in free_by_domain if len(f) >= k]
        if not fitting:
            return None
        _, _, free = min(fitting)  # tightest domain that fits
        return free[:k]

    total_free = sum(len(f) for _, f in free_by_domain)
    if total_free < k:
        return None
    if numa_affinity == "prefer":
        fitting = [(len(f), did, f) for did, f in free_by_domain if len(f) >= k]
        if fitting:
            _, _, free = min(fitting)
            return free[:k]
        # no single domain fits: drain domains fullest-first
        out: List[int] = []
        for _, _, free in sorted(((len(f), did, f) for did, f in free_by_domain)):
            out.extend(free[: k - len(out)])
            if len(out) == k:
                return out
        return None
    # "none": lowest ids across the node
    free = sorted(c for _, f in free_by_domain for c in f)
    return free[:k]
