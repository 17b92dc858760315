"""Scheduler utilities (reference ``nomad_tpu/scheduler/util.py``):
tainted nodes, the alloc name index, the lost marking and the spec diff
that decides in-place against destructive updates."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Set

import numpy as np

from ..structs import Node, enums
from ..structs.alloc import Allocation, alloc_name


def tainted_nodes(snapshot, allocs: Iterable[Allocation]) -> Dict[str, Node]:
    """Node id -> node for the nodes of ``allocs`` that are draining,
    down or disconnected; a node that no longer exists counts as down
    (reference ``util.py:11-31``)."""
    out: Dict[str, Node] = {}
    seen = set()
    for alloc in allocs:
        if alloc.node_id in seen:
            continue
        seen.add(alloc.node_id)
        node = snapshot.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = Node(id=alloc.node_id,
                                      status=enums.NODE_STATUS_DOWN)
            continue
        if node.drain or node.status in (enums.NODE_STATUS_DOWN,
                                         enums.NODE_STATUS_DISCONNECTED):
            out[node.id] = node
    return out


class AllocNameIndex:
    """In-use alloc name indexes of a task group, so new placements take
    the lowest free "<job>.<group>[i]" names (reference
    ``util.py:34-86``)."""

    def __init__(self, job_id: str, group: str, count: int,
                 in_use: Iterable[Allocation] = ()):
        self.job_id = job_id
        self.group = group
        self.count = count
        self.used: Set[int] = set()
        for a in in_use:
            idx = a.index()
            if idx >= 0:
                self.used.add(idx)

    def next_batch(self, n: int) -> List[str]:
        out = []
        i = 0
        while len(out) < n:
            if i not in self.used:
                self.used.add(i)
                out.append(alloc_name(self.job_id, self.group, i))
            i += 1
        return out

    def next_batch_indices(self, n: int) -> np.ndarray:
        """``n`` name indexes as an array (the columnar path names its
        block positions lazily)."""
        if not self.used:
            self.used.update(range(n))
            return np.arange(n, dtype=np.int64)
        out = np.empty(n, dtype=np.int64)
        filled, i = 0, 0
        while filled < n:
            if i not in self.used:
                self.used.add(i)
                out[filled] = i
                filled += 1
            i += 1
        return out


def update_non_terminal_allocs_to_lost(plan, tainted: Dict[str, Node],
                                       allocs: Iterable[Allocation]) -> None:
    """Stop the live allocs of down nodes as lost in the plan (reference
    ``util.py:89-102``)."""
    for alloc in allocs:
        node = tainted.get(alloc.node_id)
        if node is None or node.status != enums.NODE_STATUS_DOWN:
            continue
        if alloc.server_terminal() or alloc.client_terminal():
            continue
        plan.append_stopped_alloc(alloc, "alloc lost since node is down",
                                  client_status=enums.ALLOC_CLIENT_LOST)


def _network_sig(networks) -> list:
    return sorted(
        (n.mode or "host", tuple(sorted(n.reserved_ports)),
         tuple(sorted(n.dynamic_ports)))
        for n in networks)


def _rows(items) -> list:
    """Constraints, affinities or spreads as comparable plain rows."""
    return [dataclasses.astuple(x) for x in items]


def _device_sig(devices) -> list:
    return sorted((d.name, d.count, repr(_rows(d.constraints)),
                   repr(_rows(d.affinities))) for d in devices)


def tasks_updated(old_tg, new_tg) -> bool:
    """Whether a task-group change destroys and replaces its allocs
    (reference ``util.py:124-177``). Count, meta, the update strategy and
    the reschedule policy update in place; what runs, what it holds and
    where it may be placed are destructive. Fields the port does not
    model compare equal."""
    if old_tg is None or new_tg is None:
        return True
    if _network_sig(old_tg.networks) != _network_sig(new_tg.networks):
        return True
    if _rows_of(old_tg.volumes) != _rows_of(new_tg.volumes):
        return True
    if (old_tg.ephemeral_disk.size_mb != new_tg.ephemeral_disk.size_mb
            or old_tg.ephemeral_disk.migrate
            != new_tg.ephemeral_disk.migrate):
        return True
    if (_rows(old_tg.constraints) != _rows(new_tg.constraints)
            or _rows(old_tg.affinities) != _rows(new_tg.affinities)
            or _rows(old_tg.spreads) != _rows(new_tg.spreads)):
        return True
    olds = {t.name: t for t in old_tg.tasks}
    news = {t.name: t for t in new_tg.tasks}
    if set(olds) != set(news):
        return True
    for name, o in olds.items():
        n = news[name]
        if (o.driver != n.driver or o.user != n.user
                or o.config != n.config or o.env != n.env):
            return True
        if (_rows(o.constraints) != _rows(n.constraints)
                or _rows(o.affinities) != _rows(n.affinities)):
            return True
        orr, nrr = o.resources, n.resources
        if (orr.cpu != nrr.cpu or orr.memory_mb != nrr.memory_mb
                or orr.disk_mb != nrr.disk_mb or orr.cores != nrr.cores
                or orr.numa_affinity != nrr.numa_affinity):
            return True
        if _network_sig(orr.networks) != _network_sig(nrr.networks):
            return True
        if _device_sig(orr.devices) != _device_sig(nrr.devices):
            return True
        if _rows(o.volume_mounts) != _rows(n.volume_mounts):
            return True
    return False


def _rows_of(mapping) -> list:
    return sorted((k, repr(v)) for k, v in (mapping or {}).items())
