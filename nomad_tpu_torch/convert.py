"""Carry cluster state across from plain records: the port's counterpart
of loading weights. A node or job table exported from another
implementation as plain dicts (and numpy values) becomes the port's
``Node`` and ``Job`` objects with the same ids, so both stores hold the
same cluster in the same registration order. Only plain data is read;
fields this slice does not model must be empty, or the conversion
raises rather than drop them."""

from __future__ import annotations

from typing import Iterable, List, Mapping

from .structs import (Affinity, Constraint, Job, Node, NodeResources,
                      Resources, Task, TaskGroup)
from .structs.job import EphemeralDisk, UpdateStrategy
from .structs.resources import NodeReservedResources


def _require_empty(record: Mapping, keys, what: str) -> None:
    for key in keys:
        if record.get(key):
            raise NotImplementedError(
                f"{what} field {key!r} is not modelled by the bulk slice")


def node_from_record(rec: Mapping) -> Node:
    res = rec["resources"]
    _require_empty(res, ("devices", "networks", "numa"), "node resources")
    _require_empty(rec, ("host_volumes", "drain_strategy"), "node")
    reserved = rec.get("reserved") or {}
    node = Node(
        id=str(rec["id"]),
        name=str(rec["name"]),
        datacenter=str(rec.get("datacenter", "dc1")),
        node_class=str(rec.get("node_class", "")),
        node_pool=str(rec.get("node_pool", "default")),
        attributes={str(k): str(v) for k, v in
                    (rec.get("attributes") or {}).items()},
        meta={str(k): str(v) for k, v in (rec.get("meta") or {}).items()},
        resources=NodeResources(
            cpu=float(res["cpu"]), memory_mb=float(res["memory_mb"]),
            disk_mb=float(res["disk_mb"]),
            total_cores=int(res.get("total_cores", 0)),
            min_dynamic_port=int(res.get("min_dynamic_port", 20000)),
            max_dynamic_port=int(res.get("max_dynamic_port", 32000))),
        reserved=NodeReservedResources(
            cpu=float(reserved.get("cpu", 0.0)),
            memory_mb=float(reserved.get("memory_mb", 0.0)),
            disk_mb=float(reserved.get("disk_mb", 0.0)),
            reserved_ports=[int(p) for p in
                            reserved.get("reserved_ports", ())]),
        drivers={str(k): bool(v) for k, v in
                 (rec.get("drivers") or {}).items()},
        status=str(rec.get("status", "ready")),
        scheduling_eligibility=str(rec.get("scheduling_eligibility",
                                           "eligible")),
    )
    node.compute_class()
    return node


def nodes_from_records(records: Iterable[Mapping]) -> List[Node]:
    """Node records, in order, -> the port's Nodes."""
    return [node_from_record(r) for r in records]


def _constraints(rows) -> List[Constraint]:
    return [Constraint(ltarget=l, rtarget=r, operand=op)
            for l, r, op in rows or ()]


def _affinities(rows) -> List[Affinity]:
    return [Affinity(ltarget=l, rtarget=r, operand=op, weight=int(w))
            for l, r, op, w in rows or ()]


def job_from_record(rec: Mapping) -> Job:
    """A job record -> the port's Job. Constraints are (ltarget, rtarget,
    operand) rows, affinities (ltarget, rtarget, operand, weight)."""
    _require_empty(rec, ("spreads",), "job")
    groups = []
    for g in rec["task_groups"]:
        _require_empty(g, ("spreads", "networks", "volumes"), "task group")
        tasks = []
        for t in g["tasks"]:
            r = t["resources"]
            _require_empty(r, ("networks", "devices"), "task resources")
            tasks.append(Task(
                name=str(t["name"]), driver=str(t["driver"]),
                config=dict(t.get("config") or {}),
                resources=Resources(cpu=float(r["cpu"]),
                                    memory_mb=float(r["memory_mb"]),
                                    disk_mb=float(r.get("disk_mb", 0.0)),
                                    cores=int(r.get("cores", 0))),
                constraints=_constraints(t.get("constraints")),
                affinities=_affinities(t.get("affinities"))))
        update = g.get("update")
        groups.append(TaskGroup(
            name=str(g["name"]), count=int(g["count"]), tasks=tasks,
            constraints=_constraints(g.get("constraints")),
            affinities=_affinities(g.get("affinities")),
            update=(None if update is None else UpdateStrategy(
                max_parallel=int(update.get("max_parallel", 1)),
                canary=int(update.get("canary", 0)))),
            ephemeral_disk=EphemeralDisk(
                size_mb=int(g.get("ephemeral_disk_mb", 300)))))
    return Job(
        id=str(rec["id"]), name=str(rec.get("name", rec["id"])),
        namespace=str(rec.get("namespace", "default")),
        type=str(rec["type"]), priority=int(rec.get("priority", 50)),
        datacenters=[str(d) for d in rec.get("datacenters", ["dc1"])],
        node_pool=str(rec.get("node_pool", "default")),
        constraints=_constraints(rec.get("constraints")),
        affinities=_affinities(rec.get("affinities")),
        task_groups=groups)
