"""Carry cluster state across from plain records: the port's counterpart
of loading weights. A node or job table exported from another
implementation as plain dicts (and numpy values) becomes the port's
``Node`` and ``Job`` objects with the same ids, so both stores hold the
same cluster in the same registration order. Only plain data is read:
networks as ``{mode, device, ip, mbits, reserved_ports: [(label, port)],
dynamic_ports: [label]}``, device groups as ``{vendor, type, name,
instance_ids, attributes}``, NUMA domains as ``{id, cores}`` and device
asks as ``{name, count, constraints, affinities}`` (rows as for jobs),
a node's host volumes as ``{name: {name, path, read_only}}``, a group's
volumes as ``{name: {name, type, source, read_only, access_mode,
per_alloc}}`` and a task's mounts as ``[{volume, destination,
read_only}]``. A drain strategy, which the port does not carry across,
must be empty, or the conversion raises rather than drop it.

A whole store carries across as a dump (``state/persist.py``, the
reference's layout): ``store_from_dump`` restores a dump the reference's
``dump_store`` wrote (plain dicts, lists and numpy arrays, format 2 or
1) into a fresh port store, and the port's ``dump_store`` writes one the
reference's ``restore_store`` reads. For a scheduler this is the
counterpart of carrying weights across."""

from __future__ import annotations

from typing import Iterable, List, Mapping

from .state import StateStore
from .state.persist import restore_store
from .structs import (Affinity, Constraint, Job, Node, NodeResources,
                      Resources, Spread, SpreadTarget, Task, TaskGroup)
from .structs.job import EphemeralDisk, UpdateStrategy
from .structs.resources import (NetworkResource, NodeDeviceResource,
                                NodeReservedResources, NumaNode,
                                RequestedDevice)
from .structs.volumes import (ClientHostVolumeConfig, VolumeMount,
                              VolumeRequest)


def _require_empty(record: Mapping, keys, what: str) -> None:
    for key in keys:
        if record.get(key):
            raise NotImplementedError(
                f"{what} field {key!r} is not modelled by the port")


def _networks(rows) -> List[NetworkResource]:
    return [NetworkResource(
        mode=str(r.get("mode") or "host"), device=str(r.get("device", "")),
        ip=str(r.get("ip", "")), mbits=int(r.get("mbits", 0)),
        reserved_ports=[(str(label), int(port)) for label, port in
                        r.get("reserved_ports") or ()],
        dynamic_ports=[str(label) for label in r.get("dynamic_ports") or ()])
        for r in rows or ()]


def _device_groups(rows) -> List[NodeDeviceResource]:
    return [NodeDeviceResource(
        vendor=str(r["vendor"]), type=str(r["type"]), name=str(r["name"]),
        instance_ids=[str(i) for i in r.get("instance_ids") or ()],
        attributes=dict(r.get("attributes") or {}))
        for r in rows or ()]


def _numa(rows) -> List[NumaNode]:
    return [NumaNode(id=int(r["id"]), cores=[int(c) for c in r["cores"]])
            for r in rows or ()]


def _host_volumes(rows) -> dict:
    return {str(k): ClientHostVolumeConfig(
        name=str(r.get("name", k)), path=str(r.get("path", "")),
        read_only=bool(r.get("read_only", False)))
        for k, r in (rows or {}).items()}


def _volume_requests(rows) -> dict:
    return {str(k): VolumeRequest(
        name=str(r.get("name", k)), type=str(r.get("type", "host")),
        source=str(r.get("source", "")),
        read_only=bool(r.get("read_only", False)),
        access_mode=str(r.get("access_mode", "single-node-writer")),
        per_alloc=bool(r.get("per_alloc", False)))
        for k, r in (rows or {}).items()}


def _volume_mounts(rows) -> list:
    return [VolumeMount(volume=str(r["volume"]),
                        destination=str(r.get("destination", "")),
                        read_only=bool(r.get("read_only", False)))
            for r in rows or ()]


def _device_asks(rows) -> List[RequestedDevice]:
    return [RequestedDevice(name=str(r["name"]), count=int(r.get("count", 1)),
                            constraints=_constraints(r.get("constraints")),
                            affinities=_affinities(r.get("affinities")))
            for r in rows or ()]


def node_from_record(rec: Mapping) -> Node:
    res = rec["resources"]
    _require_empty(rec, ("drain_strategy",), "node")
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
            networks=_networks(res.get("networks")),
            devices=_device_groups(res.get("devices")),
            numa=_numa(res.get("numa")),
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
        host_volumes=_host_volumes(rec.get("host_volumes")),
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


def _spreads(rows) -> List[Spread]:
    return [Spread(attribute=str(a), weight=int(w),
                   targets=[SpreadTarget(value=str(v), percent=int(p))
                            for v, p in targets or ()])
            for a, w, targets in rows or ()]


def job_from_record(rec: Mapping) -> Job:
    """A job record -> the port's Job. Constraints are (ltarget, rtarget,
    operand) rows (distinct_hosts and distinct_property among them),
    affinities (ltarget, rtarget, operand, weight) and spreads
    (attribute, weight, ((value, percent), ...)); task resources may carry
    ``cores``, ``numa_affinity``, ``devices`` and ``networks``, tasks
    ``volume_mounts``, groups ``networks`` and ``volumes``."""
    groups = []
    for g in rec["task_groups"]:
        tasks = []
        for t in g["tasks"]:
            r = t["resources"]
            tasks.append(Task(
                name=str(t["name"]), driver=str(t["driver"]),
                config=dict(t.get("config") or {}),
                resources=Resources(cpu=float(r["cpu"]),
                                    memory_mb=float(r["memory_mb"]),
                                    disk_mb=float(r.get("disk_mb", 0.0)),
                                    cores=int(r.get("cores", 0)),
                                    networks=_networks(r.get("networks")),
                                    devices=_device_asks(r.get("devices")),
                                    numa_affinity=str(
                                        r.get("numa_affinity", "none"))),
                constraints=_constraints(t.get("constraints")),
                affinities=_affinities(t.get("affinities")),
                volume_mounts=_volume_mounts(t.get("volume_mounts"))))
        update = g.get("update")
        groups.append(TaskGroup(
            name=str(g["name"]), count=int(g["count"]), tasks=tasks,
            constraints=_constraints(g.get("constraints")),
            affinities=_affinities(g.get("affinities")),
            spreads=_spreads(g.get("spreads")),
            update=(None if update is None else UpdateStrategy(
                max_parallel=int(update.get("max_parallel", 1)),
                progress_deadline_s=float(
                    update.get("progress_deadline_s", 600.0)),
                auto_revert=bool(update.get("auto_revert", False)),
                auto_promote=bool(update.get("auto_promote", False)),
                canary=int(update.get("canary", 0)))),
            ephemeral_disk=EphemeralDisk(
                size_mb=int(g.get("ephemeral_disk_mb", 300))),
            networks=_networks(g.get("networks")),
            volumes=_volume_requests(g.get("volumes"))))
    return Job(
        id=str(rec["id"]), name=str(rec.get("name", rec["id"])),
        namespace=str(rec.get("namespace", "default")),
        type=str(rec["type"]), priority=int(rec.get("priority", 50)),
        datacenters=[str(d) for d in rec.get("datacenters", ["dc1"])],
        node_pool=str(rec.get("node_pool", "default")),
        constraints=_constraints(rec.get("constraints")),
        affinities=_affinities(rec.get("affinities")),
        spreads=_spreads(rec.get("spreads")),
        task_groups=groups)


def store_from_dump(dump: Mapping) -> StateStore:
    """A fresh store holding a dump's state, at the dump's index."""
    store = StateStore()
    restore_store(store, dict(dump))
    return store
