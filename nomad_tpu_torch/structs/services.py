"""Service registrations and checks (a copy of
``nomad_tpu/structs/services.py``; reference nomad/structs/services.go
and service_registration.go).

Tasks register named services while their alloc runs and deregister at
stop; HTTP and TCP checks run on the client and their results fold into
the alloc's deployment health."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass(slots=True)
class ServiceCheck:
    """One health check of a service."""

    name: str = ""
    type: str = "tcp"            # "http" | "tcp"
    path: str = "/"              # http only
    method: str = "GET"          # http only
    interval_s: float = 10.0
    timeout_s: float = 3.0
    port_label: str = ""         # defaults to the service's port

    @classmethod
    def from_obj(cls, obj) -> "ServiceCheck":
        if isinstance(obj, cls):
            return obj
        d = dict(obj or {})
        return cls(
            name=d.get("name", ""),
            type=d.get("type", "tcp"),
            path=d.get("path", "/"),
            method=d.get("method", "GET"),
            interval_s=float(d.get("interval_s", d.get("interval", 10.0))),
            timeout_s=float(d.get("timeout_s", d.get("timeout", 3.0))),
            port_label=d.get("port_label", d.get("port", "")),
        )


@dataclass(slots=True)
class ServiceRegistration:
    """A live instance of a service."""

    id: str = ""                 # alloc_id + "/" + task + "/" + name
    service_name: str = ""
    namespace: str = "default"
    node_id: str = ""
    job_id: str = ""
    alloc_id: str = ""
    task_name: str = ""          # "" = group service
    address: str = ""
    port: int = 0
    tags: List[str] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0


def collect_services(tg):
    """Every (task_name, Service) pair of a task group, "" for the
    group's own: the one walk that registration, the check runner and
    the server's health gate share."""
    out = [("", s) for s in (tg.services or [])]
    for task in tg.tasks:
        out.extend((task.name, s) for s in (task.services or []))
    return out
