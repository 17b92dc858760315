"""Node (reference ``nomad_tpu/structs/node.py``)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from . import enums
from .resources import R_PORTS, NodeReservedResources, NodeResources


@dataclass(slots=True)
class DrainStrategy:
    """Node drain spec (reference ``structs/node.py:15``)."""

    deadline_s: float = 0.0
    ignore_system_jobs: bool = False


@dataclass(slots=True)
class Node:
    """A machine in the cluster. ``attributes`` and ``meta`` are flat
    string maps addressed from constraints as "${attr.x}" / "${meta.x}"."""

    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    node_pool: str = enums.NODE_POOL_DEFAULT
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    resources: NodeResources = field(default_factory=NodeResources)
    reserved: NodeReservedResources = field(default_factory=NodeReservedResources)
    drivers: Dict[str, bool] = field(default_factory=dict)
    status: str = enums.NODE_STATUS_READY
    scheduling_eligibility: str = enums.NODE_SCHED_ELIGIBLE
    drain_strategy: Optional[DrainStrategy] = None
    # volumes this node exposes, by name (ClientHostVolumeConfig);
    # class-relevant: the host-volume mask is memoized per class
    host_volumes: Dict[str, object] = field(default_factory=dict)
    # when the status last changed: a disconnected node's allocs stay
    # unknown for their window from here
    status_updated_at: float = 0.0
    create_index: int = 0
    modify_index: int = 0
    computed_class: str = ""
    _avail_vec: Optional[np.ndarray] = field(default=None, repr=False,
                                             compare=False)

    @property
    def drain(self) -> bool:
        return self.drain_strategy is not None

    def ready(self) -> bool:
        return (self.status == enums.NODE_STATUS_READY and not self.drain
                and self.scheduling_eligibility == enums.NODE_SCHED_ELIGIBLE)

    def in_pool(self, datacenters, node_pool: str) -> bool:
        dcs = set(datacenters)
        if "*" not in dcs and self.datacenter not in dcs:
            return False
        return node_pool == enums.NODE_POOL_ALL or self.node_pool == node_pool

    def available_vec(self) -> np.ndarray:
        """Total minus agent-reserved resources; the ports dimension drops
        reserved ports that fall inside the dynamic range. Memoized per
        row (rows are immutable by convention)."""
        if self._avail_vec is not None:
            return self._avail_vec
        v = self.resources.vec() - self.reserved.vec()
        lo, hi = self.resources.min_dynamic_port, self.resources.max_dynamic_port
        v[R_PORTS] -= sum(1 for p in self.reserved.reserved_ports
                          if lo <= p <= hi)
        self._avail_vec = v
        return v

    def compute_class(self) -> str:
        """Hash of the scheduling-relevant fields (node equivalence
        class)."""
        h = hashlib.blake2b(digest_size=16)

        def put(*fields: str) -> None:
            for f in fields:
                h.update(f.encode())
                h.update(b"\x00")

        put(self.datacenter, self.node_class, self.node_pool)
        for k in sorted(self.attributes):
            if not k.startswith("unique."):
                put(k, str(self.attributes[k]))
        for k in sorted(self.meta):
            if not k.startswith("unique."):
                put(k, str(self.meta[k]))
        for k in sorted(self.drivers):
            put(k, "1" if self.drivers[k] else "0")
        put(repr(self.resources.vec().tolist()),
            repr(self.reserved.vec().tolist()))
        put(str(self.resources.total_cores),
            str(self.resources.min_dynamic_port),
            str(self.resources.max_dynamic_port))
        # fingerprinted network modes, host volumes, NUMA domains and device
        # groups are class-relevant: the masks memoized per class read them
        for mode in sorted({n.mode for n in self.resources.networks}):
            put("net", mode)
        for name in sorted(self.host_volumes):
            hv = self.host_volumes[name]
            put("vol", name, "ro" if getattr(hv, "read_only", False) else "rw")
        for numa in self.resources.numa:
            put(str(numa.id), repr(numa.cores))
        for d in self.resources.devices:
            put(d.id, str(len(d.instance_ids)))
        self.computed_class = h.hexdigest()
        return self.computed_class
