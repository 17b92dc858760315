"""Resource model (reference ``nomad_tpu/structs/resources.py``): the
dense comparable vector the kernels read, with the networks, device
groups and NUMA domains beside it that exact port, instance and core
assignment reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# Dense resource dimensions. Order is load-bearing: the tensor layer and
# the kernels index by these constants.
R_CPU = 0    # MHz of cpu shares
R_MEM = 1    # MB of memory
R_DISK = 2   # MB of ephemeral disk
R_PORTS = 3  # count of dynamic-range port slots
RESOURCE_DIMS = 4


def comparable(cpu: float = 0, memory_mb: float = 0, disk_mb: float = 0,
               ports: float = 0) -> np.ndarray:
    """Build a dense comparable-resources vector."""
    v = np.zeros(RESOURCE_DIMS, dtype=np.float64)
    v[R_CPU] = cpu
    v[R_MEM] = memory_mb
    v[R_DISK] = disk_mb
    v[R_PORTS] = ports
    return v


@dataclass(slots=True)
class NetworkResource:
    """A requested or fingerprinted network (reference NetworkResource)."""

    mode: str = "host"
    device: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Tuple[str, int]] = field(default_factory=list)
    dynamic_ports: List[str] = field(default_factory=list)


@dataclass(slots=True)
class RequestedDevice:
    """A device ask, e.g. "nvidia/gpu" count 2 (reference RequestedDevice)."""

    name: str = ""          # vendor/type[/name] selector
    count: int = 1
    constraints: list = field(default_factory=list)
    affinities: list = field(default_factory=list)


@dataclass(slots=True)
class NodeDeviceResource:
    """A homogeneous device group on a node (reference NodeDeviceResource)."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    instance_ids: List[str] = field(default_factory=list)
    attributes: Dict[str, object] = field(default_factory=dict)

    @property
    def id(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"

    def matches(self, selector: str) -> bool:
        """Selector match: "type", "vendor/type" or "vendor/type/name"."""
        parts = selector.split("/")
        if len(parts) == 1:
            return parts[0] == self.type
        if len(parts) == 2:
            return parts[0] == self.vendor and parts[1] == self.type
        return (parts[0] == self.vendor and parts[1] == self.type
                and "/".join(parts[2:]) == self.name)


@dataclass(slots=True)
class Resources:
    """Task/task-group resource ask (reference Resources)."""

    cpu: float = 100.0
    memory_mb: float = 300.0
    disk_mb: float = 0.0
    cores: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)
    numa_affinity: str = "none"   # none | prefer | require

    def dynamic_port_count(self) -> int:
        return sum(len(n.dynamic_ports) for n in self.networks)

    def reserved_port_asks(self) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        for n in self.networks:
            out.extend(n.reserved_ports)
        return out

    def vec(self) -> np.ndarray:
        return comparable(self.cpu, self.memory_mb, self.disk_mb,
                          self.dynamic_port_count())


@dataclass(slots=True)
class NodeReservedResources:
    """Resources carved out of a node for the OS/agent."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    disk_mb: float = 0.0
    reserved_ports: List[int] = field(default_factory=list)

    def vec(self) -> np.ndarray:
        return comparable(self.cpu, self.memory_mb, self.disk_mb)


@dataclass(slots=True)
class NumaNode:
    """One NUMA domain: the cores that belong to it."""

    id: int = 0
    cores: List[int] = field(default_factory=list)


@dataclass(slots=True)
class NodeResources:
    """Total fingerprinted capacity of a node (reference NodeResources)."""

    cpu: float = 4000.0
    memory_mb: float = 8192.0
    disk_mb: float = 100 * 1024.0
    total_cores: int = 4
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDeviceResource] = field(default_factory=list)
    numa: List[NumaNode] = field(default_factory=list)
    min_dynamic_port: int = 20000
    max_dynamic_port: int = 32000

    def dynamic_port_capacity(self) -> int:
        return max(0, self.max_dynamic_port - self.min_dynamic_port + 1)

    def vec(self) -> np.ndarray:
        return comparable(self.cpu, self.memory_mb, self.disk_mb,
                          self.dynamic_port_capacity())
