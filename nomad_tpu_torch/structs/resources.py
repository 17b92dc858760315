"""Resource model, trimmed to the dense comparable vector the bulk path
reads (reference ``nomad_tpu/structs/resources.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

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
    reserved_ports: List[Tuple[str, int]] = field(default_factory=list)
    dynamic_ports: List[str] = field(default_factory=list)


@dataclass(slots=True)
class RequestedDevice:
    """A device ask (reference RequestedDevice)."""

    name: str = ""
    count: int = 1


@dataclass(slots=True)
class Resources:
    """Task/task-group resource ask (reference Resources)."""

    cpu: float = 100.0
    memory_mb: float = 300.0
    disk_mb: float = 0.0
    cores: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[RequestedDevice] = field(default_factory=list)

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
class NodeResources:
    """Total fingerprinted capacity of a node (reference NodeResources)."""

    cpu: float = 4000.0
    memory_mb: float = 8192.0
    disk_mb: float = 100 * 1024.0
    total_cores: int = 4
    min_dynamic_port: int = 20000
    max_dynamic_port: int = 32000

    def dynamic_port_capacity(self) -> int:
        return max(0, self.max_dynamic_port - self.min_dynamic_port + 1)

    def vec(self) -> np.ndarray:
        return comparable(self.cpu, self.memory_mb, self.disk_mb,
                          self.dynamic_port_capacity())
