"""Host fingerprinting (a copy of ``nomad_tpu/client/fingerprint.py``;
reference client/fingerprint/).

Discovers node attributes and resources from the OS: kernel, arch and
host identity, CPU count and clock, memory, disk; the drivers report
their own health; the CUDA cards the process sees become device groups.
"""

from __future__ import annotations

import os
import platform
import shutil
import socket
from typing import Dict, Optional

from ..structs.node import Node
from ..structs.resources import NodeResources
from ..utils.ids import generate_uuid

VERSION = "0.1.0"


def _cpu_mhz() -> float:
    """Total compute in MHz across cores (reference fingerprints
    cpu.frequency x cpu.numcores into Resources.CPU)."""
    cores = os.cpu_count() or 1
    mhz = 0.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except (OSError, ValueError):
        pass
    if mhz <= 0:
        mhz = 2000.0  # conservative default when the OS won't say
    return mhz * cores


def _memory_mb() -> float:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return float(line.split()[1]) / 1024.0
    except (OSError, ValueError):
        pass
    return 4096.0


def _disk_mb(path: str = "/") -> float:
    try:
        return shutil.disk_usage(path).free / (1024 * 1024)
    except OSError:
        return 10 * 1024.0


def _accelerators():
    """The CUDA cards this process sees, as schedulable device groups
    (reference ``fingerprint.py:61-100``, which asks JAX): one group
    ``nvidia/gpu/<name>`` a card model, ``<name>`` the device name lower
    cased with spaces as ``-``, instance ids ``gpu-<i>`` and attribute
    ``platform: "gpu"``, so a job asks with ``device "nvidia/gpu" {}``.
    The vendor is a deliberate divergence (ROADMAP §C): the reference
    would name a CUDA device ``gpu/gpu/<name>``, Nomad's nvidia plugin
    names it ``nvidia/gpu/<model>``.

    Consults torch only when it is ALREADY imported, and asks
    ``torch.cuda.is_available()`` first: the agent never pays a torch
    import to fingerprint a box, and never initialises CUDA where there
    is no card."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_available():
            return []
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
    except Exception:
        return []
    from ..structs.resources import NodeDeviceResource

    groups: Dict[str, NodeDeviceResource] = {}
    for i, kind in enumerate(names):
        name = (kind or "gpu").lower().replace(" ", "-")
        grp = groups.get(name)
        if grp is None:
            grp = groups[name] = NodeDeviceResource(
                vendor="nvidia", type="gpu", name=name,
                attributes={"platform": "gpu"})
        grp.instance_ids.append(f"gpu-{i}")
    return list(groups.values())


def fingerprint(node_id: Optional[str] = None,
                datacenter: str = "dc1",
                node_class: str = "",
                drivers: Optional[Dict[str, bool]] = None,
                data_dir: str = "/") -> Node:
    """Build a Node from the host (reference client/fingerprint_manager.go)."""
    cores = os.cpu_count() or 1
    attrs = {
        "kernel.name": platform.system().lower(),
        "kernel.version": platform.release(),
        "os.name": platform.system().lower(),
        "arch": platform.machine(),
        "cpu.arch": platform.machine(),
        "cpu.numcores": str(cores),
        "cpu.totalcompute": str(int(_cpu_mhz())),
        "memory.totalbytes": str(int(_memory_mb() * 1024 * 1024)),
        "nomad.version": VERSION,
        "unique.hostname": socket.gethostname(),
    }
    if drivers is None:
        from .drivers import available_drivers

        drivers = {name: True for name in available_drivers()}
    for name, healthy in drivers.items():
        attrs[f"driver.{name}"] = "1" if healthy else "0"

    accelerators = _accelerators()
    for grp in accelerators:
        attrs[f"device.{grp.id}.count"] = str(len(grp.instance_ids))

    node = Node(
        id=node_id or generate_uuid(),
        name=socket.gethostname(),
        datacenter=datacenter,
        node_class=node_class,
        attributes=attrs,
        resources=NodeResources(
            cpu=_cpu_mhz(),
            memory_mb=_memory_mb(),
            disk_mb=_disk_mb(data_dir),
            total_cores=cores,
            devices=accelerators,
        ),
        drivers=dict(drivers),
    )
    node.compute_class()
    return node
