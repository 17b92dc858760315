"""Port accounting and assignment (reference
``nomad_tpu/structs/network.py``, itself Nomad's NetworkIndex).

Exhaustion of the dynamic range is a count in the dense resource vector
(``resources.R_PORTS``), which the kernels fit like any other column.
Exact port numbers are assigned on the host, for the groups that ask for
ports only: per chosen node after the solve, and re-checked by the plan
applier through ``allocs_fit``, where two racing plans that book one
port on one node become a rejected node. Dynamic assignment takes the
lowest free port, so a replayed plan picks the same ports.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set, Tuple

from .alloc import AllocatedPort


class NetworkIndex:
    """The used ports of one node."""

    def __init__(self, node):
        res = node.resources
        self.min_dyn = res.min_dynamic_port
        self.max_dyn = res.max_dynamic_port
        self.used: Set[int] = set(node.reserved.reserved_ports)
        self.collision = False
        self.colliding_ports: List[int] = []

    def add_ports(self, ports: Iterable[int]) -> None:
        for p in ports:
            if p in self.used:
                self.collision = True
                self.colliding_ports.append(p)
            self.used.add(p)

    def add_allocs(self, allocs: Sequence) -> None:
        """Register the ports of the allocs that count for usage
        (client-terminal allocs free their ports)."""
        for a in allocs:
            if not a.should_count_for_usage():
                continue
            self.add_ports(p.value for p in a.allocated_ports)

    def assign_ports(self, ask) -> Tuple[List[AllocatedPort], str]:
        """The ask's reserved and dynamic ports against this index ->
        (ports, "") with the ports recorded as used, or ([], reason)."""
        out: List[AllocatedPort] = []
        taken: Set[int] = set()
        for label, port in ask.reserved_port_asks():
            if port in self.used or port in taken:
                return [], f"reserved port collision {label}={port}"
            taken.add(port)
            out.append(AllocatedPort(label=label, value=port))
        for net in ask.networks:
            for label in net.dynamic_ports:
                port = self._next_free(taken)
                if port is None:
                    return [], "dynamic port selection failed"
                taken.add(port)
                out.append(AllocatedPort(label=label, value=port))
        self.used |= taken
        return out, ""

    def _next_free(self, taken: Set[int]) -> Optional[int]:
        for p in range(self.min_dyn, self.max_dyn + 1):
            if p not in self.used and p not in taken:
                return p
        return None


def check_port_collisions(node, allocs: Sequence) -> List[int]:
    """The ports the given allocs book twice on this node (or that hit
    the node's agent-reserved ports); empty when they fit."""
    idx = NetworkIndex(node)
    idx.add_allocs(allocs)
    return idx.colliding_ports
