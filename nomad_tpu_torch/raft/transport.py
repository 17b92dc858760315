"""The in-process raft transport (a trimmed copy of
``nomad_tpu/raft/transport.py:33-153, 603-611``).

The node logic only needs ``send(from, to, message) -> reply``:
``InProcTransport`` is a registry of node handlers, and a send is a
function call unless the failure set drops it. The failure model, for
tests, is consulted per message: per-node partitions (symmetric: the
node is cut from everyone), then directed per-link cuts
(``partition_link(a, b)`` drops a->b only). A dropped message or an
unregistered (crashed) node reads as ``None``: message loss, which raft
tolerates.

Not ported: the reference's ``SocketTransport`` (length-prefixed frames
over TCP, the server-to-server call forwarding) and its chaos fault
plans; they wait for the CLI. ``TransportError`` and
``RemoteCallError`` are kept for the callers that name them.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

log = logging.getLogger("nomad_tpu_torch.raft")


class InProcTransport:
    """A registry of node handlers; ``send`` is a function call with a
    configurable failure set for partition tests."""

    def __init__(self):
        self._handlers: Dict[str, Callable[[dict], dict]] = {}
        self._lock = threading.Lock()
        self._partitioned: set = set()  # node ids cut off from everyone
        self._cut_links: set = set()    # directed (src, dst) pairs

    def register(self, node_id: str, handler: Callable[[dict], dict]) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        """A crashed process: its handler vanishes."""
        with self._lock:
            self._handlers.pop(node_id, None)

    def partition(self, node_id: str) -> None:
        with self._lock:
            self._partitioned.add(node_id)

    def partition_link(self, src: str, dst: str) -> None:
        """Cut src -> dst only; dst -> src still delivers."""
        with self._lock:
            self._cut_links.add((src, dst))

    def heal_link(self, src: str, dst: str) -> None:
        with self._lock:
            self._cut_links.discard((src, dst))

    def heal(self, node_id: Optional[str] = None) -> None:
        """Heal one node's symmetric partition, or - with no argument -
        everything: node partitions and directed link cuts."""
        with self._lock:
            if node_id is None:
                self._partitioned.clear()
                self._cut_links.clear()
            else:
                self._partitioned.discard(node_id)

    def send(self, from_id: str, to_id: str, msg: dict) -> Optional[dict]:
        with self._lock:
            if from_id in self._partitioned or to_id in self._partitioned:
                return None
            if (from_id, to_id) in self._cut_links:
                return None
            handler = self._handlers.get(to_id)
        if handler is None:
            return None
        try:
            return handler(msg)
        except Exception:  # noqa: BLE001 - a raising peer is a lost reply
            log.debug("in-proc handler on %s raised for message from %s",
                      to_id, from_id, exc_info=True)
            return None


class TransportError(Exception):
    maybe_delivered = False


class RemoteCallError(Exception):
    def __init__(self, error_type: str, message: str, leader_id=None):
        super().__init__(f"{error_type}: {message}")
        self.error_type = error_type
        self.leader_id = leader_id
