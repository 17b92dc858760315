"""In-flight usage overlay for the per-eval solve path (reference
``nomad_tpu/tensor/overlay.py:33-108``).

Each per-eval solve registers its placements' per-node usage deltas,
keyed by node id; every ClusterTensors usage gather folds the open
entries in, so the next racing eval plans around them instead of
filling the same best-fit nodes. Entries close through the plan's
post-apply hooks (committed usage is then in the store; rejected nodes'
deltas die with the entry), with a TTL for evals that die between solve
and submit. Optimism repair only: the plan commit stays the gate.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

ENTRY_TTL = 60.0


class InflightOverlay:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, dict] = {}  # token -> entry
        self._token = 0
        self.stats = {"registered": 0, "confirmed": 0, "expired": 0}

    def register(self, deltas: Dict[str, object], plan) -> None:
        """Record one eval's in-flight deltas ({node_id: vec}) and close
        the entry when the plan is applied."""
        if not deltas:
            return
        with self._lock:
            self._token += 1
            token = self._token
            self._entries[token] = {"deltas": deltas, "born": time.time(),
                                    "plan": id(plan)}
            self.stats["registered"] += 1
        if plan is not None:
            plan.post_apply_hooks.append(
                lambda result, _t=token: self.confirm(_t))

    def confirm(self, token: int) -> None:
        with self._lock:
            if self._entries.pop(token, None) is not None:
                self.stats["confirmed"] += 1

    def fold(self, used, node_index: Dict[str, int],
             exclude_plan=None) -> None:
        """Add every open entry's deltas into a canonical-order usage
        matrix, in place, skipping ``exclude_plan``'s own entries (its
        placements are already in the plan the usage recompute reads)."""
        now = time.time()
        exclude = id(exclude_plan) if exclude_plan is not None else None
        with self._lock:
            if not self._entries:
                return
            for t in [t for t, e in self._entries.items()
                      if now - e["born"] > ENTRY_TTL]:
                del self._entries[t]
                self.stats["expired"] += 1
            entries = [e for e in self._entries.values()
                       if exclude is None or e["plan"] != exclude]
        d = used.shape[1]
        for e in entries:
            for node_id, vec in e["deltas"].items():
                row = node_index.get(node_id)
                if row is not None:
                    used[row] += vec[:d]


INFLIGHT = InflightOverlay()
