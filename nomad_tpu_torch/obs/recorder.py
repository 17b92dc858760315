"""Flight recorder: bounded per-subsystem event rings (reference
``nomad_tpu/obs/recorder.py``).

Broker transitions, plan verdicts and solver launches, each subsystem in
its own ``deque(maxlen=RING_EVENTS)``: appends are GIL-atomic, so
recording takes no lock. A recorder made with ``enabled=False`` records
nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

# events kept per subsystem
RING_EVENTS = 512


class FlightRecorder:
    def __init__(self, enabled: bool = True, ring_events: int = RING_EVENTS):
        self.enabled = enabled
        self.ring_events = ring_events
        # subsystem -> deque of (t, thread, event, fields)
        self._rings: Dict[str, deque] = {}
        self._create_lock = threading.Lock()

    def record(self, subsystem: str, event: str, **fields) -> None:
        if not self.enabled:
            return
        ring = self._rings.get(subsystem)
        if ring is None:
            with self._create_lock:
                ring = self._rings.setdefault(
                    subsystem, deque(maxlen=self.ring_events))
        ring.append((time.time(), threading.current_thread().name,
                     event, fields))

    def events(self, subsystem: Optional[str] = None) -> List[tuple]:
        """Merged (t, subsystem, thread, event, fields) records, oldest
        first."""
        with self._create_lock:
            items = [(name, list(ring))
                     for name, ring in self._rings.items()
                     if subsystem is None or name == subsystem]
        out = [(t, name, thread, event, fields)
               for name, recs in items
               for (t, thread, event, fields) in recs]
        out.sort(key=lambda r: r[0])
        return out

    def dump_text(self, last: int = 80) -> str:
        """The merged tail, one line an event, relative timestamps."""
        evs = self.events()[-last:]
        if not evs:
            return ""
        t0 = evs[0][0]
        lines = []
        for t, subsystem, thread, event, fields in evs:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            lines.append(f"+{t - t0:9.4f}s [{subsystem:<7}] {event:<18} "
                         f"{kv}  ({thread})")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._create_lock:
            self._rings.clear()


RECORDER = FlightRecorder()
