"""Raft log entries and the in-memory log (a copy of
``nomad_tpu/raft/log.py``): 1-indexed, append-only, with the term and
index invariants of the durable log (``durable.py``) that replaces it
when a server has a data directory.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(slots=True)
class Entry:
    index: int
    term: int
    command: tuple  # (op, payload) — see fsm.py


class RaftLog:
    """1-indexed append-only log guarded by a lock."""

    def __init__(self):
        self._entries: List[Entry] = []
        self._lock = threading.Lock()

    def last(self) -> Tuple[int, int]:
        """-> (last_index, last_term)."""
        with self._lock:
            if not self._entries:
                return 0, 0
            e = self._entries[-1]
            return e.index, e.term

    def term_at(self, index: int) -> int:
        if index == 0:
            return 0
        with self._lock:
            if index > len(self._entries):
                return -1
            return self._entries[index - 1].term

    def get(self, index: int) -> Optional[Entry]:
        with self._lock:
            if 1 <= index <= len(self._entries):
                return self._entries[index - 1]
            return None

    def slice_from(self, index: int, limit: int = 64) -> List[Entry]:
        with self._lock:
            return list(self._entries[index - 1: index - 1 + limit])

    def append(self, term: int, command: tuple) -> Entry:
        with self._lock:
            e = Entry(index=len(self._entries) + 1, term=term, command=command)
            self._entries.append(e)
            return e

    def append_batch(self, term: int, commands: List[tuple],
                     prev: Optional[Tuple[int, int]] = None
                     ) -> Optional[List[Entry]]:
        """Append a whole batch in one lock hold (the group-commit
        primitive; DurableLog adds the single-fsync disk write on top).

        When ``prev`` is given the append is conditional on the tail
        still being exactly ``(last_index, last_term)``: the log writer
        snapshots the tail under the node lock, builds the batch outside
        it, and any interleaved append — a config entry, a new leader's
        noop, a follower truncation after step-down — fails the
        compare-and-swap instead of landing the batch on a diverged log.
        Returns None on a CAS mismatch."""
        with self._lock:
            if not self._entries:
                tail = (0, 0)
            else:
                e = self._entries[-1]
                tail = (e.index, e.term)
            if prev is not None and tail != tuple(prev):
                return None
            batch = [Entry(index=tail[0] + 1 + i, term=term, command=c)
                     for i, c in enumerate(commands)]
            self._entries.extend(batch)
            return batch

    def append_entries(self, prev_index: int, entries: List[Entry]) -> bool:
        """Follower-side: truncate conflicts after prev_index, then
        append (the AppendEntries receiver rules). Returns True when a
        conflicting suffix was truncated (membership must be
        recomputed — a dropped entry may have been a config change)."""
        truncated = False
        with self._lock:
            for e in entries:
                pos = e.index - 1
                if pos < len(self._entries):
                    if self._entries[pos].term != e.term:
                        del self._entries[pos:]
                        self._entries.append(e)
                        truncated = True
                    # else: already have it
                else:
                    self._entries.append(e)
        return truncated

    def length(self) -> int:
        with self._lock:
            return len(self._entries)
