"""MVCC primitives: versioned tables, persistent cons-lists and the
snapshot tracker (reference ``nomad_tpu/state/mvcc.py``)."""

from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


class ConsList:
    """Immutable singly-linked list cell: appending is O(1) and never
    disturbs older snapshots."""

    __slots__ = ("head", "tail", "length")

    def __init__(self, head: Any, tail: Optional["ConsList"]):
        self.head = head
        self.tail = tail
        self.length = 1 + (tail.length if tail is not None else 0)


def cons(head: Any, tail: Optional[ConsList]) -> ConsList:
    return ConsList(head, tail)


def cons_iter(cell: Optional[ConsList]) -> Iterator[Any]:
    while cell is not None:
        yield cell.head
        cell = cell.tail


class _Chain:
    """Per-key version chain: parallel arrays of (generation, value)."""

    __slots__ = ("gens", "vals")

    def __init__(self):
        self.gens: List[int] = []
        self.vals: List[Any] = []


class VersionedTable:
    """A dict of version chains keyed by primary key. The single writer
    puts with a monotonically increasing generation; readers get and
    iterate at a captured generation. Insertion order is key order."""

    __slots__ = ("name", "_rows")

    def __init__(self, name: str):
        self.name = name
        # key -> (gen, value) single-version tuple | _Chain
        self._rows: Dict[Any, Any] = {}

    def put(self, key: Any, value: Any, gen: int, min_live_gen: int) -> None:
        row = self._rows.get(key)
        if row is None:
            self._rows[key] = (gen, value)
            return
        if type(row) is tuple:
            if row[0] == gen:
                self._rows[key] = (gen, value)
                return
            chain = _Chain()
            chain.gens = [row[0], gen]
            chain.vals = [row[1], value]
            self._rows[key] = chain
        else:
            chain = row
            if chain.gens[-1] == gen:
                chain.vals[-1] = value
            else:
                chain.gens.append(gen)
                chain.vals.append(value)
        if len(chain.gens) > 1 and chain.gens[0] < min_live_gen:
            # keep the newest version at or below min_live_gen onward
            i = bisect.bisect_right(chain.gens, min_live_gen) - 1
            if i > 0:
                del chain.gens[:i]
                del chain.vals[:i]

    def delete(self, key: Any, gen: int, min_live_gen: int) -> None:
        """From ``gen`` on the key reads as absent: its value is None."""
        if key in self._rows:
            self.put(key, None, gen, min_live_gen)

    @staticmethod
    def _visible(row: Any, gen: int) -> Tuple[bool, Any]:
        if type(row) is tuple:
            return (row[0] <= gen, row[1])
        gens = row.gens
        if gens[-1] <= gen:
            return True, row.vals[-1]
        i = bisect.bisect_right(gens, gen) - 1
        return (i >= 0, row.vals[i] if i >= 0 else None)

    def get(self, key: Any, gen: int) -> Any:
        row = self._rows.get(key)
        if row is None:
            return None
        ok, v = self._visible(row, gen)
        return v if ok else None

    def get_latest(self, key: Any) -> Any:
        row = self._rows.get(key)
        if row is None:
            return None
        return row[1] if type(row) is tuple else row.vals[-1]

    def iterate(self, gen: int) -> Iterator[Tuple[Any, Any]]:
        # list(dict) is one atomic step under the GIL; keys inserted after
        # it carry gen > the snapshot's and would be skipped anyway
        for key in list(self._rows):
            row = self._rows.get(key)
            if row is None:
                continue
            ok, v = self._visible(row, gen)
            if ok and v is not None:
                yield key, v


class SnapshotTracker:
    """Live snapshot generations, so the writer knows how far back
    version chains must be kept."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, int] = {}  # gen -> refcount

    def acquire_atomic(self, get_gen: Callable[[], int]) -> int:
        with self._lock:
            gen = get_gen()
            self._live[gen] = self._live.get(gen, 0) + 1
            return gen

    def release(self, gen: int) -> None:
        with self._lock:
            n = self._live.get(gen, 0) - 1
            if n <= 0:
                self._live.pop(gen, None)
            else:
                self._live[gen] = n

    def min_live(self, current_gen: int) -> int:
        with self._lock:
            return min(self._live) if self._live else current_gen
