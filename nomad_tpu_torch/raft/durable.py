"""Durable raft storage: the on-disk log, the stable term and vote, and
the FSM snapshot files (a copy of ``nomad_tpu/raft/durable.py``).

The log is
an append-only JSONL file (commands are wire-encoded, structs/wire.py),
term/vote is an atomically-replaced JSON file, and snapshots are whole
state dumps (state/persist.py) with index/term metadata. Compaction
rewrites the log keeping only entries past the snapshot.

Layout under <dir>/:
    log.jsonl       one entry per line: {"index","term","command"}
    stable.json     {"term": N, "voted_for": id}
    snapshot.json   {"index","term","data"}
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import List, Optional, Tuple

from ..structs.wire import wire_decode, wire_encode
from ..utils.files import atomic_write_text as _atomic_write
from ..utils.files import check_fault as _check_fault
from .log import Entry

log = logging.getLogger("nomad_tpu_torch.raft")


def dumps(obj, depth: int = 0) -> str:
    """``json.dumps`` in pieces: the containers near the top (but not an
    encoded struct) and every list of more than 64 items are joined from
    their items' texts. One encoder call on a large command or snapshot
    (10 MB for 10,240 nodes) would hold the interpreter lock for all of
    it, and the in-process servers' heartbeat and tick threads with it;
    in pieces the lock changes hands between items."""
    if isinstance(obj, list) and (depth < 3 or len(obj) > 64):
        return "[" + ", ".join(dumps(v, depth + 1) for v in obj) + "]"
    if isinstance(obj, dict) and depth < 3 and "__t" not in obj:
        return "{" + ", ".join(json.dumps(k) + ": " + dumps(v, depth + 1)
                               for k, v in obj.items()) + "}"
    return json.dumps(obj)


def snapshot_digest(text: str) -> str:
    """Whole-snapshot content digest for the chunked install protocol:
    the follower only restores once the accumulated bytes hash to what
    the leader announced with the final chunk."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _load_snapshot_file(path: str) -> Optional[dict]:
    """Read snapshot.json, tolerating a torn/corrupt file: a snapshot
    that doesn't parse is treated as absent (warn + None) — the node
    starts empty and the leader re-installs — never a bricked server.
    The normal save path is atomic (tmp + fsync + rename), so this only
    fires on truly exceptional artifacts (partial copy, bit rot)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "index" not in data:
            raise ValueError("snapshot file missing index")
        return data
    except (ValueError, KeyError, OSError) as e:
        log.warning("%s: unreadable snapshot dropped (%s); "
                    "treating as absent", path, e)
        return None


class StableStore:
    """current_term + voted_for survive restarts (Raft's persistent
    per-server state; losing it can double-vote in one term)."""

    def __init__(self, dir_path: str):
        self._path = os.path.join(dir_path, "stable.json")
        self.term = 0
        self.voted_for: Optional[str] = None
        if os.path.exists(self._path):
            with open(self._path) as f:
                data = json.load(f)
            self.term = int(data.get("term", 0))
            self.voted_for = data.get("voted_for")

    def save(self, term: int, voted_for: Optional[str]) -> None:
        # disk first: if the write fails (ENOSPC, injected fault), the
        # in-memory view must not claim a persistence that never happened
        _atomic_write(self._path,
                      json.dumps({"term": term, "voted_for": voted_for}))
        self.term = term
        self.voted_for = voted_for


class SnapshotStore:
    """snapshot.json plus a chunk-transfer staging file.

    `last_index` tracks the index of the snapshot currently on disk
    (kept current by save/load) so `save(..., only_if_newer=True)` can
    reject a stale write without parsing the file — the off-lock
    snapshot thread uses it to lose the race against a concurrent
    install_snapshot cleanly."""

    def __init__(self, dir_path: str):
        self._path = os.path.join(dir_path, "snapshot.json")
        self._partial = self._path + ".partial"
        self._lock = threading.Lock()
        self.last_index = -1

    def save(self, index: int, term: int, data: dict,
             servers: Optional[dict] = None,
             only_if_newer: bool = False) -> bool:
        payload = {"index": index, "term": term, "data": data}
        if servers:
            payload["servers"] = servers
        return self._save_text(index, dumps(payload), only_if_newer)

    def save_raw(self, index: int, term: int, data_text: str,
                 servers: Optional[dict] = None,
                 only_if_newer: bool = False) -> bool:
        """Save with the FSM dump already serialized (`data_text` is the
        JSON text of the "data" value) — the chunked install path splices
        the accumulated transfer bytes straight in instead of
        parse-then-reserialize at C2M sizes."""
        head = {"index": index, "term": term}
        if servers:
            head["servers"] = servers
        text = json.dumps(head)[:-1] + ', "data": ' + data_text + "}"
        return self._save_text(index, text, only_if_newer)

    def _save_text(self, index: int, text: str,
                   only_if_newer: bool) -> bool:
        with self._lock:
            if only_if_newer and index <= self.last_index:
                log.info("%s: skipping stale snapshot save at index %d "
                         "(disk already at %d)",
                         self._path, index, self.last_index)
                return False
            _atomic_write(self._path, text)
            self.last_index = index
            return True

    def load(self) -> Optional[dict]:
        data = _load_snapshot_file(self._path)
        if data is not None:
            with self._lock:
                self.last_index = max(self.last_index, int(data["index"]))
        return data

    def sink(self) -> "FileSnapshotSink":
        """A staging sink for an incoming chunked transfer. Writes land
        in snapshot.json.partial; the real snapshot file is untouched
        until the caller verifies the digest and calls save_raw."""
        return FileSnapshotSink(self._partial)


class FileSnapshotSink:
    """Accumulates a chunked snapshot transfer in a temp file next to
    snapshot.json. Crash/disconnect mid-transfer leaves only this file
    behind — the previous snapshot stays loadable. Writes go through
    the `check_fault("snap_chunk")` hook, so a test can tear the
    transfer at any offset."""

    def __init__(self, path: str):
        self._path = path
        self._fh = None
        self.offset = 0

    def write(self, data: str) -> None:
        _check_fault("snap_chunk", self._path)
        if self._fh is None:
            self._fh = open(self._path, "w")
        self._fh.write(data)
        self._fh.flush()
        self.offset += len(data)

    def read_all(self) -> str:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if not os.path.exists(self._path):
            return ""
        with open(self._path) as f:
            return f.read()

    def discard(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        try:
            os.unlink(self._path)
        except OSError:
            pass
        self.offset = 0


class MemorySnapshotSink:
    """Chunk accumulator for nodes running without durable storage
    (in-proc tests): same surface as FileSnapshotSink."""

    def __init__(self):
        self._buf: List[str] = []
        self.offset = 0

    def write(self, data: str) -> None:
        self._buf.append(data)
        self.offset += len(data)

    def read_all(self) -> str:
        return "".join(self._buf)

    def discard(self) -> None:
        self._buf = []
        self.offset = 0


def _line(index: int, term: int, command_text: str) -> str:
    """One log line around an already encoded command."""
    return (f'{{"index": {index}, "term": {term}, '
            f'"command": {command_text}}}\n')


def encode_command(command: tuple) -> str:
    """A command's JSON text on the log (the wire codec)."""
    return dumps(wire_encode(list(command)))


class DurableLog:
    """RaftLog-compatible append-only disk log with a compaction base.

    Indexes are 1-based and global; after compaction the log physically
    starts at base_index+1 (base_index/base_term describe the snapshot
    boundary, like hashicorp/raft's firstIndex after log truncation).

    Each entry's line is encoded once, before the log's lock is taken,
    and kept beside the entry for the rewrites: a large command (10,240
    nodes in one ``upsert_nodes``) then holds the lock for its write and
    fsync only, and the replicators and the tick thread, which read the
    log's tail under the node lock, are not held behind its encoding.
    """

    def __init__(self, dir_path: str, fsync: bool = True):
        self._dir = dir_path
        self._path = os.path.join(dir_path, "log.jsonl")
        self._fsync = fsync
        self._lock = threading.Lock()
        self.base_index = 0
        self.base_term = 0
        self._entries: List[Entry] = []  # entries base_index+1 .. last
        self._lines: List[str] = []      # their lines on disk
        self._fh = None
        self._load()

    # -- persistence internals --

    def _load(self) -> None:
        meta = _load_snapshot_file(os.path.join(self._dir, "snapshot.json"))
        if meta is not None:
            self.base_index = int(meta.get("index", 0))
            self.base_term = int(meta.get("term", 0))
        if os.path.exists(self._path):
            good_offset = 0
            torn = False
            with open(self._path, "rb") as f:
                for raw in f:
                    line = raw.decode("utf-8", errors="replace").strip()
                    if line:
                        try:
                            rec = json.loads(line)
                            e = Entry(index=int(rec["index"]),
                                      term=int(rec["term"]),
                                      command=tuple(
                                          wire_decode(rec["command"])))
                        except (ValueError, KeyError, TypeError):
                            # torn tail write (crash mid-append) — or a
                            # JSON-shaped fragment missing fields: drop
                            # it and everything after; never brick the
                            # server on restart
                            torn = True
                            break
                        if e.index > self.base_index:
                            # conflict-truncated entries may linger
                            # physically; keep the last write per index
                            pos = e.index - self.base_index - 1
                            if pos < len(self._entries):
                                del self._entries[pos:]
                                del self._lines[pos:]
                            elif pos > len(self._entries):
                                good_offset += len(raw)
                                continue  # stale pre-compaction line
                            self._entries.append(e)
                            self._lines.append(line + "\n")
                    good_offset += len(raw)
            if torn:
                last_idx = (self._entries[-1].index if self._entries
                            else self.base_index)
                dropped = os.path.getsize(self._path) - good_offset
                log.warning(
                    "%s: torn tail (%d byte(s) past entry %d) dropped; "
                    "truncating to the last good entry",
                    self._path, dropped, last_idx)
                # truncate the garbage so the next append starts clean
                with open(self._path, "r+b") as f:
                    f.truncate(good_offset)
        self._fh = open(self._path, "a")

    def _write(self, lines: List[str]) -> None:
        _check_fault("log_append", self._path)
        self._fh.write("".join(lines))
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def _rewrite(self) -> None:
        """Rewrite the whole file from the logical view (truncation or
        compaction — both rare)."""
        _check_fault("log_rewrite", self._path)
        self._fh.close()
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write("".join(self._lines))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
        finally:
            # even a failed rewrite (disk fault) leaves the old file in
            # place atomically; the append handle must come back either
            # way or every later write dies on a closed fh
            self._fh = open(self._path, "a")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- RaftLog interface --

    def last(self) -> Tuple[int, int]:
        with self._lock:
            if not self._entries:
                return self.base_index, self.base_term
            e = self._entries[-1]
            return e.index, e.term

    def first_index(self) -> int:
        """Lowest index physically present (0 = log empty)."""
        with self._lock:
            return self.base_index + 1 if self._entries else 0

    def term_at(self, index: int) -> int:
        if index == 0:
            return 0
        with self._lock:
            if index == self.base_index:
                return self.base_term
            pos = index - self.base_index - 1
            if pos < 0 or pos >= len(self._entries):
                return -1
            return self._entries[pos].term

    def get(self, index: int) -> Optional[Entry]:
        with self._lock:
            pos = index - self.base_index - 1
            if 0 <= pos < len(self._entries):
                return self._entries[pos]
            return None

    def slice_from(self, index: int, limit: int = 64) -> List[Entry]:
        with self._lock:
            pos = max(0, index - self.base_index - 1)
            return list(self._entries[pos: pos + limit])

    def append(self, term: int, command: tuple) -> Entry:
        text = encode_command(command)
        with self._lock:
            last = (self._entries[-1].index if self._entries
                    else self.base_index)
            e = Entry(index=last + 1, term=term, command=command)
            line = _line(e.index, term, text)
            self._entries.append(e)
            self._lines.append(line)
            try:
                self._write([line])
            except OSError:
                # disk fault (ENOSPC/EIO): roll the in-memory entry back
                # so memory never claims an entry the disk lost — a
                # crash-restart would otherwise drop an acked write
                del self._entries[-1]
                del self._lines[-1]
                raise
            return e

    def append_batch(self, term: int, commands: List[tuple],
                     prev: Optional[Tuple[int, int]] = None
                     ) -> Optional[List[Entry]]:
        """Group commit: append a whole batch of commands with ONE
        buffered write and ONE fsync — the amortization the leader's
        log-writer thread lives on.

        When ``prev`` is given the append is conditional on the tail
        still being exactly ``(last_index, last_term)``; a concurrent
        append (config entry, new-leader noop, post-step-down
        truncation) fails the compare-and-swap and returns None, so the
        caller re-reads the tail instead of writing onto a diverged
        log. Entries become visible (and replicable) only after the
        fsync returns: memory never claims what disk might lose, and a
        disk fault rolls the whole batch back — the same atomicity
        contract as append()."""
        texts = [encode_command(c) for c in commands]
        with self._lock:
            if not self._entries:
                tail = (self.base_index, self.base_term)
            else:
                e = self._entries[-1]
                tail = (e.index, e.term)
            if prev is not None and tail != tuple(prev):
                return None
            batch = [Entry(index=tail[0] + 1 + i, term=term, command=c)
                     for i, c in enumerate(commands)]
            lines = [_line(e.index, term, t) for e, t in zip(batch, texts)]
            before = len(self._entries)
            self._entries.extend(batch)
            self._lines.extend(lines)
            try:
                self._write(lines)
            except OSError:
                # one fault fails the whole batch: every entry rolls
                # back together, so there is never a gap where a prefix
                # is durable but memory claims the full batch
                del self._entries[before:]
                del self._lines[before:]
                raise
            return batch

    def append_entries(self, prev_index: int, entries: List[Entry]) -> bool:
        lines_of = {e.index: _line(e.index, e.term, encode_command(e.command))
                    for e in entries if e.index > self.base_index}
        with self._lock:
            before_len = len(self._entries)
            appended: List[str] = []
            truncated = False
            for e in entries:
                if e.index <= self.base_index:
                    continue  # snapshot already covers it
                line = lines_of.get(e.index)
                if line is None:
                    line = _line(e.index, e.term, encode_command(e.command))
                pos = e.index - self.base_index - 1
                if pos < len(self._entries):
                    if self._entries[pos].term != e.term:
                        del self._entries[pos:]
                        del self._lines[pos:]
                        self._entries.append(e)
                        self._lines.append(line)
                        truncated = True
                        appended = [line]
                    # else: already have it
                else:
                    self._entries.append(e)
                    self._lines.append(line)
                    appended.append(line)
            try:
                if truncated:
                    self._rewrite()
                elif appended:
                    self._write(appended)
            except OSError:
                if not truncated:
                    # plain-append fault: shed the entries the disk
                    # never saw (the follower will nack and be retried)
                    del self._entries[before_len:]
                    del self._lines[before_len:]
                raise
            return truncated

    def length(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- compaction --

    def compact(self, upto_index: int, upto_term: int) -> None:
        """Drop entries <= upto_index (now covered by a snapshot)."""
        with self._lock:
            if self._fh is None:
                # closed mid-race by a crash/stop (the async snapshot
                # worker outlives the node lock); the snapshot is saved,
                # compaction just waits for the next round
                return
            keep = upto_index - self.base_index
            if keep <= 0:
                return
            del self._entries[:keep]
            del self._lines[:keep]
            self.base_index = upto_index
            self.base_term = upto_term
            self._rewrite()

    def reset_to(self, index: int, term: int) -> None:
        """Install-snapshot on a follower: discard everything, restart
        the log at the snapshot boundary."""
        with self._lock:
            if self._fh is None:
                return
            self._entries.clear()
            self._lines.clear()
            self.base_index = index
            self.base_term = term
            self._rewrite()
