"""Client state persistence (a copy of ``nomad_tpu/client/state_db.py``;
reference client/state/db_bolt.go:165).

A write-through JSON file under the client's data_dir records the node
identity, each assigned alloc (encoded by ``structs/wire.py``, the raft
log's codec) and each started task's driver handle (pid and process
start time, or the executor's status file). A restarted client reloads
it, re-attaches to the tasks still running and resumes its status sync.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..structs.alloc import Allocation
from ..structs.wire import wire_decode, wire_encode
from ..utils.files import atomic_write_text


class ClientStateDB:
    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self._path = os.path.join(data_dir, "client_state.json")
        self._lock = threading.Lock()
        self._data: dict = {"node_id": "", "allocs": {}}
        # alloc id -> its record's JSON, re-encoded only when it changes
        self._enc: Dict[str, str] = {}
        if os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, OSError):
                pass  # corrupt state file: start fresh (never wedge startup)

    def _save(self, changed=()) -> None:
        """Write the whole state file, as the reference does; only the
        records named in ``changed`` are JSON-encoded again (each write
        would otherwise re-encode every alloc's job)."""
        for aid in changed:
            self._enc.pop(aid, None)
        allocs = self._data["allocs"]
        for aid in [a for a in self._enc if a not in allocs]:
            del self._enc[aid]
        parts = []
        for aid, rec in allocs.items():
            enc = self._enc.get(aid)
            if enc is None:
                enc = self._enc[aid] = json.dumps(rec)
            parts.append(f"{json.dumps(aid)}: {enc}")
        head = json.dumps({k: v for k, v in self._data.items()
                           if k != "allocs"})[:-1]
        atomic_write_text(self._path, head + (", " if len(head) > 1 else "")
                          + '"allocs": {' + ", ".join(parts) + "}}")

    # -- node identity --

    @property
    def node_id(self) -> str:
        return self._data.get("node_id", "")

    def set_node_id(self, node_id: str) -> None:
        with self._lock:
            self._data["node_id"] = node_id
            self._save()

    # -- allocs + task handles --

    # The batch forms write once for many records: a client assigned
    # hundreds of allocs at once, or syncing hundreds of statuses, would
    # otherwise rewrite the whole file once for each.

    def put_allocs(self, allocs: List[Allocation]) -> None:
        if not allocs:
            return
        with self._lock:
            for alloc in allocs:
                rec = self._data["allocs"].setdefault(alloc.id, {})
                rec["alloc"] = wire_encode(alloc)
                rec.setdefault("handles", {})
            self._save([a.id for a in allocs])

    def put_task_handle(self, alloc_id: str, task_name: str,
                        handle_data: Optional[dict]) -> None:
        with self._lock:
            rec = self._data["allocs"].get(alloc_id)
            if rec is None:
                return
            handles = rec.setdefault("handles", {})
            if handle_data is None and handles.get(task_name) is None:
                return  # nothing to re-attach, before and after
            handles[task_name] = handle_data
            self._save([alloc_id])

    def update_client_statuses(self, statuses: Dict[str, str]) -> None:
        """Track the latest client status so restore can tell a completed
        batch alloc from one still owed execution (re-running finished
        work would duplicate side effects)."""
        with self._lock:
            changed = []
            for alloc_id, client_status in statuses.items():
                rec = self._data["allocs"].get(alloc_id)
                if rec is None or rec.get("client_status") == client_status:
                    continue
                rec["client_status"] = client_status
                changed.append(alloc_id)
            if changed:
                self._save(changed)

    def remove_allocs(self, alloc_ids) -> None:
        with self._lock:
            gone = [a for a in alloc_ids
                    if self._data["allocs"].pop(a, None) is not None]
            if gone:
                self._save()

    def restore_allocs(self) -> List[Tuple[Allocation, Dict[str, dict]]]:
        """-> [(alloc, {task_name: handle_data})] for every stored alloc.
        The alloc carries the last synced client_status, not the
        assignment-time one."""
        out = []
        with self._lock:
            for rec in self._data["allocs"].values():
                try:
                    alloc = wire_decode(rec["alloc"])
                except Exception:
                    continue
                if rec.get("client_status"):
                    alloc.client_status = rec["client_status"]
                out.append((alloc, dict(rec.get("handles") or {})))
        return out
