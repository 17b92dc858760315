"""Atomic file writes and the disk-fault hook of the durable raft
stores (a copy of ``nomad_tpu/utils/files.py``). ``set_fault_hook``
installs ``hook(op, path)``, called before every durable write
(``log_append``, ``log_rewrite``, ``atomic_write_text``,
``snap_chunk``); the tests raise ``OSError`` from it to inject a
fault."""

from __future__ import annotations

import os
from typing import Callable, Optional

# a no-op until a hook is installed; durable writes call check_fault
# before their disk IO
_fault_hook: Optional[Callable[[str, str], None]] = None


def set_fault_hook(hook: Optional[Callable[[str, str], None]]) -> None:
    global _fault_hook
    _fault_hook = hook


def check_fault(op: str, path: str) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(op, path)


def atomic_write_text(path: str, payload: str) -> None:
    """Write-temp + fsync + rename so readers see the old or the new
    file, never a torn one."""
    check_fault("atomic_write_text", path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
