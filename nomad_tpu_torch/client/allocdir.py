"""Allocation directory layout (a copy of ``nomad_tpu/client/allocdir.py``;
reference client/allocdir/), and the confined reads the HTTP agent's
``/v1/client/fs`` routes serve (the reference keeps them in
``client/execstream.py``, whose exec sessions wait for ROADMAP A10.3b).

  <data_dir>/alloc/<alloc_id>/
      alloc/            shared between the alloc's tasks
      logs/             the tasks' rotated stdout/stderr
      <task>/local/     task-private scratch
      <task>/secrets/   secrets (mode 0700)
      <task>/tmp/
"""

from __future__ import annotations

import os
import shutil
import stat as _stat
from typing import List


class AllocDir:
    def __init__(self, data_dir: str, alloc_id: str):
        self.root = os.path.join(data_dir, "alloc", alloc_id)
        self.shared = os.path.join(self.root, "alloc")
        self.logs = os.path.join(self.root, "logs")

    def build(self) -> None:
        os.makedirs(self.shared, exist_ok=True)
        os.makedirs(self.logs, exist_ok=True)

    def migrate_from(self, prev: "AllocDir") -> bool:
        """Copy the previous alloc's shared dir into ours (ephemeral disk
        migrate/sticky; reference client/allocwatcher local migration)."""
        if not os.path.isdir(prev.shared):
            return False
        self.build()
        shutil.copytree(prev.shared, self.shared, dirs_exist_ok=True)
        return True

    def task_dir(self, task_name: str) -> str:
        return os.path.join(self.root, task_name)

    def build_task_dir(self, task_name: str) -> str:
        td = self.task_dir(task_name)
        os.makedirs(os.path.join(td, "local"), exist_ok=True)
        os.makedirs(os.path.join(td, "tmp"), exist_ok=True)
        secrets = os.path.join(td, "secrets")
        os.makedirs(secrets, exist_ok=True)
        os.chmod(secrets, 0o700)
        return td


# -- confined reads (reference ``client/execstream.py:258-328``) --

def safe_alloc_path(alloc_root: str, rel: str) -> str:
    """Resolve ``rel`` under the alloc dir; a path that escapes it (by
    ``..`` or a symlink) raises PermissionError."""
    rel = (rel or "/").lstrip("/")
    full = os.path.realpath(os.path.join(alloc_root, rel))
    root = os.path.realpath(alloc_root)
    if full != root and not full.startswith(root + os.sep):
        raise PermissionError(f"path escapes the allocation directory: {rel}")
    return full


def fs_list(alloc_root: str, rel: str) -> List[dict]:
    fd = _open_confined(alloc_root, rel, os.O_DIRECTORY)
    out = []
    try:
        for name in sorted(os.listdir(fd)):
            try:
                # through the pinned dir fd, never following symlinks: a
                # link to host paths must not be probed
                st = os.stat(name, dir_fd=fd, follow_symlinks=False)
            except OSError:
                continue
            out.append({"name": name, "is_dir": _stat.S_ISDIR(st.st_mode),
                        "size": st.st_size, "mtime": st.st_mtime})
    finally:
        os.close(fd)
    return out


def fs_stat(alloc_root: str, rel: str) -> dict:
    full = safe_alloc_path(alloc_root, rel)
    st = os.stat(full, follow_symlinks=False)
    return {"name": os.path.basename(full) or "/",
            "is_dir": os.path.isdir(full),
            "size": st.st_size, "mtime": st.st_mtime}


def _open_confined(alloc_root: str, rel: str, extra_flags: int = 0) -> int:
    """Open the resolved path refusing a symlink as its last component,
    then check again that the opened file lies under the alloc dir (a
    task swapping in a symlink between the check and the open must not
    reach host files)."""
    full = safe_alloc_path(alloc_root, rel)
    fd = os.open(full, os.O_RDONLY | os.O_NOFOLLOW | extra_flags)
    try:
        actual = os.path.realpath(f"/proc/self/fd/{fd}")
        root = os.path.realpath(alloc_root)
        if actual != root and not actual.startswith(root + os.sep):
            raise PermissionError(
                f"path escapes the allocation directory: {rel}")
    except PermissionError:
        os.close(fd)
        raise
    except OSError:
        pass  # no /proc: the O_NOFOLLOW check on the last component stands
    return fd


def fs_read(alloc_root: str, rel: str, offset: int = 0,
            limit: int = 65536) -> bytes:
    fd = _open_confined(alloc_root, rel)
    with os.fdopen(fd, "rb") as f:
        f.seek(max(offset, 0))
        return f.read(max(limit, 0))
