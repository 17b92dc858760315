"""Task environment and interpolation (a copy of
``nomad_tpu/client/taskenv.py``; reference client/taskenv/): the NOMAD_*
environment a task sees, and "${node.*}" / "${attr.*}" / "${meta.*}" /
"${env.*}" / "${NOMAD_*}" references in task config values.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

_VAR = re.compile(r"\$\{([^}]+)\}")


def build_env(alloc, task, node, task_dir: str = "",
              shared_dir: str = "") -> Dict[str, str]:
    """Reference client/taskenv/env.go Builder.Build."""
    job = alloc.job
    env: Dict[str, str] = {
        "NOMAD_ALLOC_ID": alloc.id,
        "NOMAD_ALLOC_NAME": alloc.name,
        "NOMAD_ALLOC_INDEX": str(alloc.index()),
        "NOMAD_TASK_NAME": task.name,
        "NOMAD_GROUP_NAME": alloc.task_group,
        "NOMAD_JOB_ID": alloc.job_id,
        "NOMAD_JOB_NAME": job.name if job is not None else alloc.job_id,
        "NOMAD_NAMESPACE": alloc.namespace,
        "NOMAD_REGION": "global",
        "NOMAD_DC": node.datacenter if node is not None else "",
        "NOMAD_CPU_LIMIT": str(int(task.resources.cpu)),
        "NOMAD_MEMORY_LIMIT": str(int(task.resources.memory_mb)),
    }
    if task_dir:
        env["NOMAD_TASK_DIR"] = f"{task_dir}/local"
        env["NOMAD_SECRETS_DIR"] = f"{task_dir}/secrets"
    if shared_dir:
        env["NOMAD_ALLOC_DIR"] = shared_dir
    for port in alloc.allocated_ports:
        label = port.label.upper().replace("-", "_")
        env[f"NOMAD_PORT_{label}"] = str(port.value)
        env[f"NOMAD_HOST_PORT_{label}"] = str(port.value)
        env[f"NOMAD_IP_{label}"] = port.host_ip or ""
    # job/group/task meta (task wins), uppercased with NOMAD_META_ prefix
    meta: Dict[str, str] = {}
    if job is not None:
        meta.update(job.meta)
        tg = job.lookup_task_group(alloc.task_group)
        if tg is not None:
            meta.update(tg.meta)
    meta.update(task.meta)
    for k, v in meta.items():
        env[f"NOMAD_META_{k.upper().replace('-', '_')}"] = str(v)
        env[f"NOMAD_META_{k.replace('-', '_')}"] = str(v)
    for k, v in (task.env or {}).items():
        env[k] = interpolate(str(v), node, env)
    return env


def interpolate(s: str, node, env: Optional[Dict[str, str]] = None) -> str:
    """Replace ${...} references (reference client/taskenv +
    scheduler-side resolveTarget semantics for node targets)."""
    def repl(m: re.Match) -> str:
        key = m.group(1).strip()
        if node is not None:
            if key == "node.unique.id":
                return node.id
            if key == "node.datacenter":
                return node.datacenter
            if key == "node.unique.name":
                return node.name
            if key == "node.class":
                return node.node_class
            if key == "node.pool":
                return node.node_pool
            if key.startswith("attr."):
                return str(node.attributes.get(key[5:], ""))
            if key.startswith("meta."):
                return str(node.meta.get(key[5:], ""))
        if key.startswith("env.") and env is not None:
            return env.get(key[4:], "")
        if env is not None and key in env:
            return env[key]
        return ""

    return _VAR.sub(repl, s)


def interpolate_config(cfg: dict, node, env: Dict[str, str]) -> dict:
    """Deep-interpolate a driver config."""
    def walk(v):
        if isinstance(v, str):
            return interpolate(v, node, env)
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        return v

    return {k: walk(v) for k, v in cfg.items()}
