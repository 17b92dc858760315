"""Deployment health (a trimmed copy of ``nomad_tpu/core/deployments.py``):
the health rule the promotion endpoint reads. The watcher itself (its
progress deadlines, failure, auto-revert and auto-promote) is ROADMAP
A27; the caller plays it."""

from __future__ import annotations

from ..structs import enums


def alloc_healthy(alloc, job, now: float) -> bool:
    """Server-side health of one alloc (reference ``deployments.py:35-61``):
    the client's explicit ``deployment_status`` verdict wins; else every
    task has been running for the group's ``min_healthy_time``. The port
    models no service checks, so no group gates health on them."""
    ds = alloc.deployment_status
    if isinstance(ds, dict) and ds.get("healthy") is not None:
        return bool(ds.get("healthy"))
    if alloc.client_status != enums.ALLOC_CLIENT_RUNNING:
        return False
    tg = job.lookup_task_group(alloc.task_group)
    min_healthy = (tg.update.min_healthy_time_s
                   if tg is not None and tg.update is not None else 10.0)
    if not alloc.task_states:
        return False
    for st in alloc.task_states.values():
        if st.state != "running" or not st.started_at:
            return False
        if now - st.started_at < min_healthy:
            return False
    return True
