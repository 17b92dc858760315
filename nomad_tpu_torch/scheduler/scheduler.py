"""Scheduler factory (reference ``nomad_tpu/scheduler/scheduler.py``):
the generic scheduler for service and batch jobs, the system scheduler
for system and sysbatch jobs."""

from __future__ import annotations

from ..structs import enums


def NewScheduler(sched_type: str, state, planner, *, sched_config=None,
                 placer=None, device=None):
    """A scheduler for ``sched_type`` over ``state`` submitting to
    ``planner``; ``device`` is threaded to the placer the scheduler
    builds from its configuration. The system scheduler ranks nodes on
    the host and takes no placer."""
    if sched_type in (enums.JOB_TYPE_SYSTEM, enums.JOB_TYPE_SYSBATCH):
        from .system_sched import SystemScheduler

        return SystemScheduler(
            state, planner, sysbatch=sched_type == enums.JOB_TYPE_SYSBATCH,
            sched_config=sched_config)
    if sched_type not in (enums.JOB_TYPE_SERVICE, enums.JOB_TYPE_BATCH):
        raise ValueError(f"unknown scheduler type {sched_type!r}")
    from .generic_sched import GenericScheduler

    return GenericScheduler(state, planner,
                            batch=sched_type == enums.JOB_TYPE_BATCH,
                            sched_config=sched_config, placer=placer,
                            device=device)
