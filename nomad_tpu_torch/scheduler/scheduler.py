"""Scheduler factory (reference ``nomad_tpu/scheduler/scheduler.py``):
the service and batch schedulers and the system scheduler for fresh
system jobs; sysbatch is a later slice."""

from __future__ import annotations

from ..structs import enums


def NewScheduler(sched_type: str, state, planner, *, sched_config=None,
                 placer=None, device=None):
    """A scheduler for ``sched_type`` over ``state`` submitting to
    ``planner``; ``device`` is threaded to the placer the scheduler
    builds from its configuration. The system scheduler ranks nodes on
    the host and takes no placer."""
    if sched_type == enums.JOB_TYPE_SYSTEM:
        from .system_sched import SystemScheduler

        return SystemScheduler(state, planner, sched_config=sched_config)
    if sched_type not in (enums.JOB_TYPE_SERVICE, enums.JOB_TYPE_BATCH):
        raise NotImplementedError(
            f"scheduler type {sched_type!r}: ROADMAP queue A1 "
            f"(the Server/Worker slice)")
    from .generic_sched import GenericScheduler

    return GenericScheduler(state, planner,
                            batch=sched_type == enums.JOB_TYPE_BATCH,
                            sched_config=sched_config, placer=placer,
                            device=device)
