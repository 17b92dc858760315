"""Scheduler factory (reference ``nomad_tpu/scheduler/scheduler.py``).
Only the service and batch schedulers exist in this slice."""

from __future__ import annotations

from ..structs import enums


def NewScheduler(sched_type: str, state, planner, *, sched_config=None,
                 placer=None, device=None):
    """A scheduler for ``sched_type`` over ``state`` submitting to
    ``planner``; ``device`` is threaded to the placer the scheduler
    builds from its configuration."""
    from .generic_sched import GenericScheduler

    if sched_type not in (enums.JOB_TYPE_SERVICE, enums.JOB_TYPE_BATCH):
        raise NotImplementedError(
            f"scheduler type {sched_type!r}: ROADMAP queue A "
            f"(the Server/Worker slice)")
    return GenericScheduler(state, planner,
                            batch=sched_type == enums.JOB_TYPE_BATCH,
                            sched_config=sched_config, placer=placer,
                            device=device)
