"""The Server's scheduling core (reference ``nomad_tpu/core``), trimmed
to the path that places jobs:

- broker.py      -- EvalBroker: priority queues, per-job serialization,
                    ack/nack redelivery, delayed evals
- blocked.py     -- BlockedEvals: unplaceable evals, class-keyed unblock
- plan_apply.py  -- PlanQueue + the serialized plan applier (the fit
                    re-check, partial commits)
- worker.py      -- scheduler workers: dequeue -> snapshot -> process
- server.py      -- Server: the wiring and the job / node / eval calls

The reference's ``core/metrics.py`` (``REGISTRY``) lives in ``obs/``.
"""

from .server import Server, ServerConfig

__all__ = ["Server", "ServerConfig"]
