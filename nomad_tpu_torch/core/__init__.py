"""The Server's scheduling core (reference ``nomad_tpu/core``), trimmed
to the paths that place jobs and carry allocations through their
lifecycle:

- broker.py      -- EvalBroker: priority queues, per-job serialization,
                    ack/nack redelivery, delayed evals
- blocked.py     -- BlockedEvals: unplaceable evals, class-keyed unblock
- plan_apply.py  -- PlanQueue + the serialized plan applier (the fit
                    re-check, partial commits)
- worker.py      -- scheduler workers: dequeue -> snapshot -> process
- deployments.py -- the canary health rule of the promotion endpoint
- server.py      -- Server: the wiring and the job / node / eval calls
                    and the allocation lifecycle's
- events.py      -- the sharded event broker (the restore sentinel)

The replicated Server and its cluster (``raft/cluster.py``) are exported
here too, loaded on first use: ``raft`` imports ``core``.

The reference's ``core/metrics.py`` (``REGISTRY``) lives in ``obs/``.
"""

from .server import Server, ServerConfig

__all__ = ["Server", "ServerConfig", "RaftCluster", "ReplicatedServer"]


def __getattr__(name: str):
    if name in ("RaftCluster", "ReplicatedServer"):
        from .. import raft

        return getattr(raft, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
