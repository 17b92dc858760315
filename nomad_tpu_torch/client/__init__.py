"""The client: the agent that runs on every node (a trimmed copy of
``nomad_tpu/client/``; reference client/). It fingerprints the host into
a Node, registers with the server, heartbeats, watches its allocations
and runs them through alloc and task runners on the task drivers.

- fingerprint.py  host discovery -> Node attributes and resources (the
                  CUDA cards as ``nvidia/gpu/<name>`` groups)
- drivers.py      mock, raw_exec, exec and container drivers
- executor.py     the drivers' out-of-process supervisor (stdlib only)
- logmon.py       rotated task stdout/stderr capture
- allocdir.py     alloc/<id>/{alloc,logs,<task>/{local,secrets,tmp}}
- taskenv.py      NOMAD_* env and ${...} interpolation
- task_runner.py  a task's lifecycle with its restart policy
- checks.py       service checks
- alloc_runner.py an allocation's tasks, services and health
- hoststats.py    /v1/client/stats samples
- state_db.py     the client's persisted state, for restarts
- client.py       the agent loop: register, heartbeat, watch, sync
"""

from .client import Client, ClientConfig

__all__ = ["Client", "ClientConfig"]
