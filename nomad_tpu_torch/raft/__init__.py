"""The replicated control plane (a trimmed copy of ``nomad_tpu/raft``):
a compact Raft - elections with leader stickiness, group-commit log
writes, pipelined per-peer replication, batched apply, snapshots with
chunked install, read index and single-server configuration changes -
over an in-process transport. Committed entries feed an FSM that applies
state-store mutations, so every server holds the same MVCC store, and
the leader's Server schedules against its own replica.

- log.py       -- entries and the in-memory log
- durable.py   -- the fsync'd log, the stable term and vote, snapshots
- fsm.py       -- commands as store mutations; the RaftStore facade
- node.py      -- the Raft state machine
- transport.py -- the in-process message bus (partitions, link cuts)
- cluster.py   -- ReplicatedServer (a Server over the log), RaftCluster
"""

from .cluster import RaftCluster, ReplicatedServer
from .node import NotLeaderError, RaftNode

__all__ = ["RaftNode", "RaftCluster", "ReplicatedServer", "NotLeaderError"]
