"""The replicated control plane: Servers over a raft log (a trimmed copy
of ``nomad_tpu/raft/cluster.py:63-170, 247-290, 405-545, 547-640``).

Each ``ReplicatedServer`` owns a local MVCC store, replicated through its
raft node and the FSM; its Server sees the ``RaftStore`` facade, so
every write the Server, the applier, the workers and the background
actors make is a replicated command. Only the leader's Server runs: it
starts when its raft node wins an election and stops when it steps
down. A call landing on a follower is forwarded to the leader.

With a data directory the log, the term and vote and the snapshots are
durable (``durable.py``; one fsync a group commit), a snapshot is taken
every ``snapshot_threshold`` applied entries, and a crashed server
restarts from its directory (``RaftCluster.restart``): it loads its
snapshot (the store's ``restore``, which makes its feed resync), replays
its log and catches up from the leader.

Two guards keep a failover from placing twice or racing the card:

- a new leader's Server starts only once this term's barrier entry is
  applied locally (``read_index`` then ``wait_applied``), so the evals it
  restores see every placement the old leader committed, and an eval the
  old leader finished is not run again;
- the servers of one cluster share a start gate: ``crash`` holds it
  while it stops the crashed Server (joining its workers), and a new
  leader's Server starts under it. The in-process servers share one
  solver service a card (``tensor.solver.get_service``), so the crashed
  Server's workers are gone before the new leader's first launch.

The HTTP agent (``api/http.py``) takes a ``ReplicatedServer`` as its
``writer``: writes forward to the leader, reads stay on the local
replica behind the read-index round, and the follower-read headers
come from ``known_leader`` and ``last_contact``; ``remove_peer`` is
``DELETE /v1/operator/raft/peer``.

Not ported: gossip and join by address and the socket transport's call
forwarding (they wait for the CLI, ROADMAP A10.2), and the admission
controller with the request tiers it binds (ROADMAP A10.7).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.server import Server, ServerConfig
from ..state import StateStore
from ..utils.backoff import Retryer
from .fsm import FSM, RaftStore
from .node import NotLeaderError, RaftNode
from .transport import InProcTransport

log = logging.getLogger("nomad_tpu_torch.raft")

# the Server calls a follower forwards to the leader
FORWARD = ("register_job", "deregister_job", "scale_job",
           "create_job_eval", "revert_job", "upsert_namespace",
           "delete_namespace", "upsert_node_pool", "delete_node_pool",
           "register_node", "register_nodes", "heartbeat", "heartbeat_batch",
           "update_node_status", "update_node_drain",
           "update_node_eligibility", "deregister_node", "mark_nodes_down",
           "update_allocs_from_client", "update_alloc_desired_transitions",
           "stop_alloc", "create_eval", "set_scheduler_config",
           "promote_deployment", "fail_deployment",
           "register_volume", "deregister_volume", "force_gc",
           "upsert_service_registrations", "delete_service_registrations",
           "delete_services_by_alloc")


class ReplicatedServer:
    def __init__(self, node_id: str, peers: List[str], transport,
                 config: Optional[ServerConfig] = None,
                 peer_lookup: Optional[Callable[[str],
                                                "ReplicatedServer"]] = None,
                 data_dir: Optional[str] = None,
                 snapshot_threshold: int = 1024,
                 start_gate: Optional[threading.Lock] = None,
                 election_timeout: float = 0.3,
                 heartbeat_interval: float = 0.05):
        self.id = node_id
        self.crashed = False
        self.local_store = StateStore()
        self.fsm = FSM(self.local_store)
        self.data_dir = data_dir
        # the Server (and its event broker and feed) is built before the
        # raft node loads a snapshot, so the restore reaches the feed
        self.store = RaftStore(self.local_store, None)
        self.server = Server(config, store=self.store)
        raft_log = stable = snapshots = None
        fsm_snapshot = fsm_restore = None
        fsm_capture = fsm_serialize = None
        if data_dir is not None:
            from ..state.persist import (capture_store, dump_store,
                                         restore_store, serialize_capture)
            from .durable import DurableLog, SnapshotStore, StableStore

            raft_dir = os.path.join(data_dir, "raft")
            os.makedirs(raft_dir, exist_ok=True)
            stable = StableStore(raft_dir)
            snapshots = SnapshotStore(raft_dir)
            raft_log = DurableLog(raft_dir)
            fsm_snapshot = lambda: dump_store(self.local_store)  # noqa: E731
            fsm_restore = lambda data: restore_store(  # noqa: E731
                self.local_store, data)
            # capture pins an MVCC generation under the node lock (O(1));
            # serialization runs on the snapshot worker
            fsm_capture = lambda: capture_store(self.local_store)  # noqa: E731
            fsm_serialize = lambda cap: serialize_capture(  # noqa: E731
                self.local_store, cap)
        self.raft = RaftNode(node_id, peers, transport,
                             self.fsm.apply_prepared,
                             fsm_prepare=self.fsm.prepare,
                             election_timeout=election_timeout,
                             heartbeat_interval=heartbeat_interval,
                             on_leadership=self._on_leadership,
                             log=raft_log, stable=stable,
                             snapshots=snapshots,
                             fsm_snapshot=fsm_snapshot,
                             fsm_restore=fsm_restore,
                             fsm_capture=fsm_capture,
                             fsm_serialize=fsm_serialize,
                             snapshot_threshold=snapshot_threshold)
        self.store._raft = self.raft
        self._peer_lookup = peer_lookup
        self.transport = transport
        self._lock = threading.Lock()
        self._gate = start_gate if start_gate is not None else threading.Lock()
        # set once the leader's Server has started (its evals restored),
        # cleared before it stops: is_leader reads it
        self._serving = False
        # leadership flips run on threads of their own; stop and crash
        # join them
        self._flips: List[threading.Thread] = []

    # -- lifecycle --

    def start(self) -> None:
        self.raft.start()

    def stop(self) -> None:
        with self._lock:
            self._serving = False
            if self.server._running:
                self.server.stop()
        self.raft.stop()
        self._join_flips()

    def crash(self) -> None:
        """An abrupt kill: the node stops answering and sending at once,
        with no leader handoff and no flush beyond what each append
        already fsynced, so the data directory holds what a process
        crash leaves. Restart by building a fresh ReplicatedServer over
        the same directory (``RaftCluster.restart``)."""
        self.crashed = True
        self.transport.unregister(self.id)
        with self._gate:
            self.raft.stop()
            with self._lock:
                self._serving = False
                if self.server._running:
                    self.server.stop()
        self._join_flips()
        # a snapshot write in flight finishes (it is atomic: the old or
        # the new file) before the directory counts as what the crash
        # left; nothing else writes there once the node stopped
        for t in list(self.raft._bg_threads):
            t.join()
        close = getattr(self.raft.log, "close", None)
        if close is not None:
            close()

    def _join_flips(self) -> None:
        for t in self._flips:
            t.join(timeout=30.0)
        self._flips = []

    def _on_leadership(self, is_leader: bool) -> None:
        """Establish or revoke the leader's subsystems (reference
        ``leader.go`` establishLeadership / revokeLeadership), on a
        thread of its own: it runs under the raft node's lock."""
        def flip():
            if is_leader and not self._barrier_applied():
                return
            with self._gate, self._lock:
                if self.crashed:
                    return
                if is_leader and not self.server._running:
                    if self.raft.is_leader():
                        self.server.start()
                        self._serving = True
                elif not is_leader and self.server._running:
                    self._serving = False
                    self.server.stop()

        t = threading.Thread(target=flip, daemon=True,
                             name=f"leadership-{self.id}")
        self._flips = [x for x in self._flips if x.is_alive()] + [t]
        t.start()

    def _barrier_applied(self) -> bool:
        """Wait until this term's barrier entry has committed and this
        replica has applied through it; False when leadership or the
        node went away first."""
        while not self.raft._stop.is_set():
            try:
                index = self.raft.read_index(timeout=1.0)
                self.raft.wait_applied(index, timeout=30.0)
                return True
            except NotLeaderError:
                return False
            except TimeoutError:
                continue
        return False

    # -- the forwarded call surface --

    def is_leader(self) -> bool:
        """This node leads and its Server runs, evals restored."""
        return self.raft.is_leader() and self._serving

    def known_leader(self) -> bool:
        """``X-Nomad-KnownLeader``: does this server know a leader now? A
        crashed or stopped node's last belief is frozen, not current."""
        if self.crashed or self.raft._stop.is_set():
            return False
        return bool(self.raft.leader_id)

    def last_contact(self) -> float:
        """``X-Nomad-LastContact``: seconds since the leader was last
        heard (0.0 on the leader, inf when none ever was)."""
        return self.raft.last_contact_age()

    def remove_peer(self, server_id: str) -> dict:
        """The operator's removal of a server from the raft configuration,
        run on the leader (``operator raft remove-peer``)."""
        for _ in Retryer(deadline_s=10.0, base=0.05, cap=0.5, jitter=0.25):
            if self.raft.is_leader():
                self.raft.remove_server(server_id)
                return {"ok": True}
            peer = self._leader_peer()
            if peer is not None and peer.raft.is_leader():
                peer.raft.remove_server(server_id)
                return {"ok": True}
        raise NotLeaderError(self.raft.leader_id)

    def read_index(self, consistent: bool = False,
                   timeout: float = 2.0) -> int:
        """A linearizable read index from the leader (locally when this
        node leads): the caller waits for its LOCAL store to reach it
        (``wait_applied``) and reads there (Raft section 6.4)."""
        if self.raft.is_leader():
            return self.raft.read_index(timeout=timeout,
                                        lease=not consistent)
        leader = self._leader_peer()
        if leader is None:
            raise NotLeaderError(self.raft.leader_id)
        return leader.raft.read_index(timeout=timeout, lease=not consistent)

    def wait_applied(self, index: int, timeout: float = 5.0) -> None:
        """Wait until the LOCAL FSM reaches a read_index() result."""
        self.raft.wait_applied(index, timeout)

    def _leader_peer(self) -> Optional["ReplicatedServer"]:
        lid = self.raft.leader_id
        if not lid or lid == self.id or self._peer_lookup is None:
            return None
        return self._peer_lookup(lid)

    def _forward(self, name: str, args: tuple, kwargs: dict):
        """Run the call on the leader: locally if this node leads, else
        on the leader's server (reference ``nomad/rpc.go`` forward),
        retrying for up to 5 s while leadership moves."""
        # jittered backoff: during an election every forwarder spins here
        for _ in Retryer(deadline_s=5.0, base=0.02, cap=0.25, jitter=0.5):
            if self.is_leader():
                return getattr(self.server, name)(*args, **kwargs)
            peer = self._leader_peer()
            if peer is not None and peer.is_leader():
                return getattr(peer.server, name)(*args, **kwargs)
        raise NotLeaderError(self.raft.leader_id)

    def __getattr__(self, name: str):
        if name in FORWARD:
            def call(*args, **kwargs):
                return self._forward(name, args, kwargs)

            return call
        raise AttributeError(name)


class RaftCluster:
    """N in-process replicated servers on one transport (the reference's
    multi-server test topology). ``config_fn(i)`` gives server i's
    ServerConfig; its ``device`` is where that server's placer runs (the
    card when unset)."""

    def __init__(self, n: int = 3,
                 config_fn: Optional[Callable[[int], ServerConfig]] = None,
                 data_dir: Optional[str] = None,
                 snapshot_threshold: int = 1024,
                 election_timeout: float = 0.3,
                 heartbeat_interval: float = 0.05):
        self.transport = InProcTransport()
        self._ids = [f"server-{i}" for i in range(n)]
        self._config_fn = config_fn
        self._data_dir = data_dir
        self._opts = dict(snapshot_threshold=snapshot_threshold,
                          election_timeout=election_timeout,
                          heartbeat_interval=heartbeat_interval)
        self._gate = threading.Lock()
        self.servers: Dict[str, ReplicatedServer] = {}
        for i, node_id in enumerate(self._ids):
            node_dir = None
            if data_dir is not None:
                node_dir = os.path.join(data_dir, node_id)
                os.makedirs(node_dir, exist_ok=True)
            self.servers[node_id] = self._build(i, node_id, node_dir)

    def _build(self, i: int, node_id: str,
               node_dir: Optional[str]) -> ReplicatedServer:
        cfg = (self._config_fn(i) if self._config_fn
               else ServerConfig(heartbeat_ttl=30.0))
        return ReplicatedServer(
            node_id, self._ids, self.transport, cfg,
            peer_lookup=self.servers.get, data_dir=node_dir,
            start_gate=self._gate, **self._opts)

    def start(self) -> "RaftCluster":
        for s in self.servers.values():
            s.start()
        return self

    def stop(self) -> None:
        for s in self.servers.values():
            if not s.crashed:
                s.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def crash(self, node_id: str) -> ReplicatedServer:
        """Kill one server abruptly (``ReplicatedServer.crash``); the dead
        instance stays in ``servers`` until ``restart`` replaces it, like
        a dead process whose data directory persists."""
        server = self.servers[node_id]
        server.crash()
        return server

    def restart(self, node_id: str) -> ReplicatedServer:
        """A fresh ReplicatedServer over the crashed one's data
        directory: the durable recovery path of a real restart (without
        a data directory it boots empty and catches up by a snapshot
        install)."""
        old = self.servers[node_id]
        replacement = self._build(self._ids.index(node_id), node_id,
                                  old.data_dir)
        self.servers[node_id] = replacement
        replacement.start()
        return replacement

    def wait_for_leader(self, timeout: float = 10.0
                        ) -> Optional[ReplicatedServer]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            leader = self.leader()
            if leader is not None:
                return leader
            time.sleep(0.02)
        return None

    def leader(self) -> Optional[ReplicatedServer]:
        for s in self.servers.values():
            if not s.crashed and s.is_leader():
                return s
        return None
