"""The Raft state machine: leader election and log replication (a copy
of ``nomad_tpu/raft/node.py``).

Follows the Raft paper's receiver/sender rules: randomized election
timeouts, term-based vote safety with the up-to-date log check, leader
append-entries with per-peer next/match indexes, and commit advancement
restricted to current-term entries. Committed commands are applied to
the FSM in log order on a dedicated apply thread; leader-side apply()
blocks until the entry is both committed and locally applied, giving
the linearizable write the plan applier needs.

The write path is batched at every stage (hashicorp/raft's leader
loop + group commit, PERF.md "The replicated write path"):

- **Group commit** — apply() enqueues the proposal and a log-writer
  thread drains the whole queue, deep-copies the batch outside the node
  lock, and lands it with ONE buffered write + ONE fsync
  (DurableLog.append_batch). RPC handlers and the tick thread never
  block on client-write disk I/O.
- **Pipelined replication** — one replicator thread per peer, woken by
  a condition variable on every append and commit advance; the timed
  wait doubles as the idle-heartbeat fallback. Catch-up uses the
  follower's conflict hint (conflict_term/first_index) instead of
  decrement-by-one, and followers persist each entry batch with a
  single fsync before acking.
- **Batched apply** — the apply thread applies a whole committed range
  per lock hold with one notify_all; leader-side waiters are per-
  proposal events in a registry (no polling, no unbounded results map).

Spans: ``raft.fsync`` (one a group commit, ``n`` proposals),
``raft.apply`` (one a chunk of committed entries), ``raft.replicate``,
``raft.snapshot_persist`` and ``raft.snapshot_send``; the flight
recorder's ``raft`` ring gets every role change.
"""

from __future__ import annotations

import copy
import json
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import NULL_SPAN, RECORDER, REGISTRY, TRACER
from ..utils.backoff import Retryer
from .durable import MemorySnapshotSink, dumps, snapshot_digest
from .log import Entry, RaftLog

log = logging.getLogger("nomad_tpu_torch.raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

# per-AppendEntries in-flight window (entries per RPC); the replicator
# streams back-to-back windows while a peer has backlog
MAX_APPEND_ENTRIES = 256
# cap on proposals landed per log-writer flush: bounds the size of one
# buffered write (and the blast radius of one fsync fault)
MAX_GROUP_COMMIT = 1024
# committed entries applied per lock hold: large enough to amortize the
# lock, small enough that RPC handlers never stall behind a big backlog
APPLY_CHUNK = 64
# install-snapshot transfer chunk (Raft §7 offset/done protocol): large
# enough to amortize per-frame overhead, small enough that one frame
# never trips the transport's frame cap and a torn transfer wastes
# little resend work
SNAPSHOT_CHUNK_BYTES = 1 << 20


class _Proposal:
    """A leader-side write waiting for commit + local apply. The event
    replaces the old 0.1 s polling wait; `command` doubles as an
    identity token so a result can never be delivered to a waiter whose
    registration lost the append CAS (see _commit_batch). `deadline`
    (absolute, time.time() base) is the end of apply's timeout: the log
    writer drops proposals whose waiter has already given up instead of
    burning an fsync slot on them."""

    __slots__ = ("command", "index", "result", "error", "done", "deadline")

    def __init__(self, command: tuple, deadline: Optional[float] = None):
        self.command = command
        self.index: Optional[int] = None
        self.result: object = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.deadline = deadline


class RaftNode:
    def __init__(self, node_id: str, peers: List[str], transport,
                 fsm_apply: Callable[[tuple], object],
                 election_timeout: float = 0.3,
                 heartbeat_interval: float = 0.05,
                 on_leadership: Optional[Callable[[bool], None]] = None,
                 log=None, stable=None, snapshots=None,
                 fsm_snapshot: Optional[Callable[[], dict]] = None,
                 fsm_restore: Optional[Callable[[dict], None]] = None,
                 snapshot_threshold: int = 1024,
                 peer_addrs: Optional[Dict[str, str]] = None,
                 on_config_change: Optional[Callable[[Dict[str, str]], None]] = None,
                 bootstrap: bool = True,
                 dead_server_cleanup_s: Optional[float] = None,
                 max_append_entries: int = MAX_APPEND_ENTRIES,
                 fsm_capture: Optional[Callable[[], object]] = None,
                 fsm_serialize: Optional[Callable[[object], dict]] = None,
                 snapshot_chunk_bytes: int = SNAPSHOT_CHUNK_BYTES,
                 lease_duration: Optional[float] = None,
                 fsm_prepare: Optional[Callable[[tuple], tuple]] = None):
        self.id = node_id
        # membership: server id -> address ("" when the transport
        # resolves ids directly). Config-change log entries rewrite this
        # at APPEND time (the standard single-server-change rule; see
        # change_config) — reference nomad/server.go AddVoter/
        # RemoveServer via hashicorp/raft.
        self.servers: Dict[str, str] = {node_id: (peer_addrs or {}).get(node_id, "")}
        for p in peers:
            if p != node_id:
                self.servers[p] = (peer_addrs or {}).get(p, "")
        self.peers = [p for p in self.servers if p != node_id]
        self.on_config_change = on_config_change
        # a non-bootstrap node with no peers (a joiner) must NOT elect
        # itself leader of a one-node cluster; it waits to learn the
        # real membership from the leader's append_entries
        self.bootstrap = bootstrap
        self.dead_server_cleanup_s = dead_server_cleanup_s
        self.max_append_entries = max_append_entries
        self._last_contact: Dict[str, float] = {}
        self._config_index = 0  # log index of the latest config entry
        # replication state precedes the durability restore below:
        # a recovered snapshot/log config calls _set_servers_locked, which
        # maintains these
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        # per-peer replicator scheduling: next idle-heartbeat time, the
        # leader commit index last acked down, and the retry-backoff
        # gate for unreachable peers
        self._next_heartbeat: Dict[str, float] = {}
        self._peer_commit: Dict[str, int] = {}
        self._repl_backoff: Dict[str, float] = {}
        self._replicators: Dict[str, threading.Thread] = {}
        self._started = False
        self.transport = transport
        self.fsm_apply = fsm_apply
        # the FSM's copy of a command, made outside the node lock by the
        # apply loop (FSM.prepare); fsm_apply then gets the prepared one
        self.fsm_prepare = fsm_prepare
        self.on_leadership = on_leadership
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        self.state = FOLLOWER
        self.current_term = 0
        self.voted_for: Optional[str] = None
        self.log = log if log is not None else RaftLog()
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[str] = None
        # Leader lease for read_index: a read may skip the heartbeat
        # confirmation round while a quorum of peers acked within this
        # window. Safe at half the election timeout because followers
        # refuse votes while they heard from a live leader within a full
        # election_timeout (_on_request_vote leader-stickiness): by the
        # time a rival CAN win votes, any lease granted on pre-partition
        # acks has expired.
        self.lease_duration = (lease_duration if lease_duration is not None
                               else election_timeout * 0.5)
        # index of this term's barrier noop: reads wait for it to commit
        # (Raft §6.4 / §8 — earlier-term commits aren't known final
        # until a current-term entry commits on top)
        self._term_start_index = 0

        # durability (raft/durable.py); all optional — in-memory otherwise
        self.stable = stable
        self.snapshots = snapshots
        self.fsm_snapshot = fsm_snapshot
        self.fsm_restore = fsm_restore
        self.snapshot_threshold = snapshot_threshold
        # stall-free capture: fsm_capture pins an O(1) MVCC handle under
        # the node lock; fsm_serialize turns it into the snapshot dict on
        # a worker thread, outside the lock. When unset, _maybe_snapshot
        # falls back to the legacy under-lock fsm_snapshot path.
        self.fsm_capture = fsm_capture
        self.fsm_serialize = fsm_serialize
        self.snapshot_chunk_bytes = snapshot_chunk_bytes
        if stable is not None:
            self.current_term = stable.term
            self.voted_for = stable.voted_for
        if snapshots is not None and fsm_restore is not None:
            snap = snapshots.load()
            if snap is not None:
                fsm_restore(snap["data"])
                self.commit_index = snap["index"]
                self.last_applied = snap["index"]
                if snap.get("servers"):
                    self._set_servers_locked(dict(snap["servers"]))
        # the config to fall back to if a log truncation drops the only
        # config entry (snapshot membership, else the bootstrap peers)
        self._fallback_servers = dict(self.servers)
        # membership survives restarts: the latest config entry in the
        # recovered log wins over the snapshot's
        self._recover_config_from_log_locked()
        self._last_leader_contact = 0.0

        self._snap_inflight: set = set()  # peers mid-install-snapshot
        self._snap_active = False  # a local snapshot worker is running
        # follower-side chunk accumulator: {"leader","term","index","sink"}
        self._snap_rx: Optional[dict] = None
        # snapshot worker/sender threads, joined by stop(); pruned on
        # each spawn so the list stays bounded
        self._bg_threads: List[threading.Thread] = []
        self._lock = threading.RLock()
        self._apply_cond = threading.Condition(self._lock)
        # both conditions share the node lock (so notify is race-free
        # with the state they guard) but carry distinct wait-sets: the
        # log-writer sleeps on _propose_cond, replicators on _repl_cond
        self._propose_cond = threading.Condition(self._lock)
        self._repl_cond = threading.Condition(self._lock)
        self._deadline = self._new_deadline()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # the group-commit queue and the waiter registry: proposals wait
        # here for the log-writer, then (keyed by index) for commit +
        # apply. Results without a registered waiter are dropped at
        # apply time — nothing accumulates.
        self._proposals: List[_Proposal] = []
        self._waiters: Dict[int, _Proposal] = {}
        self._autopilot: Optional[threading.Thread] = None

        transport.register(node_id, self.handle)

    # -- lifecycle --

    def start(self) -> None:
        for name, fn in (("tick", self._run_tick),
                         ("apply", self._run_apply),
                         ("logwriter", self._run_log_writer)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"raft-{self.id}-{name}")
            t.start()
            self._threads.append(t)
        with self._lock:
            self._started = True
            self._spawn_replicators_locked()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            # unblock every apply() caller promptly: after stop there is
            # no writer/apply thread left to complete them
            self._fail_waiters_locked(
                lambda: TimeoutError("raft node stopped"))
            self._apply_cond.notify_all()
            self._propose_cond.notify_all()
            self._repl_cond.notify_all()
            repls = list(self._replicators.values())
            bg = list(self._bg_threads)
        for t in self._threads + repls + bg:
            t.join(timeout=2.0)

    def _new_deadline(self) -> float:
        return time.time() + self.election_timeout * (1.0 + random.random())

    # -- public API --

    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    def apply(self, command: tuple, timeout: float = 5.0):
        """Leader-only: replicate a command, wait for commit + local
        apply, return the FSM result. Raises NotLeaderError otherwise. A
        proposal still queued when its timeout passes is dropped before
        it costs an fsync."""
        deadline = time.time() + timeout
        prop = _Proposal(command, deadline=deadline)
        with self._lock:
            if self._stop.is_set():
                raise TimeoutError("raft node stopped")
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            self._proposals.append(prop)
            self._propose_cond.notify()
        return self._await_proposal(prop, deadline)

    def apply_async(self, command: tuple) -> _Proposal:
        """First half of apply: enqueue the command for the group-commit
        log writer and return the proposal handle without waiting.
        Proposals enter the log in apply_async call order, so one caller
        serializing its apply_async calls gets FSM apply order equal to
        its propose order — the ordering contract the plan applier's
        pipelined commit rounds depend on."""
        prop = _Proposal(command)
        with self._lock:
            if self._stop.is_set():
                raise TimeoutError("raft node stopped")
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            self._proposals.append(prop)
            self._propose_cond.notify()
        return prop

    def apply_wait(self, prop: _Proposal, timeout: float = 5.0):
        """Second half of apply_async: wait for commit + local apply,
        return the FSM result. Same timeout/step-down semantics as
        apply; safe to call at most once per proposal."""
        return self._await_proposal(prop, time.time() + timeout)

    def _await_proposal(self, prop: _Proposal, deadline: float):
        prop.done.wait(max(0.0, deadline - time.time()))
        if not prop.done.is_set():
            with self._lock:
                # completion may have raced the timeout: every
                # completion path holds the lock, so re-check under it
                if not prop.done.is_set():
                    # unregister so the result landing later finds no
                    # waiter and is dropped instead of leaking
                    try:
                        self._proposals.remove(prop)
                    except ValueError:
                        pass
                    if prop.index is not None \
                            and self._waiters.get(prop.index) is prop:
                        del self._waiters[prop.index]
                    idx = prop.index if prop.index is not None else "?"
                    raise TimeoutError(f"apply of index {idx} timed out")
        if prop.error is not None:
            raise prop.error
        return prop.result

    def _fail_waiters_locked(self, make_err: Callable[[], BaseException]) -> None:
        """Complete every queued proposal and registered waiter with an
        error (step-down / stop). Call with the lock held."""
        stale = list(self._proposals) + list(self._waiters.values())
        self._proposals.clear()
        self._waiters.clear()
        for p in stale:
            if not p.done.is_set():
                p.error = make_err()
                p.done.set()

    # -- group commit (the log-writer thread) --

    def _run_log_writer(self) -> None:
        while not self._stop.is_set():
            with self._propose_cond:
                while not self._proposals and not self._stop.is_set():
                    self._propose_cond.wait(0.5)
                if self._stop.is_set():
                    return
                batch = self._proposals[:MAX_GROUP_COMMIT]
                del self._proposals[:MAX_GROUP_COMMIT]
            # Freeze the payloads at the propose boundary
            # (ROBUSTNESS.md): callers keep mutating their structs after
            # proposing, and a log entry aliasing them would retransmit
            # the MUTATED payload to a follower that catches up later.
            # Copying here — off the caller threads and outside the node
            # lock — is the point of the log-writer: serialization cost
            # never stalls RPC handlers or the tick thread.
            # deadline propagation: a proposal whose waiter
            # already gave up (deadline passed while queued) is dropped
            # BEFORE it costs a serialize + fsync slot — capacity spent
            # on replies nobody awaits is how overload collapses
            now = time.time()
            live = []
            for p in batch:
                if (p.deadline is not None and now >= p.deadline
                        and not p.done.is_set()):
                    REGISTRY.incr("nomad.load.expired_drops")
                    REGISTRY.incr("nomad.load.expired_drops.raft_logwriter")
                    p.error = TimeoutError(
                        "proposal deadline expired before append")
                    p.done.set()
                    continue
                live.append(p)
            if not live:
                continue
            for p in live:
                p.command = copy.deepcopy(p.command)
            self._commit_batch(live)

    def _commit_batch(self, batch: List[_Proposal]) -> None:
        """Land a drained batch: one buffered write + one fsync via
        DurableLog.append_batch, outside the node lock. The append is
        CAS-guarded on the log tail: if a config entry, a new leader's
        noop, or a post-step-down truncation moved the tail while we
        were unlocked, the append refuses and we re-read the world."""
        while True:
            with self._lock:
                if self._stop.is_set() or self.state != LEADER:
                    stopped = self._stop.is_set()
                    for p in batch:
                        if not p.done.is_set():
                            p.error = (TimeoutError("raft node stopped")
                                       if stopped
                                       else NotLeaderError(self.leader_id))
                            p.done.set()
                    return
                term = self.current_term
                last_index, last_term = self.log.last()
                # register waiters BEFORE the disk write: the CAS pins
                # the indexes, and registering now means an ack that
                # races the fsync can commit + apply the entry and still
                # find its waiter. A registration that loses the CAS is
                # unregistered below; the apply loop's identity check
                # (waiter.command is entry.command) makes a stale
                # registration unable to swallow someone else's result.
                for i, p in enumerate(batch):
                    p.index = last_index + 1 + i
                    self._waiters[p.index] = p
            try:
                # the group-commit fsync: one durable write per batch
                with TRACER.span("raft.fsync", n=len(batch)):
                    entries = self.log.append_batch(
                        term, [p.command for p in batch],
                        prev=(last_index, last_term))
            except OSError as e:
                # disk fault: the log rolled the whole batch back;
                # surface the error to every caller in it
                with self._lock:
                    for p in batch:
                        if self._waiters.get(p.index) is p:
                            del self._waiters[p.index]
                        if not p.done.is_set():
                            p.error = e
                            p.done.set()
                return
            if entries is not None:
                break
            with self._lock:
                for p in batch:
                    if self._waiters.get(p.index) is p:
                        del self._waiters[p.index]
        with self._lock:
            self._maybe_advance_commit_locked()
            self._repl_cond.notify_all()

    # -- membership (reference nomad/server.go:1602 join,
    #    nomad/autopilot.go dead-server cleanup) --

    def _set_servers_locked(self, servers: Dict[str, str]) -> None:
        """Install a membership set (call with the lock held or from
        __init__). Takes effect immediately — Raft's single-server
        change rule applies configs at append, not commit."""
        self.servers = dict(servers)
        self.peers = [p for p in self.servers if p != self.id]
        for p in self.peers:
            self._next_index.setdefault(p, 1)
            self._match_index.setdefault(p, 0)
        for gone in [p for p in list(self._match_index) if p not in self.servers]:
            self._match_index.pop(gone, None)
            self._next_index.pop(gone, None)
            self._last_contact.pop(gone, None)
            self._next_heartbeat.pop(gone, None)
            self._peer_commit.pop(gone, None)
            self._repl_backoff.pop(gone, None)
        self._spawn_replicators_locked()
        if self.on_config_change is not None:
            try:
                self.on_config_change(dict(self.servers))
            except Exception:
                log.debug("on_config_change callback failed on %s",
                          self.id, exc_info=True)

    def _spawn_replicators_locked(self) -> None:
        """One replicator thread per peer (call with the lock held).
        A thread whose peer leaves the config exits on its own; a peer
        that rejoins gets a fresh thread here."""
        if not self._started or self._stop.is_set():
            return
        for p in self.peers:
            t = self._replicators.get(p)
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._run_replicator, args=(p,),
                                     daemon=True,
                                     name=f"raft-{self.id}-repl-{p}")
                self._replicators[p] = t
                t.start()

    def _recover_config_from_log_locked(self, reset_on_missing: bool = False) -> None:
        base = getattr(self.log, "base_index", 0)
        last, _ = self.log.last()
        idx = base + 1
        latest = None
        while idx <= last:
            chunk = self.log.slice_from(idx)
            if not chunk:
                break
            for e in chunk:
                if tuple(e.command)[:1] == ("config",):
                    latest = (e.index, e.command[1][0])
            idx = chunk[-1].index + 1
        if latest is not None:
            self._config_index = latest[0]
            self._set_servers_locked(dict(latest[1]))
        elif reset_on_missing:
            # a truncation dropped the only config entry: the membership
            # applied at append time must revert to the snapshot /
            # bootstrap configuration, not linger
            self._config_index = 0
            self._set_servers_locked(dict(self._fallback_servers))

    def change_config(self, servers: Dict[str, str], timeout: float = 5.0):
        """Leader-only single-server membership change: append a config
        entry (effective immediately), replicate, wait for commit. One
        change at a time — a second change while the first is
        uncommitted is refused (the safety condition the one-at-a-time
        rule depends on)."""
        with self._lock:
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            if self._config_index > self.commit_index:
                raise ConfigInProgressError()
            cur, new = set(self.servers), set(servers)
            if len(cur.symmetric_difference(new)) > 1:
                raise ValueError("membership changes must add or remove "
                                 "one server at a time")
            entry = self.log.append(self.current_term,
                                    ("config", (dict(servers),), {}))
            self._config_index = entry.index
            self._set_servers_locked(servers)
            index = entry.index
            self._maybe_advance_commit_locked()
            self._repl_cond.notify_all()
        deadline = time.time() + timeout
        with self._apply_cond:
            while self.commit_index < index:
                if self.state != LEADER:
                    # stepped down while the change replicated — the
                    # entry may still commit under the new leader, but
                    # this node can no longer confirm it; fail fast
                    # (NotLeaderError = "outcome unknown") instead of
                    # spinning out the full timeout
                    raise NotLeaderError(self.leader_id)
                remaining = deadline - time.time()
                if remaining <= 0 or self._stop.is_set():
                    raise TimeoutError(f"config change {index} timed out")
                self._apply_cond.wait(min(remaining, 0.5))

    def add_server(self, server_id: str, addr: str = "",
                   timeout: float = 5.0) -> None:
        with self._lock:
            if server_id in self.servers:
                return
            servers = dict(self.servers)
        servers[server_id] = addr
        self.change_config(servers, timeout=timeout)

    def remove_server(self, server_id: str, timeout: float = 5.0) -> None:
        if server_id == self.id:
            raise ValueError("cannot remove the current leader; "
                             "demote it by electing another first")
        with self._lock:
            if server_id not in self.servers:
                raise KeyError(f"no such server {server_id!r}")
            servers = {k: v for k, v in self.servers.items()
                       if k != server_id}
        self.change_config(servers, timeout=timeout)

    def _dead_server_cleanup(self) -> None:
        """Leader-side autopilot: remove ONE server that has been
        unreachable past the threshold, but only while the healthy
        majority stands without it (reference nomad/autopilot.go
        CleanupDeadServers)."""
        threshold = self.dead_server_cleanup_s
        now = time.time()
        with self._lock:
            if self.state != LEADER or threshold is None:
                return
            if self._config_index > self.commit_index:
                return
            healthy = 1 + sum(
                1 for p in self.peers
                if now - self._last_contact.get(p, 0.0) < threshold)
            dead = [p for p in self.peers
                    if self._last_contact.get(p) is not None
                    and now - self._last_contact[p] >= threshold]
            if not dead or healthy * 2 <= len(self.servers):
                return
            victim = dead[0]
        try:
            self.remove_server(victim, timeout=2.0)
        except (NotLeaderError, ConfigInProgressError, TimeoutError,
                ValueError, KeyError):
            pass

    # -- message handling (the RPC receiver rules) --

    def handle(self, msg: dict) -> dict:
        kind = msg["kind"]
        if kind == "request_vote":
            return self._on_request_vote(msg)
        if kind == "append_entries":
            return self._on_append_entries(msg)
        if kind == "install_snapshot":
            return self._on_install_snapshot(msg)
        raise ValueError(f"unknown raft message {kind}")

    def _persist_vote(self) -> None:
        """Term and vote must hit disk before any reply leaves this node
        (the Raft persistent-state rule)."""
        if self.stable is not None:
            self.stable.save(self.current_term, self.voted_for)

    def _on_request_vote(self, msg: dict) -> dict:
        with self._lock:
            # Leader stickiness (Raft thesis §4.2.3, hashicorp/raft's
            # check): while we hear from a live leader, a campaigner's
            # ever-growing term must not depose it — the canonical case
            # is a REMOVED server that no longer receives heartbeats and
            # campaigns forever. Non-members get no votes at all.
            recent = time.time() - self._last_leader_contact < self.election_timeout
            candidate = msg["candidate"]
            if recent or candidate not in self.servers:
                return {"term": self.current_term, "granted": False}
            term = msg["term"]
            if term > self.current_term:
                self._become_follower_locked(term)
            granted = False
            if term == self.current_term and self.voted_for in (None, msg["candidate"]):
                last_index, last_term = self.log.last()
                up_to_date = (msg["last_log_term"], msg["last_log_index"]) >= \
                    (last_term, last_index)
                if up_to_date:
                    granted = True
                    self.voted_for = msg["candidate"]
                    self._persist_vote()
                    self._deadline = self._new_deadline()
            return {"term": self.current_term, "granted": granted}

    def _conflict_hint_locked(self, prev_index: int) -> dict:
        """Follower-side catch-up hint on a prev-entry mismatch
        (hashicorp/raft / the Raft paper's fast-backtracking note):
        conflict_term is the term of our entry at prev_index and
        first_index the first index of that term, so the leader jumps a
        whole term per round trip instead of decrementing by one."""
        last_index, _ = self.log.last()
        base = getattr(self.log, "base_index", 0)
        if prev_index > last_index:
            return {"conflict_term": 0, "first_index": last_index + 1}
        ct = self.log.term_at(prev_index)
        if ct < 0:
            # prev_index fell below our snapshot base: everything up to
            # the base is committed state, resync from just past it
            return {"conflict_term": 0, "first_index": base + 1}
        fi = prev_index
        while fi - 1 > base and self.log.term_at(fi - 1) == ct:
            fi -= 1
        return {"conflict_term": ct, "first_index": fi}

    def _on_append_entries(self, msg: dict) -> dict:
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower_locked(term)
            self.leader_id = msg["leader"]
            self._deadline = self._new_deadline()
            self._last_leader_contact = time.time()

            prev_index = msg["prev_log_index"]
            prev_term = msg["prev_log_term"]
            if prev_index > 0 and self.log.term_at(prev_index) != prev_term:
                reply = {"term": self.current_term, "success": False}
                reply.update(self._conflict_hint_locked(prev_index))
                return reply
            entries = [Entry(**e) if isinstance(e, dict) else e
                       for e in msg["entries"]]
            if entries:
                # the whole batch lands with a single buffered write +
                # fsync (DurableLog.append_entries) before the ack below
                truncated = self.log.append_entries(prev_index, entries)
                # the election clock restarts when the entries are
                # processed, not only when they arrived: a large batch
                # can take longer to write than the timeout
                self._deadline = self._new_deadline()
                configs = [e for e in entries
                           if tuple(e.command)[:1] == ("config",)]
                if truncated and not configs:
                    # a dropped conflicting suffix may have contained a
                    # config entry: recompute membership from the log
                    self._recover_config_from_log_locked(reset_on_missing=True)
                elif configs:
                    last_cfg = configs[-1]
                    self._config_index = last_cfg.index
                    self._set_servers_locked(dict(last_cfg.command[1][0]))
            leader_commit = msg["leader_commit"]
            if leader_commit > self.commit_index:
                # cap at the last entry this RPC verified, not our last
                # log index: a stale divergent tail past prev+len must
                # never be committed by a leader_commit that refers to
                # the leader's (different) entries at those indexes
                new_commit = min(leader_commit, prev_index + len(entries))
                if new_commit > self.commit_index:
                    self.commit_index = new_commit
                    self._apply_cond.notify_all()
            return {"term": self.current_term,
                    "success": True,
                    "match_index": prev_index + len(entries)}

    def _on_install_snapshot(self, msg: dict) -> dict:
        """Follower-side snapshot install: the leader compacted past the
        entries this node needs (Raft §7 / hashicorp/raft InstallSnapshot).
        Chunked transfers (offset/done protocol) carry an "offset" key;
        the legacy single-frame form ships the whole dict in "data"."""
        if "offset" in msg:
            return self._on_install_snapshot_chunk(msg)
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower_locked(term)
            self.leader_id = msg["leader"]
            self._deadline = self._new_deadline()
            self._last_leader_contact = time.time()
            index, snap_term = msg["index"], msg["snap_term"]
            if index <= self.last_applied:
                return {"term": self.current_term, "success": True,
                        "match_index": self.last_applied}
            if self.fsm_restore is None:
                return {"term": self.current_term, "success": False}
            try:
                self._install_locked(index, snap_term, msg["data"], None,
                                     msg.get("servers"))
            except OSError as e:
                log.warning("install_snapshot persist failed on %s: %s",
                            self.id, e)
                return {"term": self.current_term, "success": False}
            return {"term": self.current_term, "success": True,
                    "match_index": index}

    def _install_locked(self, index: int, snap_term: int, data: dict,
                        data_text: Optional[str],
                        servers: Optional[dict]) -> None:
        """Shared install tail, node lock held. Ordering is deliberate:
        persist the snapshot FIRST, then truncate the log, then mutate
        memory — a crash between any two steps leaves a state the normal
        recovery path reads back correctly (the saved snapshot's base
        makes stale log entries skippable; see DurableLog._load)."""
        if self.snapshots is not None:
            if data_text is not None:
                self.snapshots.save_raw(index, snap_term, data_text,
                                        servers=servers or self.servers)
            else:
                self.snapshots.save(index, snap_term, data,
                                    servers=servers or self.servers)
        if hasattr(self.log, "reset_to"):
            self.log.reset_to(index, snap_term)
        if servers:
            self._set_servers_locked(dict(servers))
        self.fsm_restore(data)
        self.commit_index = max(self.commit_index, index)
        self.last_applied = index
        self._apply_cond.notify_all()
        # installs can take seconds at C2M scale: restart the election
        # clock so the node doesn't immediately campaign against the
        # leader that just fed it
        self._deadline = self._new_deadline()

    def _on_install_snapshot_chunk(self, msg: dict) -> dict:
        """One frame of a chunked InstallSnapshot (Raft §7). Chunks
        accumulate in a sink (temp file beside snapshot.json when
        durable); nothing is restored until the final frame's digest
        verifies over the whole body, so a crash, disconnect, or
        leadership change mid-transfer leaves the old state intact."""
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower_locked(term)
            self.leader_id = msg["leader"]
            self._deadline = self._new_deadline()
            self._last_leader_contact = time.time()
            index, snap_term = msg["index"], msg["snap_term"]
            if index <= self.last_applied:
                return {"term": self.current_term, "success": True,
                        "match_index": self.last_applied}
            if self.fsm_restore is None:
                return {"term": self.current_term, "success": False}
            rx = self._snap_rx
            if (rx is None or rx["leader"] != msg["leader"]
                    or rx["term"] != term or rx["index"] != index):
                if rx is not None:
                    rx["sink"].discard()
                sink = (self.snapshots.sink() if self.snapshots is not None
                        else MemorySnapshotSink())
                rx = self._snap_rx = {"leader": msg["leader"], "term": term,
                                      "index": index, "sink": sink}
            sink = rx["sink"]
            if msg["offset"] != sink.offset:
                # resume protocol: tell the leader where to rewind to
                return {"term": self.current_term, "success": False,
                        "offset": sink.offset}
            try:
                sink.write(msg["data"])
            except OSError as e:
                log.warning("snapshot chunk write failed on %s: %s",
                            self.id, e)
                sink.discard()
                self._snap_rx = None
                return {"term": self.current_term, "success": False,
                        "offset": 0}
            if not msg.get("done"):
                return {"term": self.current_term, "success": True,
                        "offset": sink.offset}
            self._snap_rx = None
        # final frame: verify + decode outside the lock (json.loads of a
        # C2M snapshot takes seconds; applies/heartbeats must not stall)
        text = sink.read_all()
        ok = (len(text) == msg["total"]
              and snapshot_digest(text) == msg["digest"])
        data = None
        if ok:
            try:
                data = json.loads(text)
            except ValueError:
                ok = False
        if not ok:
            log.warning("snapshot transfer to %s failed verification "
                        "(%d bytes)", self.id, len(text))
            sink.discard()
            return {"term": self.current_term, "success": False,
                    "offset": 0}
        with self._lock:
            if (msg["term"] != self.current_term or self.state != FOLLOWER
                    or index <= self.last_applied):
                sink.discard()
                return {"term": self.current_term, "success": False,
                        "offset": 0}
            try:
                self._install_locked(index, snap_term, data, text,
                                     msg.get("servers"))
            except OSError as e:
                log.warning("install_snapshot persist failed on %s: %s",
                            self.id, e)
                sink.discard()
                return {"term": self.current_term, "success": False,
                        "offset": 0}
            sink.discard()
            return {"term": self.current_term, "success": True,
                    "match_index": index}

    def _maybe_snapshot(self) -> None:
        """Apply-thread only: snapshot the FSM and compact the log once
        enough entries accumulated past the last snapshot boundary. With
        an MVCC-capable FSM (fsm_capture/fsm_serialize wired) the work
        runs on a worker thread and only the O(1) capture happens under
        the node lock; otherwise the legacy under-lock path runs."""
        if self.snapshots is None:
            return
        if not hasattr(self.log, "compact"):
            return
        if self.fsm_capture is not None and self.fsm_serialize is not None:
            return self._maybe_snapshot_async()
        if self.fsm_snapshot is None:
            return
        with self._lock:
            base = getattr(self.log, "base_index", 0)
            applied = self.last_applied
            if applied - base < self.snapshot_threshold:
                return
            term = self.log.term_at(applied)
            if term < 0:
                return
            # only this thread mutates the FSM, and holding the lock
            # blocks install_snapshot, so the dump matches `applied`
            data = self.fsm_snapshot()
            self.snapshots.save(applied, term, data, servers=self.servers)
            self.log.compact(applied, term)

    def _maybe_snapshot_async(self) -> None:
        """Stall-free variant: pin an MVCC handle + (applied, term) under
        the lock, then serialize/write/compact on a dedicated worker.
        Concurrent applies, heartbeats, and elections proceed; a CAS on
        (last_applied, base_index) discards the compaction if an
        install_snapshot raced in."""
        with self._lock:
            if self._snap_active:
                return
            base = getattr(self.log, "base_index", 0)
            applied = self.last_applied
            if applied - base < self.snapshot_threshold:
                return
            term = self.log.term_at(applied)
            if term < 0:
                return
            try:
                capture = self.fsm_capture()
            except Exception as e:
                log.warning("snapshot capture failed on %s: %s", self.id, e)
                return
            servers = dict(self.servers)
            self._snap_active = True
            t = threading.Thread(
                target=self._snapshot_worker,
                args=(capture, applied, term, servers, base),
                daemon=True, name=f"raft-{self.id}-snapshot")
            self._bg_threads = [x for x in self._bg_threads
                                if x.is_alive()] + [t]
        t.start()

    def _snapshot_worker(self, capture, applied: int, term: int,
                         servers: dict, base: int) -> None:
        try:
            with TRACER.span("raft.snapshot_persist", node=self.id,
                             index=applied):
                try:
                    data = self.fsm_serialize(capture)
                finally:
                    close = getattr(capture, "close", None)
                    if close is not None:
                        close()
                saved = self.snapshots.save(applied, term, data,
                                            servers=servers,
                                            only_if_newer=True)
            if not saved:
                return
            with self._lock:
                # CAS: an install_snapshot that raced in moved the base
                # (and possibly last_applied) — its snapshot supersedes
                # ours, so compacting to `applied` would be wrong/no-op
                if (self._stop.is_set() or self.last_applied < applied
                        or getattr(self.log, "base_index", 0) != base):
                    return
            # the log has its own lock; compacting outside the node lock
            # keeps the fsync off the commit path. A reset_to that lands
            # between the CAS and here moves base past `applied`, which
            # makes this compact a no-op inside DurableLog.
            self.log.compact(applied, term)
        except OSError as e:
            # disk fault mid-save: atomic_write left the previous
            # snapshot loadable; skip compaction and retry next round
            log.warning("snapshot persist failed on %s: %s", self.id, e)
        except Exception:
            log.exception("snapshot worker crashed on %s", self.id)
        finally:
            with self._lock:
                self._snap_active = False

    # -- roles --

    def _become_follower_locked(self, term: int) -> None:
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        RECORDER.record("raft", "follower", node=self.id, term=term,
                        was_leader=was_leader)
        # Vote safety: voted_for is per-term state, so it only resets when
        # the term advances. A same-term step-down (e.g. a candidate seeing
        # the elected leader's heartbeat) must keep its recorded vote, or it
        # could grant a second vote in the same term.
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_vote()
        self._deadline = self._new_deadline()
        # leader-side writes can't complete any more: fail queued
        # proposals and registered waiters instead of letting callers
        # hang to their timeout (the entry may still commit under the
        # new leader — NotLeaderError means "outcome unknown", exactly
        # the old wake-time semantics)
        self._fail_waiters_locked(lambda: NotLeaderError(self.leader_id))
        # wake commit-index waiters (change_config) so they observe the
        # step-down now rather than at their next poll tick
        self._apply_cond.notify_all()
        if was_leader and self.on_leadership:
            self.on_leadership(False)

    def _become_leader_locked(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        RECORDER.record("raft", "leader", node=self.id,
                        term=self.current_term)
        last_index, _ = self.log.last()
        now = time.time()
        for p in self.peers:
            self._next_index[p] = last_index + 1
            self._match_index[p] = 0
            # autopilot clocks restart at tenure: a server that was
            # already dead before this leadership still times out and
            # gets cleaned up, and stale timestamps from an earlier
            # tenure can't condemn a healthy peer instantly
            self._last_contact[p] = now
            self._next_heartbeat[p] = 0.0
            self._peer_commit[p] = 0
            self._repl_backoff.pop(p, None)
        # Barrier entry: commit counting skips prior-term entries, so without
        # a fresh current-term entry, anything replicated under the old
        # leader stays uncommitted until the next client write. The no-op
        # commits promptly and drags predecessors with it (hashicorp/raft
        # does the same).
        self._term_start_index = self.log.append(
            self.current_term, ("noop", (), {})).index
        self._maybe_advance_commit_locked()
        self._repl_cond.notify_all()
        if self.on_leadership:
            self.on_leadership(True)

    def _start_election(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.current_term += 1
            self.voted_for = self.id
            self._persist_vote()
            term = self.current_term
            self._deadline = self._new_deadline()
            last_index, last_term = self.log.last()
            RECORDER.record("raft", "candidate", node=self.id, term=term)
        votes = 1
        for p in self.peers:
            reply = self.transport.send(self.id, p, {
                "kind": "request_vote", "term": term, "candidate": self.id,
                "last_log_index": last_index, "last_log_term": last_term,
            })
            if reply is None:
                continue
            with self._lock:
                if reply["term"] > self.current_term:
                    self._become_follower_locked(reply["term"])
                    return
            if reply.get("granted"):
                votes += 1
        with self._lock:
            if self.state == CANDIDATE and self.current_term == term \
                    and votes * 2 > len(self.peers) + 1:
                self._become_leader_locked()

    # -- ticker (election deadlines + autopilot; replication moved to
    #    the per-peer replicator threads) --

    def _run_tick(self) -> None:
        last_cleanup = time.time()
        while not self._stop.wait(self.heartbeat_interval / 2):
            with self._lock:
                state = self.state
                expired = time.time() >= self._deadline
                # a joiner (bootstrap=False) that still only knows
                # itself must not elect itself leader of a one-node
                # cluster; it waits for the real membership
                can_elect = self.bootstrap or len(self.servers) > 1
            if state == LEADER:
                if (self.dead_server_cleanup_s is not None
                        and time.time() - last_cleanup >= 1.0):
                    last_cleanup = time.time()
                    # off-thread: remove_server blocks on commit and
                    # must not stall the tick. ONE outstanding worker:
                    # a removal blocked on commit used to leak a new
                    # thread every second on top of the stuck one.
                    t = self._autopilot
                    if t is None or not t.is_alive():
                        t = threading.Thread(
                            target=self._dead_server_cleanup,
                            daemon=True,
                            name=f"raft-{self.id}-autopilot")
                        self._autopilot = t
                        t.start()
            elif expired and can_elect:
                self._start_election()

    # -- replication (one pipelined replicator thread per peer) --

    def _repl_due_locked(self, peer: str, now: float) -> bool:
        """Does this peer need a send right now? (call with the lock
        held). True on: idle-heartbeat due, backlog to ship, or a commit
        advance the peer hasn't heard. The backoff gate keeps a dead
        peer from turning backlog into a hot retry loop."""
        if self.state != LEADER:
            return False
        if now < self._repl_backoff.get(peer, 0.0):
            return False
        if now >= self._next_heartbeat.get(peer, 0.0):
            return True
        if peer in self._snap_inflight:
            return False
        last_index, _ = self.log.last()
        if last_index >= self._next_index.get(peer, 1):
            return True
        return self.commit_index > self._peer_commit.get(peer, 0)

    def _run_replicator(self, peer: str) -> None:
        """Wake-on-propose replication: the log-writer (and commit
        advancement) notify _repl_cond; the timed wait is the idle-
        heartbeat fallback that replaces the old tick-paced fan-out."""
        while not self._stop.is_set():
            with self._repl_cond:
                while not self._stop.is_set() and peer in self.servers \
                        and not self._repl_due_locked(peer, time.time()):
                    self._repl_cond.wait(self.heartbeat_interval / 2)
                if self._stop.is_set():
                    return
                if peer not in self.servers:
                    # peer left the configuration; a rejoin spawns a
                    # fresh thread (_spawn_replicators_locked)
                    if self._replicators.get(peer) is threading.current_thread():
                        self._replicators.pop(peer, None)
                    return
            self._replicate(peer)

    def _replicate(self, peer: str) -> None:
        now = time.time()
        with self._lock:
            if self.state != LEADER or peer not in self.servers:
                return
            term = self.current_term
            next_idx = self._next_index.get(peer, 1)
            base = getattr(self.log, "base_index", 0)
            self._next_heartbeat[peer] = now + self.heartbeat_interval
            if next_idx <= base:
                return self._send_snapshot_locked(peer, term, base)
            prev_index = next_idx - 1
            prev_term = self.log.term_at(prev_index)
            entries = self.log.slice_from(next_idx,
                                          self.max_append_entries)
            commit = self.commit_index
        # span only when entries ship — idle heartbeats would drown the
        # trace in zero-payload sends
        ctx = (TRACER.span("raft.replicate", peer=peer, n=len(entries))
               if entries else NULL_SPAN)
        with ctx:
            reply = self.transport.send(self.id, peer, {
                "kind": "append_entries", "term": term, "leader": self.id,
                "prev_log_index": prev_index, "prev_log_term": prev_term,
                "entries": [{"index": e.index, "term": e.term,
                             "command": e.command} for e in entries],
                "leader_commit": commit,
            })
        with self._lock:
            if reply is None:
                # unreachable: retry at heartbeat cadence, not hot-loop
                self._repl_backoff[peer] = time.time() + self.heartbeat_interval
                return
            if reply["term"] > self.current_term:
                self._become_follower_locked(reply["term"])
                return
            if self.state != LEADER or reply["term"] != self.current_term:
                return
            self._last_contact[peer] = time.time()
            self._repl_backoff.pop(peer, None)
            if reply["success"]:
                self._match_index[peer] = max(self._match_index.get(peer, 0),
                                              reply["match_index"])
                self._next_index[peer] = self._match_index[peer] + 1
                self._peer_commit[peer] = commit
                self._maybe_advance_commit_locked()
            else:
                self._next_index[peer] = \
                    self._conflict_next_index_locked(reply, next_idx)

    def _conflict_next_index_locked(self, reply: dict, next_idx: int) -> int:
        """Leader-side fast backtrack from a follower's conflict hint
        (call with the lock held). If we have entries of the conflicting
        term, resend from just past our last one; otherwise jump all the
        way to the follower's first index of that term. Falls back to
        decrement-by-one against a peer that sent no hint."""
        first_index = reply.get("first_index")
        if not first_index:
            return max(1, next_idx - 1)
        conflict_term = reply.get("conflict_term", 0)
        base = getattr(self.log, "base_index", 0)
        if conflict_term:
            idx = min(next_idx - 1, self.log.last()[0])
            while idx > base and self.log.term_at(idx) > conflict_term:
                idx -= 1
            if idx > base and self.log.term_at(idx) == conflict_term:
                return idx + 1
        return max(1, min(first_index, next_idx - 1))

    def _send_snapshot_locked(self, peer: str, term: int, base: int) -> None:
        """The peer needs entries the log compacted away: stream the
        snapshot in chunks instead (call with the lock held — the
        _snap_inflight reservation below relies on it; the transfer
        itself runs on a spawned thread outside the lock). At most one
        install per peer in flight — a full-state transfer outlives any
        replication round."""
        if self.snapshots is None or peer in self._snap_inflight:
            return
        self._snap_inflight.add(peer)
        t = threading.Thread(target=self._snapshot_sender, args=(peer, term),
                             daemon=True,
                             name=f"raft-{self.id}-snap-{peer}")
        self._bg_threads = [x for x in self._bg_threads
                            if x.is_alive()] + [t]
        t.start()

    def _snapshot_sender(self, peer: str, term: int) -> None:
        """Chunked InstallSnapshot transfer (Raft §7 offset/done).
        Fixed-size frames ride the "snap" transport channel; a None
        reply (peer unreachable) backs off via Retryer and resumes at
        the follower-reported offset on reconnect. Leadership loss,
        stop, or a higher term abort the transfer — the follower's
        accumulated chunks are simply superseded or discarded."""
        try:
            snap = self.snapshots.load()
            if snap is None:
                return
            index, snap_term = snap["index"], snap["term"]
            text = dumps(snap["data"])
            digest = snapshot_digest(text)
            total = len(text)
            with self._lock:
                servers = dict(self.servers)
            offset = 0
            with TRACER.span("raft.snapshot_send", peer=peer, index=index,
                             bytes=total):
                # each Retryer pass is one connection attempt; progress
                # resets backoff by starting a fresh Retryer
                while not self._stop.is_set():
                    retryer = Retryer(deadline_s=None, stop=self._stop,
                                      base=self.heartbeat_interval,
                                      cap=2.0)
                    progressed = False
                    for _ in retryer:
                        outcome, offset = self._push_snapshot_chunks(
                            peer, term, index, snap_term, text, digest,
                            total, servers, offset)
                        if outcome == "done":
                            return
                        if outcome == "progress":
                            progressed = True
                            break  # fresh Retryer → backoff resets
                    if not progressed:
                        return
        except Exception:
            log.exception("snapshot sender to %s crashed", peer)
        finally:
            with self._lock:
                self._snap_inflight.discard(peer)

    def _push_snapshot_chunks(self, peer: str, term: int, index: int,
                              snap_term: int, text: str, digest: str,
                              total: int, servers: dict, offset: int):
        """Send frames from `offset` until the transfer completes, the
        peer rewinds us, or the peer stops answering. Returns
        (outcome, next_offset): "done" = finished or aborted for good,
        "progress" = at least one frame landed before a None reply
        (caller resets backoff), "retry" = unreachable with no
        progress."""
        chunk = self.snapshot_chunk_bytes
        made_progress = False
        while True:
            with self._lock:
                if (self._stop.is_set() or self.state != LEADER
                        or self.current_term != term):
                    return "done", offset
            done = offset + chunk >= total
            msg = {"kind": "install_snapshot", "term": term,
                   "leader": self.id, "index": index,
                   "snap_term": snap_term, "offset": offset,
                   "data": text[offset:offset + chunk], "done": done}
            if done:
                msg["total"] = total
                msg["digest"] = digest
                msg["servers"] = servers
            reply = self.transport.send(self.id, peer, msg)
            if reply is None:
                return ("progress" if made_progress else "retry"), offset
            with self._lock:
                if reply["term"] > self.current_term:
                    self._become_follower_locked(reply["term"])
                    return "done", offset
                if self.state != LEADER or self.current_term != term:
                    return "done", offset
                self._last_contact[peer] = time.time()
                if reply.get("success"):
                    if "match_index" in reply:
                        # follower finished the install (or already had
                        # this index)
                        self._match_index[peer] = max(
                            self._match_index.get(peer, 0),
                            reply["match_index"])
                        self._next_index[peer] = self._match_index[peer] + 1
                        self._maybe_advance_commit_locked()
                        return "done", offset
                    offset = reply.get("offset", offset + len(msg["data"]))
                    made_progress = True
                    continue
                if "offset" in reply:
                    # resume protocol: realign to where the follower is.
                    # A rewind that makes no net progress (e.g. a disk
                    # fault reset the sink to 0) backs off via the
                    # caller's Retryer instead of hot-looping.
                    new_off = reply["offset"]
                    forward = new_off > offset
                    offset = new_off
                    if forward or made_progress:
                        made_progress = True
                        continue
                    return "retry", offset
                # hard refusal (no fsm_restore, stale term view): give up
                return "done", offset

    def _maybe_advance_commit_locked(self) -> None:
        """Quorum commit via one sorted match-index pass (call with the
        lock held). The median-ish element of the descending-sorted
        match vector IS the highest index a majority holds; one
        current-term check suffices because terms are monotone in index —
        if the quorum index carries an older term, no current-term entry
        is quorum-replicated yet (the leader barrier noop closes that
        window at term start)."""
        if self.state != LEADER:
            return
        last_index, _ = self.log.last()
        matches = [last_index]  # the leader's own durable log
        matches.extend(self._match_index.get(p, 0) for p in self.peers)
        matches.sort(reverse=True)
        n = matches[len(matches) // 2]
        if n > self.commit_index and self.log.term_at(n) == self.current_term:
            self.commit_index = n
            self._apply_cond.notify_all()
            # piggyback the new commit index to followers promptly so
            # their FSMs converge without waiting for the idle heartbeat
            self._repl_cond.notify_all()

    # -- apply loop --

    def _run_apply(self) -> None:
        while not self._stop.is_set():
            with self._apply_cond:
                while self.last_applied >= self.commit_index \
                        and not self._stop.is_set():
                    self._apply_cond.wait(0.5)
            if self._stop.is_set():
                return
            while self._apply_chunk():
                pass
            self._maybe_snapshot()

    def _apply_chunk(self) -> bool:
        """Apply up to APPLY_CHUNK committed entries under ONE lock hold
        and wake all waiters with ONE notify_all. The re-check, fetch,
        and FSM mutation stay a single critical section with
        _on_install_snapshot (RPC thread): releasing the lock between
        the last_applied check and fsm_apply would let a snapshot
        restore land in between, after which applying the stale entry
        regresses the restored store. The chunk bound keeps RPC handlers
        from stalling behind an arbitrarily large committed backlog.

        With ``fsm_prepare`` the FSM's copies of the chunk's commands are
        made first, outside the lock: the copy of a large command (10,240
        nodes) would otherwise hold the lock past the election timeout,
        and a leader holding it sends no heartbeat. The critical section
        then re-checks that nothing was applied or installed meanwhile,
        and applies the prepared commands."""
        prepared = None
        if self.fsm_prepare is not None:
            with self._lock:
                start = self.last_applied + 1
                end = min(self.commit_index, start + APPLY_CHUNK - 1)
                entries = [self.log.get(idx) for idx in range(start, end + 1)]
            prepared = {}
            for e in entries:
                if e is None:
                    break
                if tuple(e.command)[:1] not in (("noop",), ("config",)):
                    try:
                        prepared[e.index] = (e.command,
                                             self.fsm_prepare(e.command))
                    except Exception as err:  # noqa: BLE001 - its result
                        prepared[e.index] = (e.command, err)
        with self._lock:
            start = self.last_applied + 1
            end = min(self.commit_index, start + APPLY_CHUNK - 1)
            if start > end:
                return False
            with TRACER.span("raft.apply", n=end - start + 1,
                             node=self.id):
                for idx in range(start, end + 1):
                    entry = self.log.get(idx)
                    if entry is None:
                        break  # compacted/leapfrogged: recompute next round
                    if tuple(entry.command)[:1] in (("noop",), ("config",)):
                        result = None  # raft-internal entries, not FSM ops
                    else:
                        try:
                            if prepared is None:
                                result = self.fsm_apply(tuple(entry.command))
                            else:
                                ready = prepared.get(idx)
                                if ready is None or ready[0] is not \
                                        entry.command:
                                    # not prepared (a later commit, or the
                                    # entry replaced): prepare it here
                                    ready = (entry.command, self.fsm_prepare(
                                        entry.command))
                                if isinstance(ready[1], Exception):
                                    raise ready[1]
                                result = self.fsm_apply(ready[1])
                        except Exception as e:
                            result = e
                    self.last_applied = idx
                    waiter = self._waiters.get(idx)
                    if waiter is not None \
                            and waiter.command is entry.command:
                        # identity check: a registration that lost the
                        # append CAS must not swallow another entry's
                        # result
                        del self._waiters[idx]
                        waiter.result = result
                        waiter.done.set()
            progressed = self.last_applied >= start
            self._apply_cond.notify_all()
        return progressed

    # -- read path (read-index / lease; Raft §6.4) --

    def wait_applied(self, index: int, timeout: float = 5.0) -> None:
        """Block until this node's FSM has applied through the given
        RAFT log index (the second half of a follower read: the leader
        names a read index, the serving node waits to reach it). Note
        the raft index space counts noop/config entries — it is NOT the
        state store's MVCC index."""
        deadline = time.monotonic() + timeout
        with self._apply_cond:
            while self.last_applied < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    raise TimeoutError(
                        f"fsm at {self.last_applied}, read index {index}")
                self._apply_cond.wait(min(remaining, 0.05))

    def last_contact_age(self) -> float:
        """Seconds since this node last heard from a live leader — the
        HTTP layer's X-Nomad-LastContact bound. 0.0 on the leader (it IS
        the source), inf when no leader was ever heard."""
        with self._lock:
            if self.state == LEADER:
                return 0.0
            if self._last_leader_contact <= 0.0:
                return float("inf")
            return max(0.0, time.time() - self._last_leader_contact)

    def _lease_valid_locked(self, now: float) -> bool:
        """True while a quorum of the cluster acked this leader within
        lease_duration (call with the lock held). The leader counts
        toward its own quorum, so it needs quorum-1 recent peer acks."""
        peers = self.peers
        if not peers:
            return True
        need = (len(peers) + 1) // 2 + 1 - 1  # quorum minus self
        recent = sum(1 for p in peers
                     if now - self._last_contact.get(p, 0.0)
                     < self.lease_duration)
        return recent >= need

    def read_index(self, timeout: float = 1.0, lease: bool = True) -> int:
        """Leader-side half of a linearizable read: confirm we are still
        the leader, then return a commit index the reader must wait past
        (serve once ``last_applied >= read_index`` on ANY server).

        Confirmation is a held lease (quorum of replication acks within
        lease_duration) when ``lease=True``, else a full round of empty
        append_entries (``lease=False`` = the ?consistent= HTTP mode —
        immune even to clock-rate assumptions). Either way the read
        index is only valid once this term's barrier noop has committed:
        before that, entries committed by the previous leader are not
        yet known final (Raft §8), so we first wait for it.

        Raises NotLeaderError when not (or no longer provably) the
        leader, TimeoutError when the barrier noop doesn't commit in
        time (e.g. a freshly elected leader still replicating)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if self._stop.is_set():
                # a stopped (crashed) node may still carry LEADER state;
                # it must never vouch for a read
                raise NotLeaderError(None)
            if self.state != LEADER:
                raise NotLeaderError(self.leader_id)
            term = self.current_term
            # wait for the term-start barrier to commit
            while self.commit_index < self._term_start_index:
                if self.state != LEADER or self.current_term != term \
                        or self._stop.is_set():
                    raise NotLeaderError(self.leader_id)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("term-start barrier not committed")
                self._apply_cond.wait(min(remaining, 0.05))
            index = self.commit_index
            if lease and self._lease_valid_locked(time.time()):
                REGISTRY.incr("nomad.reads.lease_reads")
                return index
        # no valid lease (or caller opted out): prove leadership with a
        # round of empty append_entries — outside the lock, it's I/O
        self._confirm_leadership(term, deadline)
        return index

    def _confirm_leadership(self, term: int, deadline: float) -> None:
        """One empty-AppendEntries round: a quorum answering in our term
        proves no newer leader exists (their acks double as fresh lease
        basis). Raises NotLeaderError on a higher term or no quorum."""
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                raise NotLeaderError(self.leader_id)
            peers = list(self.peers)
            last_index, _ = self.log.last()
            prev_term = self.log.term_at(last_index)
            commit = self.commit_index
        acks = 1  # self
        for p in peers:
            if time.monotonic() > deadline:
                break
            reply = self.transport.send(self.id, p, {
                "kind": "append_entries", "term": term, "leader": self.id,
                "prev_log_index": last_index, "prev_log_term": prev_term,
                "entries": [], "leader_commit": commit,
            })
            if reply is None:
                continue
            with self._lock:
                if reply["term"] > self.current_term:
                    self._become_follower_locked(reply["term"])
                    raise NotLeaderError(self.leader_id)
                if reply["term"] == term:
                    # success or not, a same-term reply acknowledges our
                    # leadership (a log mismatch is a replication
                    # problem, not an authority one)
                    acks += 1
                    self._last_contact[p] = time.time()
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                raise NotLeaderError(self.leader_id)
        if acks * 2 <= len(peers) + 1:
            raise NotLeaderError(None)
        REGISTRY.incr("nomad.reads.lease_extensions")


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str]):
        super().__init__(f"not the leader (leader: {leader_id})")
        self.leader_id = leader_id


class ConfigInProgressError(Exception):
    def __init__(self):
        super().__init__("a membership change is already in flight")
