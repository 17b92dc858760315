"""Client agent (a copy of ``nomad_tpu/client/client.py``; reference
client/client.go:139).

The per-node agent loop:

  fingerprint -> Node.Register -> heartbeat loop
  watch assigned allocs (the server's AllocSyncHub deltas, or polling
  where the server has none, client.go:2281) -> diff desired against
  running -> start and stop AllocRunners -> batched status sync back to
  the server (allocSync, 200 ms, client.go:2198), which the Server
  coalesces with the other clients' (core/allocsync.py).

Transport: the agent talks to anything with the server's endpoint
surface (register_node / heartbeat / update_allocs_from_client and a
``store`` for alloc reads): the port's Server, or a ReplicatedServer.

Trimmed: external driver plugins (``plugin_dir``) and the device and
CSI managers (``client/devices.py``, ``client/volumes.py``,
``client/dynamicplugins.py``) wait for ROADMAP A10.10; workload
identities (``widmgr.py``) for A10.4.

``stop()`` leaves no client, alloc, task, health or check thread
running and no executor process; ``shutdown()`` stops the agent's
threads and leaves the tasks running for a restarted agent to
re-attach (``state_db``).
"""

from __future__ import annotations

import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..structs.alloc import Allocation
from ..structs.node import Node
from .alloc_runner import AllocRunner
from .fingerprint import fingerprint
from .state_db import ClientStateDB


@dataclass
class ClientConfig:
    datacenter: str = "dc1"
    node_class: str = ""
    data_dir: str = ""
    heartbeat_interval: float = 3.0
    sync_interval: float = 0.2     # allocSync batching (client.go:2198)
    watch_interval: float = 0.1
    # safety full-resync cadence on the delta alloc-sync path (deltas
    # never report GC'd allocs vanishing; a periodic snapshot read
    # prunes them and bounds any missed-delta window)
    resync_interval: float = 5.0
    # periodic re-fingerprint (reference fingerprint_manager periodics)
    fingerprint_interval: float = 60.0
    # host stats sampling (reference client/hoststats)
    hoststats_interval: float = 10.0


class Client:
    def __init__(self, server, config: Optional[ClientConfig] = None,
                 node: Optional[Node] = None):
        self.server = server
        self.config = config or ClientConfig()
        if not self.config.data_dir:
            self.config.data_dir = tempfile.mkdtemp(
                prefix="nomad_tpu_torch_client_")
        self.node = node or fingerprint(datacenter=self.config.datacenter,
                                        node_class=self.config.node_class,
                                        data_dir=self.config.data_dir)
        # a node the caller gives keeps its shape: no periodic
        # re-fingerprint registers the host's over it (the reference's
        # does, every fingerprint_interval)
        self._fingerprints = node is None
        # persistent identity + alloc/handle state (client/state/db_bolt
        # equivalent): a restarted client keeps its node id, so the server
        # sees a re-registration, not a new node
        self.state_db = ClientStateDB(self.config.data_dir)
        if node is None and self.state_db.node_id:
            self.node.id = self.state_db.node_id
        self.state_db.set_node_id(self.node.id)
        self.runners: Dict[str, AllocRunner] = {}
        self._dirty: Dict[str, AllocRunner] = {}   # pending status syncs
        self._lock = threading.Lock()              # guards self.runners
        self._dirty_lock = threading.Lock()        # guards self._dirty
        # serializes node-mutating RPCs (heartbeat / re-register) against
        # stop(): a heartbeat already past the stop-flag check would
        # otherwise race deregistration and re-arm the server-side TTL
        # for a node that is going away
        self._rpc_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        from .hoststats import HostStatsCollector

        self.hoststats = HostStatsCollector(
            self.config.data_dir, interval=self.config.hoststats_interval)
        # heartbeatstop (reference client/heartbeatstop.go): while the
        # server is unreachable, allocs opting into
        # stop_after_client_disconnect are stopped locally at expiry
        self._last_heartbeat_ok = time.time()

    # -- lifecycle --

    def start(self) -> None:
        self._restore()
        self._register_with_retry()
        self.hoststats.start()
        loops = [("heartbeat", self._run_heartbeat),
                 ("watch", self._run_watch), ("sync", self._run_sync)]
        if self._fingerprints:
            loops.append(("fingerprint", self._run_fingerprint))
        for name, fn in loops:
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"client-{self.node.id[:8]}-{name}")
            t.start()
            self._threads.append(t)

    def _register_with_retry(self, deadline_s: float = 120.0) -> None:
        """Registration must outlast server-side unavailability — at boot
        the cluster may still be electing its first leader (reference
        client/client.go:1735 registerAndHeartbeat retries with backoff;
        a client crashing because it raced the election would take the
        whole agent process down with it)."""
        from ..utils.backoff import Retryer

        Retryer(deadline_s=deadline_s, base=0.2, cap=5.0,
                stop=self._stop).call(
            lambda: self.server.register_node(self.node))

    def signal_stop(self) -> None:
        """The first half of ``stop``, which returns at once: raise the
        stop flag and signal every alloc's tasks to die. An agent
        stopping many clients signals them all, then stops each, so their
        tasks die together rather than one client after another."""
        self._stop.set()
        with self._lock:
            runners = list(self.runners.values())
        for r in runners:
            r.kill()

    def stop(self) -> None:
        # take the RPC lock BEFORE raising the stop flag is not enough:
        # a heartbeat could be blocked waiting for the lock already.
        # Order: set the flag first, then wait out any RPC in flight —
        # every RPC loop re-checks the flag under the lock before
        # issuing, so after this block no further node RPC can start
        self._stop.set()
        with self._rpc_lock:
            pass
        self.hoststats.stop()
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            runners = list(self.runners.values())
        for r in runners:
            r.kill()
        for r in runners:
            r.stop()
        # full stop kills the tasks, so cached image extractions have
        # no remaining users (shutdown() below leaves tasks running and
        # must NOT evict)
        from .drivers import ContainerDriver

        ContainerDriver.evict_image_cache()

    def shutdown(self) -> None:
        """Stop the agent threads but LEAVE TASKS RUNNING (the reference
        agent shutdown: tasks survive the restart and the next start
        re-attaches via the state DB, client/client.go:1216)."""
        self._stop.set()
        with self._rpc_lock:
            pass
        self.hoststats.stop()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _restore(self) -> None:
        """Re-adopt allocs from the state DB (client.go:1216
        restoreState): live tasks re-attach by pid, dead ones roll
        through the normal restart/fail paths."""
        from .drivers import get_driver

        for alloc, handles in self.state_db.restore_allocs():
            if alloc.server_terminal() or alloc.client_terminal():
                self.state_db.remove_allocs([alloc.id])
                continue
            recovered = {}
            for task_name, data in handles.items():
                tg = (alloc.job.lookup_task_group(alloc.task_group)
                      if alloc.job else None)
                task = next((t for t in (tg.tasks if tg else [])
                             if t.name == task_name), None)
                if task is None:
                    continue
                try:
                    driver = get_driver(task.driver)
                except Exception:
                    continue
                recover = getattr(driver, "recover_task", None)
                handle = recover(data) if recover is not None else None
                if handle is not None:
                    recovered[task_name] = handle
            runner = AllocRunner(alloc, self.node, self.config.data_dir,
                                 on_update=self._mark_dirty,
                                 state_db=self.state_db,
                                 restored_handles=recovered,
                                 services_api=self.server)
            with self._lock:
                self.runners[alloc.id] = runner
            runner.run()

    # -- heartbeats (client.go:1735 registerAndHeartbeat) --

    def _run_heartbeat(self) -> None:
        from ..utils.backoff import Backoff

        # while the server is unreachable each failed heartbeat RPC
        # burns a 5 s forwarding deadline (raft/cluster.py _forward), so
        # consecutive failures space out on a jittered backoff instead
        # of hammering a cluster that is mid-election
        failure_backoff = Backoff(base=self.config.heartbeat_interval,
                                  factor=2.0, cap=5.0, jitter=0.25)
        while not self._stop.wait(self.config.heartbeat_interval):
            try:
                with self._rpc_lock:
                    if self._stop.is_set():
                        return
                    self.server.heartbeat(self.node.id)
                self._last_heartbeat_ok = time.time()
                failure_backoff.reset()
            except KeyError:
                # the server no longer knows us (registration lost, or
                # we were GC'd while partitioned): re-register instead
                # of arming a ghost TTL for a node row that isn't there
                try:
                    with self._rpc_lock:
                        if self._stop.is_set():
                            return
                        self.server.register_node(self.node)
                    self._last_heartbeat_ok = time.time()
                    failure_backoff.reset()
                except Exception:
                    self._check_heartbeat_stop()
                    if self._stop.wait(failure_backoff.next_delay()):
                        return
            except Exception:
                # server unreachable: the TTL will mark us down; local
                # stop_after_client_disconnect timers start running
                self._check_heartbeat_stop()
                if self._stop.wait(failure_backoff.next_delay()):
                    return

    def _check_heartbeat_stop(self) -> None:
        """Stop allocs whose stop_after_client_disconnect window expired
        while the server is unreachable (reference client/heartbeatstop.go:
        a partitioned client must not keep singleton workloads alive
        after the server has rescheduled them elsewhere)."""
        disconnected_for = time.time() - self._last_heartbeat_ok
        with self._lock:
            runners = list(self.runners.values())
        for r in runners:
            tg = r.tg
            if tg is None or tg.stop_after_client_disconnect_s is None:
                continue
            if disconnected_for >= tg.stop_after_client_disconnect_s \
                    and not r.is_terminal():
                r.client_description = ("stopped locally: client "
                                        "disconnected past "
                                        "stop_after_client_disconnect")
                r.stop()
                self._mark_dirty(r)

    # -- periodic re-fingerprint (reference client/fingerprint_manager) --

    def _run_fingerprint(self) -> None:
        while not self._stop.wait(self.config.fingerprint_interval):
            try:
                fresh = fingerprint(node_id=self.node.id,
                                    datacenter=self.config.datacenter,
                                    node_class=self.config.node_class,
                                    data_dir=self.config.data_dir)
            except Exception:
                continue
            changed = (fresh.attributes != self.node.attributes
                       or fresh.drivers != self.node.drivers
                       or fresh.resources.vec().tolist()
                       != self.node.resources.vec().tolist())
            if not changed:
                continue
            # re-register a FRESH node object: in-proc mode the current
            # object is aliased into the MVCC store (rows are immutable
            # by convention), so mutating it in place would tear the
            # snapshots concurrent schedulers hold
            import copy as _copy

            updated = _copy.copy(self.node)
            updated.attributes = fresh.attributes
            updated.drivers = fresh.drivers
            updated.resources = fresh.resources
            updated._avail_vec = None
            updated.computed_class = ""
            updated.compute_class()
            try:
                with self._rpc_lock:
                    if self._stop.is_set():
                        return
                    self.server.register_node(updated)
            except Exception:
                continue  # retried on the next tick
            self.node = updated

    # -- alloc watching (client.go:2281 watchAllocations -> :2539 runAllocs) --

    def _run_watch(self) -> None:
        # delta path: the server pushes per-node changed allocs off the
        # event broker; a full snapshot read happens only on subscribe,
        # on a subscription gap, and on the periodic safety resync.
        # Falls back to interval polling against servers without a hub
        # (e.g. a follower in a replicated cluster, or an HTTP facade).
        hub = getattr(self.server, "alloc_sync", None)
        if hub is not None and hub.running:
            # returns if the hub shuts down mid-session; fall through to
            # polling then (the server may be stopping — or restarting)
            self._watch_deltas(hub)
        while not self._stop.wait(self.config.watch_interval):
            try:
                desired = self.server.store.snapshot().allocs_by_node(self.node.id)
            except Exception:
                continue
            self._reconcile(desired)

    def _watch_deltas(self, hub) -> None:
        sub = hub.subscribe(self.node.id)
        try:
            desired: Dict[str, Allocation] = {}
            last_full = 0.0
            while not self._stop.is_set():
                now = time.monotonic()
                need_full = (now - last_full) >= self.config.resync_interval
                if not need_full:
                    batch, need_full = sub.poll(
                        timeout=self.config.watch_interval)
                    if self._stop.is_set() or sub.closed:
                        return
                    if batch and not need_full:
                        for alloc in batch:
                            prev = desired.get(alloc.id)
                            if (prev is None
                                    or alloc.modify_index >= prev.modify_index):
                                desired[alloc.id] = alloc
                        self._reconcile(list(desired.values()))
                        continue
                    if not need_full:
                        continue
                try:
                    full = self.server.store.snapshot().allocs_by_node(
                        self.node.id)
                except Exception:
                    # server unreachable: keep the last desired set and
                    # retry the resync on the next tick
                    if self._stop.wait(self.config.watch_interval):
                        return
                    continue
                desired = {a.id: a for a in full}
                last_full = time.monotonic()
                self._reconcile(list(desired.values()))
        finally:
            sub.close()

    def _reconcile(self, desired: List[Allocation]) -> None:
        by_id = {a.id: a for a in desired}
        stops: List[AllocRunner] = []
        starts: List[AllocRunner] = []
        with self._lock:
            # stops: server wants it gone (or it vanished after GC)
            for alloc_id, runner in list(self.runners.items()):
                server_alloc = by_id.get(alloc_id)
                if server_alloc is None or server_alloc.server_terminal():
                    stops.append(runner)
                    del self.runners[alloc_id]
            self.state_db.remove_allocs([r.alloc.id for r in stops])
            # adds: new non-terminal allocs assigned to us
            for alloc_id, alloc in by_id.items():
                if alloc_id in self.runners:
                    continue
                if alloc.server_terminal() or alloc.client_terminal():
                    continue
                runner = AllocRunner(alloc, self.node, self.config.data_dir,
                                     on_update=self._mark_dirty,
                                     state_db=self.state_db,
                                     prev_runner_lookup=self.runners.get,
                                     services_api=self.server)
                self.runners[alloc_id] = runner
                starts.append(runner)
            self.state_db.put_allocs([r.alloc for r in starts])
        # stop() joins task threads (up to kill_timeout each) — must run
        # outside the lock or the watch/sync loops stall behind it
        for runner in stops:
            runner.stop()
            if not runner.is_terminal():
                self._mark_dirty(runner)
        for runner in starts:
            runner.run()

    def _mark_dirty(self, runner: AllocRunner) -> None:
        with self._dirty_lock:
            self._dirty[runner.alloc.id] = runner

    # -- batched status sync (client.go:2198 allocSync) --

    def _run_sync(self) -> None:
        while not self._stop.wait(self.config.sync_interval):
            self.sync_now()

    def sync_now(self) -> None:
        with self._dirty_lock:
            dirty, self._dirty = self._dirty, {}
        if not dirty:
            return
        updates = []
        self.state_db.update_client_statuses(
            {r.alloc.id: r.client_status for r in dirty.values()})
        for runner in dirty.values():
            upd = runner.alloc.copy_for_update()
            upd.client_status = runner.client_status
            upd.client_description = runner.client_description
            upd.task_states = {name: st.copy()
                               for name, st in runner.task_states.items()}
            if runner.deployment_health is not None:
                ok, ts = runner.deployment_health
                upd.deployment_status = {"healthy": ok, "timestamp": ts}
            fin = runner.finished_at()
            if fin:
                upd.task_finished_at = fin
            updates.append(upd)
        from ..obs.trace import TRACER

        try:
            with TRACER.span("client.sync", node=self.node.id[:8],
                             count=len(updates)):
                self.server.update_allocs_from_client(updates)
        except Exception:
            with self._dirty_lock:  # retry next tick
                for r in dirty.values():
                    self._dirty.setdefault(r.alloc.id, r)
