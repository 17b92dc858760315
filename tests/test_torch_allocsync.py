"""The port's client alloc sync (nomad_tpu_torch/core/allocsync.py)
against the reference's (nomad_tpu/core/allocsync.py): the hub's
per-node deltas and its resync on a lapped ring, the client update
batcher's rounds and its isolation of a poisoned update, the client's
delta watch, and the delta path against the polling fallback -- each
case through both packages, and where the outcome is deterministic, the
same outcome. Every wait has its own deadline."""

import itertools
import threading
import time
import types

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.client import Client as RefClient
from nomad_tpu.client import ClientConfig as RefClientConfig
from nomad_tpu.core import allocsync as ref_allocsync
from nomad_tpu.core import events as ref_events
from nomad_tpu.core import server as ref_server
from nomad_tpu.state.store import StateStore as RefStore
from nomad_tpu.structs import enums as ref_enums
from nomad_tpu.structs.job import Task as RefTask
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.client import Client as PortClient
from nomad_tpu_torch.client import ClientConfig as PortClientConfig
from nomad_tpu_torch.core import allocsync as port_allocsync
from nomad_tpu_torch.core import events as port_events
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.state.store import StateStore as PortStore
from nomad_tpu_torch.structs import enums as port_enums
from nomad_tpu_torch.structs.job import Task as PortTask

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, allocsync=ref_allocsync, events=ref_events,
    Store=RefStore, enums=ref_enums, Task=RefTask, Client=RefClient,
    ClientConfig=RefClientConfig,
    server=lambda **kw: ref_server.Server(ref_server.ServerConfig(**kw)))
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, allocsync=port_allocsync,
    events=port_events, Store=PortStore, enums=port_enums, Task=PortTask,
    Client=PortClient, ClientConfig=PortClientConfig,
    server=lambda **kw: port_server.Server(port_server.ServerConfig(
        device="cpu", **kw)))


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


class _HubServer:
    """A store and its event broker: the surface AllocSyncHub reads."""

    def __init__(self, pk, ring_size=4096):
        self.store = pk.Store()
        self.events = pk.events.EventBroker(self.store, ring_size=ring_size)


def _node(pk, i):
    return pk.mock.node(id=f"node-{i:04d}", name=f"node-{i}")


def _alloc(pk, job, node, i):
    a = pk.mock.alloc(job, node)
    a.id = f"alloc-{i:04d}"
    return a


# --------------------------------------------------------------------------
# AllocSyncHub
# --------------------------------------------------------------------------


def _hub_script(pk):
    """The deltas and resync flags one subscription over two nodes sees
    for a fixed run of writes: placements on three nodes, a client
    update, a stop."""
    srv = _HubServer(pk)
    hub = pk.allocsync.AllocSyncHub(srv)
    hub.start()
    seen = []
    try:
        n1, n2, n3 = (_node(pk, i) for i in range(3))
        sub = hub.subscribe([n1.id, n2.id])
        job = pk.mock.job(id="hub-job")
        allocs = [_alloc(pk, job, n, i)
                  for i, n in enumerate((n1, n2, n3, n1))]
        srv.store.upsert_allocs(allocs)
        assert _wait(lambda: hub.stats["events"] >= 4)
        batch, resync = sub.poll(timeout=5.0)
        seen.append((sorted(a.id for a in batch), resync))
        upd = allocs[0].copy_for_update()
        upd.client_status = pk.enums.ALLOC_CLIENT_RUNNING
        srv.store.update_allocs_from_client([upd])
        stop = allocs[1].copy_for_update()
        stop.desired_status = pk.enums.ALLOC_DESIRED_STOP
        srv.store.upsert_allocs([stop])
        assert _wait(lambda: hub.stats["events"] >= 6)
        batch, resync = sub.poll(timeout=5.0)
        seen.append((sorted((a.id, a.client_status, a.desired_status)
                            for a in batch), resync))
        sub.close()
        assert sub.closed
        stats = dict(hub.stats)
    finally:
        hub.stop()
    return seen, stats


def test_hub_routes_the_same_deltas_as_the_reference():
    """A subscription over two of three nodes gets exactly its nodes'
    changed allocs, the newest row of each, in both packages."""
    got = {pk.name: _hub_script(pk) for pk in (REF, PORT)}
    assert got["port"] == got["ref"]
    seen, stats = got["port"]
    assert seen[0] == (["alloc-0000", "alloc-0001", "alloc-0003"], False)
    assert seen[1] == ([("alloc-0000", "running", "run"),
                        ("alloc-0001", "running", "stop")], False)
    assert stats == {"events": 6, "deltas": 5, "resyncs": 0}


def test_hub_ring_truncation_forces_full_resync(pkg):
    """A pump that falls off an 8-event ring flags every subscription for
    a full resync (test_swarm.py's case, both packages)."""
    srv = _HubServer(pkg, ring_size=8)
    hub = pkg.allocsync.AllocSyncHub(srv)
    n = _node(pkg, 1)
    sub = hub.subscribe(n.id)
    hub.start()
    job = pkg.mock.job()
    try:
        # hold the subscription's condition so the pump blocks on its
        # first delivery, then lap the ring past the pump's cursor
        with sub._cond:
            for i in range(40):
                srv.store.upsert_allocs([_alloc(pkg, job, n, i)])
        deadline = time.time() + 10.0
        resync = False
        while not resync and time.time() < deadline:
            _batch, resync = sub.poll(timeout=1.0)
        assert resync
        assert hub.stats["resyncs"] >= 1
    finally:
        sub.close()
        hub.stop()


def test_hub_stop_closes_its_broker_subscription():
    """The port's pump closes its broker subscription when it stops, so a
    stopped hub leaves no waiter behind."""
    srv = _HubServer(PORT)
    hub = port_allocsync.AllocSyncHub(srv)
    hub.start()
    assert _wait(lambda: srv.events.waiter_count() >= 1)
    sub = hub.subscribe("node-x")
    hub.stop()
    assert sub.closed and not hub.running
    assert _wait(lambda: srv.events.waiter_count() == 0)


# --------------------------------------------------------------------------
# ClientUpdateBatcher
# --------------------------------------------------------------------------


def _batcher_rounds(pk):
    """Three callers while the store's writer is held: the first leads a
    round of its own, the two that park ride the next one."""
    srv = _HubServer(pk)
    n = _node(pk, 1)
    job = pk.mock.job(id="b-job")
    allocs = [_alloc(pk, job, n, i) for i in range(6)]
    srv.store.upsert_allocs(allocs)
    b = pk.allocsync.ClientUpdateBatcher(srv.store)
    b.start()

    def ack(group):
        upds = []
        for a in group:
            u = a.copy_for_update()
            u.client_status = pk.enums.ALLOC_CLIENT_RUNNING
            upds.append(u)
        b.submit(upds)

    try:
        with srv.store._write_lock:
            lead = threading.Thread(target=ack, args=(allocs[:2],))
            lead.start()
            assert _wait(lambda: b._committing and not b._pending)
            rest = [threading.Thread(target=ack, args=(allocs[i:i + 2],))
                    for i in (2, 4)]
            for t in rest:
                t.start()
            assert _wait(lambda: len(b._pending) == 2)
        for t in [lead] + rest:
            t.join(10.0)
            assert not t.is_alive()
        snap = srv.store.snapshot()
        rows = sorted((a.id, snap.alloc_by_id(a.id).client_status)
                      for a in allocs)
        stats = dict(b.stats)
    finally:
        b.stop()
    # stopped: a submit commits directly
    u = allocs[0].copy_for_update()
    u.client_status = pk.enums.ALLOC_CLIENT_COMPLETE
    b.submit([u])
    after = srv.store.snapshot().alloc_by_id(allocs[0].id).client_status
    return rows, stats, after


def test_batcher_rounds_equal_the_reference():
    got = {pk.name: _batcher_rounds(pk) for pk in (REF, PORT)}
    assert got["port"] == got["ref"]
    rows, stats, after = got["port"]
    assert all(s == "running" for _, s in rows)
    assert stats == {"rounds": 2, "batched_updates": 6, "fallbacks": 0}
    assert after == "complete"


def test_batcher_isolates_poisoned_update(pkg):
    """A round holding a bad update falls back to one commit a caller:
    the good caller commits, only the bad one raises."""
    class _PoisonStore:
        def __init__(self):
            self.applied = []

        def update_allocs_from_client(self, updates, ts=None):
            if any(u.id == "poison" for u in updates):
                raise ValueError("bad update")
            self.applied.extend(u.id for u in updates)

    store = _PoisonStore()
    b = pkg.allocsync.ClientUpdateBatcher(store)
    b.start()
    try:
        n = _node(pkg, 1)
        job = pkg.mock.job()
        good = _alloc(pkg, job, n, 1)
        bad = _alloc(pkg, job, n, 2)
        bad.id = "poison"
        errs = []

        def submit(u):
            try:
                b.submit([u])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=submit, args=(u,))
                   for u in (good, bad)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
        assert store.applied == [good.id]
        assert len(errs) == 1 and isinstance(errs[0], ValueError)
    finally:
        b.stop()


def test_server_submits_client_updates_through_the_batcher():
    """The port's Server runs the hub and the batcher while it runs, and
    its update_allocs_from_client goes through the batcher."""
    srv = PORT.server(heartbeat_ttl=3600, gc_interval=3600)
    assert not srv.alloc_sync.running and not srv.client_updates.running
    with srv:
        assert srv.alloc_sync.running and srv.client_updates.running
        n = _node(PORT, 1)
        srv.register_node(n)
        job = port_mock.job(id="s-job")
        a = _alloc(PORT, job, n, 1)
        srv.store.upsert_allocs([a])
        u = a.copy_for_update()
        u.client_status = port_enums.ALLOC_CLIENT_RUNNING
        srv.update_allocs_from_client([u])
        assert srv.client_updates.stats["batched_updates"] == 1
        assert (srv.store.snapshot().alloc_by_id(a.id).client_status
                == "running")
    assert not srv.alloc_sync.running and not srv.client_updates.running
    off = PORT.server(client_update_batching=False)
    assert off.client_updates.batch_enabled is False


# --------------------------------------------------------------------------
# the client's delta watch and its polling fallback
# --------------------------------------------------------------------------


class _NoHub:
    """A server facade without the hub: the client polls."""

    def __init__(self, srv):
        self._srv = srv

    def __getattr__(self, name):
        if name == "alloc_sync":
            raise AttributeError(name)
        return getattr(self._srv, name)


def _pin(monkeypatch):
    """One id counter a package for the ids the scheduler makes."""
    from nomad_tpu.core import server as rs
    from nomad_tpu.scheduler import generic_sched as rg
    from nomad_tpu_torch.scheduler import generic_sched as pg

    for mod in (rs, rg, port_server, pg):
        counter = itertools.count()
        monkeypatch.setattr(
            mod, "generate_uuid",
            lambda c=counter, m=mod.__name__.split(".")[-1]:
            f"{next(c):08x}-{len(m):04x}-0000-0000-000000000000")
    monkeypatch.setattr(rg, "generate_uuids",
                        lambda n: [rg.generate_uuid() for _ in range(n)])


def _watch_run(pk, tmp_path, hub: bool):
    """A batch group and a service group on three clients, the service
    job stopped: the final rows, and each client's desired set."""
    srv = pk.server(num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
                    gc_interval=3600)
    clients = []
    with srv:
        for i in range(3):
            c = pk.Client(srv if hub else _NoHub(srv), pk.ClientConfig(
                data_dir=str(tmp_path / f"{pk.name}-{hub}-{i}"),
                watch_interval=5.0 if hub else 0.05,
                resync_interval=60.0), node=_node(pk, i))
            c.start()
            clients.append(c)
        try:
            batch = pk.mock.batch_job(id="w-batch")
            batch.task_groups[0].count = 12
            batch.task_groups[0].tasks[0] = pk.Task(
                name="web", driver="mock", config={"run_for": 0.1})
            svc = pk.mock.job(id="w-svc")
            svc.task_groups[0].count = 4
            svc.task_groups[0].tasks[0] = pk.Task(
                name="web", driver="mock", config={"run_for": 600.0})
            srv.register_job(batch)
            srv.register_job(svc)

            def statuses(jid):
                return [a.client_status for a in
                        srv.store.snapshot().allocs_by_job(jid)]

            assert _wait(lambda: statuses("w-batch").count("complete") == 12
                         and statuses("w-svc").count("running") == 4, 20.0)
            srv.deregister_job("w-svc")
            assert _wait(lambda: statuses("w-svc").count("complete") == 4,
                         20.0)
            snap = srv.store.snapshot()
            rows = sorted((a.name, a.node_id, a.desired_status,
                           a.client_status)
                          for jid in ("w-batch", "w-svc")
                          for a in snap.allocs_by_job(jid))
            desired = [sorted(a.id for a in snap.allocs_by_node(c.node.id)
                              if not a.server_terminal())
                       == sorted(c.runners) for c in clients]
            deltas = srv.alloc_sync.stats["deltas"]
        finally:
            for c in clients:
                c.stop()
    return rows, desired, deltas


def test_delta_path_equals_polling(monkeypatch, tmp_path):
    """The same jobs on three clients watching by the hub's deltas (a 5 s
    poll interval, so only a delta can start a task in time) and by the
    polling fallback, in both packages: the same final rows, every
    client's runners its node's allocs."""
    got = {}
    for pk in (REF, PORT):
        for hub in (True, False):
            _pin(monkeypatch)
            got[(pk.name, hub)] = _watch_run(pk, tmp_path, hub)
    rows = got[("port", True)][0]
    assert len(rows) == 16
    for key, (r, desired, deltas) in got.items():
        assert r == rows, key
        assert all(desired), key
        assert (deltas > 0) == key[1], key


def test_client_stop_halts_heartbeats(pkg, tmp_path):
    """No heartbeat RPC starts after Client.stop() returns (test_swarm.py's
    case, both packages)."""
    srv = pkg.server(heartbeat_ttl=30.0)
    srv.start()
    c = pkg.Client(srv, pkg.ClientConfig(data_dir=str(tmp_path / "c"),
                                         heartbeat_interval=0.01),
                   node=_node(pkg, 1))
    c.start()
    try:
        assert _wait(lambda: srv.store.snapshot().node_by_id(c.node.id)
                     is not None)
        calls = []
        real = srv.heartbeat

        def spying(node_id):
            calls.append(time.monotonic())
            return real(node_id)

        srv.heartbeat = spying
        assert _wait(lambda: len(calls) >= 3)
        c.stop()
        stopped_at = time.monotonic()
        time.sleep(0.2)
        assert not [t for t in calls if t > stopped_at]
    finally:
        srv.stop()
