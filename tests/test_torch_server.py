"""The port's Server path (nomad_tpu_torch/core): the broker's cases of
test_core_server.py::TestBroker and test_e2e_pipeline.py::TestDequeueBatch
through both packages' brokers; the Server end to end on the CPU
(register, deregister, a blocked eval that a new node unblocks); the
reference Server's per-job fingerprint (one worker, one eval a dequeue,
pinned ids) under "tpu-binpack" and "tpu-solve"; and racing workers
whose plans the applier re-checks."""

import itertools
import threading
import time
import types

import numpy as np
import pytest

import bench
from nomad_tpu import mock as ref_mock
from nomad_tpu.core import broker as ref_broker
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.structs import enums as ref_enums
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import broker as port_broker
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.obs.metrics import REGISTRY
from nomad_tpu_torch.obs import TRACER
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.structs import Spread, enums
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor import incremental as port_incremental

from test_torch_bulk_scan import over_capacity
from test_torch_pipeline import (JOBS, fingerprint, node_record,  # noqa: F401
                                 port_service)
from test_torch_spread_pipeline import job_record

REF = types.SimpleNamespace(name="ref", mock=ref_mock, broker=ref_broker,
                            enums=ref_enums)
PORT = types.SimpleNamespace(name="port", mock=port_mock, broker=port_broker,
                             enums=enums)


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def make_broker(pkg, **kw):
    b = pkg.broker.EvalBroker(**kw)
    b.set_enabled(True)
    return b


# --------------------------------------------------------------------------
# test_core_server.py::TestBroker
# --------------------------------------------------------------------------


def test_enqueue_dequeue_ack(pkg):
    b = make_broker(pkg)
    ev = pkg.mock.eval_for(pkg.mock.job())
    b.enqueue(ev)
    got, token = b.dequeue([ev.type], timeout=1.0)
    assert got.id == ev.id
    assert b.inflight() == 1
    b.ack(ev.id, token)
    assert b.inflight() == 0
    b.set_enabled(False)


def test_priority_order(pkg):
    b = make_broker(pkg)
    lo = pkg.mock.eval_for(pkg.mock.job(), priority=10)
    hi = pkg.mock.eval_for(pkg.mock.job(), priority=90)
    b.enqueue(lo)
    b.enqueue(hi)
    got, tok = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=1.0)
    assert got.id == hi.id
    b.ack(got.id, tok)
    b.set_enabled(False)


def test_per_job_serialization(pkg):
    b = make_broker(pkg)
    j = pkg.mock.job()
    e1 = pkg.mock.eval_for(j)
    e2 = pkg.mock.eval_for(j)
    e2.modify_index = 99
    b.enqueue(e1)
    b.enqueue(e2)
    got1, tok1 = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=1.0)
    got2, _ = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=0.05)
    assert got2 is None
    b.ack(got1.id, tok1)
    got3, tok3 = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=1.0)
    assert got3.id == e2.id
    b.ack(got3.id, tok3)
    b.set_enabled(False)


def test_pending_promotes_latest_and_cancels_stale(pkg):
    b = make_broker(pkg)
    j = pkg.mock.job()
    first = pkg.mock.eval_for(j)
    old = pkg.mock.eval_for(j)
    old.modify_index = 5
    new = pkg.mock.eval_for(j)
    new.modify_index = 10
    for e in (first, old, new):
        b.enqueue(e)
    got, tok = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=1.0)
    b.ack(got.id, tok)
    got2, tok2 = b.dequeue([pkg.enums.JOB_TYPE_SERVICE], timeout=1.0)
    assert got2.id == new.id
    b.ack(got2.id, tok2)
    cancelled = b.drain_cancelled()
    assert [e.id for e in cancelled] == [old.id]
    assert cancelled[0].status == pkg.enums.EVAL_STATUS_CANCELLED
    assert old.status == pkg.enums.EVAL_STATUS_PENDING  # a copy changed
    b.set_enabled(False)


def test_nack_redelivers_then_fails(pkg):
    b = make_broker(pkg, delivery_limit=2)
    ev = pkg.mock.eval_for(pkg.mock.job())
    b.enqueue(ev)
    got, tok = b.dequeue([ev.type], timeout=1.0)
    b.nack(got.id, tok)
    got2, tok2 = b.dequeue([ev.type], timeout=1.0)
    assert got2.id == ev.id
    b.nack(got2.id, tok2)
    got3, _ = b.dequeue([ev.type], timeout=0.05)
    assert got3 is None
    assert [e.id for e in b.failed_evals()] == [ev.id]
    assert b.wait_for_reaper_work(timeout=0.05)
    b.set_enabled(False)


def test_nack_timeout_redelivery(pkg):
    b = make_broker(pkg, nack_timeout=0.1)
    ev = pkg.mock.eval_for(pkg.mock.job())
    b.enqueue(ev)
    got, tok = b.dequeue([ev.type], timeout=1.0)
    got2, tok2 = b.dequeue([ev.type], timeout=1.0)
    assert got2.id == ev.id
    b.ack(got2.id, tok2)
    with pytest.raises(ValueError):
        b.ack(ev.id, tok)  # the stale token is refused
    b.set_enabled(False)


def test_delayed_eval(pkg):
    b = make_broker(pkg)
    ev = pkg.mock.eval_for(pkg.mock.job())
    ev.wait_until = time.time() + 0.15
    b.enqueue(ev)
    assert b.delayed_count() == 1
    got, _ = b.dequeue([ev.type], timeout=0.05)
    assert got is None
    got, tok = b.dequeue([ev.type], timeout=1.0)
    assert got.id == ev.id
    assert ev.wait_until > 0  # the broker released a copy
    b.ack(got.id, tok)
    b.set_enabled(False)


# --------------------------------------------------------------------------
# test_e2e_pipeline.py::TestDequeueBatch
# --------------------------------------------------------------------------


def test_batch_drains_everything_ready_now(pkg):
    b = make_broker(pkg)
    evals = [pkg.mock.eval_for(pkg.mock.job()) for _ in range(5)]
    for ev in evals:
        b.enqueue(ev)
    got = b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], max_batch=8,
                          timeout=1.0)
    assert {ev.id for ev, _ in got} == {ev.id for ev in evals}
    assert len({tok for _, tok in got}) == 5
    assert b.inflight() == 5
    for ev, tok in got:
        b.ack(ev.id, tok)
    assert b.inflight() == 0
    b.set_enabled(False)


def test_batch_of_one_beats_idling(pkg):
    b = make_broker(pkg)
    ev = pkg.mock.eval_for(pkg.mock.job())
    b.enqueue(ev)
    t0 = time.monotonic()
    got = b.dequeue_batch([ev.type], max_batch=8, timeout=5.0)
    assert time.monotonic() - t0 < 1.0
    assert [e.id for e, _ in got] == [ev.id]
    b.set_enabled(False)


def test_batch_max_respected(pkg):
    b = make_broker(pkg)
    for _ in range(6):
        b.enqueue(pkg.mock.eval_for(pkg.mock.job()))
    got = b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], max_batch=4,
                          timeout=1.0)
    assert len(got) == 4
    b.set_enabled(False)


def test_batch_per_job_serialization(pkg):
    b = make_broker(pkg)
    job = pkg.mock.job()
    ev1 = pkg.mock.eval_for(job, modify_index=1)
    ev2 = pkg.mock.eval_for(job, modify_index=2)
    b.enqueue(ev1)
    b.enqueue(ev2)
    got = b.dequeue_batch([job.type], max_batch=8, timeout=1.0)
    assert len(got) == 1
    ev, tok = got[0]
    b.ack(ev.id, tok)
    got2 = b.dequeue_batch([job.type], max_batch=8, timeout=1.0)
    assert len(got2) == 1
    assert got2[0][0].id != ev.id
    b.set_enabled(False)


def test_batch_nack_requeues_one_member_alone(pkg):
    b = make_broker(pkg)
    for _ in range(3):
        b.enqueue(pkg.mock.eval_for(pkg.mock.job()))
    got = b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], max_batch=8,
                          timeout=1.0)
    assert len(got) == 3
    victim, vtok = got[0]
    for ev, tok in got[1:]:
        b.ack(ev.id, tok)
    b.nack(victim.id, vtok)
    again = b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], max_batch=8,
                            timeout=2.0)
    assert [e.id for e, _ in again] == [victim.id]
    b.set_enabled(False)


def test_batch_mixed_types_no_starvation(pkg):
    b = make_broker(pkg)
    lo = pkg.mock.eval_for(pkg.mock.batch_job(), priority=10)
    his = [pkg.mock.eval_for(pkg.mock.job(), priority=90) for _ in range(3)]
    b.enqueue(lo)
    for ev in his:
        b.enqueue(ev)
    got = b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE,
                           pkg.enums.JOB_TYPE_BATCH],
                          max_batch=8, timeout=1.0)
    ids = [e.id for e, _ in got]
    assert lo.id in ids
    assert ids.index(lo.id) == len(ids) - 1
    b.set_enabled(False)


def test_batch_timeout_and_disable_return_empty(pkg):
    b = make_broker(pkg)
    assert b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], timeout=0.05) == []
    b.set_enabled(False)
    assert b.dequeue_batch([pkg.enums.JOB_TYPE_SERVICE], timeout=0.05) == []


# --------------------------------------------------------------------------
# the Server end to end on the CPU
# --------------------------------------------------------------------------


def _server(algorithm="tpu-binpack", **kw):
    kw.setdefault("failed_eval_unblock_interval", 0.3)
    return port_server.Server(port_server.ServerConfig(
        device="cpu", sched_config=port_operator.SchedulerConfiguration(
            scheduler_algorithm=algorithm), **kw))


def test_server_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        assert port_server.Server().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            port_server.Server()
    assert _server().device.type == "cpu"


def test_register_job_places_allocs(port_service):
    with _server() as s:
        for _ in range(5):
            s.register_node(port_mock.node())
        job = port_mock.job()
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        assert len(s.store.snapshot().allocs_by_job(job.id)) == 10
        ev = [e for e in s.store.snapshot().evals() if e.job_id == job.id]
        assert [e.status for e in ev] == [enums.EVAL_STATUS_COMPLETE]


def test_deregister_stops_allocs(port_service):
    before = set(threading.enumerate())
    with _server() as s:
        port_mock.build_nodes(s.store, 32)
        job = port_mock.service_job(400, cpu=50, mem=32, batch=True)
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        assert len(list(s.store.snapshot().alloc_blocks())) == 1
        s.deregister_job(job.id)
        assert s.wait_for_idle(30.0)
        snap = s.store.snapshot()
        allocs = snap.allocs_by_job(job.id)
        assert len(allocs) == 400
        assert all(a.server_terminal() for a in allocs)
        assert snap.job_by_id(job.id).stopped()
        for n in snap.nodes():
            u = snap.node_usage(n.id)
            assert u is None or np.allclose(u, 0)
    # stop joined every thread the Server started (the solver service's
    # thread belongs to the process's service, not to the Server)
    left = [t for t in set(threading.enumerate()) - before
            if t.name != "bulk-solver"]
    for t in left:
        t.join(timeout=2.0)  # a cancelled nack timer exits on its own
    assert [t.name for t in left if t.is_alive()] == []


def test_blocked_eval_unblocks_on_new_node(port_service):
    with _server() as s:
        small = port_mock.node()
        small.resources.cpu = 600
        small.resources.memory_mb = 512
        small.compute_class()
        s.register_node(small)
        job = port_mock.job()  # 10 x 500 MHz / 256 MB: one fits
        s.register_job(job)
        assert s.wait_for_idle(30.0)
        assert len(s.store.snapshot().allocs_by_job(job.id)) == 1
        assert s.blocked.blocked_count() == 1
        big = port_mock.node()
        big.resources.cpu = 32000
        big.resources.memory_mb = 65536
        big.compute_class()
        s.register_node(big)
        deadline = time.time() + 30
        while time.time() < deadline:
            live = [a for a in s.store.snapshot().allocs_by_job(job.id)
                    if not a.terminal_status()]
            if len(live) == 10:
                break
            time.sleep(0.05)
        assert len(live) == 10
        assert s.wait_for_idle(30.0)
        assert s.blocked.blocked_count() == 0


# --------------------------------------------------------------------------
# parity with the reference Server
# --------------------------------------------------------------------------


def _pin_ids(monkeypatch):
    """One id counter a module that imported generate_uuid by name, in
    each package: eval ids (the jitter's seeds), alloc and block ids."""
    for mod in (ref_server, ref_generic, port_server, port_generic):
        counter = itertools.count()
        monkeypatch.setattr(
            mod, "generate_uuid",
            lambda c=counter, m=mod.__name__.split(".")[-1]:
            f"{next(c):08x}-{len(m):04x}-0000-0000-000000000000")
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])


def _register_all(srv, jobs, timeout=30.0):
    with srv:
        for j in jobs:
            srv.register_job(j)
        assert srv.wait_for_idle(timeout)
        return dict(srv.plan_applier.stats)


@pytest.mark.parametrize("alg,incr", [
    pytest.param("tpu-binpack", "0", id="tpu-binpack"),
    pytest.param("tpu-solve", "0", id="tpu-solve"),
    pytest.param("tpu-binpack", "1", id="tpu-binpack-incr"),
    pytest.param("tpu-solve", "1", id="tpu-solve-incr")])
def test_server_fingerprint_equals_reference(alg, incr, monkeypatch,
                                             port_service):
    """Both packages' Servers on the same pinned workload, with the
    incremental feed off (the kill switch) and on: the same per-job
    fingerprint. With the feed on, every service resync of the port takes
    the twin route, and the feed ends exact against a rebuild."""
    monkeypatch.setenv("NOMAD_TPU_INCR", incr)
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    _pin_ids(monkeypatch)
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    try:
        ref = ref_server.Server(ref_server.ServerConfig(
            num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
            gc_interval=3600, nack_timeout=900.0,
            sched_config=ref_operator.SchedulerConfiguration(
                scheduler_algorithm=alg)))
        bench.build_nodes(ref.store, 256)
        jobs = []
        for i, (count, cpu, mem) in enumerate(JOBS):
            j = bench.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = j.name = f"srv-parity-{i}"
            jobs.append(j)
        records = [job_record(j) for j in jobs]
        ref_stats = _register_all(ref, jobs)
    finally:
        ref_svc.stop()
    want = fingerprint(ref.store, jobs)
    assert sum(fp[0] for fp in want.values()) == sum(c for c, _, _ in JOBS)

    srv = _server(alg, num_workers=1, eval_batch_size=1, nack_timeout=900.0)
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        srv.store.upsert_node(n)
    pjobs = [convert.job_from_record(r) for r in records]
    TRACER.clear()
    stats = _register_all(srv, pjobs)
    got = fingerprint(srv.store, pjobs)
    assert set(got) == set(want)
    for jid in want:
        assert got[jid][:2] == want[jid][:2], jid
        assert np.allclose(got[jid][2], want[jid][2], rtol=0,
                           atol=1e-12), jid
    for key in ("applied", "nodes_rejected", "partial_commits"):
        assert stats[key] == ref_stats[key], key
    joint = port_service.stats["joint_launches"]
    assert (joint == len(jobs)) if alg == "tpu-solve" else joint == 0
    assert over_capacity(srv.store) == []
    resyncs = port_service.stats["resyncs"]
    feed = port_incremental.feed_for(srv.store)
    if incr == "1":
        assert port_service.stats["twin_resyncs"] == resyncs >= 1
        assert port_service.stats["host_resyncs"] == 0
        assert feed.stats()["fast_hits"] > 0
        assert feed.force_verify()
    else:
        assert port_service.stats["host_resyncs"] == resyncs >= 1
        assert port_service.stats["twin_resyncs"] == 0
        assert feed.stats()["builds"] == 0
    # the per-eval span chain of the port's Server
    names = {r[0] for r in TRACER.spans()}
    assert {"eval.queued", "worker.snapshot", "worker.schedule",
            "worker.tensor_build", "worker.solve_bulk", "solver.wait",
            "solver.launch", "solver.apply", "plan.submit", "plan.verify",
            "plan.commit_round", "plan.commit", "eval.persist"} <= names


def test_racing_workers_never_oversubscribe(port_service):
    """4 workers in batches of 8 race bulk groups (the service's carry)
    against rack-spread groups (the per-eval scan on the store's usage):
    the applier rejects what a race over-booked, the schedulers place
    the rest, and every alloc lands once with no node over capacity."""
    before = REGISTRY.get("nomad.plan.node_rejected")
    _ext.COUNTS.reset()
    with _server(num_workers=4, eval_batch_size=8) as s:
        port_mock.build_nodes(s.store, 256)
        jobs = []
        for i in range(12):
            if i % 3 == 1:
                j = port_mock.service_job(
                    120, cpu=1000, mem=1024, batch=True,
                    spreads=[Spread(attribute="${attr.rack}", weight=50)])
            else:
                j = port_mock.service_job(700, cpu=250, mem=256, batch=True)
            jobs.append(j)
        for j in jobs:
            s.register_job(j)
        deadline = time.time() + 30.0
        while True:
            assert s.wait_for_idle(max(1.0, deadline - time.time()))
            if s.blocked.blocked_count() == 0:
                break
            assert time.time() < deadline, "blocked evals did not drain"
            time.sleep(0.1)
        snap = s.store.snapshot()
        want = sum(j.task_groups[0].count for j in jobs)
        placed = sum(len([a for a in snap.allocs_by_job(j.id)
                          if not a.terminal_status()]) for j in jobs)
        ids = [a.id for a in snap.allocs()]
        assert placed == want == len(ids) == len(set(ids))
        assert over_capacity(s.store) == []
        stats = s.plan_applier.stats
    rejected = stats["nodes_rejected"]
    assert REGISTRY.get("nomad.plan.node_rejected") - before == rejected
    assert stats["partial_commits"] <= rejected
    assert stats["applied"] >= len(jobs) + stats["partial_commits"]
    # bench.py's rejection rate over what the applier verified
    assert 0.0 <= rejected / (placed + rejected) < 1.0
    assert port_service.stats["solves"] >= 8
    assert not any(_ext.COUNTS.snapshot()["plain_on_cuda"].values())
