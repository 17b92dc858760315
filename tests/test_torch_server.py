"""The port's Server path (nomad_tpu_torch/core): the broker's cases of
test_core_server.py::TestBroker and test_e2e_pipeline.py::TestDequeueBatch
through both packages' brokers; the Server end to end on the CPU
(register, deregister, a blocked eval that a new node unblocks); the
reference Server's per-job fingerprint (one worker, one eval a dequeue,
pinned ids) under "tpu-binpack" and "tpu-solve"; racing workers whose
plans the applier re-checks; and the allocation lifecycle's endpoints
(nodes down, a drain, failed client updates, an alloc stop, a promoted
canary deployment, scaling, a disconnect and reconnect) through both
packages' Servers with equal rows, then down, drain and failures on four
workers with the incremental feed on; and the lifecycle's own endpoints
(heartbeats, node deregistration, core GC with node delete, CSI volume
registration and claims) through both Servers."""

import copy
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
from nomad_tpu.scheduler import reconcile as ref_reconcile
from nomad_tpu.structs import DrainStrategy as RefDrain
from nomad_tpu.structs.alloc import DesiredTransition as RefTransition
from nomad_tpu.structs.evaluation import Evaluation as RefEvaluation
from nomad_tpu.structs.job import UpdateStrategy as RefUpdate
from nomad_tpu.structs import enums as ref_enums
from nomad_tpu.structs import volumes as ref_volumes
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import broker as port_broker
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.obs.metrics import REGISTRY
from nomad_tpu_torch.obs import TRACER
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.scheduler import reconcile as port_reconcile
from nomad_tpu_torch.structs import (DesiredTransition, DrainStrategy, Spread,
                                     enums)
from nomad_tpu_torch.structs.evaluation import Evaluation
from nomad_tpu_torch.structs.job import UpdateStrategy
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs import volumes as port_volumes
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
    # the bench-safe TTL and GC interval: these tests never heartbeat
    kw.setdefault("heartbeat_ttl", 3600)
    kw.setdefault("gc_interval", 3600)
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


def _c12_jobs():
    """ROADMAP C12's scenario: a "tpu-solve" warm job (the solver service
    syncs its carry), a 64-alloc service job (B9: a per-eval placement the
    carry does not see), then four "tpu-solve" jobs on the same nodes."""
    jobs = [bench.service_job(900, cpu=500, mem=256, batch=True),
            bench.service_job(64, cpu=2000, mem=1024)]
    jobs += [bench.service_job(300, cpu=500, mem=256, batch=True)
             for _ in range(4)]
    for j, name in zip(jobs, ["warm", "b9"] + [f"solve-{i}"
                                              for i in range(4)]):
        j.id = j.name = f"c12-{name}"
    return jobs


def _c12_outcome(srv, jobs):
    """Each job's register-and-drain, then the applier's rejected nodes
    and partial commits, the evals failed at "maximum attempts", and the
    live allocs a job."""
    with srv:
        for j in jobs:
            srv.register_job(j)
            assert srv.wait_for_idle(60.0)
        stats = dict(srv.plan_applier.stats)
    snap = srv.store.snapshot()
    failed = sorted((e.job_id, e.status_description) for e in snap.evals()
                    if e.status == "failed")
    live = {j.id: sum(1 for a in snap.allocs_by_job(j.id)
                      if not a.terminal_status()) for j in jobs}
    return (stats["nodes_rejected"], stats["partial_commits"],
            stats["applied"], failed, live)


@pytest.mark.parametrize("incr", ["0", "1"])
def test_carry_blind_to_per_eval_placements_as_the_reference(
        incr, monkeypatch, port_service):
    """ROADMAP C12 on both packages' Servers (one worker, pinned ids, 64
    nodes, "tpu-solve", the feed off and on): after the B9 job the joint
    solves fill its nodes again from the service's stale carry, the
    applier rejects them and evals run out of plan attempts -- the same
    rejected nodes, partial commits, failed evals and live allocs in
    both. A reference fault the port keeps."""
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
                scheduler_algorithm="tpu-solve")))
        bench.build_nodes(ref.store, 64)
        jobs = _c12_jobs()
        records = [job_record(j) for j in jobs]
        want = _c12_outcome(ref, jobs)
    finally:
        ref_svc.stop()
    srv = port_server.Server(port_server.ServerConfig(
        device="cpu", num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0,
        sched_config=port_operator.SchedulerConfiguration(
            scheduler_algorithm="tpu-solve")))
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        srv.store.upsert_node(n)
    got = _c12_outcome(srv, [convert.job_from_record(r) for r in records])
    assert got == want
    rejected, partial, _, failed, live = got
    assert rejected > 0 and partial > 0 and failed
    assert all(desc == "maximum attempts reached" for _, desc in failed)
    assert live["c12-b9"] == 64
    assert over_capacity(srv.store) == []


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


# --------------------------------------------------------------------------
# the allocation lifecycle's endpoints through both packages' Servers
# --------------------------------------------------------------------------

LC_REF = types.SimpleNamespace(
    mock=ref_mock, enums=ref_enums, Drain=RefDrain, Transition=RefTransition,
    Evaluation=RefEvaluation, Update=RefUpdate)
LC_PORT = types.SimpleNamespace(
    mock=port_mock, enums=enums, Drain=DrainStrategy,
    Transition=DesiredTransition, Evaluation=Evaluation, Update=UpdateStrategy)
ENDPOINTS = ("mark_nodes_down", "drain", "client_failed", "stop_alloc",
             "promote", "scale", "disconnect_reconnect")


def _lc_jobs(pk):
    """A bulk group (one AllocBlock), a per-request group with a rolling
    update, and a group that tolerates disconnects."""
    jobs = []
    for i, (count, cpu, mem, extra) in enumerate((
            (300, 100, 64, {}),
            (40, 200, 128, {"update": pk.Update(max_parallel=8)}),
            (24, 150, 96, {"max_client_disconnect_s": 300.0}))):
        j = pk.mock.job(id=f"lc-{i}")
        tg = j.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        for k, v in extra.items():
            setattr(tg, k, v)
        jobs.append(j)
    return jobs


def _loaded_nodes(srv, job_id, n):
    """The ``n`` nodes holding most live allocs of the job (ties by id)."""
    counts = {}
    for a in srv.store.snapshot().allocs_by_job(job_id):
        if not a.terminal_status():
            counts[a.node_id] = counts.get(a.node_id, 0) + 1
    return sorted(counts, key=lambda nid: (-counts[nid], nid))[:n]


def _by_name(srv, job_id, n=None):
    allocs = sorted((a for a in srv.store.snapshot().allocs_by_job(job_id)
                     if not a.terminal_status()), key=lambda a: a.name)
    return allocs if n is None else allocs[:n]


def _client(srv, allocs, status, **fields):
    upds = []
    for a in allocs:
        u = a.copy_for_update()
        u.client_status = status
        for k, v in fields.items():
            setattr(u, k, v)
        upds.append(u)
    srv.update_allocs_from_client(upds)


def _lc_drive(srv, pk, endpoint):
    """Drive one lifecycle endpoint on a Server of either package, as its
    caller (the client, the drainer, the operator, the watcher) would."""
    e = pk.enums

    def idle():
        assert srv.wait_for_idle(60.0, include_delayed=False)

    if endpoint == "mark_nodes_down":
        nodes = _loaded_nodes(srv, "lc-0", 2)
        if hasattr(srv, "heartbeats"):
            # the reference's TTL timers fired: an armed node is skipped
            for nid in nodes:
                srv.heartbeats.remove(nid)
        srv.mark_nodes_down(nodes)
    elif endpoint == "drain":
        node = _loaded_nodes(srv, "lc-1", 1)[0]
        srv.update_node_drain(node, pk.Drain(deadline_s=600))
        idle()
        on = [a for a in srv.store.snapshot().allocs_by_node(node)
              if not a.terminal_status()]
        evals = [pk.Evaluation(
            id=f"drain-{jid}", namespace="default", priority=50,
            type=e.JOB_TYPE_SERVICE, triggered_by=e.TRIGGER_NODE_DRAIN,
            job_id=jid, status=e.EVAL_STATUS_PENDING)
            for jid in sorted({a.job_id for a in on})]
        transitions = {a.id: pk.Transition(migrate=True) for a in on}
        if hasattr(srv, "update_alloc_desired_transitions"):
            srv.update_alloc_desired_transitions(transitions, evals)
        else:   # the reference's drainer writes and enqueues
            srv.store.update_alloc_desired_transitions(transitions, evals)
            srv.broker.enqueue_all(evals)
    elif endpoint == "client_failed":
        _client(srv, _by_name(srv, "lc-1", 20), e.ALLOC_CLIENT_FAILED,
                task_finished_at=time.time() - 3600)
    elif endpoint == "stop_alloc":
        srv.stop_alloc(_by_name(srv, "lc-1", 1)[0].id)
    elif endpoint == "promote":
        job = copy.deepcopy(srv.store.snapshot().job_by_id("lc-1"))
        job.task_groups[0].tasks[0].config = {"command": "/bin/new"}
        job.task_groups[0].update = pk.Update(canary=2, max_parallel=8)
        srv.register_job(job)
        idle()
        canaries = [a for a in _by_name(srv, "lc-1") if a.canary]
        assert len(canaries) == 2
        _client(srv, canaries, e.ALLOC_CLIENT_RUNNING,
                deployment_status={"healthy": True})
        idle()
        dep = srv.store.snapshot().latest_deployment_by_job("lc-1")
        srv.promote_deployment(dep.id)
        for i in range(8):
            idle()
            srv.create_eval(pk.Evaluation(
                id=f"watch-{i}", namespace="default", priority=50,
                type=e.JOB_TYPE_SERVICE,
                triggered_by=e.TRIGGER_DEPLOYMENT_WATCHER, job_id="lc-1",
                status=e.EVAL_STATUS_PENDING))
    elif endpoint == "scale":
        srv.scale_job("lc-0", "web", 200)
        idle()
        srv.scale_job("lc-1", "web", 60)
    elif endpoint == "disconnect_reconnect":
        node = _loaded_nodes(srv, "lc-2", 1)[0]
        srv.update_node_status(node, e.NODE_STATUS_DISCONNECTED)
        idle()
        srv.update_node_status(node, e.NODE_STATUS_READY)
        idle()
        _client(srv, [a for a in srv.store.snapshot().allocs_by_node(node)
                      if a.client_status == e.ALLOC_CLIENT_UNKNOWN],
                e.ALLOC_CLIENT_RUNNING)
    idle()


def _lc_rows(srv, job_ids):
    snap = srv.store.snapshot()
    allocs = []
    for jid in job_ids:
        for a in snap.allocs_by_job(jid):
            prev = (snap.alloc_by_id(a.previous_allocation).name
                    if a.previous_allocation else "")
            allocs.append((a.name, a.node_name, a.job_version,
                           a.desired_status, a.client_status, prev,
                           bool(a.next_allocation), a.canary))
    evals = sorted((ev.job_id, ev.triggered_by, ev.status,
                    ev.wait_until > 0) for ev in snap.evals())
    deps = [(jid, d.job_version, sorted(
        (g, s.desired_canaries, len(s.placed_canaries), s.promoted)
        for g, s in d.task_groups.items()))
        for jid in job_ids
        for d in [snap.latest_deployment_by_job(jid)] if d is not None]
    return sorted(allocs), evals, deps


@pytest.mark.parametrize("endpoint", ENDPOINTS)
def test_lifecycle_endpoint_equals_reference(endpoint, monkeypatch,
                                             port_service):
    """Each lifecycle endpoint on both packages' Servers (one worker, one
    eval a dequeue, pinned ids, "tpu-binpack"): the same rows, eval
    kinds and deployment states. Both packages' drainers and deployment
    watchers are held off: the caller plays them."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    _pin_ids(monkeypatch)
    for mod in (ref_reconcile, port_reconcile):
        counter = itertools.count()
        monkeypatch.setattr(mod, "generate_uuid", lambda c=counter:
                            f"{next(c):08x}-fup0-0000-0000-000000000000")
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    got = {}
    try:
        ref = ref_server.Server(ref_server.ServerConfig(
            num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
            gc_interval=3600, nack_timeout=900.0,
            sched_config=ref_operator.SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack")))
        ref.deployment_watcher.start = lambda: None
        ref.drainer.start = lambda: None
        bench.build_nodes(ref.store, 64)
        records = [node_record(n) for n in ref.store.snapshot().nodes()]
        with ref:
            for j in _lc_jobs(LC_REF):
                ref.register_job(j)
            assert ref.wait_for_idle(60.0)
            _lc_drive(ref, LC_REF, endpoint)
            got["ref"] = (_lc_rows(ref, ["lc-0", "lc-1", "lc-2"]),
                          {k: ref.plan_applier.stats[k] for k in
                           ("applied", "nodes_rejected")})
    finally:
        ref_svc.stop()
    srv = _server("tpu-binpack", num_workers=1, eval_batch_size=1,
                  nack_timeout=900.0)
    srv.deployment_watcher.start = lambda: None
    srv.drainer.start = lambda: None
    for n in convert.nodes_from_records(records):
        srv.store.upsert_node(n)
    with srv:
        for j in _lc_jobs(LC_PORT):
            srv.register_job(j)
        assert srv.wait_for_idle(60.0)
        _lc_drive(srv, LC_PORT, endpoint)
        got["port"] = (_lc_rows(srv, ["lc-0", "lc-1", "lc-2"]),
                       {k: srv.plan_applier.stats[k] for k in
                        ("applied", "nodes_rejected")})
    assert over_capacity(srv.store) == []
    assert got["port"][0][0] == got["ref"][0][0]
    assert got["port"] == got["ref"]


def test_lifecycle_four_workers_with_the_feed(monkeypatch, port_service):
    """Down, drain and failures on 4 workers with the incremental feed on:
    every group back at its count, no live alloc on a down or drained
    node, 0 nodes over capacity and the feed exact against a rebuild."""
    monkeypatch.setenv("NOMAD_TPU_INCR", "1")
    srv = _server(num_workers=4, eval_batch_size=8)
    # the test plays the drainer and the deployment watcher
    srv.deployment_watcher.start = lambda: None
    srv.drainer.start = lambda: None
    with srv:
        port_mock.build_nodes(srv.store, 128)
        jobs = [port_mock.service_job(400, cpu=50, mem=32) for _ in range(4)]
        for j in jobs:
            srv.register_job(j)
        assert srv.wait_for_idle(60.0)
        down = _loaded_nodes(srv, jobs[0].id, 4)
        srv.mark_nodes_down(down)
        assert srv.wait_for_idle(60.0)
        drained = [n for n in _loaded_nodes(srv, jobs[1].id, 8)
                   if n not in down][:4]
        for node in drained:
            srv.update_node_drain(node, DrainStrategy(deadline_s=600))
        assert srv.wait_for_idle(60.0)
        on = [a for n in drained
              for a in srv.store.snapshot().allocs_by_node(n)
              if not a.terminal_status()]
        srv.update_alloc_desired_transitions(
            {a.id: DesiredTransition(migrate=True) for a in on},
            [port_mock.eval_for(j, triggered_by=enums.TRIGGER_NODE_DRAIN)
             for j in jobs])
        assert srv.wait_for_idle(60.0)
        failed = [a for j in jobs[2:] for a in _by_name(srv, j.id, 60)]
        _client(srv, failed, enums.ALLOC_CLIENT_FAILED,
                task_finished_at=time.time() - 3600)
        assert srv.wait_for_idle(60.0, include_delayed=False)
        snap = srv.store.snapshot()
        gone = set(down) | set(drained)
        for j in jobs:
            live = [a for a in snap.allocs_by_job(j.id)
                    if not a.terminal_status()]
            assert len(live) == 400
            assert not any(a.node_id in gone for a in live)
        repl = [a for a in snap.allocs() if a.previous_allocation]
        assert len(repl) >= len(on) + len(failed)
        assert all(snap.alloc_by_id(a.id).next_allocation
                   for a in failed)
        assert over_capacity(srv.store) == []
        assert port_incremental.feed_for(srv.store).force_verify()


# --------------------------------------------------------------------------
# the lifecycle on its own: the Server's heartbeat, node delete, volume and
# GC endpoints through both packages' Servers
# --------------------------------------------------------------------------

AP_REF = types.SimpleNamespace(
    mock=ref_mock, server=ref_server, enums=ref_enums, extra={})
AP_PORT = types.SimpleNamespace(
    mock=port_mock, server=port_server, enums=enums, extra={"device": "cpu"})
AP_ENDPOINTS = ("heartbeat_batch", "deregister_node", "force_gc",
                "register_volume")


def _ap_server(pk):
    """One worker, one eval a dequeue, the bench-safe TTL, the drainer
    and the watcher held off, 6 nodes with pinned ids."""
    srv = pk.server.Server(pk.server.ServerConfig(
        num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0, **pk.extra))
    srv.deployment_watcher.start = lambda: None
    srv.drainer.start = lambda: None
    for i in range(6):
        srv.store.upsert_node(pk.mock.node(id=f"sv-{i}", name=f"sv-{i}"))
    return srv


def _ap_drive(pk, srv, endpoint):
    """One endpoint's scenario; returns what the caller can see."""
    e = pk.enums
    j = pk.mock.job(id="ap-0", name="ap-0")
    j.task_groups[0].count = 12
    j.task_groups[0].update = None
    srv.register_job(j)
    assert srv.wait_for_idle(60.0, include_delayed=False)
    node = _loaded_nodes(srv, "ap-0", 1)[0]
    if endpoint == "heartbeat_batch":
        srv.heartbeats.remove(node)
        srv.mark_nodes_down([node])
        assert srv.wait_for_idle(60.0, include_delayed=False)
        down = srv.store.snapshot().node_by_id(node).status
        ttl = srv.heartbeat_batch([f"sv-{i}" for i in range(6)] + ["ghost"])
        with pytest.raises(KeyError):
            srv.heartbeat("ghost")
        assert srv.wait_for_idle(60.0, include_delayed=False)
        return (down, ttl, srv.store.snapshot().node_by_id(node).status,
                srv.heartbeats.armed(node))
    if endpoint == "deregister_node":
        srv.deregister_node(node)
        assert srv.wait_for_idle(60.0, include_delayed=False)
        snap = srv.store.snapshot()
        return (snap.node_by_id(node), srv.heartbeats.armed(node),
                sum(1 for a in snap.allocs_by_job("ap-0")
                    if not a.terminal_status()),
                sorted(a.node_id for a in snap.allocs_by_job("ap-0")
                       if not a.terminal_status() and a.node_id == node))
    if endpoint == "force_gc":
        srv.heartbeats.remove(node)
        srv.mark_nodes_down([node])
        assert srv.wait_for_idle(60.0, include_delayed=False)
        srv.deregister_job("ap-0")
        assert srv.wait_for_idle(60.0, include_delayed=False)
        _client(srv, [a for a in srv.store.snapshot().allocs_by_job("ap-0")
                      if not a.client_terminal()], e.ALLOC_CLIENT_COMPLETE)
        stats = srv.force_gc()
        snap = srv.store.snapshot()
        return ({k: stats[k] for k in ("evals", "allocs", "jobs", "nodes",
                                       "deployments", "volume_claims")},
                snap.job_by_id("ap-0"), snap.node_by_id(node),
                sorted(n.id for n in snap.nodes()))
    # register_volume: a CSI writer claims it, a second writer waits, the
    # claim goes with the first writer's stop and GC
    vol_cls = (ref_volumes if pk is AP_REF else port_volumes)
    srv.register_volume(vol_cls.Volume(id="vol", name="vol"))
    w = []
    for i in range(2):
        job = pk.mock.job(id=f"ap-w{i}", name=f"ap-w{i}")
        job.task_groups[0].count = 1
        job.task_groups[0].update = None
        job.task_groups[0].volumes = {"v": vol_cls.VolumeRequest(
            name="v", type="csi", source="vol")}
        srv.register_job(job)
        assert srv.wait_for_idle(60.0, include_delayed=False)
        w.append(sum(1 for a in srv.store.snapshot().allocs_by_job(job.id)
                     if not a.terminal_status()))
    with pytest.raises(ValueError):
        srv.deregister_volume("vol")
    srv.deregister_job("ap-w0")
    assert srv.wait_for_idle(60.0, include_delayed=False)
    _client(srv, srv.store.snapshot().allocs_by_job("ap-w0"),
            e.ALLOC_CLIENT_COMPLETE)
    stats = srv.force_gc()
    claims = sorted(srv.store.snapshot().volume_by_id("vol").claims)
    return w, stats["volume_claims"], claims, srv.blocked.blocked_count()


@pytest.mark.parametrize("endpoint", AP_ENDPOINTS)
def test_autopilot_endpoint_equals_reference(endpoint, monkeypatch):
    """Heartbeats that revive a down node, a node deregistered, core GC
    with node delete, and a CSI volume's claims through both packages'
    Servers (pinned ids, "binpack"): the same answers."""
    _pin_ids(monkeypatch)
    got = {}
    for name, pk in (("ref", AP_REF), ("port", AP_PORT)):
        srv = _ap_server(pk)
        with srv:
            got[name] = _ap_drive(pk, srv, endpoint)
    assert got["port"] == got["ref"]
