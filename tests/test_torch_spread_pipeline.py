"""The per-eval general path as a whole: a pinned workload of spread,
distinct_hosts, distinct_property and small jobs under "tpu-binpack"
through the JAX package's Harness and through the port's
Harness(device="cpu") gives the same fingerprint. The jobs take all
three routes of the placer: the per-eval scan (B9) for the spread and
distinct_* groups, the host oracle for the count-10 group.

Counts per node are exact. Scores: the host oracle's are float64 and
exact; the scan's are float32 and may differ by one rounding of the f32
``10**x`` between torch and XLA (1 ulp, 1.2e-7 near 1.0), so they are
held to 1e-6 absolute."""

import numpy as np
import pytest

import bench
from nomad_tpu import mock
from nomad_tpu.structs import Constraint, Spread, SpreadTarget
from nomad_tpu.structs.operator import SchedulerConfiguration
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import Harness as PortHarness
from test_torch_pipeline import (device_ask_records, fingerprint,
                                 network_records, node_record)

ALG = "tpu-binpack"
SCORE_ATOL = 1e-6


def _jobs():
    """(count, spreads, constraints) of the pinned workload."""
    return [
        (300, [Spread(attribute="${attr.rack}", weight=50)], []),
        (100, [Spread(attribute="${attr.zone}", weight=70,
                      targets=[SpreadTarget("z0", 50),
                               SpreadTarget("z1", 20)])], []),
        (40, [], [Constraint("", "", "distinct_hosts")]),
        (60, [], [Constraint("${attr.rack}", "4", "distinct_property")]),
        (10, [], []),
    ]


def job_record(j) -> dict:
    """A reference Job, spreads included, as plain data."""
    def cons(cs):
        return [(c.ltarget, c.rtarget, c.operand) for c in cs]

    def affs(a):
        return [(x.ltarget, x.rtarget, x.operand, x.weight) for x in a]

    def spreads(ss):
        return [(s.attribute, s.weight,
                 [(t.value, t.percent) for t in s.targets]) for s in ss]

    return dict(
        id=j.id, name=j.name, namespace=j.namespace, type=j.type,
        priority=j.priority, datacenters=list(j.datacenters),
        node_pool=j.node_pool, constraints=cons(j.constraints),
        affinities=affs(j.affinities), spreads=spreads(j.spreads),
        task_groups=[dict(
            name=tg.name, count=tg.count, constraints=cons(tg.constraints),
            affinities=affs(tg.affinities), spreads=spreads(tg.spreads),
            ephemeral_disk_mb=tg.ephemeral_disk.size_mb,
            networks=network_records(tg.networks),
            update=(None if tg.update is None else dict(
                max_parallel=tg.update.max_parallel,
                progress_deadline_s=tg.update.progress_deadline_s,
                auto_revert=tg.update.auto_revert,
                auto_promote=tg.update.auto_promote,
                canary=tg.update.canary)),
            tasks=[dict(
                name=t.name, driver=t.driver, config=dict(t.config),
                constraints=cons(t.constraints),
                affinities=affs(t.affinities),
                resources=dict(cpu=t.resources.cpu,
                               memory_mb=t.resources.memory_mb,
                               disk_mb=t.resources.disk_mb,
                               cores=t.resources.cores,
                               numa_affinity=t.resources.numa_affinity,
                               networks=network_records(t.resources.networks),
                               devices=device_ask_records(
                                   t.resources.devices)))
                for t in tg.tasks]) for tg in j.task_groups])


def _run_reference(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", svc)
    try:
        h = Harness()
        bench.build_nodes(h.store, 256)
        cfg = SchedulerConfiguration(scheduler_algorithm=ALG)
        jobs = []
        for i, (count, spreads, constraints) in enumerate(_jobs()):
            j = bench.service_job(count, spreads=spreads,
                                  constraints=constraints)
            j.id = f"spread-{i}"
            jobs.append(j)
        records = [job_record(j) for j in jobs]
        for i, j in enumerate(jobs):
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"spread-ev-{i}"),
                      sched_config=cfg)
        return h, jobs, records
    finally:
        svc.stop()


@pytest.fixture
def port_service(monkeypatch):
    svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", svc)
    yield svc
    svc.stop()


def test_spread_pipeline_fingerprint_equals_reference(monkeypatch,
                                                      port_service):
    ref_h, ref_jobs, job_records = _run_reference(monkeypatch)
    want = fingerprint(ref_h.store, ref_jobs)
    assert [fp[0] for fp in want.values()] == [c for c, _, _ in _jobs()]

    h = PortHarness(device="cpu")
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref_h.store.snapshot().nodes()]):
        h.store.upsert_node(n)
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    jobs = [convert.job_from_record(r) for r in job_records]
    _ext.COUNTS.reset()
    for i, j in enumerate(jobs):
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j, id=f"spread-ev-{i}"),
                  sched_config=cfg)
    got = fingerprint(h.store, jobs)
    assert set(got) == set(want)
    for jid in want:
        n_w, nodes_w, scores_w = want[jid]
        n_g, nodes_g, scores_g = got[jid]
        assert n_g == n_w and nodes_g == nodes_w, jid
        assert len(scores_g) == len(scores_w), jid
        np.testing.assert_allclose(scores_g, scores_w, rtol=0,
                                   atol=SCORE_ATOL, err_msg=jid)
    # four groups through the scan's plain version, none through the bulk
    # service, the count-10 group through the host oracle
    assert _ext.COUNTS.plain_on_cuda["solve_task_group"] == 0
    assert port_service.stats["launches"] == 0
    assert all(e.status == "complete" and not e.failed_tg_allocs
               for e in h.evals)

    snap = h.store.snapshot()
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    usage = np.zeros((len(nodes), 4))
    for a in snap.allocs():
        usage[row[a.node_id]] += a.allocated_vec
    cap = np.stack([n.available_vec() for n in nodes])
    assert (usage <= cap).all()
    # the reference's deployment rule, mirrored: a group with
    # per-request placements opens one, the 300-alloc bulk-placed group
    # does not
    ref_snap = ref_h.store.snapshot()
    for j, rj in zip(jobs, ref_jobs):
        mine = snap.latest_deployment_by_job(j.id)
        theirs = ref_snap.latest_deployment_by_job(rj.id)
        assert (mine is None) == (theirs is None), j.id
        if mine is not None:
            assert sorted(mine.task_groups) == sorted(theirs.task_groups)
    assert snap.latest_deployment_by_job(jobs[0].id) is None


def test_spread_pipeline_counts_scan_launches(monkeypatch, port_service):
    """The scan's plain version runs once per per-eval group, the host
    oracle takes the small group, and a second eval of a placed job is
    a no-op."""
    h = PortHarness(device="cpu")
    port_mock.build_nodes(h.store, 64)
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    calls = []
    from nomad_tpu_torch.tensor import placer as port_placer

    real = port_placer.solve_task_group_fused
    monkeypatch.setattr(port_placer, "solve_task_group_fused",
                        lambda *a: calls.append(a[1].shape[0]) or real(*a))
    for count, spreads, constraints in _jobs()[:3] + [(12, [], [])]:
        j = port_mock.service_job(
            count, spreads=[port_mock_spread(s) for s in spreads],
            constraints=[port_mock_constraint(c) for c in constraints])
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j), sched_config=cfg)
        assert len(h.store.snapshot().allocs_by_job(j.id)) == count
        plans = len(h.plans)
        h.process(port_mock.eval_for(j), sched_config=cfg)
        assert len(h.plans) == plans   # nothing left to place
    # K 300 -> 512, 100 -> 128, the distinct_hosts 40 -> 64; the 12 on
    # the host oracle
    assert calls == [512, 128, 64]


def port_mock_spread(s):
    from nomad_tpu_torch.structs import Spread as PSpread
    from nomad_tpu_torch.structs import SpreadTarget as PTarget

    return PSpread(attribute=s.attribute, weight=s.weight,
                   targets=[PTarget(t.value, t.percent) for t in s.targets])


def port_mock_constraint(c):
    from nomad_tpu_torch.structs import Constraint as PConstraint

    return PConstraint(ltarget=c.ltarget, rtarget=c.rtarget,
                       operand=c.operand)


def test_racing_per_eval_solves_never_oversubscribe(monkeypatch,
                                                    port_service):
    """Six threads race spread jobs onto a nearly full cluster. The
    harness commits plans without re-checking fit, so only the per-eval
    lock and the in-flight overlay keep racing solves off each other's
    capacity: no node may end over capacity."""
    import sys
    import threading
    import time

    from nomad_tpu_torch.structs import Spread as PSpread
    from nomad_tpu_torch.tensor.overlay import INFLIGHT

    h = PortHarness(device="cpu")
    port_mock.build_nodes(h.store, 16, seed=3)
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    jobs = [port_mock.service_job(20, cpu=1000, mem=64, spreads=[
        PSpread(attribute="${attr.rack}", weight=50)]) for _ in range(12)]
    for j in jobs:
        h.store.upsert_job(j)
    errors = []

    def worker(mine):
        try:
            for j in mine:
                h.process(port_mock.eval_for(j), sched_config=cfg)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    # widen the window between reading the in-flight entries and
    # reading the store, where a racing commit could slip through
    real_fold = INFLIGHT.fold

    def slow_fold(*a, **kw):
        time.sleep(0.005)
        real_fold(*a, **kw)

    monkeypatch.setattr(INFLIGHT, "fold", slow_fold)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(jobs[i::6],))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    snap = h.store.snapshot()
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    usage = np.zeros((len(nodes), 4))
    allocs = list(snap.allocs())
    for a in allocs:
        usage[row[a.node_id]] += a.allocated_vec
    cap = np.stack([n.available_vec() for n in nodes])
    assert (usage <= cap).all()
    assert len({a.id for a in allocs}) == len(allocs) > 100
    assert INFLIGHT.stats["registered"] >= 12
