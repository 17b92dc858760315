"""The slice as a whole: the pinned C2M workload of
tests/test_c2m_sharded.py::_run_pipeline (256 nodes, three batch jobs,
pinned job and eval ids, "tpu-binpack") through the JAX package's Harness
and through the port's Harness(device="cpu") must give the same per-job
fingerprint. The port's nodes and jobs are carried across from the
reference's as plain records (nomad_tpu_torch.convert)."""

import numpy as np
import pytest

import bench
from nomad_tpu import mock
from nomad_tpu.structs.operator import SchedulerConfiguration
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.structs import Constraint
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.resources import NetworkResource, RequestedDevice
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.tensor.placer import TorchPlacer
from nomad_tpu_torch.testing import Harness as PortHarness

ALG = "tpu-binpack"
JOBS = ((700, 50, 32), (900, 60, 48), (500, 80, 64))


def node_record(n) -> dict:
    """A reference Node as plain data."""
    r, rs = n.resources, n.reserved
    return dict(
        id=n.id, name=n.name, datacenter=n.datacenter,
        node_class=n.node_class, node_pool=n.node_pool,
        attributes=dict(n.attributes), meta=dict(n.meta),
        drivers=dict(n.drivers), status=n.status,
        scheduling_eligibility=n.scheduling_eligibility,
        host_volumes=dict(n.host_volumes), drain_strategy=n.drain_strategy,
        resources=dict(cpu=r.cpu, memory_mb=r.memory_mb, disk_mb=r.disk_mb,
                       total_cores=r.total_cores,
                       min_dynamic_port=r.min_dynamic_port,
                       max_dynamic_port=r.max_dynamic_port,
                       devices=list(r.devices), networks=list(r.networks),
                       numa=list(r.numa)),
        reserved=dict(cpu=rs.cpu, memory_mb=rs.memory_mb, disk_mb=rs.disk_mb,
                      reserved_ports=list(rs.reserved_ports)))


def job_record(j) -> dict:
    """A reference Job as plain data."""
    def cons(cs):
        return [(c.ltarget, c.rtarget, c.operand) for c in cs]

    def affs(a):
        return [(x.ltarget, x.rtarget, x.operand, x.weight) for x in a]

    return dict(
        id=j.id, name=j.name, namespace=j.namespace, type=j.type,
        priority=j.priority, datacenters=list(j.datacenters),
        node_pool=j.node_pool, constraints=cons(j.constraints),
        affinities=affs(j.affinities), spreads=list(j.spreads),
        task_groups=[dict(
            name=tg.name, count=tg.count, constraints=cons(tg.constraints),
            affinities=affs(tg.affinities), spreads=list(tg.spreads),
            networks=list(tg.networks), volumes=dict(tg.volumes),
            ephemeral_disk_mb=tg.ephemeral_disk.size_mb,
            update=(None if tg.update is None else dict(
                max_parallel=tg.update.max_parallel,
                canary=tg.update.canary)),
            tasks=[dict(
                name=t.name, driver=t.driver, config=dict(t.config),
                constraints=cons(t.constraints),
                affinities=affs(t.affinities),
                resources=dict(cpu=t.resources.cpu,
                               memory_mb=t.resources.memory_mb,
                               disk_mb=t.resources.disk_mb,
                               cores=t.resources.cores,
                               networks=list(t.resources.networks),
                               devices=list(t.resources.devices)))
                for t in tg.tasks]) for tg in j.task_groups])


def fingerprint(store, jobs):
    """Per job: alloc count, per-node counts keyed by registration
    ordinal, sorted set of normalized scores."""
    snap = store.snapshot()
    ordinal = {n.id: i for i, n in enumerate(snap.nodes())}
    out = {}
    for j in jobs:
        per_node, scores = {}, []
        allocs = snap.allocs_by_job(j.id)
        for a in allocs:
            key = ordinal[a.node_id]
            per_node[key] = per_node.get(key, 0) + 1
            if a.metrics is not None:
                scores.extend(v for k, v in a.metrics.scores.items()
                              if k.endswith(".normalized-score"))
        out[j.id] = (len(allocs), tuple(sorted(per_node.items())),
                     tuple(sorted(set(scores))))
    return out


@pytest.fixture
def port_service(monkeypatch):
    """A private CPU service installed as the port's singleton."""
    svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", svc)
    yield svc
    svc.stop()


def _run_reference(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", svc)
    try:
        h = Harness()
        bench.build_nodes(h.store, 256)
        cfg = SchedulerConfiguration(scheduler_algorithm=ALG)
        jobs = []
        for i, (count, cpu, mem) in enumerate(JOBS):
            j = bench.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = f"parity-{ALG}-{i}"
            jobs.append(j)
        records = [job_record(j) for j in jobs]
        for i, j in enumerate(jobs):
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"parity-ev-{ALG}-{i}"),
                      sched_config=cfg)
        return h, jobs, records
    finally:
        svc.stop()


def test_pipeline_fingerprint_equals_reference(monkeypatch, port_service):
    ref_h, ref_jobs, job_records = _run_reference(monkeypatch)
    want = fingerprint(ref_h.store, ref_jobs)
    assert sum(fp[0] for fp in want.values()) == 700 + 900 + 500

    h = PortHarness(device="cpu")
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref_h.store.snapshot().nodes()]):
        h.store.upsert_node(n)
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    jobs = [convert.job_from_record(r) for r in job_records]
    for i, j in enumerate(jobs):
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j, id=f"parity-ev-{ALG}-{i}"),
                  sched_config=cfg)
    got = fingerprint(h.store, jobs)
    assert set(got) == set(want)
    for jid in want:
        n_w, nodes_w, scores_w = want[jid]
        n_g, nodes_g, scores_g = got[jid]
        assert n_g == n_w and nodes_g == nodes_w, jid
        assert len(scores_g) == len(scores_w), jid
        assert np.allclose(scores_g, scores_w, rtol=0, atol=1e-12), jid
    assert port_service.stats["launches"] >= 3

    snap = h.store.snapshot()
    ids = [a.id for a in snap.allocs()]
    assert len(ids) == len(set(ids)) == 2100
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    usage = np.zeros((len(nodes), 4))
    for a in snap.allocs():
        usage[row[a.node_id]] += a.allocated_vec
    cap = np.stack([n.available_vec() for n in nodes])
    assert (usage <= cap).all()
    assert all(e.status == "complete" and not e.failed_tg_allocs
               for e in h.evals)


def _port_cluster(n=256):
    h = PortHarness(device="cpu")
    port_mock.build_nodes(h.store, n)
    return h


def test_unported_shapes_raise_not_implemented(port_service):
    h = _port_cluster()
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    # dynamic ports (bulk-sized and host-oracle-sized groups)
    for count in (300, 10):
        ports = port_mock.service_job(count)
        ports.task_groups[0].tasks[0].resources.networks = [
            NetworkResource(dynamic_ports=["http"])]
        h.store.upsert_job(ports)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            h.process(port_mock.eval_for(ports), sched_config=cfg)
    # a device ask
    gpu = port_mock.service_job(40)
    gpu.task_groups[0].tasks[0].resources.devices = [
        RequestedDevice(name="nvidia/gpu")]
    h.store.upsert_job(gpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        h.process(port_mock.eval_for(gpu), sched_config=cfg)
    # a version constraint
    versioned = port_mock.service_job(40, constraints=[Constraint(
        "${attr.kernel.version}", ">= 4.19", "version")])
    h.store.upsert_job(versioned)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        h.process(port_mock.eval_for(versioned), sched_config=cfg)
    # the host placer is not ported
    big = port_mock.service_job(300, batch=True)
    h.store.upsert_job(big)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        h.process(port_mock.eval_for(big),
                  sched_config=port_operator.SchedulerConfiguration())
    assert port_service.stats["launches"] == 0


def test_node_pool_override_and_injected_placer(port_service):
    """A pool override of the algorithm swaps the placer unless one was
    injected (the reference's _placer_injected hazard, kept as is)."""
    h = _port_cluster()
    h.store.upsert_node_pool(port_operator.NodePool(
        name="default",
        scheduler_configuration=port_operator.NodePoolSchedulerConfiguration(
            scheduler_algorithm="binpack")))
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    j = port_mock.service_job(300, batch=True)
    h.store.upsert_job(j)
    with pytest.raises(NotImplementedError, match="host placer"):
        h.process(port_mock.eval_for(j), sched_config=cfg)
    h.process(port_mock.eval_for(j), sched_config=cfg,
              placer=TorchPlacer(device="cpu"))
    assert len(h.store.snapshot().allocs_by_job(j.id)) == 300
    assert port_service.stats["launches"] == 1


def test_rejected_plans_retry_then_block(port_service):
    """A planner that commits nothing: the batch scheduler retries its
    zero-progress attempts, then fails the eval with a blocked eval; each
    rejected solve's usage leaves the carry as negative corrections."""
    h = _port_cluster()
    h.reject_plan = True
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    j = port_mock.service_job(300, batch=True)
    h.store.upsert_job(j)
    h.process(port_mock.eval_for(j), sched_config=cfg)
    assert len(h.plans) == 2                 # MAX_BATCH_ATTEMPTS
    assert h.evals[-1].status == "failed"
    assert len(h.created_evals) == 1
    assert h.created_evals[0].status == "blocked"
    assert not h.store.snapshot().allocs_by_job(j.id)
    touched = sum(len(p.alloc_blocks[0].node_ids) for p in h.plans)
    assert port_service.stats["corrections"] == touched > 0
    with port_service._lock:
        assert not port_service._ledger
