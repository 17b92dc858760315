"""The slice as a whole: the pinned C2M workload of
tests/test_c2m_sharded.py::_run_pipeline (256 nodes, three batch jobs,
pinned job and eval ids) under "tpu-binpack" and under "tpu-solve"
through the JAX package's Harness and through the port's
Harness(device="cpu") must give the same per-job fingerprint. The port's
nodes and jobs are carried across from the reference's as plain records
(nomad_tpu_torch.convert)."""

import dataclasses
import random

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


def _rows(cs, weighted=False):
    return [(c.ltarget, c.rtarget, c.operand) + ((c.weight,) if weighted
                                                  else ()) for c in cs]


def network_records(nets) -> list:
    return [dataclasses.asdict(n) for n in nets]


def device_ask_records(asks) -> list:
    return [dict(name=d.name, count=d.count, constraints=_rows(d.constraints),
                 affinities=_rows(d.affinities, weighted=True))
            for d in asks]


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
                       devices=[dataclasses.asdict(d) for d in r.devices],
                       networks=network_records(r.networks),
                       numa=[dataclasses.asdict(d) for d in r.numa]),
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
            networks=network_records(tg.networks), volumes=dict(tg.volumes),
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
                               numa_affinity=t.resources.numa_affinity,
                               networks=network_records(t.resources.networks),
                               devices=device_ask_records(
                                   t.resources.devices)))
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


def _run_reference(monkeypatch, alg):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", svc)
    try:
        h = Harness()
        bench.build_nodes(h.store, 256)
        cfg = SchedulerConfiguration(scheduler_algorithm=alg)
        jobs = []
        for i, (count, cpu, mem) in enumerate(JOBS):
            j = bench.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = f"parity-{alg}-{i}"
            jobs.append(j)
        records = [job_record(j) for j in jobs]
        for i, j in enumerate(jobs):
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"parity-ev-{alg}-{i}"),
                      sched_config=cfg)
        return h, jobs, records, dict(svc.stats)
    finally:
        svc.stop()


@pytest.mark.parametrize("alg", [ALG, "tpu-solve"])
def test_pipeline_fingerprint_equals_reference(monkeypatch, port_service,
                                               alg):
    ref_h, ref_jobs, job_records, ref_stats = _run_reference(monkeypatch,
                                                             alg)
    want = fingerprint(ref_h.store, ref_jobs)
    assert sum(fp[0] for fp in want.values()) == 700 + 900 + 500

    h = PortHarness(device="cpu")
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref_h.store.snapshot().nodes()]):
        h.store.upsert_node(n)
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=alg)
    jobs = [convert.job_from_record(r) for r in job_records]
    for i, j in enumerate(jobs):
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j, id=f"parity-ev-{alg}-{i}"),
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
    joint = port_service.stats["joint_launches"]
    if alg == "tpu-solve":
        # one joint launch per eval, as in the reference, with the same
        # pick and the same auction rounds
        assert joint >= 1 and joint == ref_stats["joint_launches"]
        for key in ("auction_won", "auction_rounds", "joint_solves"):
            assert port_service.stats[key] == ref_stats[key], key
        assert port_service.stats["joint_score"] == pytest.approx(
            ref_stats["joint_score"], rel=1e-6)
    else:
        assert joint == 0

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
    # a network mode other than "host" (bulk-sized and host-oracle-sized
    # groups) and a group volume: ROADMAP queue A5b
    for count in (300, 10):
        bridged = port_mock.service_job(count)
        bridged.task_groups[0].networks = [
            NetworkResource(mode="bridge", dynamic_ports=["http"])]
        h.store.upsert_job(bridged)
        with pytest.raises(NotImplementedError, match="ROADMAP queue A5b"):
            h.process(port_mock.eval_for(bridged), sched_config=cfg)
    volume = port_mock.service_job(40)
    volume.task_groups[0].volumes = {"data": object()}
    h.store.upsert_job(volume)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A5b"):
        h.process(port_mock.eval_for(volume), sched_config=cfg)
    # ports, device asks and version constraints place (A5)
    for count in (300, 10):
        ports = port_mock.service_job(count)
        ports.task_groups[0].tasks[0].resources.networks = [
            NetworkResource(dynamic_ports=["http"])]
        h.store.upsert_job(ports)
        h.process(port_mock.eval_for(ports), sched_config=cfg)
        placed = h.store.snapshot().allocs_by_job(ports.id)
        assert len(placed) == count
        assert all(len(a.allocated_ports) == 1 for a in placed)
    gpu = port_mock.service_job(40)
    gpu.task_groups[0].tasks[0].resources.devices = [
        RequestedDevice(name="nvidia/gpu")]
    h.store.upsert_job(gpu)
    h.process(port_mock.eval_for(gpu), sched_config=cfg)
    assert h.store.snapshot().allocs_by_job(gpu.id) == []  # no GPU nodes
    versioned = port_mock.service_job(40, constraints=[Constraint(
        "${attr.kernel.version}", ">= 4.19", "version")])
    h.store.upsert_job(versioned)
    h.process(port_mock.eval_for(versioned), sched_config=cfg)
    snap = h.store.snapshot()
    placed = snap.allocs_by_job(versioned.id)
    assert len(placed) == 40
    assert {snap.node_by_id(a.node_id).attributes["kernel.version"]
            for a in placed} <= {"4.19.0", "5.10.0"}
    # the default algorithm ("binpack") places through the host placer
    big = port_mock.service_job(300, batch=True)
    h.store.upsert_job(big)
    h.process(port_mock.eval_for(big),
              sched_config=port_operator.SchedulerConfiguration())
    assert len(h.store.snapshot().allocs_by_job(big.id)) == 300
    # a sysbatch job
    sysbatch = port_mock.system_job()
    sysbatch.type = "sysbatch"
    h.store.upsert_job(sysbatch)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A1"):
        h.process(port_mock.eval_for(sysbatch), sched_config=cfg)
    # a system job update: its allocs of the old version must be replaced
    system = port_mock.system_job()
    h.store.upsert_job(system)
    h.process(port_mock.eval_for(system), sched_config=cfg)
    assert len(h.store.snapshot().allocs_by_job(system.id)) == 256
    h.store.upsert_job(system)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A1"):
        h.process(port_mock.eval_for(system), sched_config=cfg)
    assert port_service.stats["launches"] == 0


def test_tpu_solve_matches_greedy_placement_count(port_service):
    """The reference's test of the same name (tests/test_batch_solver.py)
    through the port's Harness: on 24 nodes, three jobs of 256 allocs,
    "tpu-solve" places every alloc that "tpu-binpack" places."""
    def run(algorithm):
        h = PortHarness(device="cpu")
        rng = random.Random(9)
        jobs = [port_mock.service_job(256, cpu=rng.choice([60, 100, 140]),
                                      mem=rng.choice([48, 64, 128]),
                                      batch=True) for _ in range(3)]
        for i in range(24):
            n = port_mock.node(id=f"pc-{algorithm}-{i:03d}")
            n.resources.cpu = 16000
            n.resources.memory_mb = 32768
            n.compute_class()
            h.store.upsert_node(n)
        cfg = port_operator.SchedulerConfiguration(
            scheduler_algorithm=algorithm)
        for j in jobs:
            h.store.upsert_job(j)
            h.process(port_mock.eval_for(j), sched_config=cfg)
        snap = h.store.snapshot()
        return sum(len(snap.allocs_by_job(j.id)) for j in jobs)

    assert run("tpu-solve") == run(ALG) == 3 * 256
    assert port_service.stats["joint_launches"] == 3
    assert port_service.stats["joint_solves"] == 3


def test_node_pool_override_and_injected_placer(port_service):
    """A pool override of the algorithm swaps the placer unless one was
    injected (the reference's _placer_injected hazard, kept as is): the
    pool's "binpack" places through the host placer, with no service
    launch; an injected TorchPlacer keeps the device path."""
    h = _port_cluster()
    h.store.upsert_node_pool(port_operator.NodePool(
        name="default",
        scheduler_configuration=port_operator.NodePoolSchedulerConfiguration(
            scheduler_algorithm="binpack")))
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=ALG)
    j = port_mock.service_job(300, batch=True)
    h.store.upsert_job(j)
    h.process(port_mock.eval_for(j), sched_config=cfg)
    assert len(h.store.snapshot().allocs_by_job(j.id)) == 300
    assert port_service.stats["launches"] == 0
    j2 = port_mock.service_job(300, batch=True)
    h.store.upsert_job(j2)
    h.process(port_mock.eval_for(j2), sched_config=cfg,
              placer=TorchPlacer(device="cpu"))
    assert len(h.store.snapshot().allocs_by_job(j2.id)) == 300
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
