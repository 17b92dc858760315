"""Device instance assignment and NUMA core selection
(nomad_tpu_torch/scheduler/devices.py, reference
nomad_tpu/scheduler/devices.py), the device and core columns of the
per-eval solve (tensor/cluster.py ``_device_core_tensors``), the store's
``node_dev_usage`` rows, and the slice's config-5 shape (BASELINE config
5: device asks, two reserved cores, ``numa_affinity="prefer"``): the
same inputs through both packages give the same answers.

Instance ids are pinned (the reference's ``mock.gpu_node`` draws uuids),
and so are job and eval ids, which seed the host oracle's shuffle and
the kernel's tie-break. Fingerprints hold every alloc's node, device
instances, cores and ports; host scores agree to 1e-12, the per-eval
scan's (B9's plain version against JAX's program, both f32) to 1e-6."""

import random
import types

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import devices as ref_devices
from nomad_tpu.scheduler.context import EvalContext as RefEvalContext
from nomad_tpu.structs import Affinity as RefAffinity
from nomad_tpu.structs import Constraint as RefConstraint
from nomad_tpu.structs.alloc import Allocation as RefAllocation
from nomad_tpu.structs.operator import SchedulerConfiguration
from nomad_tpu.structs.resources import NodeDeviceResource as RefDeviceGroup
from nomad_tpu.structs.resources import NumaNode as RefNumaNode
from nomad_tpu.structs.resources import RequestedDevice as RefRequestedDevice
from nomad_tpu.tensor import cluster as ref_cluster
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import devices as port_devices
from nomad_tpu_torch.scheduler.context import EvalContext as PortEvalContext
from nomad_tpu_torch.structs import Affinity, Constraint
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.alloc import Allocation
from nomad_tpu_torch.structs.resources import (NodeDeviceResource, NumaNode,
                                               RequestedDevice)
from nomad_tpu_torch.tensor import cluster as port_cluster
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_bulk_scan import SCAN_SCORE_ATOL, SCORE_ATOL, over_capacity
from test_torch_pipeline import fingerprint, node_record
from test_torch_spread_pipeline import job_record

REF = types.SimpleNamespace(
    name="ref", devices=ref_devices, mock=ref_mock, Group=RefDeviceGroup,
    Numa=RefNumaNode, Ask=RefRequestedDevice, Constraint=RefConstraint,
    Affinity=RefAffinity, Allocation=RefAllocation)
PORT = types.SimpleNamespace(
    name="port", devices=port_devices, mock=port_mock,
    Group=NodeDeviceResource, Numa=NumaNode, Ask=RequestedDevice,
    Constraint=Constraint, Affinity=Affinity, Allocation=Allocation)

def both(fn, ref=REF, port=PORT):
    """``fn(pkg)`` in each package; the answers must be equal."""
    want, got = fn(ref), fn(port)
    assert got == want
    return got


def gpu_node(pkg, n_gpus=4, vendor="nvidia", name="a100", mem="40000",
             tag="n"):
    n = pkg.mock.node()
    n.resources.devices = [pkg.Group(
        vendor=vendor, type="gpu", name=name,
        instance_ids=[f"{tag}-{name}-{k}" for k in range(n_gpus)],
        attributes={"memory": mem})]
    n.compute_class()
    return n


def two_group_node(pkg):
    n = gpu_node(pkg, n_gpus=2, name="a100", mem="40000")
    n.resources.devices.append(pkg.Group(
        vendor="nvidia", type="gpu", name="t4",
        instance_ids=["t4-0", "t4-1", "t4-2"], attributes={"memory": "16000"}))
    n.resources.devices.append(pkg.Group(
        vendor="amd", type="gpu", name="mi100", instance_ids=["mi-0"]))
    n.compute_class()
    return n


def numa_node(pkg, cores=8):
    n = pkg.mock.node()
    half = cores // 2
    n.resources.total_cores = cores
    n.resources.numa = [pkg.Numa(id=0, cores=list(range(half))),
                        pkg.Numa(id=1, cores=list(range(half, cores)))]
    n.compute_class()
    return n


# --------------------------------------------------------------------------
# devices.py units (tests/test_devices.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("selector", ["gpu", "nvidia/gpu", "nvidia/gpu/t4",
                                      "amd/gpu", "nvidia/gpu/h100", "fpga"])
def test_selector_forms_match_the_same_groups(selector):
    def run(pkg):
        node = two_group_node(pkg)
        ask = pkg.Ask(name=selector, count=1)
        groups = pkg.devices.matching_groups(node, ask)
        return ([g.id for g in groups],
                pkg.devices.device_capacity(node, ask))

    both(run)


def test_device_constraints_and_affinities_score_the_same():
    def run(pkg):
        node = two_group_node(pkg)
        big = pkg.Ask(name="nvidia/gpu", count=1, constraints=[pkg.Constraint(
            ltarget="${device.attr.memory}", rtarget="20000", operand=">=")])
        liked = pkg.Ask(name="gpu", count=2, affinities=[
            pkg.Affinity(ltarget="${device.model}", rtarget="t4",
                         operand="=", weight=50),
            pkg.Affinity(ltarget="${device.vendor}", rtarget="amd",
                         operand="=", weight=-20)])
        versioned = pkg.Ask(name="gpu", constraints=[pkg.Constraint(
            ltarget="${device.attr.memory}", rtarget=">= 20000.0",
            operand="version")])
        d = pkg.devices
        return ([g.id for g in d.matching_groups(node, big)],
                [round(d.group_affinity_score(g, liked), 12)
                 for g in node.resources.devices],
                round(d.device_affinity_boost(node, [big, liked]), 12),
                d.device_capacity(node, versioned))

    got = both(run)
    assert got[0] == ["nvidia/gpu/a100"]


@pytest.mark.parametrize("case", ["unique", "existing", "affinity",
                                  "exhausted", "two_asks"])
def test_device_index_assigns_the_same_instances(case):
    def run(pkg):
        node = two_group_node(pkg) if case != "unique" else gpu_node(
            pkg, n_gpus=4)
        existing = []
        if case == "existing":
            existing = [pkg.Allocation(
                id="held", allocated_devices={"nvidia/gpu/a100": ["n-a100-0"],
                                              "nvidia/gpu/t4": ["t4-1"]})]
        idx = pkg.devices.DeviceIndex(node, existing)
        asks = [pkg.Ask(name="nvidia/gpu", count=1)]
        if case == "affinity":
            asks = [pkg.Ask(name="gpu", count=1, affinities=[pkg.Affinity(
                ltarget="${device.model}", rtarget="t4", operand="=",
                weight=100)])]
        elif case == "exhausted":
            asks = [pkg.Ask(name="nvidia/gpu", count=4)]
        elif case == "two_asks":
            asks = [pkg.Ask(name="nvidia/gpu/a100", count=1),
                    pkg.Ask(name="gpu", count=2)]
        out = [idx.assign(asks) for _ in range(5)]
        return out, {k: sorted(v) for k, v in idx.used.items()}

    out, used = both(run)
    if case == "unique":
        insts = [i for a in out if a for v in a.values() for i in v]
        assert len(insts) == len(set(insts)) == 4 and out[4] is None


@pytest.mark.parametrize("policy", ["none", "prefer", "require"])
@pytest.mark.parametrize("taken,k", [((), 2), ((0, 1, 2), 2), ((0, 4), 3),
                                     ((0, 1, 4, 5), 3), ((0, 1, 2, 3), 4),
                                     ((), 9)])
def test_select_cores_picks_the_same_cores(policy, taken, k):
    def run(pkg):
        node = numa_node(pkg)
        held = [pkg.Allocation(id="held", allocated_cores=list(taken))]
        plain = pkg.mock.node()   # no NUMA topology: the lowest free ids
        plain.resources.total_cores = 8
        return (pkg.devices.select_cores(node, held, k, policy),
                pkg.devices.select_cores(plain, held, k, policy),
                pkg.devices.select_cores(node, (), k, policy,
                                         taken=set(taken)))

    both(run)


@pytest.mark.parametrize("policies,want", [
    (("none", "prefer"), "prefer"), (("require", "prefer"), "require"),
    (("none",), "none"), (("", "none"), "none")])
def test_combined_numa_affinity_strictest_wins(policies, want):
    def run(pkg):
        tg = pkg.mock.job().task_groups[0]
        tg.tasks = [type(tg.tasks[0])(name=f"t{i}") for i in
                    range(len(policies))]
        for t, p in zip(tg.tasks, policies):
            t.resources.numa_affinity = p
        return pkg.devices.combined_numa_affinity(tg)

    assert both(run) == want


def test_accumulate_dev_usage_rows():
    def run(pkg):
        row = {}
        a = pkg.Allocation(allocated_devices={"x/gpu/a": ["1", "2"]},
                           allocated_cores=[3, 4, 5])
        b = pkg.Allocation(allocated_devices={"x/gpu/b": ["9"]})
        pkg.devices.accumulate_dev_usage(row, a)
        pkg.devices.accumulate_dev_usage(row, b)
        pkg.devices.accumulate_dev_usage(row, a, -1)
        return row

    assert both(run) == {"x/gpu/a": 0, "cores": 0, "x/gpu/b": 1}


# --------------------------------------------------------------------------
# the scheduler end to end (tests/test_devices.py::TestSchedulerIntegration)
# --------------------------------------------------------------------------


def id_fingerprint(store, jobs):
    """Per job, every live alloc's (node ordinal, device instances,
    cores, ports), sorted."""
    snap = store.snapshot()
    ordinal = {n.id: i for i, n in enumerate(snap.nodes())}
    return {j.id: sorted(
        (ordinal[a.node_id],
         tuple(sorted((k, tuple(v)) for k, v in a.allocated_devices.items())),
         tuple(a.allocated_cores),
         tuple((p.label, p.value) for p in a.allocated_ports))
        for a in snap.allocs_by_job(j.id) if not a.terminal_status())
        for j in jobs}


@pytest.fixture
def services(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref)
    port = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port)
    yield ref, port
    ref.stop()
    port.stop()


def run_both(ref_nodes, ref_jobs, alg, tag, *, atol=None):
    """The reference's nodes and jobs through its Harness, then carried
    across as records through the port's Harness(device="cpu"), one eval
    a job with pinned ids. Checks both fingerprints equal (scores to
    ``atol``: by default 1e-6 under a device algorithm, where the scan's
    f32 scores may differ by an ulp, else 1e-12) and returns (reference
    harness, port harness, port jobs)."""
    if atol is None:
        atol = SCAN_SCORE_ATOL if alg.startswith("tpu") else SCORE_ATOL
    ref = RefHarness()
    for n in ref_nodes:
        ref.store.upsert_node(n)
    records = [job_record(j) for j in ref_jobs]
    cfg = SchedulerConfiguration(scheduler_algorithm=alg)
    for i, j in enumerate(ref_jobs):
        ref.store.upsert_job(j)
        ref.process(ref_mock.eval_for(j, id=f"{tag}-ev-{i}"), sched_config=cfg)

    h = PortHarness(device="cpu")
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        h.store.upsert_node(n)
    pcfg = port_operator.SchedulerConfiguration(scheduler_algorithm=alg)
    jobs = [convert.job_from_record(r) for r in records]
    for i, j in enumerate(jobs):
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j, id=f"{tag}-ev-{i}"),
                  sched_config=pcfg)
    want, got = fingerprint(ref.store, ref_jobs), fingerprint(h.store, jobs)
    assert set(got) == set(want)
    for jid in want:
        assert got[jid][:2] == want[jid][:2], jid
        assert len(got[jid][2]) == len(want[jid][2]), jid
        np.testing.assert_allclose(got[jid][2], want[jid][2], rtol=0,
                                   atol=atol, err_msg=jid)
    assert id_fingerprint(h.store, jobs) == id_fingerprint(ref.store,
                                                           ref_jobs)
    assert over_capacity(h.store) == []
    return ref, h, jobs


def device_job(count, *, cores=0, numa="none", gpus=1, name="nvidia/gpu",
               tag="dev"):
    j = ref_mock.job()
    j.id = j.name = tag
    tg = j.task_groups[0]
    tg.count = count
    res = tg.tasks[0].resources
    res.devices = [RefRequestedDevice(name=name, count=gpus)]
    res.cores = cores
    res.numa_affinity = numa
    return j


ALGS = ("binpack", "tpu-binpack")


@pytest.mark.parametrize("alg", ALGS)
def test_device_and_core_placement(alg, services):
    nodes = []
    for i in range(4):
        n = gpu_node(REF, n_gpus=2, tag=f"n{i}")
        n.resources.total_cores = 8
        n.resources.numa = [RefNumaNode(id=0, cores=[0, 1, 2, 3]),
                            RefNumaNode(id=1, cores=[4, 5, 6, 7])]
        n.compute_class()
        nodes.append(n)
    _, h, jobs = run_both(nodes, [device_job(4, cores=2, numa="require")], alg,
                       f"dc-{alg}")
    allocs = h.store.snapshot().allocs_by_job(jobs[0].id)
    assert len(allocs) == 4
    for a in allocs:
        assert sum(len(v) for v in a.allocated_devices.values()) == 1
        assert (set(a.allocated_cores) <= {0, 1, 2, 3}
                or set(a.allocated_cores) <= {4, 5, 6, 7})


@pytest.mark.parametrize("alg", ALGS)
def test_device_usage_and_exhaustion(alg, services):
    """Instances held by an earlier eval's allocs are taken; a group asks
    for more than remain and places what fits."""
    nodes = [gpu_node(REF, n_gpus=2, tag="a"), gpu_node(REF, n_gpus=1,
                                                         tag="b")]
    jobs = [device_job(1, gpus=2, name="gpu", tag="first"),
            device_job(3, gpus=1, name="gpu", tag="second")]
    _, h, pjobs = run_both(nodes, jobs, alg, f"use-{alg}")
    assert len(h.store.snapshot().allocs_by_job(pjobs[1].id)) == 1


@pytest.mark.parametrize("alg", ALGS)
def test_device_affinity_and_constraint_through_the_kernel(alg, services):
    """A group of 24 (above the host cutover: B9's plain version under
    "tpu-binpack") with a constrained ask and a device affinity, so the
    solve carries a nonzero dev_affinity column."""
    nodes = []
    for i in range(12):
        n = two_group_node(REF)
        if i % 3 == 0:
            n.resources.devices = n.resources.devices[1:]   # t4 and amd
        n.resources.devices = [RefDeviceGroup(
            vendor=g.vendor, type=g.type, name=g.name,
            instance_ids=[f"{i}-{x}" for x in g.instance_ids],
            attributes=dict(g.attributes)) for g in n.resources.devices]
        n.resources.total_cores = 8
        n.compute_class()
        nodes.append(n)
    j = device_job(24, cores=1, name="gpu", tag="aff")
    ask = j.task_groups[0].tasks[0].resources.devices[0]
    ask.constraints = [RefConstraint(ltarget="${device.vendor}",
                                     rtarget="nvidia", operand="=")]
    ask.affinities = [RefAffinity(ltarget="${device.model}", rtarget="a100",
                                  operand="=", weight=80)]
    _ext.COUNTS.reset()
    _, h, jobs = run_both(nodes, [j], alg, f"aff-{alg}")
    placed = h.store.snapshot().allocs_by_job(jobs[0].id)
    assert len(placed) == 24
    if alg == "tpu-binpack":
        assert _ext.COUNTS.plain_on_cuda["solve_task_group"] == 0


# --------------------------------------------------------------------------
# config 5's shape: 64 GPU nodes, 2 jobs x 32
# --------------------------------------------------------------------------


def cfg5_nodes(n_nodes, seed=0):
    """bench.py:846-860's GPU nodes: 8 a100 instances, 16 cores in two
    NUMA domains, 16,000 or 32,000 MHz, 64 GiB."""
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        n = ref_mock.node()
        n.resources.cpu = rng.choice([16000, 32000])
        n.resources.memory_mb = 65536
        n.resources.total_cores = 16
        n.resources.numa = [RefNumaNode(id=0, cores=list(range(8))),
                            RefNumaNode(id=1, cores=list(range(8, 16)))]
        n.resources.devices = [RefDeviceGroup(
            vendor="nvidia", type="gpu", name="a100",
            instance_ids=[f"g{i}-{k}" for k in range(8)])]
        n.compute_class()
        out.append(n)
    return out


def cfg5_jobs(n_jobs, count, tag):
    """bench.py:827-836's jobs: cpu 200, mem 256, one nvidia/gpu, two
    cores, numa_affinity "prefer"."""
    out = []
    for i in range(n_jobs):
        j = device_job(count, cores=2, numa="prefer", tag=f"{tag}-{i}")
        tg = j.task_groups[0]
        tg.tasks[0].resources.cpu = 200
        tg.tasks[0].resources.memory_mb = 256
        out.append(j)
    return out


@pytest.mark.parametrize("alg", ALGS)
def test_cfg5_shape_fingerprint_equals_reference(alg, services):
    _ext.COUNTS.reset()
    _, h, jobs = run_both(cfg5_nodes(64), cfg5_jobs(2, 32, f"cfg5-{alg}"), alg,
                       f"cfg5-{alg}")
    snap = h.store.snapshot()
    per_node = {}
    for j in jobs:
        allocs = snap.allocs_by_job(j.id)
        assert len(allocs) == 32
        for a in allocs:
            assert sum(len(v) for v in a.allocated_devices.values()) == 1
            assert len(a.allocated_cores) == 2
            per_node.setdefault(a.node_id, []).append(a)
    for allocs in per_node.values():
        insts = [i for a in allocs for v in a.allocated_devices.values()
                 for i in v]
        cores = [c for a in allocs for c in a.allocated_cores]
        assert len(insts) == len(set(insts))
        assert len(cores) == len(set(cores))
    if alg == "tpu-binpack":   # two B9 launches (plain on the CPU), no B1
        assert _ext.COUNTS.plain_on_cuda["solve_task_group"] == 0
        assert services[1].stats["launches"] == 0


def test_device_core_columns_equal_the_reference(services):
    """The solve's extra columns for one group with two device asks and
    cores: capacity (filtered by an ask's constraint), usage (committed
    rows, and a plan in progress on one node), the ask and the
    device-affinity sub-score."""
    nodes = cfg5_nodes(24)
    for n in nodes[::4]:
        n.resources.devices.append(RefDeviceGroup(
            vendor="nvidia", type="gpu", name="t4",
            instance_ids=[f"{n.name}-t4-{k}" for k in range(2)]))
        n.compute_class()
    j = cfg5_jobs(1, 8, "cols-next")[0]
    res = j.task_groups[0].tasks[0].resources
    res.devices = [RefRequestedDevice(name="nvidia/gpu", count=1, affinities=[
        RefAffinity(ltarget="${device.model}", rtarget="t4", operand="=",
                    weight=40)]),
        RefRequestedDevice(name="gpu", count=1, constraints=[RefConstraint(
            ltarget="${device.model}", rtarget="a100", operand="=")])]
    ref, h, _ = run_both(nodes, cfg5_jobs(1, 20, "cols"), "tpu-binpack",
                         "cols")
    pj = convert.job_from_record(job_record(j))

    def lower(cluster_mod, ctx_cls, store, job, pkg):
        snap = store.snapshot()
        node = list(snap.nodes())[5]
        ctx = ctx_cls(snap, job_plan(pkg, job), eval_id="cols-ev")
        ctx.plan.append_alloc(pkg.Allocation(
            id="inflight", node_id=node.id, job_id=job.id,
            allocated_vec=node.available_vec() * 0,
            allocated_devices={"nvidia/gpu/a100": ["x", "y", "z"]},
            allocated_cores=[14, 15]))
        nodes = list(snap.ready_nodes_in_pool(["dc1"], "default"))
        ct = cluster_mod.ClusterTensors.build(ctx, nodes)
        return cluster_mod.build_task_group_tensors(ctx, job,
                                                    job.task_groups[0], ct)

    want = lower(ref_cluster, RefEvalContext, ref.store, j, REF)
    got = lower(port_cluster, PortEvalContext, h.store, pj, PORT)
    assert got.extra_cap.shape == (got.feasible.shape[0], 3)
    for field in ("extra_cap", "extra_used", "extra_ask", "dev_affinity",
                  "feasible"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      field)
    assert got.extra_used.sum() > 0 and got.dev_affinity.any()


def job_plan(pkg, job):
    from nomad_tpu.structs.plan import Plan as RefPlan
    from nomad_tpu_torch.structs.plan import Plan

    return (RefPlan if pkg is REF else Plan)(eval_id="cols-ev", job=job)


def test_node_dev_usage_rows_match_the_allocs(services):
    """The store's per-node device and core rows equal the sum over the
    node's live allocs, after placements and after a plan stops some."""
    _, h, jobs = run_both(cfg5_nodes(16), cfg5_jobs(2, 20, "rows"), "binpack",
                       "rows")

    def check():
        snap = h.store.snapshot()
        for n in snap.nodes():
            brute = {}
            for a in snap.allocs_by_node(n.id):
                if not a.terminal_status():
                    port_devices.accumulate_dev_usage(brute, a)
            row = snap.node_dev_usage(n.id) or {}
            assert {k: v for k, v in row.items() if v} == {
                k: v for k, v in brute.items() if v}, n.id
        return snap

    snap = check()
    victims = snap.allocs_by_job(jobs[0].id)[:7]
    h.store.upsert_plan_results(stopped_allocs=[
        _stopped(a) for a in victims])
    snap = check()
    assert all(snap.alloc_by_id(a.id).terminal_status() for a in victims)


def _stopped(a):
    out = a.copy_for_update()
    out.desired_status = "stop"
    return out
