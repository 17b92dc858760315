"""Ports (nomad_tpu_torch/structs/network.py, reference
nomad_tpu/structs/network.py): ``NetworkIndex``, ``allocs_fit``'s port
and core checks, ``reserved_ports_mask``, and ports through the
scheduler under "binpack" and "tpu-binpack" (the host oracle for small
groups, B9's plain version with the per-node port assignment after the
solve for larger ones) and through the system scheduler, after
tests/test_network.py: the same inputs through both packages give the
same answers, port numbers included. Network modes other than "host"
raise, naming ROADMAP queue A5b."""

import types

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import feasible as ref_feasible
from nomad_tpu.structs import allocs_fit as ref_allocs_fit
from nomad_tpu.structs import network as ref_network
from nomad_tpu.structs.alloc import AllocatedPort as RefAllocatedPort
from nomad_tpu.structs.resources import NetworkResource as RefNetwork
from nomad_tpu.structs.resources import RequestedDevice as RefRequestedDevice
from nomad_tpu.structs.resources import Resources as RefResources
from nomad_tpu.structs.resources import R_PORTS
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import feasible as port_feasible
from nomad_tpu_torch.structs import enums
from nomad_tpu_torch.structs import network as port_network
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.alloc import AllocatedPort
from nomad_tpu_torch.structs.funcs import allocs_fit
from nomad_tpu_torch.structs.resources import NetworkResource, Resources
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_devices import both, cfg5_nodes, run_both, services  # noqa: F401

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, network=ref_network, feasible=ref_feasible,
    allocs_fit=ref_allocs_fit, Port=RefAllocatedPort, Network=RefNetwork,
    Resources=RefResources)
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, network=port_network,
    feasible=port_feasible, allocs_fit=allocs_fit, Port=AllocatedPort,
    Network=NetworkResource, Resources=Resources)


def ports(assigned):
    return [(p.label, p.value) for p in assigned]


# --------------------------------------------------------------------------
# NetworkIndex and allocs_fit (tests/test_network.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["node_reserved", "deterministic",
                                  "skips_used", "exhausted", "mixed"])
def test_network_index_assigns_the_same_ports(case):
    def run(pkg):
        n = pkg.mock.node()
        net = pkg.Network(dynamic_ports=["a", "b"])
        if case == "node_reserved":
            n.reserved.reserved_ports = [8080]
            net = pkg.Network(reserved_ports=[("http", 8080)])
        elif case == "exhausted":
            n.resources.min_dynamic_port = 20000
            n.resources.max_dynamic_port = 20001
            net = pkg.Network(dynamic_ports=["a", "b", "c"])
        elif case == "mixed":
            net = pkg.Network(reserved_ports=[("http", 20001)],
                              dynamic_ports=["a", "b"])
        idx = pkg.network.NetworkIndex(n)
        if case == "skips_used":
            lo = n.resources.min_dynamic_port
            idx.add_ports([lo, lo + 1])
        ask = pkg.Resources(networks=[net])
        out = []
        for _ in range(3):
            got, err = idx.assign_ports(ask)
            out.append((ports(got), err))
        return out, sorted(idx.used)

    out, _ = both(run, REF, PORT)
    if case == "deterministic":
        assert out[0][0] == [("a", 20000), ("b", 20001)]


@pytest.mark.parametrize("case", ["double_booking", "distinct", "terminal",
                                  "node_reserved", "dimension", "cores"])
def test_allocs_fit_port_and_core_checks(case):
    def run(pkg):
        n = pkg.mock.node()
        a1, a2 = pkg.mock.alloc(n=n), pkg.mock.alloc(n=n)
        a1.allocated_ports = [pkg.Port(label="http", value=9090)]
        a2.allocated_ports = [pkg.Port(label="http", value=9090)]
        if case == "distinct":
            a2.allocated_ports = [pkg.Port(label="http", value=9091)]
        elif case == "terminal":
            a2.client_status = "complete"
        elif case == "node_reserved":
            a2.allocated_ports = []
            n.reserved.reserved_ports = [9090]
        elif case == "dimension":
            n.resources.min_dynamic_port = 20000
            n.resources.max_dynamic_port = 20004   # 5 slots
            a2.allocated_ports = []
            a1.allocated_ports = []
            a1.allocated_vec = pkg.Resources(
                cpu=100, memory_mb=64,
                networks=[pkg.Network(dynamic_ports=["a"] * 6)]).vec()
            assert a1.allocated_vec[R_PORTS] == 6
        elif case == "cores":
            a1.allocated_ports = a2.allocated_ports = []
            a1.allocated_cores, a2.allocated_cores = [0, 1], [1, 2]
        fit, dim, used = pkg.allocs_fit(n, [a1, a2])
        return fit, dim, used.tolist(), pkg.network.check_port_collisions(
            n, [a1, a2])

    fit, dim, _, _ = both(run, REF, PORT)
    assert fit == (case in ("distinct", "terminal"))


def test_reserved_ports_mask():
    def run(pkg):
        j = pkg.mock.job()
        tg = j.task_groups[0]
        tg.networks = [pkg.Network(reserved_ports=[("http", 8080)])]
        n1, n2, n3 = pkg.mock.node(), pkg.mock.node(), pkg.mock.node()
        n2.reserved.reserved_ports = [8080]
        held = pkg.mock.alloc(n=n3)
        held.allocated_ports = [pkg.Port(label="web", value=8080)]
        proposed = {n3.id: [held]}
        return pkg.feasible.reserved_ports_mask(
            tg, [n1, n2, n3], lambda nid: proposed.get(nid, [])).tolist()

    assert both(run, REF, PORT) == [True, False, False]


def test_network_modes_other_than_host_raise():
    j = port_mock.job()
    tg = j.task_groups[0]
    nodes = [port_mock.node(), port_mock.node()]
    tg.networks = [NetworkResource(mode="host", dynamic_ports=["http"])]
    assert port_feasible.network_mask(tg, nodes).tolist() == [True, True]
    tg.networks[0].mode = ""
    assert port_feasible.network_mask(tg, nodes).tolist() == [True, True]
    tg.networks[0].mode = "bridge"
    with pytest.raises(NotImplementedError, match="ROADMAP queue A5b"):
        port_feasible.network_mask(tg, nodes)


# --------------------------------------------------------------------------
# the scheduler end to end (tests/test_network.py::TestSchedulingWithPorts)
# --------------------------------------------------------------------------


def ports_job(static=(), dynamic=(), count=2, tag="ports"):
    j = ref_mock.job()
    j.id = j.name = tag
    tg = j.task_groups[0]
    tg.count = count
    tg.networks = [RefNetwork(mode="host", reserved_ports=list(static),
                              dynamic_ports=list(dynamic))]
    return j


ALGS = ("binpack", "tpu-binpack")


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("n_nodes,count", [(2, 2), (32, 24)])
def test_static_port_forces_distinct_nodes(alg, n_nodes, count, services):
    nodes = [ref_mock.node() for _ in range(n_nodes)]
    _, h, jobs = run_both(nodes, [ports_job(static=[("http", 8080)],
                                            count=count)],
                          alg, f"static-{alg}-{count}")
    allocs = h.store.snapshot().allocs_by_job(jobs[0].id)
    assert len(allocs) == count
    assert len({a.node_id for a in allocs}) == count
    assert all(ports(a.allocated_ports) == [("http", 8080)] for a in allocs)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("count", [2, 20])
def test_static_port_more_allocs_than_nodes(alg, count, services):
    """The allocs that find no node with the port free are blocked, not
    dropped: one blocked eval in each package."""
    nodes = [ref_mock.node() for _ in range(count // 2)]
    ref, h, jobs = run_both(nodes, [ports_job(static=[("http", 8080)],
                                              count=count)],
                            alg, f"partial-{alg}-{count}")
    assert len(h.store.snapshot().allocs_by_job(jobs[0].id)) == count // 2
    blocked = [e for e in h.created_evals if e.status == "blocked"]
    assert len(blocked) == 1
    assert len([e for e in ref.created_evals if e.status == "blocked"]) == 1


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("n_nodes,count", [(1, 4), (4, 32)])
def test_dynamic_ports_unique_per_node(alg, n_nodes, count, services):
    nodes = [ref_mock.node() for _ in range(n_nodes)]
    _, h, jobs = run_both(nodes, [ports_job(dynamic=["http", "rpc"],
                                            count=count)],
                          alg, f"dyn-{alg}-{count}")
    snap = h.store.snapshot()
    allocs = snap.allocs_by_job(jobs[0].id)
    assert len(allocs) == count
    for node in snap.nodes():
        on = [a for a in allocs if a.node_id == node.id]
        values = [p.value for a in on for p in a.allocated_ports]
        assert len(values) == 2 * len(on) == len(set(values))
        lo, hi = node.resources.min_dynamic_port, node.resources.max_dynamic_port
        assert all(lo <= v <= hi for v in values)
        fit, dim, _ = allocs_fit(node, on)
        assert fit, dim


def test_system_job_with_ports_devices_and_cores(services):
    """The system scheduler ranks every node with the host scorer, which
    assigns the group's ports, device instance and cores on each."""
    nodes = cfg5_nodes(6)
    j = ref_mock.system_job()
    j.id = j.name = "system-ids"
    tg = j.task_groups[0]
    tg.networks = [RefNetwork(reserved_ports=[("metrics", 9100)],
                              dynamic_ports=["admin"])]
    res = tg.tasks[0].resources
    res.devices = [RefRequestedDevice(name="nvidia/gpu", count=2)]
    res.cores = 3
    res.numa_affinity = "require"
    _, h, jobs = run_both(nodes, [j], "tpu-binpack", "system-ids")
    allocs = h.store.snapshot().allocs_by_job(jobs[0].id)
    assert len(allocs) == 6
    for a in allocs:
        assert ports(a.allocated_ports) == [("metrics", 9100),
                                            ("admin", 20000)]
        assert len(a.allocated_devices["nvidia/gpu/a100"]) == 2
        assert a.allocated_cores == [0, 1, 2]


def test_dynamic_ports_with_devices_through_the_solve(services):
    """Ports and device ids on one group of 24 through B9's plain
    version: the per-node NetworkIndex and DeviceIndex carry the group's
    earlier placements."""
    j = ports_job(dynamic=["http"], count=24, tag="ports-devs")
    res = j.task_groups[0].tasks[0].resources
    res.devices = [RefRequestedDevice(name="gpu", count=3)]
    res.cores = 1
    _, h, jobs = run_both(cfg5_nodes(8), [j], "tpu-binpack", "ports-devs")
    allocs = h.store.snapshot().allocs_by_job(jobs[0].id)
    assert len(allocs) == 16   # 8 nodes x 8 instances / 3 a placement
    assert len({(a.node_id, p.value) for a in allocs
                for p in a.allocated_ports}) == 16
    per_node = {}
    for a in allocs:
        per_node.setdefault(a.node_id, []).extend(
            a.allocated_devices["nvidia/gpu/a100"])
    assert all(len(v) == len(set(v)) == 6 for v in per_node.values())


def test_dynamic_ports_take_the_per_eval_route():
    """A dynamic-port group of 300 (bulk-sized) takes the per-eval route,
    not the bulk one, and every alloc gets a port of its own node."""
    h = PortHarness(device="cpu")
    port_mock.build_nodes(h.store, 32)
    j = port_mock.service_job(300)
    j.task_groups[0].networks = [NetworkResource(dynamic_ports=["http"])]
    h.store.upsert_job(j)
    h.process(port_mock.eval_for(j), sched_config=port_operator.
              SchedulerConfiguration(scheduler_algorithm="tpu-binpack"))
    allocs = h.store.snapshot().allocs_by_job(j.id)
    assert len(allocs) == 300
    assert list(h.store.snapshot().alloc_blocks()) == []
    pairs = [(a.node_id, p.value) for a in allocs for p in a.allocated_ports]
    assert len(pairs) == len(set(pairs)) == 300
    assert all(e.status == enums.EVAL_STATUS_COMPLETE for e in h.evals)
