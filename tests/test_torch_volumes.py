"""Host and CSI volumes and network modes (ROADMAP A5b), each scenario
written once and run through both packages with pinned ids: the
reference's ``tests/test_volumes.py`` (TestHostVolumes, TestCSIVolumes,
the applier's racing writers), the network-mode cases of
``tests/test_network.py``, the masks and ``tg_mask_signature`` over
seeded random nodes, and groups with volumes and bridge or CNI networks
placed through ``Harness.process`` and through the Server. The port's
answers must equal the reference's, row for row.

Not ported: ``test_dump_restore_keeps_claims`` (the store's dump and
restore are ROADMAP A10), the per-alloc jobspec validation and the HTTP
volume API (the port has no API layer)."""

import copy
import itertools
import random
import types

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.core import plan_apply as ref_plan_apply
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import feasible as ref_feasible
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import ClientHostVolumeConfig as RefHostVolume
from nomad_tpu.structs import Volume as RefVolume
from nomad_tpu.structs import VolumeRequest as RefVolumeRequest
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.plan import Plan as RefPlan
from nomad_tpu.structs.resources import NetworkResource as RefNetwork
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import plan_apply as port_plan_apply
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.scheduler import feasible as port_feasible
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.state import StateStore as PortStateStore
from nomad_tpu_torch.structs import (ClientHostVolumeConfig, Volume,
                                     VolumeRequest, enums)
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.plan import Plan as PortPlan
from nomad_tpu_torch.structs.resources import NetworkResource
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_bulk_scan import over_capacity
from test_torch_pipeline import job_record, node_record

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, Harness=RefHarness, HostVolume=RefHostVolume,
    Volume=RefVolume, Request=RefVolumeRequest, Network=RefNetwork,
    StateStore=RefStateStore, pa=ref_plan_apply, Plan=RefPlan,
    feasible=ref_feasible, operator=ref_operator, generic=ref_generic,
    server=ref_server)
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, Harness=lambda: PortHarness(device="cpu"),
    HostVolume=ClientHostVolumeConfig, Volume=Volume, Request=VolumeRequest,
    Network=NetworkResource, StateStore=PortStateStore, pa=port_plan_apply,
    Plan=PortPlan, feasible=port_feasible, operator=port_operator,
    generic=port_generic, server=port_server)

ALGS = [enums.SCHED_ALG_BINPACK, enums.SCHED_ALG_TPU_BINPACK]


@pytest.fixture(autouse=True)
def services(monkeypatch):
    """Private solver services for both packages, and pinned ids: one
    counter a package for alloc, block and eval ids."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    port_svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port_svc)
    for mod in (ref_generic, port_generic, ref_server, port_server):
        counter = itertools.count()
        monkeypatch.setattr(mod, "generate_uuid", lambda c=counter:
                            f"{next(c):08x}-0000-0000-0000-000000000000")
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])
    yield
    ref_svc.stop()
    port_svc.stop()


def both(fn):
    """``fn(pkg)`` in each package; the answers must be equal."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def node(pkg, i, volume=None, read_only=False, **attrs):
    n = pkg.mock.node(id=f"vn-{i:03d}", name=f"vn-{i:03d}")
    n.attributes.update(attrs)
    if volume is not None:
        n.host_volumes = {volume: pkg.HostVolume(
            name=volume, path=f"/srv/{volume}", read_only=read_only)}
    n.compute_class()
    return n


def vol_job(pkg, tag, name="data", vtype="host", source="data",
            read_only=False, count=2, access_mode="single-node-writer"):
    j = pkg.mock.job(id=tag, name=tag)
    tg = j.task_groups[0]
    tg.count = count
    tg.volumes = {name: pkg.Request(
        name=name, type=vtype, source=source, read_only=read_only,
        access_mode=access_mode)}
    return j


def process(pkg, h, job, alg=enums.SCHED_ALG_BINPACK, tag="e"):
    h.store.upsert_job(job)
    h.process(pkg.mock.eval_for(job, id=f"{tag}-{job.id}-{job.version}"),
              sched_config=pkg.operator.SchedulerConfiguration(
                  scheduler_algorithm=alg))


def rows(h, job_id):
    """(name, node, desired, client) of every alloc of the job, sorted."""
    return sorted((a.name, a.node_id, a.desired_status, a.client_status)
                  for a in h.store.snapshot().allocs_by_job(job_id))


def live(h, job_id):
    return [a for a in h.store.snapshot().allocs_by_job(job_id)
            if not a.terminal_status() and not a.server_terminal()]


def claims(h, vol_id="pgdata"):
    vol = h.store.snapshot().volume_by_id(vol_id)
    if vol is None:
        return None
    return sorted((c.alloc_id, c.node_id, c.read_only)
                  for c in vol.claims.values())


# --------------------------------------------------------------------------
# host volumes (tests/test_volumes.py::TestHostVolumes)
# --------------------------------------------------------------------------


def test_class_hash_includes_host_volumes():
    def run(pkg):
        plain = node(pkg, 0).computed_class
        rw = node(pkg, 0, volume="data").computed_class
        ro = node(pkg, 0, volume="data", read_only=True).computed_class
        return (plain != rw, rw != ro, ro != plain)

    assert both(run) == (True, True, True)


@pytest.mark.parametrize("alg", ALGS)
def test_only_exposing_nodes_get_allocs(alg):
    def run(pkg):
        h = pkg.Harness()
        for i in range(5):
            h.store.upsert_node(node(pkg, i, volume="data" if i < 2 else None))
        j = vol_job(pkg, "hv", count=4)
        process(pkg, h, j, alg)
        assert {a.node_id for a in live(h, j.id)} <= {"vn-000", "vn-001"}
        return rows(h, j.id)

    assert len(both(run)) == 4


@pytest.mark.parametrize("alg", ALGS)
def test_readonly_host_volume_rejects_writers(alg):
    def run(pkg):
        h = pkg.Harness()
        h.store.upsert_node(node(pkg, 0, volume="data", read_only=True))
        writer = vol_job(pkg, "w", count=1)
        process(pkg, h, writer, alg)
        reader = vol_job(pkg, "r", count=1, read_only=True)
        process(pkg, h, reader, alg)
        return rows(h, writer.id), rows(h, reader.id)

    writer, reader = both(run)
    assert writer == [] and len(reader) == 1


# --------------------------------------------------------------------------
# CSI volumes (tests/test_volumes.py::TestCSIVolumes)
# --------------------------------------------------------------------------


def register(pkg, store, node_ids=(), access="single-node-writer"):
    store.upsert_volume(pkg.Volume(id="pgdata", name="pgdata",
                                   access_mode=access,
                                   topology_node_ids=list(node_ids)))


@pytest.mark.parametrize("alg", ALGS)
def test_topology_restricts_nodes(alg):
    def run(pkg):
        h = pkg.Harness()
        for i in range(4):
            h.store.upsert_node(node(pkg, i))
        register(pkg, h.store, node_ids=["vn-000", "vn-001"])
        j = vol_job(pkg, "topo", vtype="csi", source="pgdata", count=2,
                    read_only=True)
        process(pkg, h, j, alg)
        assert {a.node_id for a in live(h, j.id)} <= {"vn-000", "vn-001"}
        return rows(h, j.id), claims(h)

    got_rows, got_claims = both(run)
    assert len(got_rows) == 2 and len(got_claims) == 2


def test_single_writer_exclusivity_and_reaping():
    def run(pkg):
        h = pkg.Harness()
        for i in range(3):
            h.store.upsert_node(node(pkg, i))
        register(pkg, h.store)
        j1 = vol_job(pkg, "w1", vtype="csi", source="pgdata", count=1)
        process(pkg, h, j1)
        first = claims(h)
        # a second writer finds no node; a reader always does
        j2 = vol_job(pkg, "w2", vtype="csi", source="pgdata", count=1)
        process(pkg, h, j2)
        j3 = vol_job(pkg, "rd", vtype="csi", source="pgdata", count=1,
                     read_only=True)
        process(pkg, h, j3)
        # the writer's alloc fails: the reaper frees the volume
        (a1,) = h.store.snapshot().allocs_by_job(j1.id)
        dead = copy.copy(a1)
        dead.client_status = enums.ALLOC_CLIENT_FAILED
        h.store.update_allocs_from_client([dead])
        released = h.store.reap_volume_claims()
        vol = h.store.snapshot().volume_by_id("pgdata")
        return (first, rows(h, j2.id), rows(h, j3.id), released,
                len(vol.writers()), vol.claimable(read_only=False))

    first, second, reader, released, writers, claimable = both(run)
    assert len(first) == 1 and second == [] and len(reader) == 1
    assert (released, writers, claimable) == (1, 0, True)


def test_update_of_single_writer_job_does_not_deadlock():
    def run(pkg):
        h = pkg.Harness()
        for i in range(2):
            h.store.upsert_node(node(pkg, i))
        register(pkg, h.store)
        j = vol_job(pkg, "upd", vtype="csi", source="pgdata", count=1)
        process(pkg, h, j)
        (old,) = live(h, j.id)
        j2 = vol_job(pkg, "upd", vtype="csi", source="pgdata", count=1)
        j2.task_groups[0].tasks[0].resources.cpu = 600
        process(pkg, h, j2)
        (new,) = live(h, j.id)
        assert new.id != old.id
        return rows(h, j.id), claims(h)

    both(run)


def test_scale_up_cannot_mint_second_writer():
    def run(pkg):
        h = pkg.Harness()
        for i in range(3):
            h.store.upsert_node(node(pkg, i))
        register(pkg, h.store)
        j = vol_job(pkg, "scale", vtype="csi", source="pgdata", count=1)
        process(pkg, h, j)
        j2 = copy.deepcopy(j)
        j2.task_groups[0].count = 2
        process(pkg, h, j2)
        vol = h.store.snapshot().volume_by_id("pgdata")
        return rows(h, j.id), len(vol.writers()), len(live(h, j.id))

    _, writers, n_live = both(run)
    assert (writers, n_live) == (1, 1)


def test_deregister_refuses_live_claims():
    def run(pkg):
        h = pkg.Harness()
        h.store.upsert_node(node(pkg, 0))
        register(pkg, h.store)
        process(pkg, h, vol_job(pkg, "held", vtype="csi", source="pgdata",
                                count=1))
        with pytest.raises(ValueError):
            h.store.delete_volume("pgdata")
        h.store.delete_volume("pgdata", force=True)
        return claims(h)

    assert both(run) is None


def test_applier_rejects_racing_writers():
    """Two plans from one stale snapshot both claim the single-writer
    volume: the applier's cross-node claim check commits exactly one."""
    def run(pkg):
        store = pkg.StateStore()
        n1, n2 = node(pkg, 1), node(pkg, 2)
        store.upsert_node(n1)
        store.upsert_node(n2)
        job1 = vol_job(pkg, "race-1", vtype="csi", source="pgdata", count=1)
        job2 = vol_job(pkg, "race-2", vtype="csi", source="pgdata", count=1)
        store.upsert_job(job1)
        store.upsert_job(job2)
        store.upsert_volume(pkg.Volume(id="pgdata", name="pgdata"))
        q = pkg.pa.PlanQueue()
        q.set_enabled(True)
        ap = pkg.pa.PlanApplier(store, q)
        index = store.latest_index
        p1 = pkg.Plan(eval_id="e1", snapshot_index=index)
        p1.append_alloc(pkg.mock.alloc(job1, n1, index=0, id="race-a1"))
        p2 = pkg.Plan(eval_id="e2", snapshot_index=index)
        p2.append_alloc(pkg.mock.alloc(job2, n2, index=0, id="race-a2"))
        r1, r2 = ap.apply(p1), ap.apply(p2)
        vol = store.snapshot().volume_by_id("pgdata")
        return (list(r1.rejected_nodes or ()), list(r2.rejected_nodes or ()),
                sorted(c.alloc_id for c in vol.writers()))

    rej1, rej2, writers = both(run)
    assert (rej1, rej2, writers) == ([], ["vn-002"], ["race-a1"])


def test_overlay_surfaces_in_flight_writer_claims():
    """A plan verified against an in-flight result that claims the volume
    for write is rejected: the overlay surfaces the pending claim."""
    def run(pkg):
        store = pkg.StateStore()
        n1, n2 = node(pkg, 1), node(pkg, 2)
        store.upsert_node(n1)
        store.upsert_node(n2)
        job1 = vol_job(pkg, "ov-1", vtype="csi", source="pgdata", count=1)
        job2 = vol_job(pkg, "ov-2", vtype="csi", source="pgdata", count=1)
        store.upsert_job(job1)
        store.upsert_job(job2)
        store.upsert_volume(pkg.Volume(id="pgdata", name="pgdata"))
        q = pkg.pa.PlanQueue()
        ap = pkg.pa.PlanApplier(store, q)
        index = store.latest_index
        p1 = pkg.Plan(eval_id="e1", snapshot_index=index)
        p1.append_alloc(pkg.mock.alloc(job1, n1, index=0, id="ov-a1"))
        r1, _ = ap._verify(p1, None)
        p2 = pkg.Plan(eval_id="e2", snapshot_index=index)
        p2.append_alloc(pkg.mock.alloc(job2, n2, index=0, id="ov-a2"))
        overlay = pkg.pa._OverlaySnapshot(store.snapshot(), [r1])
        return (sorted(overlay.overlay_writer_volumes()),
                sorted(ap._volume_rejections(overlay, p2)))

    pending, bad = both(run)
    assert pending == [("default", "pgdata")] and bad == ["vn-002"]


# --------------------------------------------------------------------------
# network modes (tests/test_network.py:121, 292)
# --------------------------------------------------------------------------


def test_network_mode_mask():
    def run(pkg):
        j = pkg.mock.job()
        tg = j.task_groups[0]
        n_host = node(pkg, 0)
        n_bridge = node(pkg, 1, **{"network.bridge": "true"})
        n_cni = node(pkg, 2, **{"plugins.cni.version.calico": "3.26"})
        nodes = [n_host, n_bridge, n_cni]
        out = []
        tg.networks = [pkg.Network(dynamic_ports=["http"])]
        for mode in ("host", "", "bridge", "cni/calico", "cni/flannel"):
            tg.networks[0].mode = mode
            out.append(pkg.feasible.network_mask(tg, nodes).tolist())
        return out

    assert both(run) == [[True] * 3, [True] * 3, [False, True, False],
                         [False, False, True], [False] * 3]


def test_network_modes_in_computed_class():
    def run(pkg):
        n1, n2 = node(pkg, 0), node(pkg, 0)
        n2.resources.networks = [pkg.Network(mode="bridge")]
        return n1.compute_class() != n2.compute_class()

    assert both(run) is True


def random_cluster(pkg, n, seed):
    """Seeded random nodes: bridge, CNI plugins and host volumes (rw, ro
    or none) in every combination."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        attrs = {}
        if rng.random() < 0.5:
            attrs["network.bridge"] = rng.choice(["true", "1", "false"])
        if rng.random() < 0.3:
            attrs["plugins.cni.version.calico"] = "3.26"
        pick = rng.random()
        volume = "data" if pick < 0.6 else None
        out.append(node(pkg, i, volume=volume, read_only=pick < 0.2, **attrs))
    return out


def random_groups(pkg, seed):
    rng = random.Random(seed)
    jobs = []
    for k in range(12):
        j = pkg.mock.job(id=f"mask-{k}", name=f"mask-{k}")
        tg = j.task_groups[0]
        mode = rng.choice(["host", "", "bridge", "cni/calico", "cni/other"])
        tg.networks = [pkg.Network(mode=mode, dynamic_ports=["http"])]
        if rng.random() < 0.7:
            tg.volumes = {"v": pkg.Request(
                name="v", type="host", source=rng.choice(["data", "other"]),
                read_only=rng.random() < 0.5)}
        jobs.append(j)
    return jobs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_and_signature_over_random_nodes(seed):
    def run(pkg):
        nodes = random_cluster(pkg, 40, seed)
        out = []
        for j in random_groups(pkg, seed):
            tg = j.task_groups[0]
            out.append((pkg.feasible.network_mask(tg, nodes).tolist(),
                        pkg.feasible.host_volume_mask(tg, nodes).tolist(),
                        pkg.feasible.feasible_mask_static(
                            j, tg, nodes).tolist(),
                        pkg.feasible.tg_mask_signature(j, tg)))
        return out

    got = both(run)
    assert any(any(m[0]) and not all(m[0]) for m in got)
    assert any(any(m[1]) and not all(m[1]) for m in got)


def test_csi_mask_over_random_nodes():
    def run(pkg):
        store = pkg.StateStore()
        nodes = random_cluster(pkg, 24, 5)
        for n in nodes:
            store.upsert_node(n)
        store.upsert_volume(pkg.Volume(
            id="z0", topology_node_ids=[n.id for n in nodes[::3]]))
        store.upsert_volume(pkg.Volume(id="any"))
        out = []
        for source, ro in (("z0", False), ("any", True), ("gone", True)):
            j = vol_job(pkg, f"csi-{source}", name="c", vtype="csi",
                        source=source, read_only=ro)
            tg = j.task_groups[0]
            out.append(pkg.feasible.feasible_mask(
                j, tg, nodes, snapshot=store.snapshot()).tolist())
        return out

    got = both(run)
    assert sum(got[0]) == 8 and all(got[1]) and not any(got[2])


# --------------------------------------------------------------------------
# groups with volumes and networks through Harness.process and the Server
# --------------------------------------------------------------------------


def mixed_cluster(pkg, n=32):
    out = []
    for i in range(n):
        attrs = {"zone": f"z{i % 4}"}
        if i % 2 == 0:
            attrs["network.bridge"] = "true"
        if i % 4 == 1:
            attrs["plugins.cni.version.calico"] = "3.26"
        volume = "data" if i % 2 == 0 else ("data" if i % 8 == 1 else None)
        out.append(node(pkg, i, volume=volume, read_only=(i % 8 == 1),
                        **attrs))
    return out


def mixed_jobs(pkg):
    jobs = []
    hv = vol_job(pkg, "mx-hv", count=12)
    jobs.append(hv)
    br = pkg.mock.job(id="mx-br", name="mx-br")
    br.task_groups[0].count = 40
    br.task_groups[0].networks = [pkg.Network(mode="bridge",
                                              dynamic_ports=["http"])]
    jobs.append(br)
    cni = pkg.mock.job(id="mx-cni", name="mx-cni")
    cni.task_groups[0].count = 6
    cni.task_groups[0].networks = [pkg.Network(mode="cni/calico")]
    jobs.append(cni)
    for z in range(4):
        jobs.append(vol_job(pkg, f"mx-csi-{z}", name="db", vtype="csi",
                            source=f"db-{z}", count=1))
    return jobs


def mixed_volumes(pkg, store):
    for z in range(4):
        store.upsert_volume(pkg.Volume(
            id=f"db-{z}", topology_node_ids=[f"vn-{i:03d}" for i in range(32)
                                             if i % 4 == z]))


def mixed_rows(store, jobs):
    snap = store.snapshot()
    out = {}
    for j in jobs:
        out[j.id] = sorted((a.name, a.node_id) for a in
                           snap.allocs_by_job(j.id)
                           if not a.terminal_status())
    vols = {v.id: sorted(v.claims) for v in snap.volumes()}
    return out, vols


def check_mixed(store, got):
    placed, vols = got
    assert len(placed["mx-hv"]) == 12 and len(placed["mx-br"]) == 40
    assert len(placed["mx-cni"]) == 6
    for z in range(4):
        ((_, nid),) = placed[f"mx-csi-{z}"]
        assert int(nid[3:]) % 4 == z and len(vols[f"db-{z}"]) == 1
    assert all(int(nid[3:]) % 2 == 0 for _, nid in placed["mx-hv"])
    assert all(int(nid[3:]) % 2 == 0 for _, nid in placed["mx-br"])
    assert all(int(nid[3:]) % 4 == 1 for _, nid in placed["mx-cni"])
    assert over_capacity(store) == []


@pytest.mark.parametrize("alg", ALGS)
def test_volume_and_network_groups_through_the_harness(alg):
    def run(pkg):
        h = pkg.Harness()
        for n in mixed_cluster(pkg):
            h.store.upsert_node(n)
        mixed_volumes(pkg, h.store)
        jobs = mixed_jobs(pkg)
        for j in jobs:
            process(pkg, h, j, alg)
        got = mixed_rows(h.store, jobs)
        check_mixed(h.store, got)
        return got

    both(run)


def test_volume_and_network_groups_through_the_server():
    """The same jobs through both packages' Servers (one worker, one eval
    a dequeue), the port's cluster and jobs carried across as records."""
    ref = ref_server.Server(ref_server.ServerConfig(
        num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0,
        sched_config=ref_operator.SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack")))
    for n in mixed_cluster(REF):
        ref.store.upsert_node(n)
    mixed_volumes(REF, ref.store)
    jobs = mixed_jobs(REF)
    records = [job_record(j) for j in jobs]
    with ref:
        for j in jobs:
            ref.register_job(j)
        assert ref.wait_for_idle(60.0)
    want = mixed_rows(ref.store, jobs)
    check_mixed(ref.store, want)

    srv = port_server.Server(port_server.ServerConfig(
        num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0, device="cpu",
        sched_config=port_operator.SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack")))
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        srv.store.upsert_node(n)
    mixed_volumes(PORT, srv.store)
    pjobs = [convert.job_from_record(r) for r in records]
    with srv:
        for j in pjobs:
            srv.register_job(j)
        assert srv.wait_for_idle(60.0)
    got = mixed_rows(srv.store, pjobs)
    check_mixed(srv.store, got)
    assert got == want


def test_convert_carries_volumes_and_host_volumes():
    n = node(REF, 3, volume="data", read_only=True)
    j = vol_job(REF, "conv", vtype="csi", source="pgdata", read_only=True)
    pn = convert.node_from_record(node_record(n))
    pj = convert.job_from_record(job_record(j))
    assert pn.host_volumes["data"] == ClientHostVolumeConfig(
        name="data", path="/srv/data", read_only=True)
    assert pn.computed_class and pj.task_groups[0].volumes["data"] == \
        VolumeRequest(name="data", type="csi", source="pgdata",
                      read_only=True)
    assert np.array_equal(pn.available_vec(), n.available_vec())
