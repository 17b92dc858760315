"""Snapshots and the log's codec on both packages (the reference's
tests/test_persist_format.py and test_volumes.py's
test_dump_restore_keeps_claims, case for case), and the carry-over of
state between them: a reference ``dump_store`` restores into the port's
store with equal content and a port dump into the reference's, blocks,
promoted rows and format-1 dumps included; the port's dump of a store
built by the same ops equals the reference's on the tables both have;
and a restore makes the event broker truncate every ring, so the
incremental feed resyncs.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from nomad_tpu.core.events import EventBroker as RefEventBroker
from nomad_tpu.structs import enums
from nomad_tpu.tensor import incremental as ref_incremental
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import convert
from nomad_tpu_torch.core.events import EventBroker as PortEventBroker
from nomad_tpu_torch.structs import wire as port_wire
from nomad_tpu_torch.structs.alloc import AllocBlock as PortBlock
from nomad_tpu_torch.structs.alloc import Allocation as PortAllocation
from nomad_tpu_torch.tensor import incremental as port_incremental
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import Harness as PortHarness
from nomad_tpu.structs.alloc import AllocBlock as RefBlock
from nomad_tpu.structs.alloc import Allocation as RefAllocation

from test_torch_raft import PKGS, PORT, REF

# per package: the AllocBlock and Allocation classes, the Harness, the
# event broker and the feed module
EXTRA = {
    REF.name: dict(Block=RefBlock, Allocation=RefAllocation,
                   Harness=RefHarness, EventBroker=RefEventBroker,
                   incremental=ref_incremental),
    PORT.name: dict(Block=PortBlock, Allocation=PortAllocation,
                    Harness=lambda: PortHarness(device="cpu"),
                    EventBroker=PortEventBroker,
                    incremental=port_incremental),
}


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def x(pkg, key):
    return EXTRA[pkg.name][key]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_wire_roundtrip(pkg):
    job = pkg.mock.job()
    node = pkg.mock.node()
    block = x(pkg, "Block")(
        id="b", job_id=job.id, job=job, node_ids=[node.id],
        node_names=[node.name], counts=np.array([3], np.int64),
        name_indices=np.arange(3, dtype=np.int64),
        allocated_vec=np.array([50.0, 32.0, 0.0, 0.0]),
        rejected_rows=frozenset({0}))
    value = {"cmd": ("upsert_plan_results_batch", [block, node, job]),
             ("ns", "key"): {1, 2}, "raw": b"\x00\x01",
             "arr": np.arange(6, dtype=np.int16).reshape(2, 3)}
    text = json.dumps(pkg.wire.wire_encode(value))
    got = pkg.wire.wire_decode(json.loads(text))
    assert got[("ns", "key")] == {1, 2} and got["raw"] == b"\x00\x01"
    assert got["arr"].dtype == np.int16
    assert np.array_equal(got["arr"], value["arr"])
    op, (b2, n2, j2) = got["cmd"]
    assert op == "upsert_plan_results_batch"
    assert (type(b2), type(n2), type(j2)) == (type(block), type(node),
                                               type(job))
    assert b2.rejected_rows == frozenset({0}) or b2.rejected_rows == {0}
    assert np.array_equal(b2.counts, block.counts)
    assert n2.id == node.id and j2.task_groups[0].name == \
        job.task_groups[0].name


def test_port_codec_decodes_reference_structs():
    """A reference struct decodes into the port's (trimmed) class: the
    fields the port lacks are dropped, nested types included."""
    node = REF.mock.node()
    job = REF.mock.job()
    enc = json.loads(json.dumps(REF.wire.wire_encode([node, job])))
    pnode, pjob = port_wire.wire_decode(enc)
    assert type(pnode).__module__.startswith("nomad_tpu_torch")
    assert (pnode.id, pnode.name, pnode.resources.cpu) == \
        (node.id, node.name, node.resources.cpu)
    assert pjob.task_groups[0].tasks[0].resources.cpu == \
        job.task_groups[0].tasks[0].resources.cpu


# ---------------------------------------------------------------------------
# format 2 and the format-1 migration (tests/test_persist_format.py)
# ---------------------------------------------------------------------------


def populated_store(pkg, n_allocs, n_nodes=24):
    """Nodes, jobs and n_allocs alloc rows: every 7th terminal, every
    11th with device instances and reserved cores (the sparse extras)."""
    store = pkg.StateStore()
    nodes = []
    for _ in range(n_nodes):
        n = pkg.mock.node()
        n.compute_class()
        nodes.append(n)
        store.upsert_node(n)
    jobs = [pkg.mock.job() for _ in range(max(1, min(4, n_allocs)))]
    for j in jobs:
        store.upsert_job(j)
    allocs = []
    for i in range(n_allocs):
        a = pkg.mock.alloc(jobs[i % len(jobs)], nodes[i % n_nodes], index=i)
        if i % 7 == 3:
            a.desired_status = enums.ALLOC_DESIRED_STOP
            a.client_status = enums.ALLOC_CLIENT_COMPLETE
        if i % 11 == 5:
            a.allocated_devices = {"nvidia/gpu/t4": [f"inst-{i}-0",
                                                     f"inst-{i}-1"]}
            a.allocated_cores = [0, 1]
        allocs.append(a)
    if allocs:
        store.upsert_allocs(allocs)
    return store


def normalize(dump):
    out = {}
    for key, val in dump.items():
        out[key] = (sorted(json.dumps(r, sort_keys=True) for r in val)
                    if isinstance(val, list) else val)
    return json.dumps(out, sort_keys=True)


def usage_parity(s1, s2):
    snap1, snap2 = s1.snapshot(), s2.snapshot()
    for n in snap1.nodes():
        u1, u2 = snap1.node_usage(n.id), snap2.node_usage(n.id)
        if u1 is None or not np.asarray(u1).any():
            assert u2 is None or not np.asarray(u2).any(), n.id
        else:
            assert u2 is not None and np.allclose(u1, u2), n.id
        assert snap1.node_dev_usage(n.id) == snap2.node_dev_usage(n.id)


def test_format1_dump_restores_bit_identically(pkg):
    store = populated_store(pkg, 60)
    d1 = json.loads(json.dumps(pkg.dump_store(store, fmt=1)))
    assert d1["format"] == 1
    s2 = pkg.StateStore()
    pkg.restore_store(s2, d1)
    assert normalize(pkg.dump_store(s2, fmt=1)) == normalize(d1)
    usage_parity(store, s2)


def test_unsupported_format_rejected(pkg):
    with pytest.raises(ValueError, match="unsupported snapshot"):
        pkg.restore_store(pkg.StateStore(), {"format": 3, "index": 1})
    with pytest.raises(ValueError, match="cannot write"):
        pkg.dump_store(pkg.StateStore(), fmt=7)


@pytest.mark.parametrize("n_allocs", [0, 1, 2_000])
def test_roundtrip_preserves_allocs_and_usage(pkg, n_allocs):
    store = populated_store(pkg, n_allocs)
    d = json.loads(json.dumps(pkg.dump_store(store)))
    assert d["format"] == 2
    s2 = pkg.StateStore()
    pkg.restore_store(s2, d)
    snap1, snap2 = store.snapshot(), s2.snapshot()
    a1 = {a.id: a for a in snap1.allocs()}
    a2 = {a.id: a for a in snap2.allocs()}
    assert len(a1) == n_allocs and a1.keys() == a2.keys()
    for aid, a in a1.items():
        b = a2[aid]
        assert (a.node_id, a.job_id, a.name, a.desired_status,
                a.client_status) == (b.node_id, b.job_id, b.name,
                                     b.desired_status, b.client_status)
        assert np.allclose(a.allocated_vec, b.allocated_vec)
        assert (a.allocated_devices, a.allocated_cores) == \
            (b.allocated_devices, b.allocated_cores)
    assert {n.id for n in snap1.nodes()} == {n.id for n in snap2.nodes()}
    usage_parity(store, s2)
    assert s2.latest_index == d["index"]


def block_store(pkg, n_nodes=8, k=32, rows=4):
    """A store with one AllocBlock of k placements over ``rows`` nodes
    and one of its positions promoted by a client update."""
    store = pkg.StateStore()
    nodes = []
    for i in range(n_nodes):
        n = pkg.mock.node(id=f"blk-node-{i}", name=f"blk-node-{i}")
        n.compute_class()
        nodes.append(n)
        store.upsert_node(n)
    job = pkg.mock.batch_job(id="blk-job", name="blk-job")
    job.task_groups[0].count = k
    store.upsert_job(job)
    vec = np.zeros_like(pkg.mock.alloc(job, nodes[0]).allocated_vec)
    vec[0], vec[1] = 50.0, 32.0
    block = x(pkg, "Block")(
        id="blk-rt", eval_id="ev-rt", namespace=job.namespace,
        job_id=job.id, job=job, job_version=job.version,
        task_group=job.task_groups[0].name,
        name_indices=np.arange(k, dtype=np.int64),
        node_ids=[n.id for n in nodes[:rows]],
        node_names=[n.name for n in nodes[:rows]],
        counts=np.full(rows, k // rows, dtype=np.int64), allocated_vec=vec)
    store.upsert_plan_results([], alloc_blocks=[block], job=job, ts=10.0)
    target = sorted(a.id for a in store.snapshot().allocs_by_job(job.id))[3]
    store.update_allocs_from_client([x(pkg, "Allocation")(
        id=target, client_status=enums.ALLOC_CLIENT_COMPLETE)], ts=11.0)
    return store, job, target


def check_block_restore(store, s2, job, target):
    snap1, snap2 = store.snapshot(), s2.snapshot()
    assert len(list(snap2.alloc_blocks())) == 1
    by_job = snap2.allocs_by_job(job.id)
    assert len(by_job) == len(snap1.allocs_by_job(job.id))
    assert sum(1 for a in by_job if a.id == target) == 1
    assert (snap2.alloc_by_id(target).client_status
            == enums.ALLOC_CLIENT_COMPLETE)
    for n in snap1.nodes():
        assert (sorted(a.id for a in snap1.allocs_by_node(n.id))
                == sorted(a.id for a in snap2.allocs_by_node(n.id)))
    usage_parity(store, s2)


def test_roundtrip_with_blocks_and_promoted_rows(pkg):
    store, job, target = block_store(pkg)
    s2 = pkg.StateStore()
    pkg.restore_store(s2, json.loads(json.dumps(pkg.dump_store(store))))
    check_block_restore(store, s2, job, target)


def test_format1_and_format2_restore_identical_state(pkg):
    store = populated_store(pkg, 120)
    s1, s2 = pkg.StateStore(), pkg.StateStore()
    pkg.restore_store(s1, json.loads(json.dumps(pkg.dump_store(store,
                                                               fmt=1))))
    pkg.restore_store(s2, json.loads(json.dumps(pkg.dump_store(store))))
    assert normalize(pkg.dump_store(s1, fmt=1)) == \
        normalize(pkg.dump_store(s2, fmt=1))
    usage_parity(s1, s2)


def test_dump_restore_keeps_claims(pkg, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    if pkg is PORT:
        svc = port_solver.BulkSolverService(device="cpu")
        monkeypatch.setitem(port_solver._services, "cpu", svc)
    else:
        svc = ref_solver.BulkSolverService()
        monkeypatch.setattr(ref_solver, "_service", svc)
    try:
        from test_torch_volumes import PORT as VPORT
        from test_torch_volumes import REF as VREF
        from test_torch_volumes import process, register, vol_job

        vpkg = VPORT if pkg is PORT else VREF
        h = x(pkg, "Harness")()
        h.store.upsert_node(pkg.mock.node())
        register(vpkg, h.store)
        j = vol_job(vpkg, "claims", vtype="csi", source="pgdata", count=1)
        process(vpkg, h, j)
        fresh = pkg.StateStore()
        fresh.restore_dump(h.store.dump())
        vol = fresh.snapshot().volume_by_id("pgdata")
        assert vol is not None and len(vol.writers()) == 1
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# the carry-over between the packages
# ---------------------------------------------------------------------------


def carry(obj):
    """A reference struct as the port's: through both codecs."""
    return port_wire.wire_decode(json.loads(json.dumps(
        REF.wire.wire_encode(obj))))


def same_ops(store, objs, *, Allocation):
    """One sequence of writes, given each package's copy of the objects,
    every timestamp pinned."""
    nodes, job, evals, allocs, block, dep, vol, cfg = objs
    store.upsert_nodes(nodes)
    store.upsert_job(job)
    store.upsert_evals(evals, ts=5.0)
    store.upsert_plan_results(allocs, alloc_blocks=[block], job=job,
                              deployment=dep, ts=6.0)
    store.update_allocs_from_client([Allocation(
        id=f"{block.id}.2", client_status=enums.ALLOC_CLIENT_FAILED)],
        ts=7.0)
    store.update_node_status(nodes[1].id, enums.NODE_STATUS_DOWN, ts=8.0)
    store.upsert_volume(vol)
    store.set_scheduler_configuration(cfg)
    store.delete_evals([evals[0].id])


def reference_objects():
    from nomad_tpu.structs.deployment import Deployment
    from nomad_tpu.structs.volumes import Volume

    nodes = [REF.mock.node(id=f"co-node-{i}", name=f"co-node-{i}")
             for i in range(6)]
    for n in nodes:
        n.attributes["unique.hostname"] = f"{n.name}.local"
        n.compute_class()
    job = REF.mock.batch_job(id="co-job", name="co-job")
    job.task_groups[0].count = 24
    evals = [REF.mock.eval_for(job, id=f"co-eval-{i}") for i in range(3)]
    allocs = [REF.mock.alloc(job, nodes[i], index=i, id=f"co-alloc-{i}",
                             eval_id="co-eval-1") for i in range(4)]
    allocs[3].desired_status = enums.ALLOC_DESIRED_STOP
    vec = allocs[0].allocated_vec.copy()
    block = RefBlock(
        id="co-block", eval_id="co-eval-2", namespace=job.namespace,
        job_id=job.id, job=job, job_version=job.version,
        task_group=job.task_groups[0].name,
        name_indices=np.arange(4, 24, dtype=np.int64),
        node_ids=[n.id for n in nodes[2:]], node_names=[n.name
                                                        for n in nodes[2:]],
        counts=np.array([5, 5, 5, 5], np.int64), allocated_vec=vec,
        rejected_rows=frozenset({3}))
    dep = Deployment(id="co-dep", job_id=job.id, namespace=job.namespace)
    vol = Volume(id="co-vol", name="co-vol")
    cfg = REF.SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    return [nodes, job, evals, allocs, block, dep, vol, cfg]


def built_pair():
    ref_objs = reference_objects()
    port_objs = carry(ref_objs)
    # the codec does not keep identity: share the job as the reference's
    # objects do
    port_objs[4].job = port_objs[1]
    for a in port_objs[3]:
        a.job = port_objs[1]
    ref_store, port_store = REF.StateStore(), PORT.StateStore()
    same_ops(ref_store, ref_objs, Allocation=RefAllocation)
    same_ops(port_store, port_objs, Allocation=PortAllocation)
    return ref_store, port_store


def shared(enc):
    """An encoded value with every struct cut to the port's fields."""
    if isinstance(enc, list):
        return [shared(v) for v in enc]
    if isinstance(enc, dict):
        if "__t" in enc:
            port_wire._build_registry()
            cls = port_wire._REGISTRY[enc["__t"]]
            known = {f.name for f in dataclasses.fields(cls)}
            return {"__t": enc["__t"],
                    "__f": {k: shared(v) for k, v in enc["__f"].items()
                            if k in known}}
        return {k: shared(v) for k, v in enc.items()}
    return enc


SHARED_TABLES = ("nodes", "jobs", "job_versions", "evals", "deployments",
                 "volumes", "node_pools", "alloc_blocks")


def test_port_dump_equals_reference_dump_on_shared_tables():
    ref_store, port_store = built_pair()
    rd = json.loads(json.dumps(REF.dump_store(ref_store)))
    pd = json.loads(json.dumps(PORT.dump_store(port_store)))
    assert rd["index"] == pd["index"]
    for table in SHARED_TABLES:
        want = sorted(json.dumps(shared(r), sort_keys=True)
                      for r in rd[table])
        got = sorted(json.dumps(shared(r), sort_keys=True)
                     for r in pd[table])
        assert got == want, table
    assert shared(pd["scheduler_config"]) == shared(rd["scheduler_config"])
    rc, pc = rd["allocs_columnar"], pd["allocs_columnar"]
    assert rc["n"] == pc["n"] == 5
    for col in pc["cols"]:
        if col != "alloc_modify_index":
            assert pc["cols"][col] == rc["cols"][col], col
    assert pc["vecs"] == rc["vecs"] and pc["job_idx"] == rc["job_idx"]
    assert shared(pc["extras"]) == shared(rc["extras"])


def content(store, fmt=2):
    """What a restore must carry: per alloc its node, statuses and
    vector, per node its usage, the blocks (format 1 writes their
    positions as rows), jobs, evals and config."""
    snap = store.snapshot()
    allocs = sorted((a.id, a.node_id, a.job_id, a.name, a.desired_status,
                     a.client_status, tuple(np.asarray(a.allocated_vec)))
                    for a in snap.allocs())
    usage = {}
    for n in snap.nodes():
        u = snap.node_usage(n.id)
        usage[n.id] = (tuple(np.asarray(u)[:4])
                       if u is not None and np.asarray(u).any() else None)
    by_node = {n.id: sorted(a.id for a in snap.allocs_by_node(n.id))
               for n in snap.nodes()}
    blocks = sorted((b.id, tuple(b.node_ids), tuple(b.counts),
                     tuple(sorted(b.rejected_rows)))
                    for b in snap.alloc_blocks())
    if fmt == 1:
        blocks = None
    cfg = snap.scheduler_configuration()
    return dict(
        index=store.latest_index, allocs=allocs, usage=usage,
        by_node=by_node, blocks=blocks,
        nodes=sorted((n.id, n.status) for n in snap.nodes()),
        jobs=sorted((j.id, j.version) for j in snap.jobs()),
        evals=sorted((e.id, e.status, e.modify_time) for e in snap.evals()),
        deployments=sorted(d.id for d in snap.deployments()),
        volumes=sorted(v.id for v in snap.volumes()),
        config=cfg.scheduler_algorithm if cfg is not None else None)


@pytest.mark.parametrize("fmt", [2, 1])
def test_reference_dump_restores_into_port(fmt):
    ref_store, port_store = built_pair()
    dump = json.loads(json.dumps(REF.dump_store(ref_store, fmt=fmt)))
    restored = convert.store_from_dump(dump)
    got, want = content(restored, fmt), content(ref_store, fmt)
    assert got == want
    # and the restored store is what the port built by the same ops
    assert content(port_store, fmt) == want


@pytest.mark.parametrize("fmt", [2, 1])
def test_port_dump_restores_into_reference(fmt):
    ref_store, port_store = built_pair()
    dump = json.loads(json.dumps(PORT.dump_store(port_store, fmt=fmt)))
    restored = REF.StateStore()
    REF.restore_store(restored, dump)
    assert content(restored, fmt) == content(ref_store, fmt)


@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_cross_restore_keeps_blocks_and_promoted_rows(direction):
    src_pkg, dst_pkg = (REF, PORT) if direction == "ref->port" else (PORT,
                                                                     REF)
    store, job, target = block_store(src_pkg)
    s2 = dst_pkg.StateStore()
    dst_pkg.restore_store(s2, json.loads(json.dumps(
        src_pkg.dump_store(store))))
    check_block_restore(store, s2, job, target)


# ---------------------------------------------------------------------------
# the restore sentinel
# ---------------------------------------------------------------------------


def test_restore_truncates_every_subscription(pkg):
    store = pkg.StateStore()
    broker = x(pkg, "EventBroker")(store)
    sub = broker.subscribe({"Allocation": ["*"], "Node": ["*"]})
    store.upsert_node(pkg.mock.node())
    assert [e.type for e in sub.next_events()] == ["node-upsert"]
    assert not sub.truncated
    src, _job, _target = block_store(pkg)
    store.restore_dump(pkg.dump_store(src))
    sub.next_events()
    assert sub.truncated


def test_restore_makes_the_feed_resync(pkg, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_INCR", "1")
    store = pkg.StateStore()
    broker = x(pkg, "EventBroker")(store)
    feed = x(pkg, "incremental").IncrementalFeed(
        store, broker, x(pkg, "incremental").StateTracker())
    for n in [pkg.mock.node() for _ in range(4)]:
        store.upsert_node(n)
    assert feed.force_verify()
    before = feed.stats()["resyncs"]
    src, _job, _target = block_store(pkg)
    store.restore_dump(pkg.dump_store(src))
    assert feed.force_verify()
    assert feed.stats()["resyncs"] == before + 1
