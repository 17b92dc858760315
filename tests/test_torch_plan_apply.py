"""The port's plan applier (nomad_tpu_torch/core/plan_apply.py) held
against the JAX package's: the cases of tests/test_plan_apply_scale.py,
the partial commit of tests/test_alloc_block.py
(``AllocBlock.without_nodes``) and test_core_server.py::TestPlanApplier,
each run through both packages; and the three over-capacity cases of
ROADMAP §C1 through each package's applier, which must reject the same
nodes and leave no node over capacity (recomputed from the store)."""

import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.core import plan_apply as ref_plan_apply
from nomad_tpu.core.server import Server as RefServer
from nomad_tpu.core.server import ServerConfig as RefServerConfig
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import Spread as RefSpread
from nomad_tpu.structs import allocs_fit as ref_allocs_fit
from nomad_tpu.structs import enums as ref_enums
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.alloc import AllocatedPort as RefAllocatedPort
from nomad_tpu.structs.alloc import AllocBlock as RefAllocBlock
from nomad_tpu.structs.plan import Plan as RefPlan
from nomad_tpu.structs.plan import PlanResult as RefPlanResult
from nomad_tpu.structs.resources import NetworkResource as RefNetwork
from nomad_tpu.structs.resources import NodeDeviceResource as RefDeviceGroup
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import plan_apply as port_plan_apply
from nomad_tpu_torch.core.server import Server as PortServer
from nomad_tpu_torch.core.server import ServerConfig as PortServerConfig
from nomad_tpu_torch.state import StateStore as PortStateStore
from nomad_tpu_torch.structs import enums as port_enums
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.alloc import AllocatedPort
from nomad_tpu_torch.structs.alloc import AllocBlock as PortAllocBlock
from nomad_tpu_torch.structs.funcs import allocs_fit as port_allocs_fit
from nomad_tpu_torch.structs.plan import Plan as PortPlan
from nomad_tpu_torch.structs.plan import PlanResult as PortPlanResult
from nomad_tpu_torch.structs.resources import (NetworkResource,
                                               NodeDeviceResource)
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_bulk_scan import (SCAN_SCORE_ATOL, SCORE_ATOL,  # noqa: F401
                                  assert_same_fingerprint, c2m_nodes,
                                  over_capacity, pinned_ids, services,
                                  sized_batch_job)
from test_torch_pipeline import fingerprint, node_record
from test_torch_spread_pipeline import job_record

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, pa=ref_plan_apply, StateStore=RefStateStore,
    Plan=RefPlan, PlanResult=RefPlanResult, enums=ref_enums,
    allocs_fit=ref_allocs_fit, AllocBlock=RefAllocBlock,
    Harness=RefHarness, operator=ref_operator, Port=RefAllocatedPort,
    Network=RefNetwork, DeviceGroup=RefDeviceGroup,
    server=lambda **kw: RefServer(RefServerConfig(
        heartbeat_ttl=3600, gc_interval=3600, **kw)))
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, pa=port_plan_apply,
    StateStore=PortStateStore, Plan=PortPlan, PlanResult=PortPlanResult,
    enums=port_enums, allocs_fit=port_allocs_fit, AllocBlock=PortAllocBlock,
    Harness=lambda: PortHarness(device="cpu"), operator=port_operator,
    Port=AllocatedPort, Network=NetworkResource,
    DeviceGroup=NodeDeviceResource,
    server=lambda **kw: PortServer(PortServerConfig(device="cpu", **kw)))


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def applier(pkg, store, **kw):
    q = pkg.pa.PlanQueue()
    q.set_enabled(True)
    return pkg.pa.PlanApplier(store, q, **kw), q


def small_node(pkg, cpu, mem):
    n = pkg.mock.node()
    n.resources.cpu = cpu
    n.resources.memory_mb = mem
    n.compute_class()
    return n


# --------------------------------------------------------------------------
# tests/test_plan_apply_scale.py
# --------------------------------------------------------------------------


def test_commit_thread_verdict_matches_direct_verify(pkg):
    store = pkg.StateStore()
    job = pkg.mock.job()
    store.upsert_job(job)
    nodes = []
    for i in range(40):
        n = pkg.mock.node()
        if i % 3 == 0:  # every third node too small for the ask
            n.resources.cpu = 100
            n.resources.memory_mb = 64
        n.compute_class()
        store.upsert_node(n)
        nodes.append(n)
    plan = pkg.Plan(eval_id="e1", snapshot_index=store.latest_index)
    for i, n in enumerate(nodes):
        plan.append_alloc(pkg.mock.alloc(job, n, index=i))
    a_direct, _ = applier(pkg, store)
    res_d, rej_d = a_direct._verify(plan, None)
    ap, q = applier(pkg, store)
    ap.start()
    try:
        res_q = q.enqueue(plan).wait(timeout=10.0)
    finally:
        ap.stop()
    assert sorted(rej_d) == sorted(res_q.rejected_nodes)
    assert set(res_d.node_allocation) == set(res_q.node_allocation)
    assert len(rej_d) == 14  # ceil(40/3) small nodes rejected
    assert ap.stats["commit_batches"] >= 1
    assert ap.stats["partial_commits"] == 1
    live = sum(1 for a in store.snapshot().allocs()
               if not a.terminal_status())
    assert live == 40 - 14


def test_overlay_sees_inflight_placements(pkg):
    store = pkg.StateStore()
    node = small_node(pkg, 1000, 1024)
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, _ = applier(pkg, store)
    a1 = pkg.mock.alloc(job, node, index=0)
    a1.allocated_vec = a1.allocated_vec * 0 + [900, 900, 0, 0]
    pa = pkg.Plan(eval_id="ea", snapshot_index=store.latest_index)
    pa.append_alloc(a1)
    result_a, rejected_a = ap._verify(pa, None)
    assert not rejected_a
    a2 = pkg.mock.alloc(job, node, index=1)
    a2.allocated_vec = a1.allocated_vec
    pb = pkg.Plan(eval_id="eb", snapshot_index=store.latest_index)
    pb.append_alloc(a2)
    _, rejected_b = ap._verify(pb, [result_a])
    assert rejected_b == [node.id]
    _, rejected_plain = ap._verify(pb, None)
    assert rejected_plain == []


def test_overlay_snapshot_merges_updates(pkg):
    store = pkg.StateStore()
    node = pkg.mock.node()
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    a = pkg.mock.alloc(job, node, index=0)
    store.upsert_allocs([a])
    snap = store.snapshot()
    stopped = a.copy_for_update()
    stopped.desired_status = pkg.enums.ALLOC_DESIRED_STOP
    new = pkg.mock.alloc(job, node, index=1)
    result = pkg.PlanResult()
    result.node_update[node.id] = [stopped]
    result.node_allocation[node.id] = [new]
    ov = pkg.pa._OverlaySnapshot(snap, [result])
    got = {x.id: x for x in ov.allocs_by_node(node.id)}
    assert got[a.id].desired_status == pkg.enums.ALLOC_DESIRED_STOP
    assert new.id in got
    assert ov.node_by_id(node.id) is not None
    # the usage row nets the stop out and the placement in
    assert np.allclose(ov.node_usage(node.id), new.allocated_vec)


def test_commit_failure_poisons_overlay_descendants(pkg):
    store = pkg.StateStore()
    node = small_node(pkg, 1000, 1024)
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    big = pkg.mock.alloc(job, node, index=0)
    big.allocated_vec = big.allocated_vec * 0 + [900, 900, 0, 0]
    store.upsert_allocs([big])
    ap, _ = applier(pkg, store)
    pa = pkg.Plan(eval_id="ea", snapshot_index=store.latest_index)
    pa.append_stopped_alloc(big, "test stop")
    gen_a = ap._poison_gen
    result_a, rej_a = ap._verify(pa, None)
    assert not rej_a
    new = pkg.mock.alloc(job, node, index=1)
    new.allocated_vec = new.allocated_vec * 0 + [900, 900, 0, 0]
    pc = pkg.Plan(eval_id="ec", snapshot_index=store.latest_index)
    pc.append_alloc(new)
    gen_c = ap._poison_gen
    result_c, rej_c = ap._verify(pc, [result_a])
    assert not rej_c
    real = store.upsert_plan_results_batch, store.upsert_plan_results

    def boom(*a, **kw):
        raise RuntimeError("leadership lost")

    # A's commit round fails whole: the batch write and the per-plan retry
    store.upsert_plan_results_batch = store.upsert_plan_results = boom
    cell_a = {"result": result_a}
    ea = pkg.pa._CommitEntry(pa, result_a, rej_a, gen_a, cell_a, Future())
    ap._commit_entries([ea])
    assert isinstance(ea.future.exception(), RuntimeError)
    store.upsert_plan_results_batch, store.upsert_plan_results = real
    assert ap._poison_gen != gen_c
    assert not cell_a["result"].node_update
    # C was verified on A's stop; its round re-verifies against the store
    ec = pkg.pa._CommitEntry(pc, result_c, rej_c, gen_c,
                             {"result": result_c}, Future())
    ap._commit_entries([ec])
    out = ec.future.result(timeout=10.0)
    assert out.rejected_nodes == [node.id]
    live = [a for a in store.snapshot().allocs_by_node(node.id)
            if not a.terminal_status()]
    fit, dim, _ = pkg.allocs_fit(node, live)
    assert fit, dim


def test_pipelined_loop_end_to_end(pkg):
    store = pkg.StateStore()
    nodes = []
    for _ in range(8):
        n = pkg.mock.node()
        store.upsert_node(n)
        nodes.append(n)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, q = applier(pkg, store)
    ap.start()
    try:
        pendings = []
        for i, n in enumerate(nodes):
            p = pkg.Plan(eval_id=f"e{i}", snapshot_index=store.latest_index)
            p.append_alloc(pkg.mock.alloc(job, n, index=i))
            pendings.append(q.enqueue(p))
        results = [p.wait(timeout=10.0) for p in pendings]
        assert all(r.alloc_index > 0 for r in results)
        assert sum(1 for _ in store.snapshot().allocs()) == 8
        assert ap.stats["applied"] == 8
    finally:
        ap.stop()


def test_landed_round_counts_twice_until_answered(pkg):
    """ROADMAP §C3: a plan verified after its predecessor's commit round
    has published but before the round is answered finds the
    predecessor's AllocBlock in the store and in the in-flight overlay.
    The reference's overlay nets single allocs already in the snapshot
    out, but not block rows: it counts the block twice and rejects the
    plan though both fit (a false, safe rejection). The port's overlay
    skips a block the snapshot holds and commits both. Neither lands
    over capacity."""
    import threading

    store = pkg.StateStore()
    node = small_node(pkg, 1000, 1024)
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, q = applier(pkg, store)
    landed, gate = threading.Event(), threading.Event()
    real = store.upsert_plan_results_batch

    def held(payloads, *a, **kw):
        index = real(payloads, *a, **kw)
        landed.set()
        assert gate.wait(10.0)
        return index

    store.upsert_plan_results_batch = held
    vec = pkg.mock.alloc(job, node).allocated_vec * 0 + [100, 100, 0, 0]
    plans = []
    for i in range(2):
        block = _block(pkg, job, [node], [4], vec)
        block.id = f"blk-{i}"
        p = pkg.Plan(eval_id=f"e{i}", snapshot_index=store.latest_index)
        p.alloc_blocks.append(block)
        plans.append(p)
    ap.start()
    try:
        pa = q.enqueue(plans[0])
        assert landed.wait(10.0)
        pb = q.enqueue(plans[1])
        deadline = time.time() + 10.0
        while not ap._commit_q and time.time() < deadline:
            time.sleep(0.01)  # B verified while A's round is unanswered
        gate.set()
        assert pa.wait(10.0).rejected_nodes == []
        twice = pkg is REF
        assert pb.wait(10.0).rejected_nodes == ([node.id] if twice
                                                else [])  # 800 <= 1000
    finally:
        gate.set()
        ap.stop()
    live = [a for a in store.snapshot().allocs_by_node(node.id)
            if not a.terminal_status()]
    assert len(live) == (4 if twice else 8) and pkg.allocs_fit(node, live)[0]


def test_bad_node_tracker_threshold_and_window(pkg):
    fired = []
    t = pkg.pa.BadNodeTracker(threshold=3, window=60.0,
                              on_bad_node=fired.append)
    now = 1000.0
    assert not t.add("n1", now)
    assert not t.add("n1", now + 1)
    assert t.add("n1", now + 2)
    assert fired == ["n1"]
    assert not t.add("n1", now + 3)
    t2 = pkg.pa.BadNodeTracker(threshold=2, window=10.0)
    assert not t2.add("n1", 1000.0)
    assert not t2.add("n1", 1011.0)  # the first event expired
    assert t2.add("n1", 1012.0)


def test_server_quarantines_bad_node(pkg):
    srv = pkg.server(num_workers=0, plan_rejection_tracker_enabled=True,
                     plan_rejection_threshold=2, plan_rejection_window=60.0)
    node = small_node(pkg, 100, 64)
    srv.store.upsert_node(node)
    job = pkg.mock.job()
    srv.store.upsert_job(job)
    with srv:
        for i in range(2):
            p = pkg.Plan(eval_id=f"e{i}",
                         snapshot_index=srv.store.latest_index)
            p.append_alloc(pkg.mock.alloc(job, node, index=i))
            r = srv.plan_queue.enqueue(p).wait(timeout=10.0)
            assert r.rejected_nodes == [node.id]
        deadline = time.time() + 5.0
        while time.time() < deadline:
            n = srv.store.snapshot().node_by_id(node.id)
            if n.scheduling_eligibility == pkg.enums.NODE_SCHED_INELIGIBLE:
                break
            time.sleep(0.05)
        assert (srv.store.snapshot().node_by_id(node.id)
                .scheduling_eligibility == pkg.enums.NODE_SCHED_INELIGIBLE)


# --------------------------------------------------------------------------
# test_core_server.py::TestPlanApplier
# --------------------------------------------------------------------------


def test_commit_and_partial_commit(pkg):
    store = pkg.StateStore()
    node = small_node(pkg, 1000, 1024)
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, _ = applier(pkg, store)
    a1 = pkg.mock.alloc(job, node, index=0)
    a1.allocated_vec = a1.allocated_vec * 0 + [600, 512, 0, 0]
    p1 = pkg.Plan(eval_id="e1", snapshot_index=store.latest_index)
    p1.append_alloc(a1)
    r1 = ap.apply(p1)
    assert r1.refresh_index == 0
    assert store.snapshot().alloc_by_id(a1.id) is not None
    a2 = pkg.mock.alloc(job, node, index=1)
    a2.allocated_vec = a1.allocated_vec
    p2 = pkg.Plan(eval_id="e2", snapshot_index=0)
    p2.append_alloc(a2)
    r2 = ap.apply(p2)
    assert r2.refresh_index > 0
    assert r2.rejected_nodes == [node.id]
    assert store.snapshot().alloc_by_id(a2.id) is None
    assert ap.stats["partial_commits"] == 1
    assert ap.stats["nodes_rejected"] == 1


def test_all_at_once_rejects_everything(pkg):
    store = pkg.StateStore()
    n1, n2 = small_node(pkg, 500, 256), pkg.mock.node()
    for n in (n1, n2):
        store.upsert_node(n)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, _ = applier(pkg, store)
    p = pkg.Plan(eval_id="e1", all_at_once=True)
    big = pkg.mock.alloc(job, n1, index=0)
    big.allocated_vec = big.allocated_vec * 10
    ok = pkg.mock.alloc(job, n2, index=1)
    p.append_alloc(big)
    p.append_alloc(ok)
    r = ap.apply(p)
    assert not r.node_allocation
    assert set(r.rejected_nodes) == {n1.id, n2.id}


def test_stops_apply_even_on_down_node(pkg):
    store = pkg.StateStore()
    node = pkg.mock.node()
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    a = pkg.mock.alloc(job, node, index=0)
    store.upsert_allocs([a])
    store.update_node_status(node.id, pkg.enums.NODE_STATUS_DOWN)
    ap, _ = applier(pkg, store)
    p = pkg.Plan(eval_id="e1")
    p.append_stopped_alloc(a, "node down",
                           client_status=pkg.enums.ALLOC_CLIENT_LOST)
    r = ap.apply(p)
    assert r.refresh_index == 0
    got = store.snapshot().alloc_by_id(a.id)
    assert got.desired_status == pkg.enums.ALLOC_DESIRED_STOP


def test_placement_on_down_node_is_rejected(pkg):
    store = pkg.StateStore()
    up, down = pkg.mock.node(), pkg.mock.node()
    for n in (up, down):
        store.upsert_node(n)
    store.update_node_status(down.id, pkg.enums.NODE_STATUS_DOWN)
    job = pkg.mock.job()
    store.upsert_job(job)
    ap, _ = applier(pkg, store)
    p = pkg.Plan(eval_id="e1")
    for i, n in enumerate((up, down)):
        p.append_alloc(pkg.mock.alloc(job, n, index=i))
    r = ap.apply(p)
    assert r.rejected_nodes == [down.id]
    assert list(r.node_allocation) == [up.id]


# --------------------------------------------------------------------------
# AllocBlock.without_nodes (tests/test_alloc_block.py)
# --------------------------------------------------------------------------


def _block(pkg, job, nodes, counts, vec):
    tg = job.task_groups[0]
    return pkg.AllocBlock(
        id="blk-1", eval_id="ev-1", job_id=job.id, job=job,
        task_group=tg.name,
        name_indices=np.arange(int(sum(counts)), dtype=np.int64),
        node_ids=[n.id for n in nodes], node_names=[n.name for n in nodes],
        counts=np.array(counts, dtype=np.int64), allocated_vec=vec)


def test_without_nodes_marks_rows_and_keeps_ids(pkg):
    job = pkg.mock.batch_job()
    nodes = [pkg.mock.node() for _ in range(3)]
    vec = pkg.mock.alloc(job, nodes[0]).allocated_vec
    block = _block(pkg, job, nodes, [2, 3, 1], vec)
    ids = [a.id for a in block.iter_allocs()]
    sliced = block.without_nodes({nodes[1].id})
    assert block.live_size() == 6 and sliced.live_size() == 3
    assert sliced.size == 6
    assert list(sliced.live_rows()) == [0, 2]
    assert sliced.allocs_for_row(1) == []
    assert [a.id for a in sliced.iter_allocs()] == ids[:2] + ids[5:]
    assert sliced.allocs_for_node(nodes[1].id) == []
    assert [a.name for a in sliced.allocs_for_node(nodes[2].id)] == [
        block.alloc_at(5).name]
    twice = sliced.without_nodes({nodes[0].id})
    assert list(twice.live_rows()) == [2] and twice.live_size() == 1
    # the original is untouched
    assert list(block.live_rows()) == [0, 1, 2]


def test_applier_partial_commit_slices_block(pkg):
    store = pkg.StateStore()
    for _ in range(8):
        store.upsert_node(small_node(pkg, 4000, 8192))
    job = pkg.mock.batch_job()
    store.upsert_job(job)
    nodes = sorted(store.snapshot().nodes(), key=lambda n: n.id)
    vec = np.zeros_like(pkg.mock.alloc(job, nodes[0]).allocated_vec)
    vec[0], vec[1] = 1000.0, 64.0
    block = _block(pkg, job, nodes[:2], [4, 4], vec)
    filler = pkg.mock.alloc(job, nodes[0])
    filler.allocated_vec = vec * 2.5
    store.upsert_allocs([filler])
    plan = pkg.Plan(eval_id="ev-1", snapshot_index=store.latest_index)
    plan.alloc_blocks.append(block)
    result = pkg.pa.PlanApplier(store, pkg.pa.PlanQueue()).apply(plan)
    assert result.rejected_nodes == [nodes[0].id]
    full, expected, actual = result.full_commit(plan)
    assert not full and expected == 8 and actual == 4
    snap = store.snapshot()
    placed = [a for a in snap.allocs_by_job(job.id)
              if a.id.startswith("blk-1")]
    assert len(placed) == 4
    assert all(a.node_id == nodes[1].id for a in placed)
    assert np.allclose(snap.node_usage(nodes[0].id), filler.allocated_vec)
    # a rejected position is no alloc of the store
    assert snap.alloc_by_id("blk-1.0") is None
    assert snap.alloc_by_id("blk-1.4") is not None


def test_stop_via_plan_promotes_block_alloc(pkg, services):
    """A stopped job's eval stops every alloc of its block (the
    reconciler's stop arm); the usage is released."""
    h = pkg.Harness()
    for _ in range(64):
        h.store.upsert_node(pkg.mock.node())
    job = sized_batch_job(512, 50, 32, "stop-blk") if pkg is REF else \
        convert.job_from_record(job_record(sized_batch_job(
            512, 50, 32, "stop-blk")))
    cfg = pkg.operator.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack")
    h.store.upsert_job(job)
    h.process(pkg.mock.eval_for(job), sched_config=cfg)
    assert len(list(h.store.snapshot().alloc_blocks())) == 1
    h.store.delete_job(job.id)
    h.process(pkg.mock.eval_for(
        job, triggered_by=pkg.enums.TRIGGER_JOB_DEREGISTER),
        sched_config=cfg)
    snap = h.store.snapshot()
    allocs = snap.allocs_by_job(job.id)
    assert len(allocs) == 512
    assert all(a.server_terminal() for a in allocs)
    for node in snap.nodes():
        u = snap.node_usage(node.id)
        assert u is None or np.allclose(u, 0)


def test_removed_group_stops_its_allocs(pkg, services):
    """The reconciler's stop arm for a task group that left the job: the
    old group's allocs stop and the new group places, alike in both
    packages."""
    h = pkg.Harness()
    for i in range(8):
        h.store.upsert_node(pkg.mock.node(id=f"grp-node-{i}",
                                          name=f"grp-node-{i}"))
    cfg = pkg.operator.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack")
    job = pkg.mock.job(id="grp-job")
    h.store.upsert_job(job)
    h.process(pkg.mock.eval_for(job), sched_config=cfg)
    job.task_groups[0].name = "api"
    h.store.upsert_job(job)
    h.process(pkg.mock.eval_for(job), sched_config=cfg)
    allocs = h.store.snapshot().allocs_by_job(job.id)
    got = sorted((a.task_group, a.desired_status) for a in allocs)
    assert got == ([("api", "run")] * 10 + [("web", "stop")] * 10)


# --------------------------------------------------------------------------
# ROADMAP §C1 through each package's applier
# --------------------------------------------------------------------------


def applier_harness(pkg):
    """The package's Harness with every plan through its PlanApplier
    (verify, partial commit, hooks, refresh) in place of the harness's
    unchecked commit; each plan's rejected node ids are kept."""
    h = pkg.Harness()
    ap = pkg.pa.PlanApplier(h.store, pkg.pa.PlanQueue())
    h.rejected = []

    def submit_plan(plan):
        h.plans.append(plan)
        result = ap.apply(plan)
        h.rejected.append(sorted(result.rejected_nodes))
        if result.refresh_index:
            return result, h.store.snapshot()
        return result, None

    h.submit_plan = submit_plan
    h.applier = ap
    return h


def c1a_jobs():
    """(a), in its sequential form: a bulk group through the service, a
    rack-spread group through the per-eval scan (B9) on the store's
    usage, a second bulk group on the service's carry, which has not
    seen the spread group's placements."""
    a = sized_batch_job(300, 50, 32, "race-a")
    sp = sized_batch_job(300, 1000, 1024, "race-spread")
    sp.task_groups[0].spreads = [RefSpread(attribute="${attr.rack}",
                                           weight=50)]
    b = sized_batch_job(300, 50, 32, "race-b")
    return [a, sp, b]


def c1c_jobs():
    """(c): the fused scan (33,000 > MAX_K) between two service solves."""
    return [sized_batch_job(300, 50, 32, "carry-a"),
            sized_batch_job(33_000, 50, 32, "carry-big"),
            sized_batch_job(300, 50, 32, "carry-b")]


def run_pair(nodes, jobs, config_fn, harness_fn):
    """The jobs in turn through the reference's and the port's harness
    made by ``harness_fn`` on the same node and job records."""
    runs = []
    records = [job_record(j) for j in jobs]
    for pkg in (REF, PORT):
        h = harness_fn(pkg)
        if pkg is REF:
            for n in nodes:
                h.store.upsert_node(n)
            pjobs = jobs
        else:
            for n in convert.nodes_from_records(
                    [node_record(n) for n in nodes]):
                h.store.upsert_node(n)
            pjobs = [convert.job_from_record(r) for r in records]
        cfg = config_fn(pkg)
        for i, j in enumerate(pjobs):
            h.store.upsert_job(j)
            h.process(pkg.mock.eval_for(j, id=f"c1-ev-{i}"),
                      sched_config=cfg)
        runs.append((h, pjobs))
    return runs


def _binpack(pkg):
    return pkg.operator.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack")


@pytest.mark.parametrize("case", ["a", "c"])
def test_c1_bulk_cases_end_within_capacity(case, services, pinned_ids):
    nodes = c2m_nodes(256)
    jobs = (c1a_jobs if case == "a" else c1c_jobs)()
    # the unchecked harness ends over capacity, in both packages alike
    (rh, _), (ph, _) = run_pair(nodes, jobs, _binpack,
                                lambda p: p.Harness())
    want_over = over_capacity(rh.store)
    assert want_over and over_capacity(ph.store) == want_over
    # through the applier: the same rejections, nothing over capacity
    (rh, rjobs), (ph, pjobs) = run_pair(nodes, jobs, _binpack,
                                        applier_harness)
    assert ph.rejected == rh.rejected
    assert any(rh.rejected)
    assert over_capacity(rh.store) == [] and over_capacity(ph.store) == []
    # the spread group's scores come from the per-eval scan (f32)
    assert_same_fingerprint((rh, rjobs), (ph, pjobs),
                            atol=SCAN_SCORE_ATOL if case == "a"
                            else SCORE_ATOL)
    assert ph.applier.stats == rh.applier.stats
    # the rejected rows' corrections reached the port's service once each
    assert services[1].stats["corrections"] == services[0].stats[
        "corrections"] > 0


def test_c1b_bulk_remainder_preemption_ends_within_capacity(services,
                                                            pinned_ids):
    """(b): cfg4's set-up; the filler's 2 leftover allocs go to the
    preemption solve, which misses the eval's own block and books
    bench4-node-0430 twice. The applier rejects the node whole."""
    from test_torch_preempt import _cfg4_config

    def run(pkg, harness):
        h = harness
        for i in range(1024):
            n = pkg.mock.node(id=f"bench4-node-{i:04d}",
                              name=f"bench4-node-{i:04d}")
            n.attributes["rack"] = f"r{i % 20}"
            n.resources.cpu = 16000
            n.resources.memory_mb = 32768
            n.compute_class()
            h.store.upsert_node(n)
        cfg = _cfg4_config(pkg.operator)
        svc_job = (bench_service_job if pkg is REF
                   else port_mock.service_job)
        warm = svc_job(512, cpu=1, mem=1, priority=20)
        warm.id = warm.name = "bench4-warm"
        h.store.upsert_job(warm)
        h.process(pkg.mock.eval_for(warm, id="bench4-ev-warm"),
                  sched_config=cfg)
        h.store.delete_job(warm.id)
        filler = svc_job(2048, cpu=7900, mem=14000, priority=20)
        filler.id = filler.name = "bench4-filler"
        h.store.upsert_job(filler)
        h.process(pkg.mock.eval_for(filler, id="bench4-ev-fill"),
                  sched_config=cfg)
        return h, [filler]

    import bench

    bench_service_job = bench.service_job
    plain = run(REF, REF.Harness())[0]
    assert [n.id for n in _over(plain)] == ["bench4-node-0430"]
    rh, rjobs = run(REF, applier_harness(REF))
    ph, pjobs = run(PORT, applier_harness(PORT))
    assert ph.rejected == rh.rejected
    assert ["bench4-node-0430"] in rh.rejected
    assert _over(rh) == [] and _over(ph) == []
    assert fingerprint(ph.store, pjobs) == fingerprint(rh.store, rjobs)


def _over(h):
    snap = h.store.snapshot()
    nodes = list(snap.nodes())
    return [nodes[i] for i in over_capacity(h.store)]


# --------------------------------------------------------------------------
# ports, devices and cores: tests/test_plan_apply_scale.py
# ::TestReservedPortRace, tests/test_network.py::TestPlanApplierCollisions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["binpack", "tpu-binpack"])
def test_two_workers_race_one_reserved_port(pkg, algorithm, services):
    """Two jobs that want the same static port on a one-node cluster,
    racing through two workers and the applier: exactly one holds the
    port, the other is blocked, and the committed state fits."""
    srv = pkg.server(num_workers=2, nack_timeout=900.0,
                     sched_config=pkg.operator.SchedulerConfiguration(
                         scheduler_algorithm=algorithm))
    node = pkg.mock.node()
    srv.store.upsert_node(node)
    jobs = []
    for _ in range(2):
        j = pkg.mock.job()
        tg = j.task_groups[0]
        tg.count = 1
        tg.networks = [pkg.Network(mode="host",
                                   reserved_ports=[("http", 8080)])]
        jobs.append(j)
    with srv:
        for j in jobs:
            srv.register_job(j)
        assert srv.wait_for_idle(timeout=60.0, include_delayed=False)
        snap = srv.store.snapshot()
        holders = [a for j in jobs for a in snap.allocs_by_job(j.id)
                   if not a.terminal_status()
                   and 8080 in [p.value for p in a.allocated_ports]]
        assert len(holders) == 1
        live = [a for a in snap.allocs_by_node(node.id)
                if not a.terminal_status()]
        fit, dim, _ = pkg.allocs_fit(node, live)
        assert fit, dim


def _id_plans(pkg, nodes, job, rows):
    """One plan a row; a row is (node index, ports, devices, cores) of
    one alloc, or several such tuples."""
    plans = []
    for i, row in enumerate(rows):
        p = pkg.Plan(eval_id=f"ids-{i}", snapshot_index=0)
        for k, (ni, ports, devices, cores) in enumerate(row):
            a = pkg.mock.alloc(job, nodes[ni], index=10 * i + k,
                               id=f"ids-{i}-{k}")
            a.allocated_ports = [pkg.Port(label="p", value=v) for v in ports]
            a.allocated_devices = devices
            a.allocated_cores = cores
            p.append_alloc(a)
        plans.append(p)
    return plans


# (node index, ports, devices, cores) per alloc, each list a plan; and
# the nodes each plan gets rejected
A100 = "nvidia/gpu/a100"
ID_RACES = {
    "reserved_port": ([[(0, [8080], {}, []), (1, [8080], {}, [])],
                       [(0, [8080], {}, [])],
                       [(1, [9090], {}, [])]],
                      [[], ["ids-node-0"], []]),
    "device_count": ([[(0, [], {A100: ["g-0"]}, [])],
                      [(0, [], {A100: ["g-0", "g-1"]}, [])],
                      [(0, [], {A100: ["g-1"]}, []),
                       (1, [], {A100: ["h-0", "h-1"]}, [])],
                      [(1, [], {A100: ["h-0"]}, [])]],
                     [[], ["ids-node-0"], [], ["ids-node-1"]]),
    # the device check counts instances a group holds, not their ids
    # (as the reference's does): one id twice within the count commits
    "device_same_id": ([[(0, [], {A100: ["g-0"]}, [])],
                        [(0, [], {A100: ["g-0"]}, [])]],
                       [[], []]),
    "core": ([[(0, [], {}, [0, 1]), (1, [], {}, [0, 1])],
              [(0, [], {}, [1, 2])],
              [(1, [], {}, [2, 3])]],
             [[], ["ids-node-0"], []]),
}


@pytest.mark.parametrize("case", sorted(ID_RACES))
@pytest.mark.parametrize("queued", [False, True])
def test_appliers_reject_the_same_double_bookings(case, queued):
    """The same plans, one after another, through both packages'
    appliers (directly, or queued so that each verifies against the
    in-flight results of the ones before it): the same nodes rejected,
    the same allocs committed."""
    ref_nodes = []
    for i, tag in enumerate("gh"):
        n = REF.mock.node(id=f"ids-node-{i}", name=f"ids-node-{i}")
        n.resources.devices = [RefDeviceGroup(
            vendor="nvidia", type="gpu", name="a100",
            instance_ids=[f"{tag}-0", f"{tag}-1"])]
        n.compute_class()
        ref_nodes.append(n)
    port_nodes = convert.nodes_from_records([node_record(n)
                                             for n in ref_nodes])
    out = []
    for pkg, nodes in ((REF, ref_nodes), (PORT, port_nodes)):
        store = pkg.StateStore()
        for n in nodes:
            store.upsert_node(n)
        job = pkg.mock.job()
        job.id = "ids-job"
        store.upsert_job(job)
        plans = _id_plans(pkg, nodes, job, ID_RACES[case][0])
        ap, q = applier(pkg, store)
        if queued:
            ap.start()
            try:
                pending = [q.enqueue(p) for p in plans]
                results = [pp.wait(timeout=10.0) for pp in pending]
            finally:
                ap.stop()
        else:
            results = [ap.apply(p) for p in plans]
        live = sorted(a.id for a in store.snapshot().allocs()
                      if not a.terminal_status())
        out.append(([sorted(r.rejected_nodes) for r in results], live))
    assert out[0] == out[1]
    assert out[1][0] == ID_RACES[case][1]
