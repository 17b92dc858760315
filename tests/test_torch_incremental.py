"""The incremental usage feed and its device twin
(nomad_tpu_torch/tensor/incremental.py, the event broker of
nomad_tpu_torch/core/events.py and the store's events), held against the
reference's (nomad_tpu/tensor/incremental.py) on the same seeded inputs:
the cases of tests/test_incremental_state.py that the port's writes
allow.

- a randomized delta stream (places, stops, evictions, rewrites) folded
  incrementally is bit-exact against a gen-bounded rebuild, and equal to
  the reference feed's base; so is the stream with client updates
  (terminal and not) and desired transitions in place of stops;
- an AllocBlock's expansion and a promoted position (its stop, or a
  client update of it) fold as the store counts them;
- a lapped ring forces a resync; a new static of the same layout keeps
  the epoch and a membership change resyncs;
- the NOMAD_TPU_INCR=0 kill switch restores the exact legacy build;
- the feed counts the Allocation deltas of each build;
- the device twin flushes to exactly base.astype(f32), also sharded over
  a CPU NodeMesh of 2, 4 and 8 shards, and it survives the solve: the
  service's twin route folds a clone, and its carry equals the host
  route's;
- the same writes put the same (topic, type, key) stream through both
  brokers;
- a seeded divergence trips the parity check, and the feed repairs by
  resync;
- core GC's writes fold: a GC'd promoted block position (the store's
  quiet ``with_dropped`` re-put compensated by ``gc_dropped``), and a
  node delete, which makes the next build resync onto the new layout,
  also inside a randomized stream with GC and node deletes;
- the ``NodeSlotRegistry`` keeps slots stable and recycles a deleted
  node's slot to the next joiner, lowest first.

Left out until the port's store has the write (ROADMAP A10): the restore
sentinel of test_truncation_forces_resync (restore needs
``state/persist.py``).
"""

import copy
import types

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.core.events import EventBroker as RefBroker
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs.alloc import AllocBlock as RefBlock
from nomad_tpu.structs.alloc import Allocation as RefAlloc
from nomad_tpu.structs.operator import NodePool as RefNodePool
from nomad_tpu.tensor import incremental as ref_inc
from nomad_tpu.tensor.cluster import ClusterStatic as RefStatic
from nomad_tpu.tensor.cluster import NodeSlotRegistry as RefSlotRegistry
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core.events import EventBroker
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import enums
from nomad_tpu_torch.structs.alloc import AllocBlock, Allocation
from nomad_tpu_torch.structs.operator import NodePool
from nomad_tpu_torch.structs.plan import Plan
from nomad_tpu_torch.structs.resources import RESOURCE_DIMS
from nomad_tpu_torch.tensor import incremental as inc
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.tensor.cluster import (ClusterStatic, ClusterTensors,
                                            NodeSlotRegistry)
from nomad_tpu_torch.tensor.overlay import INFLIGHT
from nomad_tpu_torch.tensor.placer import _changed_allocs_since_last_build
from nomad_tpu_torch.tensor.sharding import shard_mesh

from test_torch_pipeline import node_record

CPU = torch.device("cpu")
REF = types.SimpleNamespace(Store=RefStore, Broker=RefBroker,
                            Tracker=ref_inc.StateTracker, Alloc=RefAlloc,
                            Block=RefBlock, Static=RefStatic,
                            Slots=RefSlotRegistry, mock=ref_mock)
PORT = types.SimpleNamespace(Store=StateStore, Broker=EventBroker,
                             Tracker=inc.StateTracker, Alloc=Allocation,
                             Block=AllocBlock, Static=ClusterStatic,
                             Slots=NodeSlotRegistry, mock=port_mock)


class Side:
    """One package's store, broker, tracker, feed and nodes."""

    def __init__(self, pkg, nodes, ring_size=4096):
        self.pkg = pkg
        self.store = pkg.Store()
        self.broker = pkg.Broker(self.store, ring_size=ring_size)
        self.tracker = pkg.Tracker()
        self.feed = self.tracker.attach(self.store, self.broker)
        for n in nodes:
            self.store.upsert_node(n)
        self.nodes = nodes
        # the port's static keeps the store's usage rows (latest_usage)
        self.static = (pkg.Static(nodes, store=self.store) if pkg is PORT
                       else pkg.Static(nodes))

    def alloc(self, aid, node_i, cpu, mem):
        a = self.pkg.Alloc(id=aid, name=aid, node_id=self.nodes[node_i].id,
                           job_id="ij", eval_id="ie")
        vec = np.zeros_like(a.allocated_vec)
        vec[0] = float(cpu)
        vec[1] = float(mem)
        a.allocated_vec = vec
        return a

    def with_status(self, aid, desired):
        a = copy.copy(self.store.snapshot().alloc_by_id(aid))
        a.desired_status = desired
        return a

    def base(self, static=None):
        return self.feed.base_for(self.static if static is None else static)

    def restatic(self, nodes):
        """A new static over ``nodes`` (a node set that changed)."""
        self.nodes = nodes
        self.static = (self.pkg.Static(nodes, store=self.store)
                       if self.pkg is PORT else self.pkg.Static(nodes))


def _nodes(n):
    """n reference nodes and their port copies (same ids and capacities)."""
    ref = []
    for _ in range(n):
        node = ref_mock.node()
        node.compute_class()
        ref.append(node)
    return ref, convert.nodes_from_records([node_record(x) for x in ref])


def _pair(n, ring_size=4096):
    ref_nodes, port_nodes = _nodes(n)
    return Side(REF, ref_nodes, ring_size), Side(PORT, port_nodes, ring_size)


def _truth(store, static):
    """The gen-bounded per-node usage rebuild: the parity oracle."""
    out = np.zeros((static.n_pad, RESOURCE_DIMS))
    gen = store._index
    for nid, i in static.node_index.items():
        vec = store._node_usage.get(nid, gen)
        if vec is not None:
            out[i] = vec[:RESOURCE_DIMS]
    return out


def _check(sides):
    bases = []
    for s in sides:
        base = s.base()
        assert base is not None and not base.flags.writeable
        assert np.array_equal(base, _truth(s.store, s.static)), s.pkg
        bases.append(np.array(base))
    assert np.array_equal(bases[0], bases[1])


@pytest.fixture(autouse=True)
def _feed_on(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_INCR", raising=False)
    INFLIGHT._entries.clear()


def test_randomized_delta_stream_is_bit_exact():
    sides = _pair(6)
    rng = np.random.default_rng(7)
    live, serial = [], 0
    for _ in range(60):
        op = int(rng.integers(0, 5))
        if op in (0, 4) or not live:                # place a new alloc
            serial += 1
            aid, node_i = f"ia{serial}", int(rng.integers(0, 6))
            cpu, mem = (int(rng.integers(1, 9)) * 100,
                        int(rng.integers(1, 9)) * 64)
            for s in sides:
                a = s.alloc(aid, node_i, cpu, mem)
                if op == 4:
                    s.store.upsert_plan_results(result_allocs=[a])
                else:
                    s.store.upsert_allocs([a])
            live.append(aid)
        elif op in (1, 3):                          # stop or evict
            aid = live.pop(int(rng.integers(0, len(live))))
            for s in sides:
                if op == 1:
                    s.store.upsert_plan_results([], stopped_allocs=[
                        s.with_status(aid, enums.ALLOC_DESIRED_STOP)])
                else:
                    s.store.upsert_plan_results([], preempted_allocs=[
                        s.with_status(aid, enums.ALLOC_DESIRED_EVICT)])
        else:                                       # a rewrite, same usage
            aid = live[int(rng.integers(0, len(live)))]
            for s in sides:
                again = copy.copy(s.store.snapshot().alloc_by_id(aid))
                again.allocated_vec = again.allocated_vec.copy()
                s.store.upsert_allocs([again])
        _check(sides)
    for s in sides:
        assert s.feed.force_verify()
        assert s.tracker.violations == []
        stats = s.feed.stats()
        assert stats["deltas_applied"] > 0
        assert stats["fast_hits"] == 60 and stats["resyncs"] == 1
    assert (sides[0].feed.stats()["deltas_applied"]
            == sides[1].feed.stats()["deltas_applied"])


def test_block_expansion_and_promotion():
    sides = _pair(4)
    for s in sides:
        assert s.base() is not None                 # the epoch before blocks
        vec = np.zeros_like(s.pkg.Alloc().allocated_vec)
        vec[0], vec[1] = 50.0, 32.0
        block = s.pkg.Block(
            id="blk-inc", eval_id="ev-inc", job_id="ij", task_group="web",
            name_indices=np.arange(8, dtype=np.int64),
            node_ids=[s.nodes[0].id, s.nodes[1].id],
            node_names=[s.nodes[0].name, s.nodes[1].name],
            counts=np.array([3, 5], dtype=np.int64), allocated_vec=vec)
        s.store.upsert_plan_results([], alloc_blocks=[block])
    _check(sides)
    # a stopped block position is promoted to a real row: the row's event
    # overrides the block's expansion exactly once
    for pos in (1, 6):
        for s in sides:
            s.store.upsert_plan_results([], stopped_allocs=[
                s.with_status(f"blk-inc.{pos}", enums.ALLOC_DESIRED_STOP)])
        _check(sides)
    # a second stop of a promoted row moves nothing
    for s in sides:
        s.store.upsert_plan_results([], stopped_allocs=[
            s.with_status("blk-inc.1", enums.ALLOC_DESIRED_STOP)])
    _check(sides)
    for s in sides:
        assert s.feed.force_verify()
        assert s.tracker.violations == []
    assert sides[1].base()[0, 0] == 100.0 and sides[1].base()[1, 0] == 200.0


def _client_update(side, aid, status):
    return side.pkg.Alloc(id=aid, client_status=status)


def test_randomized_client_and_transition_stream_is_bit_exact():
    """The randomized stream of tests/test_incremental_state.py:84-118
    without its GC op, through both feeds: placements, client-terminal
    updates (they leave the usage), non-terminal client updates and
    desired transitions (they move none) and same-usage rewrites."""
    from nomad_tpu.structs.alloc import DesiredTransition as RefTransition

    from nomad_tpu_torch.structs.alloc import DesiredTransition

    sides = _pair(6)
    rng = np.random.default_rng(7)
    live, serial = [], 0
    for _ in range(80):
        op = int(rng.integers(0, 5))
        if op == 0 or not live:                     # place a new alloc
            serial += 1
            aid, node_i = f"ia{serial}", int(rng.integers(0, 6))
            cpu, mem = (int(rng.integers(1, 9)) * 100,
                        int(rng.integers(1, 9)) * 64)
            for s in sides:
                s.store.upsert_allocs([s.alloc(aid, node_i, cpu, mem)])
            live.append(aid)
        elif op == 1:                               # client-terminal
            aid = live.pop(int(rng.integers(0, len(live))))
            status = ("complete", "failed")[int(rng.integers(0, 2))]
            for s in sides:
                s.store.update_allocs_from_client(
                    [_client_update(s, aid, status)])
        elif op == 2:                               # client running
            aid = live[int(rng.integers(0, len(live)))]
            for s in sides:
                s.store.update_allocs_from_client(
                    [_client_update(s, aid, "running")])
        elif op == 3:                               # a desired transition
            aid = live[int(rng.integers(0, len(live)))]
            for s, tr in zip(sides, (RefTransition, DesiredTransition)):
                s.store.update_alloc_desired_transitions(
                    {aid: tr(migrate=True)})
        else:                                       # a rewrite, same usage
            aid = live[int(rng.integers(0, len(live)))]
            for s in sides:
                again = copy.copy(s.store.snapshot().alloc_by_id(aid))
                again.allocated_vec = again.allocated_vec.copy()
                s.store.upsert_allocs([again])
        _check(sides)
    for s in sides:
        assert s.feed.force_verify()
        assert s.tracker.violations == []
        assert s.feed.stats()["fast_hits"] == 80
    assert (sides[0].feed.stats()["deltas_applied"]
            == sides[1].feed.stats()["deltas_applied"])


def test_client_update_of_a_block_row():
    """A client update promotes a block position to a row of its own: it
    leaves the usage once, shows once in the node and job reads (the
    block position no more), and a second update or a transition of it
    moves nothing."""
    from nomad_tpu.structs.alloc import DesiredTransition as RefTransition

    from nomad_tpu_torch.structs.alloc import DesiredTransition

    sides = _pair(4)
    for s in sides:
        assert s.base() is not None
        vec = np.zeros_like(s.pkg.Alloc().allocated_vec)
        vec[0], vec[1] = 50.0, 32.0
        s.store.upsert_plan_results([], alloc_blocks=[s.pkg.Block(
            id="blk-cu", eval_id="ev-cu", job_id="ij", task_group="web",
            name_indices=np.arange(8, dtype=np.int64),
            node_ids=[s.nodes[0].id, s.nodes[1].id],
            node_names=[s.nodes[0].name, s.nodes[1].name],
            counts=np.array([3, 5], dtype=np.int64), allocated_vec=vec)])
    _check(sides)
    for step in ("failed", "failed", "transition", "running"):
        for s, tr in zip(sides, (RefTransition, DesiredTransition)):
            if step == "transition":
                s.store.update_alloc_desired_transitions(
                    {"blk-cu.4": tr(migrate=True)})
            else:
                s.store.update_allocs_from_client(
                    [_client_update(s, "blk-cu.1", step)])
        _check(sides)
    for s in sides:
        snap = s.store.snapshot()
        by_job = [a.id for a in snap.allocs_by_job("ij")]
        by_node = [a.id for a in snap.allocs_by_node(s.nodes[0].id)]
        assert sorted(by_job) == [f"blk-cu.{p}" for p in range(8)]
        assert sorted(by_node) == ["blk-cu.0", "blk-cu.1", "blk-cu.2"]
        row = snap.alloc_by_id("blk-cu.1")
        assert row.client_status == "running"
        assert snap.alloc_by_id("blk-cu.4").desired_transition.migrate
        assert sum(a.id == "blk-cu.1" for a in snap.allocs()) == 1
        assert s.feed.force_verify()
    # failed once: the row left its node's usage; running again is a
    # client update of a non-terminal row, which re-enters it
    assert sides[1].base()[0, 0] == 150.0 and sides[1].base()[1, 0] == 250.0


def test_truncation_forces_resync():
    """A ring of 8 lapped between two builds: the contract answer is a
    full resync from a snapshot, never an incremental patch."""
    sides = _pair(3, ring_size=8)
    for s in sides:
        s.store.upsert_allocs([s.alloc("ia0", 0, 200, 128)])
    _check(sides)
    before = [s.feed.stats()["resyncs"] for s in sides]
    for i in range(12):
        for s in sides:
            s.store.upsert_allocs([s.alloc(f"ib{i}", i % 3, 300, 64)])
    _check(sides)
    for s, b in zip(sides, before):
        assert s.feed.stats()["resyncs"] == b + 1
        assert s.feed.force_verify()
        assert s.tracker.violations == []


def test_same_layout_keeps_epoch_membership_change_resyncs():
    sides = _pair(4)
    for s in sides:
        assert s.base() is not None
        resyncs = s.feed.stats()["resyncs"]
        # a new static of the same membership and order keeps the epoch
        again = s.pkg.Static(s.nodes)
        assert s.base(again) is not None
        assert s.feed.stats()["resyncs"] == resyncs
        s.store.upsert_allocs([s.alloc("im0", 2, 100, 64)])
        assert np.array_equal(s.base(again), _truth(s.store, again))
        assert s.feed.stats()["resyncs"] == resyncs
        # a node joins: the new layout resyncs
        joined = (ref_mock.node() if s.pkg is REF else port_mock.node())
        joined.compute_class()
        s.store.upsert_node(joined)
        grown = s.pkg.Static(s.nodes + [joined])
        base = s.base(grown)
        assert s.feed.stats()["resyncs"] == resyncs + 1
        assert np.array_equal(base, _truth(s.store, grown))
        assert s.feed.force_verify()


def test_kill_switch_restores_exact_legacy_build(monkeypatch):
    _, port = _pair(5)
    for i in range(9):
        port.store.upsert_allocs([port.alloc(f"ik{i}", i % 5, (i + 1) * 100,
                                             (i + 1) * 32)])
    warm = ClusterTensors.build(
        EvalContext(port.store.snapshot(), eval_id="inc-on"), port.nodes)
    assert not warm.used.flags.writeable            # the shared view
    assert np.shares_memory(warm.used, port.feed._epoch.base)
    monkeypatch.setenv("NOMAD_TPU_INCR", "0")
    assert not inc.incr_enabled()
    assert port.feed.base_for(warm.static) is None  # read per call
    assert port.feed.device_used(warm.static, CPU) is None
    assert inc.device_used_fn(port.store, warm.static) is None
    cold = ClusterTensors.build(
        EvalContext(port.store.snapshot(), eval_id="inc-off"), port.nodes)
    assert cold.used.flags.writeable
    assert np.array_equal(np.asarray(warm.used), cold.used)
    monkeypatch.delenv("NOMAD_TPU_INCR")
    # copy on write: a plan that touches a node gets a private copy, and
    # the shared base stays as it was
    plan = Plan(eval_id="inc-plan")
    extra = port.alloc("ik-plan", 0, 1000, 512)
    plan.node_allocation[extra.node_id] = [extra]
    private = ClusterTensors.build(
        EvalContext(port.store.snapshot(), plan=plan, eval_id="inc-cow"),
        port.nodes)
    assert private.used.flags.writeable
    assert not np.shares_memory(private.used, port.feed._epoch.base)
    assert private.used[0, 0] == cold.used[0, 0] + 1000.0
    assert np.array_equal(port.base()[:5], cold.used[:5])


def test_feed_native_changed_allocs_count():
    _, port = _pair(3)
    assert port.base() is not None
    _changed_allocs_since_last_build(port.store)    # drain the backlog
    port.store.upsert_allocs([port.alloc(f"ic{i}", 0, 100, 64)
                              for i in range(5)])
    assert _changed_allocs_since_last_build(port.store) == 5
    assert _changed_allocs_since_last_build(port.store) == 0
    port.store.upsert_plan_results([], stopped_allocs=[
        port.with_status("ic0", enums.ALLOC_DESIRED_STOP)])
    assert _changed_allocs_since_last_build(port.store) == 1
    # without a feed: the registry's alloc_deltas counter
    assert _changed_allocs_since_last_build(StateStore()) >= 0


class _CountingLock:
    def __init__(self, lock):
        self.lock = lock
        self.taken = 0

    def __enter__(self):
        self.taken += 1
        return self.lock.__enter__()

    def __exit__(self, *exc):
        return self.lock.__exit__(*exc)


def test_build_takes_its_delta_count_with_the_base():
    """A tensor build drains and takes its delta count with the fed base
    under one acquisition of the feed's lock; a later group's refresh
    drains without taking, so its deltas count in the next build."""
    _, port = _pair(3)

    def build(i):
        return ClusterTensors.build(
            EvalContext(port.store.snapshot(), eval_id=f"ib-e{i}"),
            port.nodes)

    build(0)                                        # the backlog
    port.store.upsert_allocs([port.alloc(f"ib{i}", i % 3, 100, 64)
                              for i in range(4)])
    lock = port.feed._lock = _CountingLock(port.feed._lock)
    cluster = build(1)
    assert lock.taken == 1
    assert cluster.changed_allocs == 4
    assert _changed_allocs_since_last_build(port.store,
                                            cluster.changed_allocs) == 4
    assert lock.taken == 1                          # counted, not retaken
    port.store.upsert_allocs([port.alloc("ib9", 1, 100, 64)])
    cluster.refresh_usage(EvalContext(port.store.snapshot(), eval_id="ib-g"))
    assert cluster.changed_allocs == 4
    assert build(2).changed_allocs == 1
    assert np.array_equal(port.base(), _truth(port.store, port.static))


def test_device_twin_flushes_to_exact_base():
    _, port = _pair(4)
    port.store.upsert_allocs([port.alloc("it0", 0, 400, 256)])
    dev = port.feed.device_used(port.static, CPU)
    assert dev.dtype == torch.float32 and dev.shape == (8, RESOURCE_DIMS)
    assert np.array_equal(dev.numpy(), port.base().astype(np.float32))
    for i in range(6):
        port.store.upsert_allocs([port.alloc(f"it{i + 1}", i % 4,
                                             (i + 1) * 50, 32)])
    port.store.upsert_plan_results([], stopped_allocs=[
        port.with_status("it0", enums.ALLOC_DESIRED_STOP)])
    again = port.feed.device_used(port.static, CPU)
    assert again is dev                             # flushed in place
    assert np.array_equal(dev.numpy(), port.base().astype(np.float32))
    stats = port.feed.stats()
    assert stats["twin_uploads"] == 1 and stats["twin_flushes"] == 1
    assert port.feed.force_verify()                 # the twin included
    # more pending rows than n_pad (8): the twin is uploaded anew
    for i in range(9):
        port.store.upsert_allocs([port.alloc(f"iu{i}", i % 4, 10, 8)])
    lagged = port.feed.device_used(port.static, CPU)
    assert lagged is not dev
    assert np.array_equal(lagged.numpy(), port.base().astype(np.float32))
    stats = port.feed.stats()
    assert stats["twin_uploads"] == 2 and stats["twin_flushes"] == 1
    assert port.feed.force_verify()
    assert port.tracker.violations == []


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_twin_matches_single_device(shards):
    """The twin over a CPU NodeMesh (B15's adds, plain version) equals the
    single-device twin (B4's) after the same deltas."""
    _, port = _pair(6)
    mesh = shard_mesh(shards, "cpu")
    rng = np.random.default_rng(11)
    for i in range(5):
        port.store.upsert_allocs([port.alloc(
            f"is{i}", int(rng.integers(0, 6)), int(rng.integers(1, 9)) * 100,
            int(rng.integers(1, 9)) * 64)])
    single = port.feed.device_used(port.static, CPU)
    parts = port.feed.device_used(port.static, CPU, mesh)
    assert len(parts) == shards
    for i in range(5, 11):      # 7 pending rows, within n_pad 8
        port.store.upsert_allocs([port.alloc(
            f"is{i}", int(rng.integers(0, 6)), int(rng.integers(1, 9)) * 100,
            int(rng.integers(1, 9)) * 64)])
    port.store.upsert_plan_results([], stopped_allocs=[
        port.with_status("is3", enums.ALLOC_DESIRED_STOP)])
    single = port.feed.device_used(port.static, CPU)
    parts = port.feed.device_used(port.static, CPU, mesh)
    assert port.feed.stats()["twin_flushes"] == 2
    want = port.base().astype(np.float32)
    assert np.array_equal(single.numpy(), want)
    assert np.array_equal(torch.cat(parts).numpy(), want)
    assert not port.feed._epoch.devlog              # both caught up
    assert port.feed.force_verify()


def _bulk_solve(svc, port, seed, used_dev_fn):
    n_pad = port.static.n_pad
    feas = np.zeros(n_pad, dtype=bool)
    feas[:len(port.nodes)] = True
    aff = np.zeros(n_pad)
    usage = lambda: ClusterTensors(  # noqa: E731 - the latest_usage route
        nodes=port.nodes, n_pad=n_pad, available=port.static.available,
        used=None, node_index=port.static.node_index, static=port.static,
        _store=port.store).latest_usage()
    counts, _ = svc.solve(
        static=port.static, feas_base=feas, aff=aff,
        ask=np.array([500.0, 256.0, 0.0, 0.0]), k=12, tg_count=12.0,
        seed=seed, used_fn=usage, used_dev_fn=used_dev_fn)
    return counts


def test_twin_survives_the_solve_and_routes_agree(monkeypatch):
    """The twin route's carry (a clone of the twin, the open ledger folded
    by one B4 call) equals the host route's, solve after solve, and the
    twin still equals base.astype(f32) after the solves wrote their
    carry."""
    _, port = _pair(6)
    for i in range(4):
        port.store.upsert_allocs([port.alloc(f"iv{i}", i, 1000, 512)])
    services = []
    for twin in (True, False):
        svc = port_solver.BulkSolverService(device="cpu")
        svc.RESYNC_SOLVES = 1           # every solve after the first resyncs
        services.append(svc)
    try:
        fn = inc.device_used_fn(port.store, port.static)
        for seed in (3, 4, 5):
            got = [_bulk_solve(svc, port, seed, dev_fn)
                   for svc, dev_fn in zip(services, (fn, None))]
            assert np.array_equal(got[0], got[1])
            carries = [svc._state[1] for svc in services]
            assert torch.equal(carries[0], carries[1])
            twin = port.feed._epoch.twins[CPU].arr
            assert carries[0] is not twin
            assert np.array_equal(twin.numpy(),
                                  port.base().astype(np.float32))
        assert services[0].stats["twin_resyncs"] == 3
        assert services[0].stats["host_resyncs"] == 0
        assert services[1].stats["host_resyncs"] == 3
        assert services[1].stats["twin_resyncs"] == 0
        # the kill switch flipped after the request was made: a miss,
        # counted, on the exact host route
        monkeypatch.setenv("NOMAD_TPU_INCR", "0")
        assert fn(CPU) is None
        got = [_bulk_solve(svc, port, 6, dev_fn)
               for svc, dev_fn in zip(services, (fn, None))]
        assert np.array_equal(got[0], got[1])
        assert torch.equal(services[0]._state[1], services[1]._state[1])
        assert services[0].stats["twin_misses"] == 1
        assert services[0].stats["host_resyncs"] == 1
        monkeypatch.delenv("NOMAD_TPU_INCR")
    finally:
        for svc in services:
            svc.stop()
    assert port.feed.force_verify()


def _drive(side, make_job, pool_cls, make_eval):
    """The same writes through one package's store."""
    store = side.store
    nodes = side.nodes
    store.upsert_node_pool(pool_cls(name="pool-a"))
    job = make_job()
    job.id = job.name = "ev-job"
    store.upsert_job(job)
    store.update_node_status(nodes[1].id, "down")
    store.update_node_eligibility(nodes[2].id, "ineligible")
    store.upsert_allocs([side.alloc("ev-a0", 0, 100, 64),
                         side.alloc("ev-a1", 3, 200, 64)])
    vec = np.zeros_like(side.pkg.Alloc().allocated_vec)
    vec[0] = 50.0
    block = side.pkg.Block(
        id="ev-blk", eval_id="ev-e0", job_id=job.id, task_group="web",
        name_indices=np.arange(3, dtype=np.int64), node_ids=[nodes[0].id],
        node_names=[nodes[0].name], counts=np.array([3], dtype=np.int64),
        allocated_vec=vec)
    ev = make_eval(job, "ev-e0")
    store.upsert_evals([ev])
    store.upsert_plan_results(
        result_allocs=[side.alloc("ev-a2", 2, 300, 64),
                       side.with_status("ev-a1", "run")],
        stopped_allocs=[side.with_status("ev-a0", "stop")],
        alloc_blocks=[block], evals=[make_eval(job, "ev-e1")])
    store.upsert_plan_results([], preempted_allocs=[
        side.with_status("ev-a2", "evict")])
    store.delete_job(job.id, purge=False)


def test_both_brokers_carry_the_same_event_stream():
    sides = _pair(4)
    streams = []
    # the reference's read blocks up to ``timeout``; the port's never does
    for s, mock, pool_cls, wait in (
            (sides[0], ref_mock, RefNodePool, {"timeout": 0}),
            (sides[1], port_mock, NodePool, {})):
        sub = s.broker.subscribe()
        _drive(s, mock.job, pool_cls,
               lambda j, i, m=mock: m.eval_for(j, id=i))
        streams.append([(e.topic, e.type, e.key)
                        for e in sub.next_events(**wait)])
        assert not sub.truncated
        sub.close()
    assert streams[0] == streams[1]
    kinds = {t for _, t, _ in streams[1]}
    assert {"node-status", "node-eligibility", "job-upsert", "job-delete",
            "eval-upsert", "alloc-upsert", "alloc-stop", "alloc-preempt",
            "alloc-block-upsert"} <= kinds
    # the rewrite of an existing row comes before the first insert, as in
    # the reference's plan apply
    ups = [k for _, t, k in streams[1] if t == "alloc-upsert"]
    assert ups == ["ev-a0", "ev-a1", "ev-a1", "ev-a2"]


def test_parity_check_catches_seeded_divergence():
    _, port = _pair(3)
    port.store.upsert_allocs([port.alloc("ip0", 0, 100, 64)])
    assert port.base() is not None
    port.feed._epoch.base[0, 0] += 1.0              # the seeded corruption
    assert not port.feed.force_verify()
    assert [v.kind for v in port.tracker.violations] == ["state-divergence"]
    assert port.feed._epoch is None                 # repair: a resync
    assert np.array_equal(port.base(), _truth(port.store, port.static))
    with pytest.raises(AssertionError, match="violations"):
        port.tracker.check()


def test_block_expansion_promotion_and_gc():
    """tests/test_incremental_state.py::test_block_expansion_promotion_and_gc
    through both feeds: a block, one position promoted by a client
    update (complete), then GC'd: the store drops the position in a
    quiet block re-put, and the feed's gc_dropped stands in for it."""
    sides = _pair(4)
    for s in sides:
        assert s.base() is not None
        vec = np.zeros_like(s.pkg.Alloc().allocated_vec)
        vec[0], vec[1] = 50.0, 32.0
        s.store.upsert_plan_results([], alloc_blocks=[s.pkg.Block(
            id="blk-gc", eval_id="ev-gc", job_id="ij", task_group="web",
            name_indices=np.arange(8, dtype=np.int64),
            node_ids=[s.nodes[0].id, s.nodes[1].id],
            node_names=[s.nodes[0].name, s.nodes[1].name],
            counts=np.array([4, 4], dtype=np.int64), allocated_vec=vec)])
    _check(sides)
    for s in sides:
        s.store.update_allocs_from_client(
            [_client_update(s, "blk-gc.2", "complete")])
    _check(sides)
    for s in sides:
        assert s.store.gc_terminal_allocs(before_index=s.store._index + 1) == 1
        snap = s.store.snapshot()
        assert snap.alloc_by_id("blk-gc.2") is None
        assert len(snap.allocs_by_node(s.nodes[0].id)) == 3
        assert s.store._alloc_blocks.get_latest("blk-gc").dropped == {2}
    _check(sides)
    for s in sides:
        # the feed's held block still has the position: gc_dropped hides it
        assert 2 not in s.feed._epoch.blocks["blk-gc"].dropped
        assert s.feed._virtual_row(s.feed._epoch, "blk-gc.2") is None
    for s in sides:
        assert s.feed.force_verify()
        assert s.tracker.violations == []
    assert sides[1].base()[0, 0] == 150.0 and sides[1].base()[1, 0] == 200.0


def test_node_slot_registry_stability_and_reuse():
    def run(pkg):
        store = pkg.Store()
        nodes = [pkg.mock.node(id=f"slot-{i}") for i in range(4)]
        for n in nodes:
            store.upsert_node(n)
        reg = pkg.Slots()
        ids = [n.id for n in nodes]
        first = reg.assign(ids, store=store)
        assert sorted(first.values()) == [0, 1, 2, 3]
        # stable across re-assignment and reordering
        assert reg.assign(list(reversed(ids)), store=store) == first
        # a deleted node's slot goes to the next joiner, lowest first
        store.delete_node(ids[1])
        joiner = pkg.mock.node(id="slot-joiner")
        store.upsert_node(joiner)
        after = reg.assign([ids[0], ids[2], ids[3], joiner.id], store=store)
        assert after[joiner.id] == first[ids[1]]
        return first, after, reg.stats()

    want, got = run(REF), run(PORT)
    assert got == want and got[2]["high_water"] == 4


def test_node_delete_makes_the_next_build_resync():
    sides = _pair(5)
    for s in sides:
        assert s.base() is not None
        s.store.upsert_allocs([s.alloc("nd0", 0, 100, 64),
                               s.alloc("nd1", 3, 200, 64)])
        resyncs = s.feed.stats()["resyncs"]
        s.store.delete_node(s.nodes[3].id)
        assert s.store.snapshot().node_by_id(s.nodes[3].id) is None
        # the old layout is stale: serving it would fold onto dead rows
        assert s.feed.take_build_delta_count() >= 0
        assert s.feed._epoch.stale
        s.restatic([n for i, n in enumerate(s.nodes) if i != 3])
        base = s.base()
        assert s.feed.stats()["resyncs"] == resyncs + 1
        assert np.array_equal(base, _truth(s.store, s.static))
        assert s.feed.force_verify()
    _check(sides)


def test_randomized_stream_with_gc_and_node_delete_is_bit_exact():
    """The randomized stream of tests/test_incremental_state.py:84-118
    with its GC op, and node deletes, through both feeds: placements,
    client-terminal updates, stops, GC passes, and the delete of a node
    whose allocs are all terminal (the next build resyncs onto the new
    layout)."""
    sides = _pair(8)
    rng = np.random.default_rng(13)
    live, serial, deletes, gcs = {}, 0, 0, 0
    for _ in range(90):
        op = int(rng.integers(0, 6))
        alive = list(range(len(sides[0].nodes)))
        if op in (0, 1) or not live:                # place a new alloc
            serial += 1
            aid, node_i = f"ig{serial}", int(rng.choice(alive))
            cpu, mem = (int(rng.integers(1, 9)) * 100,
                        int(rng.integers(1, 9)) * 64)
            for s in sides:
                s.store.upsert_allocs([s.alloc(aid, node_i, cpu, mem)])
            live[aid] = sides[0].nodes[node_i].id
        elif op == 2:                               # client-terminal
            aid = sorted(live)[int(rng.integers(0, len(live)))]
            live.pop(aid)
            status = ("complete", "failed")[int(rng.integers(0, 2))]
            for s in sides:
                s.store.update_allocs_from_client(
                    [_client_update(s, aid, status)])
        elif op == 3:                               # a stop
            aid = sorted(live)[int(rng.integers(0, len(live)))]
            live.pop(aid)
            for s in sides:
                s.store.upsert_plan_results([], stopped_allocs=[
                    s.with_status(aid, enums.ALLOC_DESIRED_STOP)])
        elif op == 4:                               # a GC pass
            gcs += 1
            got = [s.store.gc_terminal_allocs(
                before_index=s.store._index + 1) for s in sides]
            assert got[0] == got[1]
        else:                                       # a node delete
            held = set(live.values())
            idle = [i for i in alive if sides[0].nodes[i].id not in held]
            if len(alive) <= 3 or not idle:
                continue
            gone = int(rng.choice(idle))
            deletes += 1
            for s in sides:
                s.store.delete_node(s.nodes[gone].id)
                s.restatic([n for i, n in enumerate(s.nodes) if i != gone])
        _check(sides)
    assert deletes and gcs
    for s in sides:
        assert s.feed.force_verify()
        assert s.tracker.violations == []
    assert (sides[0].feed.stats()["resyncs"]
            == sides[1].feed.stats()["resyncs"])
