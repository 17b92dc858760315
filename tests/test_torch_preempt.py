"""Preemption in the port against the JAX package, on the CPU.

- B7 ``preempt_solve`` and B12 ``preempt_pick``: the port's plain torch
  versions against JAX's kernels, and the port's numpy mirrors against
  the reference's, on the reference's random victim problems (seeds 0-7)
  and on edge fixtures. Picks, victim masks and flags are exact; scores
  on live rows are held to rtol 1e-6 (f32 ``10**x`` and ``exp`` may round
  one ulp apart between torch and XLA). The mirrors are float64 numpy on
  both sides and are held bit for bit.
- The host side: victim candidates and victim columns, the exact
  scanner, and a block-resident alloc's eviction in the store.
- The path: the reference's preemption scenario and BASELINE config 4
  at full width through both packages' Harness, on the mirror route and
  on the plain-version route of the kernel.

Every JAX call of the B7 fixtures runs at one of two shapes, so the
suite compiles few programs."""

import itertools

import jax
import numpy as np
import pytest
import torch

import bench
from nomad_tpu import mock
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.scheduler import system_sched as ref_system
from nomad_tpu.scheduler.context import EvalContext as RefEvalContext
from nomad_tpu.scheduler.preemption import \
    preempt_for_task_group as ref_preempt_for_task_group
from nomad_tpu.scheduler.preemption import \
    victim_candidates as ref_victim_candidates
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs.job import MigrateStrategy as RefMigrateStrategy
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.resources import Resources as RefResources
from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu.tensor import placer as ref_placer
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.tensor.cluster import ClusterTensors as RefClusterTensors
from nomad_tpu.tensor.cluster import \
    build_victim_tensors as ref_build_victim_tensors
from nomad_tpu.testing import Harness
from nomad_tpu_torch import _ext
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.scheduler import system_sched as port_system
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.preemption import (
    MAX_PARALLEL_PENALTY, PRIORITY_DELTA, is_preemptible,
    preempt_for_task_group, victim_candidates)
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.state.mvcc import VersionedTable
from nomad_tpu_torch.structs import AllocBlock, enums
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.job import MigrateStrategy
from nomad_tpu_torch.structs.resources import Resources
from nomad_tpu_torch.tensor import kernels as port_kernels
from nomad_tpu_torch.tensor import placer as port_placer
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.tensor.cluster import (ClusterTensors,
                                            build_victim_tensors)
from nomad_tpu_torch.testing import Harness as PortHarness

SCORE_RTOL = 1e-6
SEEDS = range(8)


# --------------------------------------------------------------------------
# kernel fixtures
# --------------------------------------------------------------------------

def _net_prio(v_prio):
    max_p = v_prio.max(axis=1)
    return np.where(max_p > 0,
                    max_p + v_prio.sum(axis=1) / np.maximum(max_p, 1.0),
                    0.0).astype(np.float32)


def random_victim_problem(seed, n=24, k=12, v=8, d=3):
    """The reference's ``_random_victim_problem``
    (tests/test_preempt_solve.py:26-57): integral f32 inputs, victim
    columns sorted priority-ascending, usage at 70-105% so most rows
    evict."""
    rng = np.random.default_rng(seed)
    available = rng.integers(2000, 16000, (n, d)).astype(np.float32)
    used = np.floor(available * rng.uniform(0.7, 1.05, (n, d))).astype(
        np.float32)
    ask = rng.integers(200, 1500, d).astype(np.float32)
    feasible = rng.random(n) > 0.2
    active = rng.random(k) > 0.1
    v_prio = np.zeros((n, v), np.float32)
    v_vec = np.zeros((n, v, d), np.float32)
    v_elig = np.zeros((n, v), bool)
    v_flag = np.zeros((n, v), bool)
    for i in range(n):
        cnt = int(rng.integers(0, v + 1))
        prios = np.sort(rng.integers(1, 60, cnt))
        for j in range(cnt):
            v_prio[i, j] = prios[j]
            v_vec[i, j] = rng.integers(50, 900, d)
            v_elig[i, j] = True
            v_flag[i, j] = rng.random() < 0.15
    return (available, used, ask, feasible, _net_prio(v_prio), active,
            v_prio, v_vec, v_elig, v_flag)


EDGE_N, EDGE_K, EDGE_V, EDGE_D = 8, 4, 512, 3


def edge_problem(name):
    """One shape for every edge fixture: 8 nodes of (4,000, 8,000,
    100,000) with 512 victim columns, 4 requests of (1,000, 500, 10)."""
    n, k, v, d = EDGE_N, EDGE_K, EDGE_V, EDGE_D
    available = np.tile(np.array([4000, 8000, 100000], np.float32), (n, 1))
    used = np.tile(np.array([3900, 7000, 300], np.float32), (n, 1))
    ask = np.array([1000, 500, 10], np.float32)
    feasible = np.ones(n, bool)
    active = np.ones(k, bool)
    v_prio = np.zeros((n, v), np.float32)
    v_vec = np.zeros((n, v, d), np.float32)
    v_elig = np.zeros((n, v), bool)
    v_flag = np.zeros((n, v), bool)
    for i in range(n):  # two 20-priority victims of 600 cpu per node
        v_prio[i, :2] = 20
        v_vec[i, :2] = (600, 1000, 100)
        v_elig[i, :2] = True
    if name == "inactive":
        active[:] = False
    elif name == "infeasible":
        feasible[:] = False
    elif name == "wide":
        # node 5 alone can take the requests, by evicting many of its
        # 512 small victims
        feasible[:] = False
        feasible[5] = True
        v_prio[5] = np.repeat(np.arange(1, 65), 8)
        v_vec[5] = (10, 10, 1)
        v_elig[5] = True
        used[5] = (3990, 7000, 300)
    elif name == "flagged":
        v_flag[:, 0] = True
    elif name == "fits":
        # node 3 fits one request exactly (fit score 1.0, above every
        # evicting node's mean with the preemption score)
        used[3] = (3000, 7500, 300)
    elif name != "ties":
        raise ValueError(name)
    return (available, used, ask, feasible, _net_prio(v_prio), active,
            v_prio, v_vec, v_elig, v_flag)


EDGES = ("ties", "inactive", "infeasible", "wide", "flagged", "fits")


def _jax_solve(args):
    out = jax.device_get(ref_kernels.preempt_solve(*jax.device_put(args)))
    return [np.asarray(x) for x in out]


def _port_solve(args):
    out = port_kernels.preempt_solve(*(torch.from_numpy(np.asarray(a))
                                       for a in args))
    return [x.numpy() for x in out]


def _evictable(args):
    v_vec, v_elig = args[7], args[8]
    return (v_vec * v_elig[:, :, None]).sum(axis=1).astype(np.float32)


def _pick_args(args):
    """preempt_solve's arguments -> preempt_pick's."""
    available, used, ask, feasible, net_prio, active = args[:6]
    return (available, used, _evictable(args), ask, feasible, net_prio,
            active)


def _assert_solve_equal(got, want, what):
    for name, x, y in zip(("picks", "victims", "flagged"), got, want):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")
    live = want[0] >= 0
    np.testing.assert_allclose(got[3][live], want[3][live], rtol=SCORE_RTOL,
                               err_msg=f"{what}: scores")
    assert (got[3][~live] == np.float32(port_kernels.NEG)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_preempt_solve_plain_equals_jax(seed):
    args = random_victim_problem(seed)
    _assert_solve_equal(_port_solve(args), _jax_solve(args), f"seed {seed}")


@pytest.mark.parametrize("seed", SEEDS)
def test_preempt_solve_mirror_equals_reference_mirror(seed):
    args = random_victim_problem(seed)
    got = port_placer._preempt_solve_host(*args)
    want = ref_placer._preempt_solve_host(*args)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_preempt_solve_plain_equals_mirror(seed):
    args = random_victim_problem(seed)
    got = _port_solve(args)
    want = port_placer._preempt_solve_host(*args)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("edge", EDGES)
def test_preempt_solve_edge_fixture(edge):
    args = edge_problem(edge)
    got = _port_solve(args)
    _assert_solve_equal(got, _jax_solve(args), edge)
    mirror = port_placer._preempt_solve_host(*args)
    for x, y in zip(mirror, ref_placer._preempt_solve_host(*args)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(got[:3], mirror[:3]):
        np.testing.assert_array_equal(x, y)
    picks, victims, flagged, _ = got
    if edge == "ties":
        # identical nodes: the first maximum, then the next node once the
        # first has no victims left to cover another request
        assert picks.tolist() == [0, 1, 2, 3]
    elif edge in ("inactive", "infeasible"):
        assert (picks == -1).all() and not victims.any()
    elif edge == "wide":
        assert (picks == 5).all() and victims.sum() > 100
    elif edge == "flagged":
        assert flagged.all()
    elif edge == "fits":
        assert picks[0] == 3 and not victims[0].any()


@pytest.mark.parametrize("edge", EDGES)
def test_preempt_pick_edge_fixture(edge):
    args = _pick_args(edge_problem(edge))
    got = port_kernels.preempt_pick(*(torch.from_numpy(a)
                                      for a in args)).numpy()
    want = np.asarray(ref_kernels.preempt_pick(*args))
    np.testing.assert_array_equal(got, want)
    f64 = [np.asarray(a, np.float64) if a.dtype == np.float32 else a
           for a in args]
    np.testing.assert_array_equal(
        port_placer._preempt_pick_host(*[a.copy() for a in f64]),
        ref_placer._preempt_pick_host(*[a.copy() for a in f64]))
    if edge in ("inactive", "infeasible"):
        assert (got == -1).all()


def test_preempt_pick_equals_jax_and_mirror():
    """The reference's pick parity fixture (tests/test_preemption.py:
    135-156)."""
    rng = np.random.default_rng(5)
    n, d, k = 32, 4, 16
    avail = (rng.integers(2, 9, size=(n, d)) * 500).astype(np.float64)
    used = avail * rng.uniform(0.6, 1.0, size=(n, d))
    evictable = used * rng.uniform(0.0, 0.9, size=(n, d))
    ask = np.array([400, 300, 0, 0], dtype=np.float64)
    feasible = rng.random(n) > 0.2
    net_prio = rng.uniform(0, 100, size=n)
    active = np.ones(k, dtype=bool)

    host = port_placer._preempt_pick_host(avail, used.copy(), evictable,
                                          ask, feasible, net_prio, active)
    ref_host = ref_placer._preempt_pick_host(avail, used.copy(), evictable,
                                             ask, feasible, net_prio, active)
    np.testing.assert_array_equal(host, ref_host)
    f32 = np.float32
    args32 = (avail.astype(f32), used.astype(f32), evictable.astype(f32),
              ask.astype(f32), feasible, net_prio.astype(f32), active)
    want = np.asarray(ref_kernels.preempt_pick(*args32))
    got = port_kernels.preempt_pick(*(torch.from_numpy(a)
                                      for a in args32)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_victim_selection_invariants(seed):
    """The reference's invariants (tests/test_preempt_solve.py:84-117)
    on the plain version: no victim claimed twice, only eligible
    victims, and each placement's victims cover its deficit in every
    dim, replayed request by request."""
    (available, used, ask, feasible, net_prio, active,
     v_prio, v_vec, v_elig, v_flag) = args = random_victim_problem(
        seed, n=16, k=16)
    picks, victims, flagged, _ = _port_solve(args)
    claimed = np.zeros(v_elig.shape, dtype=bool)
    run_used = used.astype(np.float64).copy()
    for i in range(len(picks)):
        b = picks[i]
        if b < 0:
            assert not victims[i].any() and not flagged[i]
            continue
        assert active[i] and feasible[b]
        sel = victims[i]
        assert not (sel & ~v_elig[b]).any()
        assert not (sel & claimed[b]).any()
        claimed[b] |= sel
        deficit = np.maximum(run_used[b] + ask - available[b], 0.0)
        evicted = (v_vec[b] * sel[:, None]).sum(axis=0)
        if deficit.max() > 0.0:
            assert (evicted >= deficit).all(), (i, deficit, evicted)
        run_used[b] = np.maximum(run_used[b] + ask - evicted, 0.0)
        assert (run_used[b] <= available[b]).all()


def test_victim_prefix_is_priority_ascending():
    args = random_victim_problem(11, n=8, k=10)
    v_elig = args[8]
    picks, victims, _, _ = _port_solve(args)
    claimed = np.zeros(v_elig.shape, dtype=bool)
    for i in range(len(picks)):
        b = picks[i]
        if b < 0:
            continue
        idx = np.flatnonzero(v_elig[b] & ~claimed[b])
        sel_in_row = victims[i][idx]
        if sel_in_row.any():
            last = int(np.flatnonzero(sel_in_row).max())
            assert sel_in_row[: last + 1].all()
        claimed[b] |= victims[i]


def test_wrappers_take_the_plain_versions_on_the_cpu():
    args = [torch.from_numpy(np.asarray(a))
            for a in random_victim_problem(3)]
    _ext.COUNTS.reset()
    port_kernels.preempt_solve(*args)
    pick = _pick_args([a.numpy() for a in args])
    port_kernels.preempt_pick(*(torch.from_numpy(a) for a in pick))
    counts = _ext.COUNTS.snapshot()
    assert counts["launches"]["preempt_solve"] == 0
    assert counts["launches"]["preempt_pick"] == 0
    assert counts["plain_on_cuda"]["preempt_solve"] == 0
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        port_kernels.preempt_solve(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        port_kernels.preempt_pick(*(torch.from_numpy(a).to("meta")
                                    for a in pick))


# --------------------------------------------------------------------------
# the host side: candidates, victim columns, the exact scanner, the store
# --------------------------------------------------------------------------

def _both_nodes(cpu=4000, mem=8192, count=1):
    """The same nodes in both packages: (reference nodes, port nodes)."""
    ref, port = [], []
    for i in range(count):
        for m, out in ((mock, ref), (port_mock, port)):
            n = m.node(id=f"pn-{i}", name=f"pn-{i}")
            n.resources.cpu = cpu
            n.resources.memory_mb = mem
            n.compute_class()
            out.append(n)
    return ref, port


def _both_allocs(rows, ref_nodes, port_nodes):
    """rows: (node index, priority, cpu, mem, alloc id, job id) -> the
    same running allocs in both packages."""
    ref, port = [], []
    for ni, prio, cpu, mem, aid, jid in rows:
        for m, res, nodes, out in ((mock, RefResources, ref_nodes, ref),
                                   (port_mock, Resources, port_nodes, port)):
            j = m.batch_job(id=jid)
            j.priority = prio
            j.task_groups[0].tasks[0].resources = res(cpu=cpu, memory_mb=mem)
            a = m.alloc(j, nodes[ni], id=aid)
            a.allocated_vec = res(cpu=cpu, memory_mb=mem).vec()
            out.append(a)
    return ref, port


def test_victim_candidates_delta_edge_and_order():
    """Eligibility is current - victim priority >= 10; the column order
    is (priority asc, alloc id asc)."""
    ref_nodes, nodes = _both_nodes()
    ref_allocs, allocs = _both_allocs([(0, 40, 100, 64, "b-edge", "j1"),
                                       (0, 41, 100, 64, "c-over", "j2"),
                                       (0, 10, 100, 64, "b-low", "j3"),
                                       (0, 10, 100, 64, "a-low", "j4")],
                                      ref_nodes, nodes)
    assert [a.id for a in victim_candidates(allocs, 50)] == [
        a.id for a in ref_victim_candidates(ref_allocs, 50)] == [
        "a-low", "b-low", "b-edge"]
    assert PRIORITY_DELTA == 10 and MAX_PARALLEL_PENALTY == 50.0
    assert not is_preemptible(allocs[1], 50)
    assert is_preemptible(allocs[1], 51)


def test_build_victim_tensors_equals_reference():
    ref_nodes, port_nodes = _both_nodes(count=3)
    rows = [(0, 20, 300, 256, "v-a", "ja"), (0, 10, 500, 128, "v-b", "jb"),
            (1, 15, 200, 64, "v-c", "jc"), (1, 15, 250, 64, "v-d", "jd"),
            (1, 45, 250, 64, "v-e", "je")]
    ref_allocs, port_allocs = _both_allocs(rows, ref_nodes, port_nodes)
    ref_store, port_store = RefStateStore(), StateStore()
    for store, nodes, allocs in ((ref_store, ref_nodes, ref_allocs),
                                 (port_store, port_nodes, port_allocs)):
        for n in nodes:
            store.upsert_node(n)
        store.upsert_allocs(allocs)
    ref_ctx = RefEvalContext(ref_store.snapshot(), eval_id="e-bt")
    ctx = EvalContext(port_store.snapshot(), eval_id="e-bt")
    want = ref_build_victim_tensors(
        ref_ctx, RefClusterTensors.build(ref_ctx, ref_nodes), 50)
    got = build_victim_tensors(ctx, ClusterTensors.build(ctx, port_nodes),
                               50)
    assert got.v_pad == want.v_pad == 8
    for name in ("prio", "vec", "elig", "flagged", "evictable", "net_prio"):
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert ([[a.id for a in r] for r in got.refs]
            == [[a.id for a in r] for r in want.refs]
            == [["v-b", "v-a"], ["v-c", "v-d"], []])


def _scan_both(rows, ask, prio, counts=None, migrate=None):
    ref_nodes, port_nodes = _both_nodes()
    ref_allocs, port_allocs = _both_allocs(rows, ref_nodes, port_nodes)
    if migrate is not None:
        for allocs, strategy in ((ref_allocs, RefMigrateStrategy),
                                 (port_allocs, MigrateStrategy)):
            allocs[migrate].job.task_groups[0].migrate = strategy(
                max_parallel=1)
    want = ref_preempt_for_task_group(
        ref_nodes[0], ref_allocs, RefResources(cpu=ask[0],
                                               memory_mb=ask[1]).vec(),
        prio, preempted_counts=counts)
    got = preempt_for_task_group(
        port_nodes[0], port_allocs, Resources(cpu=ask[0],
                                              memory_mb=ask[1]).vec(),
        prio, preempted_counts=counts)
    ids = (lambda v: None if v is None else [a.id for a in v])
    assert ids(got) == ids(want)
    return ids(got)


def test_preempt_for_task_group_skips_close_priority():
    """tests/test_preemption.py TestPriorityDelta."""
    assert _scan_both([(0, 45, 2000, 4000, "close", "jc"),
                       (0, 10, 2000, 4000, "low", "jl")],
                      (1000, 1000), 50) == ["low"]


def test_preempt_for_task_group_max_parallel_penalty():
    """tests/test_preemption.py TestMaxParallelPenalty: without earlier
    evictions the closer match wins; with its group at max_parallel the
    penalty flips the pick."""
    rows = [(0, 10, 2000, 4000, "a1", "j1"), (0, 10, 1900, 4192, "a2", "j2")]
    assert _scan_both(rows, (1900, 4000), 80, migrate=1)[0] == "a2"
    counts = {("default", "j2", "web"): 1}
    assert _scan_both(rows, (1900, 4000), 80, counts=counts,
                      migrate=1)[0] == "a1"


def test_preempt_for_task_group_three_lowest_of_four():
    """tests/test_preempt_solve.py test_mirror_agrees_with_exact_scanner:
    a deficit of 2,500 cpu over four 1,000-cpu victims of distinct
    priorities takes the three lowest."""
    rows = [(0, p, 1000, 512, f"p{p}", f"jp{p}") for p in (10, 20, 30, 40)]
    assert sorted(_scan_both(rows, (2500, 256), 50)) == ["p10", "p20", "p30"]


def test_store_evicting_a_block_alloc_promotes_it():
    """A block position written as evicted shadows its virtual row in
    every read; the node's usage drops once; an earlier snapshot still
    reads the block row."""
    store = StateStore()
    node = port_mock.node(id="blk-node")
    store.upsert_node(node)
    job = port_mock.service_job(3, cpu=1000, mem=1000, priority=20)
    job.id = "blk-job"
    store.upsert_job(job)
    store.upsert_plan_results(alloc_blocks=[AllocBlock(
        id="blk", job_id=job.id, job=job, task_group="web",
        name_indices=np.arange(3), node_ids=[node.id],
        node_names=[node.name], counts=np.array([3]),
        allocated_vec=job.task_groups[0].combined_resources().vec())])
    before = store.snapshot()
    allocs = before.allocs_by_job(job.id)
    assert len(list(before.alloc_blocks())) == 1 and len(allocs) == 3
    victim = allocs[1]
    usage0 = before.node_usage(node.id).copy()
    plan_victim = victim.copy_for_update()
    plan_victim.desired_status = enums.ALLOC_DESIRED_EVICT
    store.upsert_plan_results(preempted_allocs=[plan_victim])
    after = store.snapshot()
    np.testing.assert_array_equal(after.node_usage(node.id),
                                  usage0 - victim.allocated_vec)
    np.testing.assert_array_equal(
        store._usage_mat[store._usage_rows[node.id]],
        usage0 - victim.allocated_vec)
    for read in (after.allocs_by_job(job.id), after.allocs_by_node(node.id),
                 list(after.allocs())):
        assert sorted(a.id for a in read) == [a.id for a in allocs]
        by_id = {a.id: a for a in read}
        assert by_id[victim.id].desired_status == enums.ALLOC_DESIRED_EVICT
    assert after.alloc_by_id(victim.id).desired_status == "evict"
    assert after.alloc_by_id(allocs[0].id).desired_status == "run"
    assert [a.id for a in after.allocs_by_node_terminal(node.id, False)] == [
        allocs[0].id, allocs[2].id]
    # the earlier snapshot is unchanged
    assert all(a.desired_status == "run"
               for a in before.allocs_by_job(job.id))
    assert before.alloc_by_id(victim.id).desired_status == "run"
    np.testing.assert_array_equal(before.node_usage(node.id), usage0)
    # a second write of the promoted row moves usage no further
    again = after.alloc_by_id(victim.id).copy_for_update()
    store.upsert_plan_results(preempted_allocs=[again])
    np.testing.assert_array_equal(store.snapshot().node_usage(node.id),
                                  usage0 - victim.allocated_vec)


def test_store_reads_an_unpromoted_block_without_lookups(monkeypatch):
    """Until one of its positions is written, a block's allocs are read
    without a lookup per position in the allocs table; afterwards the
    block counts its promoted positions once each."""
    store = StateStore()
    node = port_mock.node(id="blk-node")
    store.upsert_node(node)
    job = port_mock.service_job(4, cpu=1000, mem=1000, priority=20)
    job.id = "blk-job"
    store.upsert_job(job)
    store.upsert_plan_results(alloc_blocks=[AllocBlock(
        id="blk", job_id=job.id, job=job, task_group="web",
        name_indices=np.arange(4), node_ids=[node.id],
        node_names=[node.name], counts=np.array([4]),
        allocated_vec=job.task_groups[0].combined_resources().vec())])
    lookups = []
    get = VersionedTable.get

    def counted(table, key, gen):
        if table is store._allocs:
            lookups.append(key)
        return get(table, key, gen)

    monkeypatch.setattr(VersionedTable, "get", counted)

    def reads(snap):
        return (snap.allocs_by_job(job.id), snap.allocs_by_node(node.id),
                list(snap.allocs()))

    before = store.snapshot()
    assert [len(r) for r in reads(before)] == [4, 4, 4]
    assert lookups == []
    victim = before.allocs_by_job(job.id)[2].copy_for_update()
    victim.desired_status = enums.ALLOC_DESIRED_EVICT
    store.upsert_plan_results(preempted_allocs=[victim])
    again = store.snapshot().alloc_by_id(victim.id).copy_for_update()
    store.upsert_plan_results(preempted_allocs=[again])
    assert store._promoted.get_latest("blk") == 1
    for read in reads(store.snapshot()):
        assert [a.desired_status for a in read].count("evict") == 1
    assert len(lookups) > 0
    del lookups[:]
    assert all(a.desired_status == "run" for r in reads(before) for a in r)
    assert lookups == []


def test_preempt_solve_wrapper_needs_no_victim_priorities():
    """The solve never reads v_prio, so the wrapper takes None for it."""
    args = [torch.from_numpy(np.asarray(a))
            for a in random_victim_problem(5)]
    want = port_kernels.preempt_solve(*args)
    got = port_kernels.preempt_solve(*args[:6], None, *args[7:])
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_delete_job_keeps_its_allocs():
    store = StateStore()
    node = port_mock.node()
    store.upsert_node(node)
    j = port_mock.service_job(1)
    store.upsert_job(j)
    store.upsert_allocs([port_mock.alloc(j, node)])
    store.delete_job(j.id)
    snap = store.snapshot()
    assert snap.job_by_id(j.id) is None
    assert len(snap.allocs_by_job(j.id)) == 1
    assert len(snap.allocs_by_node(node.id)) == 1


# --------------------------------------------------------------------------
# the path through both packages
# --------------------------------------------------------------------------

@pytest.fixture
def pinned_ids(monkeypatch):
    """Each package's schedulers mint ids from one counter, so the same
    call sequence gives the same ids in both (the victim column order
    ties on alloc id)."""
    for modules in ((ref_generic, ref_system), (port_generic, port_system)):
        counter = itertools.count()

        def fake(c=counter):
            return f"{next(c):08x}-0000-0000-0000-000000000000"

        for mod in modules:
            monkeypatch.setattr(mod, "generate_uuid", fake)
        if modules[0] is ref_generic:
            monkeypatch.setattr(ref_generic, "generate_uuids",
                                lambda n, f=fake: [f() for _ in range(n)])


@pytest.fixture
def services(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref)
    port = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port)
    yield
    ref.stop()
    port.stop()


def _preempt_fingerprint(store, job_ids):
    """Live placements per job as (name, node) and every evicted alloc as
    (id, job, name, node, evictor's (job, name, node))."""
    snap = store.snapshot()
    by_id = {a.id: a for a in snap.allocs()}
    placed = {jid: sorted((a.name, a.node_id)
                          for a in snap.allocs_by_job(jid)
                          if not a.terminal_status()) for jid in job_ids}
    evicted = []
    for a in by_id.values():
        if a.desired_status != enums.ALLOC_DESIRED_EVICT:
            continue
        e = by_id[a.preempted_by_allocation]
        evicted.append((a.id, a.job_id, a.name, a.node_id,
                        (e.job_id, e.name, e.node_id)))
    return placed, sorted(evicted)


def _over_capacity(store):
    snap = store.snapshot()
    nodes = {n.id: n for n in snap.nodes()}
    usage = {nid: 0.0 for nid in nodes}
    for a in snap.allocs():
        if not a.terminal_status():
            usage[a.node_id] = usage[a.node_id] + a.allocated_vec
    return [nid for nid, u in usage.items()
            if (np.asarray(u) > nodes[nid].available_vec()).any()]


def _scenario(m, harness, config, n_nodes=16, hi_count=32):
    """The reference's ``_run_preempt_scenario``
    (tests/test_preempt_solve.py:290-330) with pinned ids: 16 full nodes
    (2 priority-20 fillers each), then a priority-80 batch job that fits
    only by evicting fillers."""
    h = harness
    for i in range(n_nodes):
        n = m.node(id=f"ps-node-{i:02d}", name=f"ps-node-{i:02d}")
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.compute_class()
        h.store.upsert_node(n)
    jobs = []
    for jid, count, cpu, mem, prio in (("ps-filler", 2 * n_nodes, 1900,
                                        3800, 20),
                                       ("ps-hi", hi_count, 1000, 2000, 80)):
        j = m.batch_job(id=jid)
        j.priority = prio
        tg = j.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        h.store.upsert_job(j)
        h.process(m.eval_for(j, id=f"{jid}-ev"), sched_config=config)
        jobs.append(j.id)
    return jobs


def _preempt_config(module):
    return module.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack",
        preemption_config=module.PreemptionConfig(
            batch_scheduler_enabled=True))


@pytest.mark.parametrize("route", ["mirror", "kernel", "host"])
def test_preempt_scenario_equals_reference(route, monkeypatch, pinned_ids,
                                           services):
    """The scenario's groups of 32 take the per-eval path (B9) in both
    packages and its unplaced rows one preemption solve: below the
    cutover the mirror, with ``PREEMPT_DEVICE_MIN = 0`` the kernel's plain
    version on CPU tensors (the reference's jitted kernel). Same
    placements, same victims, every row from the kernel's columns. With
    8 requests ("host") the host oracle places each one through the
    scanner's preemption arm. (The reference's own test sets
    ``BULK_MIN = 16``, which routes the groups of 32 through
    ``_place_bulk``: tests/test_torch_bulk_scan.py runs that shape.)"""
    hi_count = 8 if route == "host" else 32
    if route == "kernel":
        monkeypatch.setattr(ref_placer.TPUPlacer, "PREEMPT_DEVICE_MIN", 0)
        monkeypatch.setattr(port_placer.TorchPlacer, "PREEMPT_DEVICE_MIN", 0)
    ref_h = Harness()
    r0 = ref_placer.preempt_stats()
    ref_jobs = _scenario(mock, ref_h, _preempt_config(ref_operator),
                         hi_count=hi_count)
    r1 = ref_placer.preempt_stats()
    want = _preempt_fingerprint(ref_h.store, ref_jobs)

    h = PortHarness(device="cpu")
    _ext.COUNTS.reset()
    p0 = port_placer.preempt_stats()
    jobs = _scenario(port_mock, h, _preempt_config(port_operator),
                     hi_count=hi_count)
    p1 = port_placer.preempt_stats()
    got = _preempt_fingerprint(h.store, jobs)

    assert got == want
    assert len(got[0]["ps-hi"]) == hi_count and got[1]
    ref_delta = {k: r1[k] - r0[k] for k in r1}
    delta = {k: p1[k] - p0[k] for k in p1}
    assert delta == ref_delta
    assert delta["host_preempted"] == 0
    assert (delta["kernel_preempted"] == 0 if route == "host"
            else delta["kernel_preempted"] >= 1)
    assert _over_capacity(h.store) == []
    assert _ext.COUNTS.snapshot()["launches"]["preempt_solve"] == 0


def _cfg4(m, harness, service_job, config, stats):
    """BASELINE config 4 (bench.py:698-818 cfg4_system_preemption) up to
    the timed region: 1,024 nodes of (16,000 MHz, 32,768 MB); a warm job
    of 512 x 1 MHz, deleted; a priority-20 filler of 2,048 x (7,900 MHz,
    14,000 MB); then the priority-80 service of 512 x (2,500 MHz,
    2,048 MB) and the system job of (400 MHz, 128 MB)."""
    h = harness
    for i in range(1024):
        n = m.node(id=f"bench4-node-{i:04d}", name=f"bench4-node-{i:04d}")
        n.attributes["rack"] = f"r{i % 20}"
        n.resources.cpu = 16000
        n.resources.memory_mb = 32768
        n.compute_class()
        h.store.upsert_node(n)
    warm = service_job(512, cpu=1, mem=1, priority=20)
    warm.id = warm.name = "bench4-warm"
    h.store.upsert_job(warm)
    h.process(m.eval_for(warm, id="bench4-ev-warm"), sched_config=config)
    h.store.delete_job(warm.id)
    filler = service_job(2048, cpu=7900, mem=14000, priority=20)
    filler.id = filler.name = "bench4-filler"
    h.store.upsert_job(filler)
    h.process(m.eval_for(filler, id="bench4-ev-fill"), sched_config=config)
    hi = service_job(512, cpu=2500, mem=2048, priority=80)
    hi.id = hi.name = "bench4-hi"
    sysj = m.system_job(id="bench4-sys", name="bench4-sys")
    sysj.task_groups[0].tasks[0].resources.cpu = 400
    sysj.task_groups[0].tasks[0].resources.memory_mb = 128
    for j in (hi, sysj):
        h.store.upsert_job(j)
    s0 = stats()
    h.process(m.eval_for(hi, id="bench4-ev-hi"), sched_config=config)
    s1 = stats()
    after_hi = _preempt_fingerprint(h.store, (hi.id,))
    h.process(m.eval_for(sysj, id="bench4-ev-sys"), sched_config=config)
    return ({k: s1[k] - s0[k] for k in s1}, after_hi,
            _preempt_fingerprint(h.store, (hi.id, sysj.id)))


def _cfg4_config(module):
    return module.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack",
        preemption_config=module.PreemptionConfig(
            system_scheduler_enabled=True, service_scheduler_enabled=True))


def test_cfg4_fingerprint_equals_reference(pinned_ids, services):
    """BASELINE config 4 at full width: the hi eval's bulk solve places
    nothing, its 512 requests go to one preemption solve at (N_pad 1,024,
    K_pad 512, V_pad 512), which is at the cutover: the kernel route (the
    plain version on CPU tensors); the system job then preempts through
    the host scanner. Every placement and every victim equal the JAX
    package's, and the counts are the reference's: 512 placed evicting
    514 fillers and 171 warm allocs, stats 512 / 0 / 512; then 1,024
    system allocs and 1,025 + 172 evicted in all."""
    ref_stats, want_hi, want = _cfg4(mock, Harness(), bench.service_job,
                                     _cfg4_config(ref_operator),
                                     ref_placer.preempt_stats)
    h = PortHarness(device="cpu")
    _ext.COUNTS.reset()
    stats, got_hi, got = _cfg4(port_mock, h, port_mock.service_job,
                               _cfg4_config(port_operator),
                               port_placer.preempt_stats)

    assert got_hi == want_hi
    assert got == want
    assert stats == ref_stats == {"kernel_preempted": 512,
                                  "host_preempted": 0,
                                  "victim_parity_checked": 512}
    placed, evicted = got
    assert len(got_hi[0]["bench4-hi"]) == len(placed["bench4-hi"]) == 512
    assert len(placed["bench4-sys"]) == 1024

    def by_job(ev):
        return {j: sum(1 for e in ev if e[1] == j)
                for j in ("bench4-filler", "bench4-warm", "bench4-hi")}

    assert by_job(got_hi[1]) == {"bench4-filler": 514, "bench4-warm": 171,
                                 "bench4-hi": 0}
    assert by_job(evicted) == {"bench4-filler": 1025, "bench4-warm": 172,
                               "bench4-hi": 0}
    assert len({e[0] for e in evicted}) == len(evicted)
    assert all(e[4][0] in ("bench4-hi", "bench4-sys") for e in evicted)
    assert _over_capacity(h.store) == []
    assert all(e.status == "complete" for e in h.evals)
    counts = _ext.COUNTS.snapshot()
    assert counts["launches"]["preempt_solve"] == 0
    assert counts["plain_on_cuda"]["preempt_solve"] == 0


@pytest.mark.parametrize("preempt", [False, True])
def test_system_job_equals_reference(preempt, pinned_ids, services):
    """A fresh system job on 16 nodes, half of them full of priority-20
    fillers: without system preemption the full nodes are exhausted and
    recorded as failures on the eval; with it they evict. Then the same
    eval again places nothing (every alloc in place and current); it
    submits a plan only to record the failures again."""
    def run(m, harness, module):
        h = harness
        for i in range(16):
            n = m.node(id=f"sy-node-{i:02d}", name=f"sy-node-{i:02d}")
            h.store.upsert_node(n)
        nodes = list(h.store.snapshot().nodes())
        filler = m.batch_job(id="sy-filler")
        filler.priority = 20
        h.store.upsert_job(filler)
        h.store.upsert_allocs([m.alloc(filler, nodes[i], index=i,
                                       id=f"sy-fill-{i:02d}")
                               for i in range(0, 16, 2)])
        # the fillers take 3,800 of each even node's 4,000 MHz
        snap = h.store.snapshot()
        for a in snap.allocs_by_job(filler.id):
            a.allocated_vec = a.allocated_vec.copy()
            a.allocated_vec[0] = 3800
        h.store.upsert_allocs(list(snap.allocs_by_job(filler.id)))
        sysj = m.system_job(id="sy-sys")
        h.store.upsert_job(sysj)
        config = module.SchedulerConfiguration(
            preemption_config=module.PreemptionConfig(
                system_scheduler_enabled=preempt))
        h.process(m.eval_for(sysj, id="sy-ev"), sched_config=config)
        first = _preempt_fingerprint(h.store, (sysj.id,))
        h.process(m.eval_for(sysj, id="sy-ev-2"), sched_config=config)
        ev = h.evals[0]
        return (first, len(h.plans), ev.status,
                {k: (v.nodes_exhausted, v.coalesced_failures)
                 for k, v in ev.failed_tg_allocs.items()},
                dict(ev.queued_allocations), h.evals[-1].status)

    want = run(mock, Harness(), ref_operator)
    got = run(port_mock, PortHarness(device="cpu"), port_operator)
    assert got == want
    placed, evicted = got[0]
    assert len(placed["sy-sys"]) == (16 if preempt else 8)
    assert len(evicted) == (8 if preempt else 0)
    assert got[1] == (1 if preempt else 2)
    assert got[3] == ({} if preempt else {"web": (1, 7)})
