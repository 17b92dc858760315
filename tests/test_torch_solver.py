"""The port's BulkSolverService (nomad_tpu_torch/tensor/solver.py) on the
CPU: the reference's service cases (tests/test_c2m_sharded.py at mesh=1)
plus the ledger's correction and TTL paths, and the joint tier's
worker-batch rendezvous (BatchContext / batch_member)."""

import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.structs.resources import RESOURCE_DIMS
from nomad_tpu_torch.tensor.cluster import ClusterStatic
from nomad_tpu_torch.tensor.sharding import NodeMesh
from nomad_tpu_torch.tensor.solver import (BulkSolverService, batch_member,
                                           current_batch, open_batch)


def _cluster(n, cpu, prefix):
    nodes = []
    for i in range(n):
        nd = mock.node()
        nd.name = f"{prefix}{i}"
        nd.resources.cpu = cpu
        nd.resources.memory_mb = 8192
        nd._avail_vec = None
        nd.compute_class()
        nodes.append(nd)
    static = ClusterStatic(nodes)
    feas = np.ones(static.n_pad, dtype=bool)
    feas[n:] = False
    aff = np.zeros(static.n_pad, dtype=np.float32)
    return nodes, static, feas, aff


def _ask(cpu, mem):
    ask = np.zeros(RESOURCE_DIMS, dtype=np.float32)
    ask[0], ask[1] = cpu, mem
    return ask


def _race(svc, static, feas, aff, ask, k, solves, sleep_s, seed_base):
    """4 committer threads x `solves` solves each, a slow apply between
    fetch and the (deferred) confirm."""
    zeros = np.zeros((static.n_pad, RESOURCE_DIMS), dtype=np.float32)
    placed_lock = threading.Lock()
    placed = np.zeros(static.n_pad, dtype=np.int64)
    tokens, errors = [], []

    def committer(t):
        try:
            for i in range(solves):
                counts, token = svc.solve(
                    static=static, feas_base=feas, aff=aff, ask=ask, k=k,
                    tg_count=1.0, seed=t * seed_base + i,
                    used_fn=lambda: zeros)
                time.sleep(sleep_s)
                with placed_lock:
                    placed[:] += counts
                    tokens.append(token)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=committer, args=(t,))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors
    return placed, tokens


@pytest.mark.parametrize("shards", [0, 2, 4],
                         ids=["no_mesh", "mesh2", "mesh4"])
def test_double_buffer_exact_fill_under_slow_apply(shards):
    """An exactly-filling workload (80 asks, 80 slots) with commits
    deferred to the end and RESYNC_SOLVES=3: a solve against a stale
    carry, or a resync that dropped the unfetched launch, overplaces.
    On a 2- or 4-shard mesh every launch is the sharded fill."""
    _, static, feas, aff = _cluster(8, 1000, "db-n")
    mesh = NodeMesh(["cpu"] * shards) if shards else None
    svc = BulkSolverService(device="cpu", mesh=mesh)
    svc.RESYNC_SOLVES = 3
    placed, tokens = _race(svc, static, feas, aff, _ask(100.0, 64.0), 4, 5,
                           0.02, 100)
    assert int(placed.sum()) == 80, placed
    assert int(placed.max()) == 10, placed
    for token in tokens:
        svc.confirm(token, [])
    svc.stop()
    with svc._lock:
        assert not svc._ledger, dict(svc._ledger)
    assert svc.stats["resyncs"] >= 2, svc.stats
    assert svc.stats["pipelined"] >= 1, svc.stats
    assert svc.stats["overlap_s"] > 0.0, svc.stats
    assert svc.stats["busy_s"] >= svc.stats["overlap_s"]
    assert svc.stats["sharded"] == (svc.stats["launches"] if shards else 0)


def test_inflight_drained_before_resync():
    """RESYNC_SOLVES=1: every dispatch rebuilds the carry from used_fn +
    ledger; skipping the drain of the unfetched launch would overplace."""
    _, static, feas, aff = _cluster(8, 500, "rs-n")
    svc = BulkSolverService(device="cpu")
    svc.RESYNC_SOLVES = 1
    placed, tokens = _race(svc, static, feas, aff, _ask(100.0, 32.0), 2, 5,
                           0.01, 10)
    assert int(placed.sum()) == 40, placed
    assert int(placed.max()) == 5, placed
    assert svc.stats["resyncs"] >= 5, svc.stats
    for token in tokens:
        svc.confirm(token, [])
    svc.stop()
    with svc._lock:
        assert not svc._ledger, dict(svc._ledger)


def test_confirm_with_rejected_nodes_queues_negative_corrections():
    """A rejected node's placements leave the carry through a negative
    correction folded into the next launch, so the next solve can use
    the freed slots again."""
    nodes, static, feas, aff = _cluster(4, 1000, "cr-n")
    svc = BulkSolverService(device="cpu")
    zeros = np.zeros((static.n_pad, RESOURCE_DIMS), dtype=np.float32)
    ask = _ask(100.0, 64.0)
    try:
        counts, token = svc.solve(static=static, feas_base=feas, aff=aff,
                                  ask=ask, k=40, tg_count=1.0, seed=1,
                                  used_fn=lambda: zeros)
        assert int(counts.sum()) == 40          # the cluster is now full
        rejected = [nodes[i].id for i in np.nonzero(counts)[0][:2]]
        freed = int(sum(counts[static.node_index[n]] for n in rejected))
        svc.confirm(token, rejected)
        assert svc.stats["corrections"] == 2
        with svc._lock:
            assert len(svc._corrections) == 2
            assert all(d[0] < 0 for _, d in svc._corrections)
            assert not svc._ledger
        again, token2 = svc.solve(static=static, feas_base=feas, aff=aff,
                                  ask=ask, k=40, tg_count=1.0, seed=2,
                                  used_fn=lambda: zeros)
        with svc._lock:
            assert not svc._corrections         # consumed by the launch
        assert int(again.sum()) == freed
        for n in rejected:
            i = static.node_index[n]
            assert again[i] == counts[i]
        assert svc.stats["resyncs"] == 1        # corrections, not resync
        svc.confirm(token2, [])
    finally:
        svc.stop()


def test_ttl_expires_dead_ledger_entry():
    """An unconfirmed solve older than LEDGER_TTL is presumed dead: it
    leaves the ledger and is no longer re-applied at resync."""
    _, static, feas, aff = _cluster(4, 1000, "ttl-n")
    svc = BulkSolverService(device="cpu")
    svc.LEDGER_TTL = 0.05
    zeros = np.zeros((static.n_pad, RESOURCE_DIMS), dtype=np.float32)
    ask = _ask(100.0, 64.0)
    try:
        counts, dead = svc.solve(static=static, feas_base=feas, aff=aff,
                                 ask=ask, k=40, tg_count=1.0, seed=3,
                                 used_fn=lambda: zeros)
        assert int(counts.sum()) == 40
        with svc._lock:
            assert dead in svc._ledger
        time.sleep(0.1)
        svc.RESYNC_SOLVES = 0                   # force a rebuild
        again, token = svc.solve(static=static, feas_base=feas, aff=aff,
                                 ask=ask, k=40, tg_count=1.0, seed=4,
                                 used_fn=lambda: zeros)
        with svc._lock:
            assert dead not in svc._ledger
        # the dead solve's usage was dropped: the whole cluster is free
        assert int(again.sum()) == 40
        svc.confirm(token, [])
    finally:
        svc.stop()


def test_service_device_is_explicit():
    svc = BulkSolverService(device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc.MAX_K == 32767 and svc.G_PAD == 16
    assert svc.RESYNC_SOLVES == 64 and svc.CORRECTIONS == 64
    assert svc.LEDGER_TTL == 60.0 and svc.JOINT_WAIT_S == 0.25


def _members(svc, static, feas, aff, ctx, n_submit, n_idle=0, wedge=None):
    """n_submit member threads that each submit one joint solve inside
    batch_member(ctx), n_idle that return without one, and, with a
    ``wedge`` event, one more that holds its membership until it is
    set. Returns (threads, results, errors)."""
    zeros = np.zeros((static.n_pad, RESOURCE_DIMS), dtype=np.float32)
    results, errors = [], []
    start = threading.Barrier(n_submit + n_idle + (wedge is not None))

    def submit(i):
        try:
            with batch_member(ctx):
                start.wait()
                counts, token = svc.solve(
                    static=static, feas_base=feas, aff=aff,
                    ask=_ask(100.0, 64.0), k=3, tg_count=1.0, seed=i,
                    used_fn=lambda: zeros, joint=True)
                results.append((counts, token))
        except Exception as e:  # pragma: no cover - surfaced by callers
            errors.append(e)

    def idle():
        with batch_member(ctx):
            assert current_batch() is ctx
            start.wait()
        assert current_batch() is None

    def wedged():
        with batch_member(ctx):
            start.wait()
            wedge.wait(10)

    threads = ([threading.Thread(target=submit, args=(i,))
                for i in range(n_submit)]
               + [threading.Thread(target=idle) for _ in range(n_idle)]
               + ([threading.Thread(target=wedged)] if wedge else []))
    for th in threads:
        th.start()
    return threads, results, errors


def _join(threads):
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()


def test_batch_members_land_in_one_joint_launch():
    """Four members of one worker batch on four threads: the service
    holds the launch until every member submitted, so all four solve in
    ONE joint launch (the reference's rendezvous, solver.py:449-502)."""
    _, static, feas, aff = _cluster(16, 4000, "jb-n")
    svc = BulkSolverService(device="cpu")
    svc.JOINT_WAIT_S = 10.0     # only the rendezvous may end the hold
    try:
        ctx = open_batch(4)
        threads, results, errors = _members(svc, static, feas, aff, ctx, 4)
        _join(threads)
        assert not errors, errors
        assert ctx.pending() == 0
        assert svc.stats["joint_launches"] == 1 == svc.stats["launches"]
        assert svc.stats["joint_solves"] == 4
        assert sum(int(c.sum()) for c, _ in results) == 12
        assert svc.stats["joint_score"] >= svc.stats["greedy_score"] > 0
    finally:
        svc.stop()


def test_member_without_a_solve_is_settled_on_exit():
    """A member whose run returns without a joint solve settles on exit,
    so the launch fires as soon as the others have submitted."""
    _, static, feas, aff = _cluster(16, 4000, "js-n")
    svc = BulkSolverService(device="cpu")
    svc.JOINT_WAIT_S = 10.0
    try:
        ctx = open_batch(3)
        t0 = time.monotonic()
        threads, results, errors = _members(svc, static, feas, aff, ctx, 2,
                                            n_idle=1)
        _join(threads)
        assert time.monotonic() - t0 < 5.0
        assert not errors, errors
        assert ctx.pending() == 0
        assert svc.stats["joint_launches"] == 1
        assert svc.stats["joint_solves"] == 2
    finally:
        svc.stop()


def test_wedged_member_costs_at_most_the_joint_wait():
    """A member that never submits nor returns holds the launch for at
    most JOINT_WAIT_S; the others' solve then fires without it."""
    _, static, feas, aff = _cluster(16, 4000, "jw-n")
    svc = BulkSolverService(device="cpu")
    svc.JOINT_WAIT_S = 0.2
    wedge = threading.Event()
    try:
        ctx = open_batch(2)
        t0 = time.monotonic()
        threads, results, errors = _members(svc, static, feas, aff, ctx, 1,
                                            wedge=wedge)
        threads[0].join(timeout=30)
        waited = time.monotonic() - t0
        assert not threads[0].is_alive() and not errors, errors
        assert 0.15 <= waited < 5.0
        assert ctx.pending() == 1
        assert svc.stats["joint_launches"] == 1
        assert svc.stats["joint_solves"] == 1
    finally:
        wedge.set()
        _join(threads)
        svc.stop()


def test_greedy_requests_never_share_a_joint_launch():
    """A "tpu-binpack" request and a joint one queued together are two
    launches: the greedy tier never goes through the auction."""
    _, static, feas, aff = _cluster(16, 4000, "jg-n")
    svc = BulkSolverService(device="cpu")
    zeros = np.zeros((static.n_pad, RESOURCE_DIMS), dtype=np.float32)
    out = []
    try:
        barrier = threading.Barrier(2)

        def run(joint):
            barrier.wait()
            out.append(svc.solve(static=static, feas_base=feas, aff=aff,
                                 ask=_ask(100.0, 64.0), k=3, tg_count=1.0,
                                 seed=7, used_fn=lambda: zeros, joint=joint))

        threads = [threading.Thread(target=run, args=(j,))
                   for j in (False, True)]
        for th in threads:
            th.start()
        _join(threads)
        assert len(out) == 2
        assert svc.stats["launches"] == 2
        assert svc.stats["joint_launches"] == 1 == svc.stats["joint_solves"]
    finally:
        svc.stop()
