"""The replicated control plane on both packages: a three-server raft
cluster whose leader's Server schedules (the reference's
tests/test_raft.py TestReplicatedServer and TestReplicatedSchedulerConfig,
test_durability.py TestClusterDurability), on the CPU.

- the cluster places through the replicated log and every replica's
  store equals the leader's (``testing.replica_fingerprint``);
- with one worker, pinned ids and "tpu-binpack", the reference's cluster
  and the port's give the same placement fingerprint as one reference
  Server (test_torch_server.py's);
- scheduling and the scheduler config survive a leader crash; a leader
  crash in the middle of a wave leaves every job with exactly its count
  of live allocs;
- a crashed server restarts from its data directory (its snapshot and
  its log), its feed resyncs on the restore, and it catches up.

Waits poll with deadlines; none sleeps a fixed time.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

import bench
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.structs import enums
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu_torch import convert
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.tensor import incremental as port_incremental
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import replica_fingerprint

from test_torch_bulk_scan import over_capacity
from test_torch_pipeline import JOBS, fingerprint, node_record
from test_torch_raft import PKGS, PORT, REF, wait_for
from test_torch_server import _pin_ids
from test_torch_spread_pipeline import job_record


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture
def services(monkeypatch):
    """Private solver services for both packages (the tpu tiers)."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    port_svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port_svc)
    yield port_svc
    ref_svc.stop()
    port_svc.stop()


# bench-safe raft timers, as the reference's bench sets them for its
# in-process clusters: a suite under load starves a 0.3 s election
# timeout, and a spurious leadership move is not what these tests test
ELECTION_TIMEOUT = 1.0


def cluster(pkg, n=3, workers=1, alg=None, server_kw=None, **kw):
    def cfg(i):
        extra = dict(server_kw or {})
        if alg is not None:
            extra["sched_config"] = pkg.SchedulerConfiguration(
                scheduler_algorithm=alg)
        return pkg.cfg(num_workers=workers, **extra)
    if pkg is PORT:
        return pkg.RaftCluster(n, config_fn=cfg,
                               election_timeout=ELECTION_TIMEOUT, **kw)
    c = pkg.RaftCluster(n, config_fn=cfg, **kw)
    for s in c.servers.values():
        s.raft.election_timeout = ELECTION_TIMEOUT
    return c


def leader_of(c, exclude=None, timeout=15.0):
    found = []

    def one():
        for s in c.servers.values():
            if (s is not exclude and not getattr(s, "crashed", False)
                    and s.is_leader()):
                found[:] = [s]
                return True
        return False
    wait_for(one, timeout, "a leader")
    return found[0]


def live_servers(c):
    return [s for s in c.servers.values() if not getattr(s, "crashed", False)]


def wait_replicas_equal(c, timeout=15.0):
    """Every live replica's fingerprint equals the leader's."""
    def equal():
        fps = {replica_fingerprint(s.local_store) for s in live_servers(c)}
        return len(fps) == 1
    wait_for(equal, timeout, "replicas equal to the leader")
    return replica_fingerprint(live_servers(c)[0].local_store)


def wait_placed(c, want, timeout=30.0):
    """Poll until every live replica holds ``want`` ({job id: live
    allocs}) and the replicas agree: robust to a leadership move, where a
    wait on one server's queue would not be."""
    def done():
        fps = {replica_fingerprint(s.local_store) for s in live_servers(c)}
        return len(fps) == 1 and dict(next(iter(fps))[2]) == want
    wait_for(done, timeout, f"every replica to hold {want}")


def live_counts(store, job_ids):
    snap = store.snapshot()
    return {jid: sum(1 for a in snap.allocs_by_job(jid)
                     if not a.terminal_status()) for jid in job_ids}


class TestReplicatedServer:
    def test_schedules_through_replicated_log(self, pkg):
        with cluster(pkg) as c:
            leader = leader_of(c)
            entry = next(s for s in c.servers.values() if s is not leader)
            entry.register_node(pkg.mock.node())   # forwarded
            entry.register_node(pkg.mock.node())
            job = pkg.mock.job()
            entry.register_job(job)
            assert leader.server.wait_for_idle(15.0)
            wait_for(lambda: [len(s.local_store.snapshot().allocs_by_job(
                job.id)) for s in c.servers.values()] == [10, 10, 10])
            fp = wait_replicas_equal(c)
            assert dict(fp[2]) == {job.id: 10}

    def test_failover_keeps_scheduling_and_config(self, pkg):
        with cluster(pkg) as c:
            leader = leader_of(c)
            assert (leader.server.sched_config.scheduler_algorithm
                    == enums.SCHED_ALG_BINPACK)
            leader.set_scheduler_config(pkg.SchedulerConfiguration(
                scheduler_algorithm=enums.SCHED_ALG_SPREAD))
            for _ in range(2):
                leader.register_node(pkg.mock.node())
            job1 = pkg.mock.job()
            job1.task_groups[0].count = 2
            leader.register_job(job1)
            wait_placed(c, {job1.id: 2})
            leader = leader_of(c)
            c.crash(leader.id)
            new = leader_of(c, exclude=leader)
            # the replicated config governs the new leader, not its boot
            # config
            wait_for(lambda: new.server.sched_config.scheduler_algorithm
                     == enums.SCHED_ALG_SPREAD)
            job2 = pkg.mock.job()
            job2.task_groups[0].count = 2
            new.register_job(job2)
            wait_placed(c, {job1.id: 2, job2.id: 2})


def test_follower_read_index_and_raft_leadership(pkg):
    """A follower reads at the leader's read index once its own store
    applied through it (Raft section 6.4), and only the leader's Server
    may write."""
    with cluster(pkg) as c:
        leader = leader_of(c)
        node = pkg.mock.node()
        leader.register_node(node)
        follower = next(s for s in c.servers.values() if s is not leader)
        index = follower.read_index(timeout=5.0)
        follower.wait_applied(index, timeout=5.0)
        assert follower.local_store.snapshot().node_by_id(node.id) is not None
        assert leader.is_leader() and not follower.is_leader()


def run_cluster(pkg, nodes, jobs, alg):
    """The replicas' stores, and the leader and terms before and after
    the run (an election in the middle shows in the terms)."""
    with cluster(pkg, alg=alg, server_kw=dict(
            eval_batch_size=1, nack_timeout=900.0)) as c:
        leader = leader_of(c)
        before = (leader.id, {sid: s.raft.current_term
                              for sid, s in c.servers.items()})
        leader.register_nodes(nodes)
        for j in jobs:
            leader.register_job(j)
        wait_placed(c, {j.id: j.task_groups[0].count for j in jobs}, 60.0)
        after = (leader_of(c).id, {sid: s.raft.current_term
                                   for sid, s in c.servers.items()})
        return ([s.local_store for s in c.servers.values()],
                {"leader and terms before": before,
                 "leader and terms after": after})


def test_cluster_fingerprint_equals_reference(monkeypatch, services):
    """One worker, pinned ids, "tpu-binpack": the reference's cluster,
    the port's and one reference Server place the same."""
    alg = enums.SCHED_ALG_TPU_BINPACK
    _pin_ids(monkeypatch)
    src = REF.StateStore()
    bench.build_nodes(src, 256)
    ref_nodes = list(src.snapshot().nodes())

    def ref_jobs():
        out = []
        for i, (count, cpu, mem) in enumerate(JOBS):
            j = bench.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = j.name = f"raft-parity-{i}"
            out.append(j)
        return out

    jobs = ref_jobs()
    records = [job_record(j) for j in jobs]
    # one reference Server: the single-server fingerprint
    ref = ref_server.Server(ref_server.ServerConfig(
        num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0,
        sched_config=REF.SchedulerConfiguration(scheduler_algorithm=alg)))
    for n in ref_nodes:
        ref.store.upsert_node(n)
    with ref:
        for j in jobs:
            ref.register_job(j)
        assert ref.wait_for_idle(60.0)
    want = fingerprint(ref.store, jobs)
    assert sum(fp[0] for fp in want.values()) == sum(c for c, _, _ in JOBS)

    _pin_ids(monkeypatch)
    rjobs = ref_jobs()
    ref_stores, ref_terms = run_cluster(
        REF, [REF.wire.wire_decode(REF.wire.wire_encode(n))
              for n in ref_nodes], rjobs, alg)
    _pin_ids(monkeypatch)
    port_jobs = [convert.job_from_record(r) for r in records]
    port_nodes = convert.nodes_from_records([node_record(n)
                                             for n in ref_nodes])
    port_stores, port_terms = run_cluster(PORT, port_nodes, port_jobs, alg)
    for name, stores, js, terms in (
            ("reference", ref_stores, rjobs, ref_terms),
            ("port", port_stores, port_jobs, port_terms)):
        for replica, store in enumerate(stores):
            got = fingerprint(store, js)
            where = f"{name} cluster, replica {replica} ({terms})"
            assert set(got) == set(want), (where, sorted(got), sorted(want))
            for jid in want:
                assert got[jid][:2] == want[jid][:2], (
                    f"{where}: job {jid} placed {got[jid][0]} allocs, "
                    f"want {want[jid][0]}; per-node counts "
                    f"{_first_node_diff(got[jid][1], want[jid][1])}")
                assert np.allclose(got[jid][2], want[jid][2], rtol=0,
                                   atol=1e-12), (f"{where}: job {jid} "
                                                 "scores differ")
        assert over_capacity(stores[0]) == []


def _first_node_diff(got, want):
    """The first node ordinal whose count differs, as ``ordinal: got vs
    want``, and the count of differing ordinals."""
    g, w = dict(got), dict(want)
    diff = sorted(k for k in set(g) | set(w) if g.get(k) != w.get(k))
    if not diff:
        return "equal"
    k = diff[0]
    return (f"first at node {k}: {g.get(k, 0)} vs {w.get(k, 0)} "
            f"({len(diff)} nodes differ)")


def test_port_leader_crash_mid_wave_places_each_job_once(services,
                                                          tmp_path):
    """A leader crash while a wave of bulk jobs commits: the new leader
    (its Server started after this term's barrier applied) finishes the
    wave, every job has exactly its count of live allocs, every eval is
    complete, no node is over capacity and the replicas agree."""
    k, n_jobs = 300, 8
    with cluster(PORT, workers=2, alg=enums.SCHED_ALG_TPU_BINPACK,
                 data_dir=str(tmp_path), snapshot_threshold=16) as c:
        leader = leader_of(c)
        nodes = [PORT.mock.node() for _ in range(96)]
        leader.register_nodes(nodes)
        jobs = [PORT.mock.service_job(k, cpu=50, mem=32, batch=True)
                for _ in range(n_jobs)]
        for j in jobs:
            leader.register_job(j)
        ids = [j.id for j in jobs]
        wait_for(lambda: sum(1 for v in live_counts(
            leader.local_store, ids).values() if v) >= 2, 30.0)
        c.crash(leader.id)
        leader_of(c, exclude=leader, timeout=30.0)

        def finished():
            store = leader_of(c).local_store
            return (live_counts(store, ids) == {jid: k for jid in ids}
                    and {e.status for e in store.snapshot().evals()}
                    == {enums.EVAL_STATUS_COMPLETE})
        wait_for(finished, 90.0, "the wave")
        wait_replicas_equal(c)
        assert over_capacity(leader_of(c).local_store) == []


class TestRestartFromDataDir:
    def test_cluster_restart_resumes_scheduling(self, pkg, tmp_path):
        d = str(tmp_path)
        job = pkg.mock.job()
        node_ids = []
        with cluster(pkg, data_dir=d) as c:
            leader = leader_of(c)
            for _ in range(3):
                n = pkg.mock.node()
                node_ids.append(n.id)
                leader.register_node(n)
            leader.register_job(job)
            wait_placed(c, {job.id: 10})
        with cluster(pkg, data_dir=d) as c2:
            leader2 = leader_of(c2)
            wait_for(lambda: len(leader2.local_store.snapshot().allocs_by_job(
                job.id)) == 10, 15.0, "allocs to survive the restart")
            snap = leader2.local_store.snapshot()
            assert {n.id for n in snap.nodes()} == set(node_ids)
            job2 = pkg.mock.job()
            leader2.register_job(job2)
            assert leader2.server.wait_for_idle(15.0)
            wait_for(lambda: len(leader2.local_store.snapshot().allocs_by_job(
                job2.id)) == 10, 15.0)

    def test_crashed_server_restarts_from_snapshot_and_log(self, pkg,
                                                           tmp_path):
        with cluster(pkg, data_dir=str(tmp_path),
                     snapshot_threshold=10) as c:
            leader = leader_of(c)
            victim = next(s for s in c.servers.values() if s is not leader)
            for n in [pkg.mock.node() for _ in range(24)]:
                leader.register_node(n)
            wait_for(lambda: victim.raft.log.base_index > 0, 15.0,
                     "the victim's snapshot")
            c.crash(victim.id)
            job = pkg.mock.job()
            leader.register_job(job)
            assert leader.server.wait_for_idle(15.0)
            back = c.restart(victim.id)
            # it loaded its own snapshot before any catch-up
            assert back.raft.snapshots.load()["index"] > 0
            assert back.raft.last_applied >= back.raft.log.base_index > 0
            wait_for(lambda: back.raft.last_applied
                     >= leader.raft.last_applied, 15.0, "the catch-up")
            wait_replicas_equal(c)
            if pkg is PORT:
                # the restore reached the feed: its next read resyncs
                feed = port_incremental.feed_for(back.server.store)
                feed.sub.next_events()
                assert feed.sub.truncated
                before = feed.stats()["resyncs"]
                assert feed.force_verify()
                assert feed.stats()["resyncs"] == before + 1

    def test_wiped_follower_catches_up_via_chunked_install(self, pkg,
                                                           tmp_path):
        with cluster(pkg, data_dir=str(tmp_path),
                     snapshot_threshold=10) as c:
            leader = leader_of(c)
            for s in c.servers.values():
                s.raft.snapshot_chunk_bytes = 256
            nodes = [pkg.mock.node() for _ in range(30)]
            for n in nodes:
                leader.server.register_node(n)
            wait_for(lambda: leader.raft.log.base_index > 0, 10.0)
            base = leader.raft.log.base_index
            victim = next(s for s in c.servers.values() if s is not leader)
            c.crash(victim.id)
            shutil.rmtree(os.path.join(victim.data_dir, "raft"))
            victim = c.restart(victim.id)
            wait_for(lambda: len(list(victim.local_store.snapshot().nodes()))
                     == len(nodes), 15.0, "the chunked install")
            assert victim.raft.log.base_index >= base
            assert victim.raft.snapshots.load()["index"] >= base

    def test_lagging_follower_catches_up_via_install_snapshot(self, pkg,
                                                              tmp_path):
        with cluster(pkg, data_dir=str(tmp_path),
                     snapshot_threshold=10) as c:
            leader = leader_of(c)
            lagger = next(s for s in c.servers.values() if s is not leader)
            c.transport.partition(lagger.id)
            nodes = [pkg.mock.node() for _ in range(30)]
            for n in nodes:
                leader.server.register_node(n)
            wait_for(lambda: leader.raft.log.base_index > 0, 10.0)
            c.transport.heal(lagger.id)
            wait_for(lambda: len(list(lagger.local_store.snapshot().nodes()))
                     == len(nodes), 15.0, "the install")
            wait_replicas_equal(c)
