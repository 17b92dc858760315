"""The raft layer of both packages, case for case (the reference's
tests/test_raft.py, test_durability.py, test_fsm_determinism.py and
test_e2e_pipeline.py's TestBatchStoreWrite, TestPayloadNormalization,
TestApplyAsync, TestRaftStorePropose and TestPipelinedCommitRounds).

Every case runs on the reference (``nomad_tpu.raft``) and on the port
(``nomad_tpu_torch.raft``) through one namespace a package (``PKGS``,
also read by test_torch_persist.py and test_torch_replicated.py). Waits
poll with deadlines; none sleeps a fixed time.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import nomad_tpu.core.plan_apply as ref_plan_apply
import nomad_tpu.core.server as ref_server
import nomad_tpu.raft.durable as ref_durable
import nomad_tpu.raft.fsm as ref_fsm
import nomad_tpu.raft.log as ref_log
import nomad_tpu.raft.node as ref_node
import nomad_tpu.raft.transport as ref_transport
import nomad_tpu.state.persist as ref_persist
import nomad_tpu.structs.wire as ref_wire
import nomad_tpu.utils.files as ref_files
import nomad_tpu_torch.core.plan_apply as port_plan_apply
import nomad_tpu_torch.core.server as port_server
import nomad_tpu_torch.raft.durable as port_durable
import nomad_tpu_torch.raft.fsm as port_fsm
import nomad_tpu_torch.raft.log as port_log
import nomad_tpu_torch.raft.node as port_node
import nomad_tpu_torch.raft.transport as port_transport
import nomad_tpu_torch.state.persist as port_persist
import nomad_tpu_torch.structs.wire as port_wire
import nomad_tpu_torch.utils.files as port_files
from nomad_tpu import mock as ref_mock
from nomad_tpu.raft.cluster import RaftCluster as RefRaftCluster
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import enums
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.alloc import AllocBlock as RefAllocBlock
from nomad_tpu.structs.plan import Plan as RefPlan
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.raft.cluster import RaftCluster as PortRaftCluster
from nomad_tpu_torch.state import StateStore as PortStateStore
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.alloc import AllocBlock as PortAllocBlock
from nomad_tpu_torch.structs.plan import Plan as PortPlan


def _ref_cfg(**kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("heartbeat_ttl", 3600)
    kw.setdefault("gc_interval", 3600)
    return ref_server.ServerConfig(**kw)


def _port_cfg(**kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("heartbeat_ttl", 3600)
    kw.setdefault("gc_interval", 3600)
    return port_server.ServerConfig(device="cpu", **kw)


def _ns(name, mock, cluster, node, log, durable, fsm, transport, store,
        persist, wire, files, server, plan_apply, plan, operator, cfg,
        applier_kw, block):
    return types.SimpleNamespace(
        name=name, mock=mock, RaftCluster=cluster, RaftNode=node.RaftNode,
        NotLeaderError=node.NotLeaderError, Entry=log.Entry,
        RaftLog=log.RaftLog, InProcTransport=transport.InProcTransport,
        DurableLog=durable.DurableLog, StableStore=durable.StableStore,
        SnapshotStore=durable.SnapshotStore,
        snapshot_digest=durable.snapshot_digest, FSM=fsm.FSM,
        RaftStore=fsm.RaftStore, TIMESTAMPED=fsm.TIMESTAMPED,
        MUTATIONS=fsm.MUTATIONS, StateStore=store,
        dump_store=persist.dump_store, restore_store=persist.restore_store,
        persist=persist, wire=wire, files=files, server=server,
        PlanApplier=plan_apply.PlanApplier, PlanQueue=plan_apply.PlanQueue,
        Plan=plan, SchedulerConfiguration=operator.SchedulerConfiguration,
        cfg=cfg, applier_kw=applier_kw, AllocBlock=block,
        logger=f"{name}.raft")


REF = _ns("nomad_tpu", ref_mock, RefRaftCluster, ref_node, ref_log,
          ref_durable, ref_fsm, ref_transport, RefStateStore, ref_persist,
          ref_wire, ref_files, ref_server, ref_plan_apply, RefPlan,
          ref_operator, _ref_cfg, {"batch": True}, RefAllocBlock)
PORT = _ns("nomad_tpu_torch", port_mock, PortRaftCluster, port_node,
           port_log, port_durable, port_fsm, port_transport, PortStateStore,
           port_persist, port_wire, port_files, port_server, port_plan_apply,
           PortPlan, port_operator, _port_cfg, {}, PortAllocBlock)
PKGS = [pytest.param(REF, id="ref"), pytest.param(PORT, id="port")]


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def wait_for(pred, timeout=10.0, msg="condition"):
    """Poll ``pred`` until it holds or the deadline passes."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    if pred():
        return True
    raise AssertionError(f"timed out waiting for {msg}")


@contextlib.contextmanager
def disk_fault(pkg, op, count=1, path_substr=None):
    """Raise OSError from the next ``count`` durable writes of kind
    ``op`` (the packages' ``utils.files`` hook)."""
    left = [count]

    def hook(kind, path):
        if kind == op and left[0] > 0 and (path_substr is None
                                           or path_substr in path):
            left[0] -= 1
            raise OSError(28, "injected fault", path)

    pkg.files.set_fault_hook(hook)
    try:
        yield left
    finally:
        pkg.files.set_fault_hook(None)


# ---------------------------------------------------------------------------
# raw raft
# ---------------------------------------------------------------------------


def mini_cluster(pkg, n=3, fsm_factory=None):
    transport = pkg.InProcTransport()
    ids = [f"n{i}" for i in range(n)]
    applied = {}
    nodes = {}
    for node_id in ids:
        if fsm_factory is not None:
            apply_fn, sink = fsm_factory()
        else:
            sink = []

            def apply_fn(cmd, lst=sink):
                lst.append(cmd)
                return len(lst)
        applied[node_id] = sink
        nodes[node_id] = pkg.RaftNode(node_id, ids, transport, apply_fn,
                                      election_timeout=0.15,
                                      heartbeat_interval=0.03)
    for nd in nodes.values():
        nd.start()
    return transport, nodes, applied


def wait_leader(nodes, timeout=10.0):
    found = []

    def one():
        leaders = [n for n in nodes.values() if n.is_leader()]
        found[:] = leaders
        return len(leaders) == 1
    wait_for(one, timeout, "a single leader")
    return found[0]


@contextlib.contextmanager
def running(pkg, **kw):
    transport, nodes, applied = mini_cluster(pkg, **kw)
    try:
        yield transport, nodes, applied
    finally:
        for nd in nodes.values():
            nd.stop()


def lone_node(pkg, peers=("a", "b")):
    return pkg.RaftNode("a", list(peers), pkg.InProcTransport(),
                        lambda c: None, election_timeout=999,
                        heartbeat_interval=999)


class TestRaftCore:
    def test_election_and_replication(self, pkg):
        with running(pkg) as (_, nodes, applied):
            leader = wait_leader(nodes)
            for i in range(5):
                leader.apply(("compact", (i,), {}))
            wait_for(lambda: all(len(v) == 5 for v in applied.values()))
            assert all(v == applied[leader.id] for v in applied.values())

    def test_follower_rejects_apply(self, pkg):
        with running(pkg) as (_, nodes, _applied):
            leader = wait_leader(nodes)
            follower = next(n for n in nodes.values() if n is not leader)
            with pytest.raises(pkg.NotLeaderError):
                follower.apply(("compact", (), {}))

    def test_asymmetric_link_cut_deposes_leader(self, pkg):
        with running(pkg) as (transport, nodes, applied):
            leader = wait_leader(nodes)
            others = [i for i in nodes if i != leader.id]
            for i in others:
                transport.partition_link(leader.id, i)
            new_leader = wait_leader({k: v for k, v in nodes.items()
                                      if k != leader.id})
            assert new_leader.id != leader.id
            wait_for(lambda: not leader.is_leader())
            for i in others:
                transport.heal_link(leader.id, i)
            new_leader.apply(("compact", ("x",), {}))
            wait_for(lambda: applied[leader.id] == applied[new_leader.id]
                     != [])

    def test_heal_with_no_args_clears_links_and_partitions(self, pkg):
        with running(pkg) as (transport, nodes, _applied):
            leader = wait_leader(nodes)
            other = next(i for i in nodes if i != leader.id)
            transport.partition(other)
            transport.partition_link(leader.id, other)
            assert transport.send(leader.id, other, {"kind": "ping"}) is None
            transport.heal()
            leader.apply(("compact", ("y",), {}))

    def test_leader_failover_and_catchup(self, pkg):
        with running(pkg) as (transport, nodes, applied):
            leader = wait_leader(nodes)
            leader.apply(("compact", ("a",), {}))
            transport.partition(leader.id)
            new_leader = wait_leader({k: v for k, v in nodes.items()
                                      if k != leader.id})
            new_leader.apply(("compact", ("b",), {}))
            transport.heal(leader.id)
            wait_for(lambda: len(applied[leader.id]) == 2
                     and not leader.is_leader())
            assert applied[leader.id] == applied[new_leader.id]

    def test_same_term_stepdown_keeps_vote(self, pkg):
        node = lone_node(pkg, ("a", "b", "c"))
        node.current_term = 5
        node.state = "candidate"
        node.voted_for = "a"
        reply = node.handle({"kind": "append_entries", "term": 5,
                             "leader": "b", "prev_log_index": 0,
                             "prev_log_term": 0, "entries": [],
                             "leader_commit": 0})
        assert reply["success"] and node.state == "follower"
        assert node.voted_for == "a"
        reply = node.handle({"kind": "request_vote", "term": 5,
                             "candidate": "c", "last_log_index": 0,
                             "last_log_term": 0})
        assert not reply["granted"]

    def test_vote_cleared_on_term_increase(self, pkg):
        node = lone_node(pkg)
        node.current_term = 5
        node.voted_for = "a"
        reply = node.handle({"kind": "request_vote", "term": 6,
                             "candidate": "b", "last_log_index": 0,
                             "last_log_term": 0})
        assert reply["granted"] and node.voted_for == "b"

    def test_leader_barrier_commits_prior_term_entries(self, pkg):
        with running(pkg) as (transport, nodes, applied):
            leader = wait_leader(nodes)
            leader.apply(("compact", (0,), {}))
            transport.partition(leader.id)
            followers = [n for n in nodes.values() if n is not leader]
            new_leader = wait_leader({n.id: n for n in followers})
            wait_for(lambda: all(len(applied[f.id]) >= 1
                                 for f in followers))
            wait_for(lambda: new_leader.commit_index
                     >= new_leader.log.last()[0])
            new_leader.apply(("compact", (1,), {}))
            assert any(c[1] == (1,) for c in applied[new_leader.id])

    def test_concurrent_proposers_each_get_their_own_result(self, pkg):
        with running(pkg) as (_, nodes, applied):
            leader = wait_leader(nodes)
            results = {}
            lock = threading.Lock()

            def propose(start):
                for i in range(start, 200, 8):
                    r = leader.apply(("compact", (i,), {}))
                    with lock:
                        results[i] = r

            threads = [threading.Thread(target=propose, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert len(results) == 200
            assert len(set(results.values())) == 200
            order = {c[1][0]: pos + 1
                     for pos, c in enumerate(applied[leader.id])}
            assert len(order) == 200
            for i, r in results.items():
                assert order[i] == r

    def test_follower_conflict_hint_shape(self, pkg):
        node = lone_node(pkg)
        for term in (1, 1, 2, 2, 2):
            node.log.append(term, ("noop", (), {}))
        reply = node.handle({"kind": "append_entries", "term": 3,
                             "leader": "b", "prev_log_index": 9,
                             "prev_log_term": 3, "entries": [],
                             "leader_commit": 0})
        assert not reply["success"]
        assert (reply["conflict_term"], reply["first_index"]) == (0, 6)
        reply = node.handle({"kind": "append_entries", "term": 3,
                             "leader": "b", "prev_log_index": 5,
                             "prev_log_term": 3, "entries": [],
                             "leader_commit": 0})
        assert (reply["conflict_term"], reply["first_index"]) == (2, 3)

    def test_leader_backtracks_past_conflicting_term(self, pkg):
        node = lone_node(pkg)
        for term in (1, 1, 2, 3, 3):
            node.log.append(term, ("noop", (), {}))
        assert node._conflict_next_index_locked(
            {"conflict_term": 2, "first_index": 3}, next_idx=6) == 4
        assert node._conflict_next_index_locked(
            {"conflict_term": 7, "first_index": 2}, next_idx=6) == 2
        assert node._conflict_next_index_locked({}, next_idx=6) == 5

    def test_follower_commit_capped_at_verified_prefix(self, pkg):
        node = lone_node(pkg)
        for _ in range(4):
            node.log.append(1, ("compact", (0,), {}))
        reply = node.handle({
            "kind": "append_entries", "term": 3, "leader": "b",
            "prev_log_index": 1, "prev_log_term": 1,
            "entries": [pkg.Entry(index=2, term=3,
                                  command=("noop", (), {}))],
            "leader_commit": 4})
        assert reply["success"]
        assert node.commit_index == 2

    def test_timed_out_waiter_unregisters(self, pkg):
        with running(pkg) as (transport, nodes, _applied):
            leader = wait_leader(nodes)
            leader.apply(("compact", (0,), {}))
            transport.partition(leader.id)
            with pytest.raises((TimeoutError, pkg.NotLeaderError)):
                leader.apply(("compact", (1,), {}), timeout=0.4)
            with leader._lock:
                assert not leader._waiters and not leader._proposals

    def test_pipelined_proposals_apply_in_propose_order(self, pkg):
        with running(pkg) as (_, nodes, applied):
            leader = wait_leader(nodes)
            props = [leader.apply_async(("cmd", (i,), {}))
                     for i in range(20)]
            results = [leader.apply_wait(p, timeout=5.0) for p in props]
            assert results == sorted(results)
            assert [c[1][0] for c in applied[leader.id]] == list(range(20))
            wait_for(lambda: all(len(v) == 20 for v in applied.values()))
            for v in applied.values():
                assert [c[1][0] for c in v] == list(range(20))

    def test_follower_rejects_apply_async(self, pkg):
        with running(pkg) as (_, nodes, _applied):
            leader = wait_leader(nodes)
            follower = next(n for n in nodes.values() if n is not leader)
            with pytest.raises(pkg.NotLeaderError):
                follower.apply_async(("cmd", (0,), {}))

    def test_read_index_waits_for_barrier_and_serves(self, pkg):
        with running(pkg) as (_, nodes, applied):
            leader = wait_leader(nodes)
            leader.apply(("compact", (0,), {}))
            index = leader.read_index(timeout=2.0)
            assert index >= leader._term_start_index
            follower = next(n for n in nodes.values() if n is not leader)
            follower.wait_applied(index, timeout=5.0)
            assert follower.last_applied >= index
            assert leader.read_index(timeout=2.0, lease=False) >= index
            with pytest.raises(pkg.NotLeaderError):
                follower.read_index(timeout=0.5)

    def test_membership_change_one_server_at_a_time(self, pkg):
        with running(pkg) as (_, nodes, applied):
            leader = wait_leader(nodes)
            victim = next(i for i in nodes if i != leader.id)
            leader.remove_server(victim)
            assert victim not in leader.servers
            leader.apply(("compact", ("after",), {}))
            with pytest.raises(ValueError):
                leader.change_config({leader.id: "", "x": "", "y": ""})


class SlowCopy:
    """A payload whose copy takes 0.6 s: four election timeouts."""

    def __deepcopy__(self, memo):
        time.sleep(0.6)
        return SlowCopy()


def test_slow_command_copy_and_leadership():
    """The reference copies a command inside the apply loop's lock hold,
    so a leader copying a large command sends no heartbeat for that long
    and a follower takes over (ROADMAP C6); the port copies it outside
    the lock (``fsm_prepare``) and keeps its leader. Only the leader's
    copy is slow, so the followers' timers run."""
    def terms(pkg, in_lock):
        transport = pkg.InProcTransport()
        ids = ["n0", "n1", "n2"]
        nodes = {}

        def copy_fn(node_id):
            def fn(cmd):
                if nodes[node_id].state == "leader":
                    return copy.deepcopy(cmd)
                return cmd
            return fn

        for i in ids:
            kw = (dict(fsm_apply=copy_fn(i)) if in_lock
                  else dict(fsm_apply=lambda cmd: 1,
                            fsm_prepare=copy_fn(i)))
            nodes[i] = pkg.RaftNode(i, ids, transport, election_timeout=0.15,
                                    heartbeat_interval=0.03, **kw)
        for nd in nodes.values():
            nd.start()
        try:
            leader = wait_leader(nodes)
            before = {i: nd.current_term for i, nd in nodes.items()}
            try:
                leader.apply(("slow", (SlowCopy(),), {}), timeout=10.0)
            except pkg.NotLeaderError:
                pass  # deposed while applying: the outcome counted below
            wait_for(lambda: sum(nd.last_applied >= 2
                                 for nd in nodes.values()) >= 2, 10.0)
            return {i: nd.current_term - before[i]
                    for i, nd in nodes.items()}
        finally:
            for nd in nodes.values():
                nd.stop()

    ref = terms(REF, in_lock=True)
    port = terms(PORT, in_lock=False)
    assert max(ref.values()) >= 1, ref
    assert set(port.values()) == {0}, port


# ---------------------------------------------------------------------------
# the FSM and the RaftStore facade
# ---------------------------------------------------------------------------


class TestFSM:
    def test_three_replicas_stamp_identical_modify_times(self, pkg):
        node = pkg.mock.node()
        job = pkg.mock.job()
        ev = pkg.mock.eval_for(job)
        alloc = pkg.mock.alloc(job, node)
        log = [("upsert_node", (node,), {}),
               ("upsert_job", (job,), {}),
               ("upsert_evals", ([ev],), {"ts": 1111.5}),
               ("upsert_allocs", ([alloc],), {"ts": 2222.25}),
               ("update_node_status", (node.id, "down"), {"ts": 3333.125})]
        replicas = [pkg.FSM(pkg.StateStore()) for _ in range(3)]
        for fsm in replicas:
            for cmd in log:
                fsm.apply(cmd)
        snaps = [f.store.snapshot() for f in replicas]
        assert {s.eval_by_id(ev.id).modify_time for s in snaps} == {1111.5}
        assert {s.alloc_by_id(alloc.id).modify_time
                for s in snaps} == {2222.25}
        assert {s.node_by_id(node.id).status_updated_at
                for s in snaps} == {3333.125}
        assert len({f.store.latest_index for f in replicas}) == 1

    def test_timestamped_command_without_ts_is_rejected(self, pkg):
        fsm = pkg.FSM(pkg.StateStore())
        with pytest.raises(ValueError, match="no ts"):
            fsm.apply(("upsert_evals", ([pkg.mock.eval_for(
                pkg.mock.job())],), {}))

    def test_fsm_store_refuses_wallclock_fallback(self, pkg):
        store = pkg.StateStore()
        pkg.FSM(store)
        with pytest.raises(RuntimeError, match="wall-clock"):
            store.upsert_evals([pkg.mock.eval_for(pkg.mock.job())])

    def test_standalone_store_still_self_stamps(self, pkg):
        store = pkg.StateStore()
        ev = pkg.mock.eval_for(pkg.mock.job())
        store.upsert_evals([ev])
        assert store.snapshot().eval_by_id(ev.id).modify_time > 0

    def test_fsm_deep_copies_the_command(self, pkg):
        store = pkg.StateStore()
        fsm = pkg.FSM(store)
        node = pkg.mock.node()
        fsm.apply(("upsert_node", (node,), {}))
        assert store.snapshot().node_by_id(node.id) is not node

    def test_raftstore_stamps_timestamped_ops_at_propose_time(self, pkg):
        class FakeRaft:
            def __init__(self):
                self.commands = []

            def apply(self, cmd, timeout=5.0):
                self.commands.append(cmd)
                return 1

        raft = FakeRaft()
        rs = pkg.RaftStore(pkg.StateStore(), raft)
        a = pkg.mock.alloc()
        rs.upsert_allocs([a])
        rs.upsert_node(pkg.mock.node())
        ops = {op: (args, kw) for op, args, kw in raft.commands}
        args, kw = ops["upsert_allocs"]
        assert kw["ts"] is not None
        assert "ts" not in ops["upsert_node"][1]
        s1, s2 = pkg.StateStore(), pkg.StateStore()
        s1.upsert_allocs(copy.deepcopy(list(args[0])), **kw)
        s2.upsert_allocs(copy.deepcopy(list(args[0])), **kw)
        assert (s1.snapshot().alloc_by_id(a.id).modify_time
                == s2.snapshot().alloc_by_id(a.id).modify_time)
        assert {"upsert_plan_results", "upsert_plan_results_batch",
                "upsert_evals"} <= pkg.TIMESTAMPED

    def test_propose_async_replicates_and_stamps_ts(self, pkg):
        def fsm_factory():
            store = pkg.StateStore()
            return pkg.FSM(store).apply, store

        with running(pkg, fsm_factory=fsm_factory) as (_, nodes, stores):
            leader = wait_leader(nodes)
            rs = pkg.RaftStore(stores[leader.id], leader)
            assert rs.can_propose_async
            ev = pkg.mock.eval_for(pkg.mock.job())
            index = rs.wait_applied(rs.propose_async("upsert_evals", [ev]),
                                    timeout=5.0)
            assert isinstance(index, int) and index > 0
            wait_for(lambda: all(s.snapshot().eval_by_id(ev.id) is not None
                                 for s in stores.values()))

    def test_propose_async_rejects_non_mutations(self, pkg):
        with pytest.raises(AttributeError):
            pkg.RaftStore(pkg.StateStore(), object()).propose_async(
                "snapshot")


def test_port_mutations_cover_every_store_writer():
    """Every mutator of the port's store is replicated: a write that
    bypassed the facade would land on the leader's replica only."""
    import inspect

    public = {n for n, f in inspect.getmembers(PortStateStore,
                                               inspect.isfunction)
              if not n.startswith("_")}
    readers = {"snapshot", "snapshot_min_index", "add_commit_listener",
               "usage_rows_for", "dump"}
    assert public - readers == port_fsm.MUTATIONS
    for op in port_fsm.TIMESTAMPED:
        assert "ts" in inspect.signature(getattr(PortStateStore,
                                                 op)).parameters, op


# ---------------------------------------------------------------------------
# storage primitives
# ---------------------------------------------------------------------------


class TestDurableLog:
    def test_append_survives_reopen(self, pkg, tmp_path):
        log = pkg.DurableLog(str(tmp_path))
        for i in range(5):
            log.append(1, ("compact", (i,), {}))
        log.close()
        log2 = pkg.DurableLog(str(tmp_path))
        assert log2.last() == (5, 1)
        assert log2.get(4).command == ("compact", (3,), {})
        assert [e.index for e in log2.slice_from(1, 100)] == [1, 2, 3, 4, 5]
        log2.close()

    def test_structs_roundtrip_through_log(self, pkg, tmp_path):
        log = pkg.DurableLog(str(tmp_path))
        n = pkg.mock.node()
        log.append(1, ("upsert_node", (n,), {}))
        log.close()
        got = pkg.DurableLog(str(tmp_path)).get(1).command
        assert got[0] == "upsert_node" and got[1][0].id == n.id
        assert type(got[1][0]) is type(n)

    def test_conflict_truncation_persists(self, pkg, tmp_path):
        log = pkg.DurableLog(str(tmp_path))
        for i in range(5):
            log.append(1, ("compact", (i,), {}))
        log.append_entries(2, [pkg.Entry(index=3, term=2,
                                         command=("noop", (), {}))])
        assert log.last() == (3, 2)
        log.close()
        log2 = pkg.DurableLog(str(tmp_path))
        assert log2.last() == (3, 2) and log2.get(4) is None
        log2.close()

    def test_torn_tail_write_dropped(self, pkg, tmp_path):
        d = str(tmp_path)
        log = pkg.DurableLog(d)
        for i in range(3):
            log.append(1, ("compact", (i,), {}))
        log.close()
        with open(os.path.join(d, "log.jsonl"), "a") as f:
            f.write('{"index": 4, "term": 1, "comma')
        log2 = pkg.DurableLog(d)
        assert log2.last() == (3, 1)
        log2.append(1, ("compact", (99,), {}))
        log2.close()
        assert pkg.DurableLog(d).last() == (4, 1)

    def test_append_batch_survives_reopen(self, pkg, tmp_path):
        log = pkg.DurableLog(str(tmp_path))
        batch = log.append_batch(1, [("compact", (i,), {})
                                     for i in range(5)])
        assert [e.index for e in batch] == [1, 2, 3, 4, 5]
        log.close()
        log2 = pkg.DurableLog(str(tmp_path))
        assert log2.last() == (5, 1)
        assert log2.get(3).command == ("compact", (2,), {})
        log2.close()

    def test_append_batch_is_one_physical_write(self, pkg, tmp_path,
                                                monkeypatch):
        log = pkg.DurableLog(str(tmp_path))
        fsyncs = []
        monkeypatch.setattr(os, "fsync", lambda fd: fsyncs.append(fd))
        log.append_batch(1, [("compact", (i,), {}) for i in range(64)])
        assert len(fsyncs) == 1
        log.close()

    def test_append_batch_cas_mismatch_refuses(self, pkg, tmp_path):
        log = pkg.DurableLog(str(tmp_path))
        log.append(1, ("compact", (0,), {}))
        assert log.append_batch(1, [("compact", (1,), {})],
                                prev=(0, 0)) is None
        assert log.last() == (1, 1)
        got = log.append_batch(1, [("compact", (1,), {})], prev=(1, 1))
        assert [e.index for e in got] == [2]
        log.close()

    def test_append_batch_fault_rolls_back_whole_batch(self, pkg, tmp_path):
        d = str(tmp_path)
        log = pkg.DurableLog(d)
        log.append(1, ("compact", (0,), {}))
        with disk_fault(pkg, "log_append"):
            with pytest.raises(OSError):
                log.append_batch(1, [("compact", (i,), {})
                                     for i in range(4)])
        assert log.last() == (1, 1)
        assert log.append_batch(1, [("compact", (9,), {})])[0].index == 2
        log.close()
        assert pkg.DurableLog(d).last() == (2, 1)

    def test_compaction_drops_prefix(self, pkg, tmp_path):
        d = str(tmp_path)
        log = pkg.DurableLog(d)
        for i in range(10):
            log.append(1, ("compact", (i,), {}))
        log.compact(7, 1)
        assert (log.first_index(), log.base_index) == (8, 7)
        assert log.get(7) is None and log.get(8) is not None
        assert log.term_at(7) == 1
        log.close()
        pkg.SnapshotStore(d).save(7, 1, {"format": 1, "index": 0})
        log2 = pkg.DurableLog(d)
        assert log2.base_index == 7 and log2.last() == (10, 1)
        log2.close()

    def test_term_vote_survive_reopen(self, pkg, tmp_path):
        s = pkg.StableStore(str(tmp_path))
        assert (s.term, s.voted_for) == (0, None)
        s.save(7, "n2")
        s2 = pkg.StableStore(str(tmp_path))
        assert (s2.term, s2.voted_for) == (7, "n2")

    def test_only_if_newer_rejects_stale_write(self, pkg, tmp_path):
        s = pkg.SnapshotStore(str(tmp_path))
        assert s.save(50, 1, {"format": 1, "index": 50}) is True
        assert s.save(30, 1, {"format": 1, "index": 30},
                      only_if_newer=True) is False
        assert s.load()["index"] == 50

    def test_save_fault_leaves_previous_snapshot_loadable(self, pkg,
                                                          tmp_path):
        s = pkg.SnapshotStore(str(tmp_path))
        s.save(50, 1, {"format": 1, "index": 50})
        with disk_fault(pkg, "atomic_write_text", path_substr="snapshot"):
            with pytest.raises(OSError):
                s.save(80, 1, {"format": 1, "index": 80})
        assert s.load()["index"] == 50
        assert s.save(80, 1, {"format": 1, "index": 80}) is True
        assert s.load()["index"] == 80


# ---------------------------------------------------------------------------
# a raft node with durable storage
# ---------------------------------------------------------------------------


def durable_node(pkg, d, node_id="n0", peers=("n0",), **kw):
    store = pkg.StateStore()
    os.makedirs(d, exist_ok=True)
    fsm = pkg.FSM(store)
    node = pkg.RaftNode(
        node_id, list(peers), pkg.InProcTransport(), fsm.apply,
        election_timeout=0.15, heartbeat_interval=0.03,
        log=pkg.DurableLog(d), stable=pkg.StableStore(d),
        snapshots=pkg.SnapshotStore(d),
        fsm_snapshot=lambda: pkg.dump_store(store),
        fsm_restore=lambda data: pkg.restore_store(store, data), **kw)
    return node, store


class TestDurableRaftNode:
    def test_single_node_restart_replays_log(self, pkg, tmp_path):
        d = str(tmp_path / "n0")
        node, _ = durable_node(pkg, d)
        node.start()
        wait_for(node.is_leader)
        n1, n2 = pkg.mock.node(), pkg.mock.node()
        node.apply(("upsert_node", (n1,), {}))
        node.apply(("upsert_node", (n2,), {}))
        node.stop()
        node.log.close()
        node2, store2 = durable_node(pkg, d)
        node2.start()
        try:
            wait_for(node2.is_leader)
            wait_for(lambda: node2.last_applied >= 3)
            assert {n.id for n in store2.snapshot().nodes()} == {n1.id, n2.id}
        finally:
            node2.stop()
            node2.log.close()

    def test_snapshot_compacts_and_restart_uses_it(self, pkg, tmp_path):
        d = str(tmp_path / "n0")
        node, _ = durable_node(pkg, d, snapshot_threshold=10)
        node.start()
        wait_for(node.is_leader)
        for n in [pkg.mock.node() for _ in range(25)]:
            node.apply(("upsert_node", (n,), {}))
        wait_for(lambda: node.log.base_index > 0, msg="a compaction")
        assert node.log.length() < 25
        node.stop()
        node.log.close()
        node2, store2 = durable_node(pkg, d, snapshot_threshold=10)
        node2.start()
        try:
            wait_for(node2.is_leader)
            wait_for(lambda: len(list(store2.snapshot().nodes())) == 25)
        finally:
            node2.stop()
            node2.log.close()

    def test_vote_persisted_across_restart(self, pkg, tmp_path):
        d = str(tmp_path / "n0")
        node, _ = durable_node(pkg, d)
        node.start()
        wait_for(node.is_leader)
        term = node.current_term
        node.stop()
        node.log.close()
        node2, _ = durable_node(pkg, d)
        assert (node2.current_term, node2.voted_for) == (term, "n0")
        node2.log.close()


# ---------------------------------------------------------------------------
# the chunked install protocol, follower side, frame by frame
# ---------------------------------------------------------------------------


def src_dump(pkg, n_nodes=3):
    src = pkg.StateStore()
    ids = []
    for _ in range(n_nodes):
        n = pkg.mock.node()
        ids.append(n.id)
        src.upsert_node(n)
    return json.dumps(pkg.dump_store(src)), ids


def frames(pkg, text, chunk, *, term=1, leader="n9", index=50, snap_term=1):
    """The frame sequence RaftNode._push_snapshot_chunks sends."""
    out, off = [], 0
    while True:
        data = text[off:off + chunk]
        done = off + chunk >= len(text)
        msg = {"kind": "install_snapshot", "term": term, "leader": leader,
               "index": index, "snap_term": snap_term, "offset": off,
               "data": data, "done": done}
        if done:
            msg["total"] = len(text)
            msg["digest"] = pkg.snapshot_digest(text)
        out.append(msg)
        off += len(data)
        if done:
            return out


class TestChunkedInstall:
    def test_multi_frame_install_restores_and_resets_log(self, pkg,
                                                         tmp_path):
        d = str(tmp_path / "n0")
        node, store = durable_node(pkg, d)
        text, ids = src_dump(pkg)
        fr = frames(pkg, text, chunk=64)
        assert len(fr) > 3
        for msg in fr[:-1]:
            reply = node._on_install_snapshot(msg)
            assert reply["success"] is True
            assert reply["offset"] == msg["offset"] + len(msg["data"])
        final = node._on_install_snapshot(fr[-1])
        assert final["success"] is True and final["match_index"] == 50
        assert {n.id for n in store.snapshot().nodes()} == set(ids)
        assert node.last_applied == node.log.base_index == 50
        assert node.snapshots.load()["index"] == 50
        assert not os.path.exists(os.path.join(d, "snapshot.json.partial"))
        node.log.close()

    def test_offset_mismatch_rewinds_then_resumes(self, pkg, tmp_path):
        node, store = durable_node(pkg, str(tmp_path / "n0"))
        text, ids = src_dump(pkg)
        fr = frames(pkg, text, chunk=64)
        assert node._on_install_snapshot(fr[0])["success"] is True
        reply = node._on_install_snapshot(fr[2])
        assert reply["success"] is False
        assert reply["offset"] == len(fr[0]["data"])
        for msg in fr[1:]:
            reply = node._on_install_snapshot(msg)
            assert reply["success"] is True
        assert reply["match_index"] == fr[-1]["index"]
        assert {n.id for n in store.snapshot().nodes()} == set(ids)
        node.log.close()

    def test_digest_mismatch_rejected_old_state_intact(self, pkg, tmp_path):
        node, store = durable_node(pkg, str(tmp_path / "n0"))
        text, _ = src_dump(pkg)
        fr = frames(pkg, text, chunk=64)
        fr[-1]["digest"] = "0" * 64
        for msg in fr[:-1]:
            assert node._on_install_snapshot(msg)["success"] is True
        reply = node._on_install_snapshot(fr[-1])
        assert reply["success"] is False and reply["offset"] == 0
        assert list(store.snapshot().nodes()) == []
        assert node.last_applied == node.log.base_index == 0
        assert node.snapshots.load() is None
        node.log.close()

    def test_truncated_body_rejected_by_total_check(self, pkg, tmp_path):
        node, _ = durable_node(pkg, str(tmp_path / "n0"))
        text, _ = src_dump(pkg)
        fr = frames(pkg, text, chunk=64)
        last = dict(fr[-1])
        last["offset"] = len(fr[0]["data"])
        assert node._on_install_snapshot(fr[0])["success"] is True
        assert node._on_install_snapshot(last)["success"] is False
        assert node.last_applied == 0
        node.log.close()

    def test_chunk_write_fault_drops_transfer_then_recovers(self, pkg,
                                                            tmp_path):
        node, store = durable_node(pkg, str(tmp_path / "n0"))
        text, ids = src_dump(pkg)
        fr = frames(pkg, text, chunk=64)
        with disk_fault(pkg, "snap_chunk") as left:
            reply = node._on_install_snapshot(fr[0])
        assert reply["success"] is False and reply["offset"] == 0
        assert left == [0]
        for msg in fr:
            reply = node._on_install_snapshot(msg)
            assert reply["success"] is True
        assert {n.id for n in store.snapshot().nodes()} == set(ids)
        node.log.close()

    def test_stale_term_chunk_refused(self, pkg, tmp_path):
        node, _ = durable_node(pkg, str(tmp_path / "n0"))
        node.current_term = 5
        text, _ = src_dump(pkg)
        reply = node._on_install_snapshot(
            frames(pkg, text, chunk=1 << 20, term=4)[0])
        assert reply["success"] is False and reply["term"] == 5
        node.log.close()

    def test_crash_between_save_and_reset_to_recovers(self, pkg, tmp_path):
        d = str(tmp_path / "n0")
        os.makedirs(d, exist_ok=True)
        log = pkg.DurableLog(d)
        for i in range(5):
            log.append(1, ("compact", (i,), {}))
        log.close()
        src = pkg.StateStore()
        nodes = [pkg.mock.node() for _ in range(3)]
        for n in nodes:
            src.upsert_node(n)
        pkg.SnapshotStore(d).save(50, 1, pkg.dump_store(src))
        node, store = durable_node(pkg, d)
        assert node.last_applied == node.log.base_index == 50
        assert ({n.id for n in store.snapshot().nodes()}
                == {n.id for n in nodes})
        node.log.close()

    def test_torn_snapshot_file_dropped_with_warning(self, pkg, tmp_path,
                                                     caplog):
        import logging

        d = str(tmp_path / "n0")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "snapshot.json"), "w") as f:
            f.write('{"index": 50, "term": 1, "data": {"form')
        with caplog.at_level(logging.WARNING, logger=pkg.logger):
            node, _ = durable_node(pkg, d)
        assert any("unreadable snapshot" in r.message
                   for r in caplog.records)
        assert node.last_applied == 0 and node.snapshots.load() is None
        node.log.close()


# ---------------------------------------------------------------------------
# the batched plan command, normalization and the pipelined commit rounds
# ---------------------------------------------------------------------------


def seeded_store(pkg):
    store = pkg.StateStore()
    node = pkg.mock.node()
    store.upsert_node(node)
    job = pkg.mock.job()
    store.upsert_job(job)
    return store, node, job


class TestBatchStoreWrite:
    def test_two_payloads_one_generation(self, pkg):
        store, node, job = seeded_store(pkg)
        a1 = pkg.mock.alloc(job, node, index=0)
        a2 = pkg.mock.alloc(job, node, index=1)
        before = store.latest_index
        index = store.upsert_plan_results_batch([{"result_allocs": [a1]},
                                                 {"result_allocs": [a2]}])
        snap = store.snapshot()
        assert index == store.latest_index > before
        assert snap.alloc_by_id(a1.id).create_index == index
        assert snap.alloc_by_id(a2.id).create_index == index

    def test_later_payload_updates_earlier_insert(self, pkg):
        store, node, job = seeded_store(pkg)
        a = pkg.mock.alloc(job, node, index=0)
        stop = copy.copy(a)
        stop.desired_status = enums.ALLOC_DESIRED_STOP
        store.upsert_plan_results_batch([{"result_allocs": [a]},
                                         {"stopped_allocs": [stop]}])
        assert (store.snapshot().alloc_by_id(a.id).desired_status
                == enums.ALLOC_DESIRED_STOP)

    def test_rehydrates_job_from_payload(self, pkg):
        store, node, job = seeded_store(pkg)
        a = pkg.mock.alloc(job, node, index=0)
        a.job = None
        store.upsert_plan_results_batch([{"result_allocs": [a], "job": job}])
        assert store.snapshot().alloc_by_id(a.id).job.id == job.id

    def test_stop_rehydrates_exact_prior_version(self, pkg):
        store, node, job = seeded_store(pkg)
        a = pkg.mock.alloc(job, node, index=0)
        store.upsert_plan_results_batch([{"result_allocs": [a], "job": job}])
        newer = copy.deepcopy(job)
        newer.version = job.version + 1
        store.upsert_job(newer)
        stop = copy.copy(store.snapshot().alloc_by_id(a.id))
        stop.desired_status = enums.ALLOC_DESIRED_STOP
        stop.job = None
        store.upsert_plan_results_batch([{"stopped_allocs": [stop],
                                          "job": newer}])
        got = store.snapshot().alloc_by_id(a.id)
        assert got.desired_status == enums.ALLOC_DESIRED_STOP
        assert got.job.version == job.version

    def test_rehydrates_from_job_table_as_last_resort(self, pkg):
        store, node, job = seeded_store(pkg)
        a = pkg.mock.alloc(job, node, index=0)
        a.job = None
        store.upsert_plan_results_batch([{"result_allocs": [a]}])
        assert store.snapshot().alloc_by_id(a.id).job.id == job.id

    def test_eval_updates_ride_the_batch(self, pkg):
        store, _node, job = seeded_store(pkg)
        ev = pkg.mock.eval_for(job, status=enums.EVAL_STATUS_COMPLETE)
        store.upsert_plan_results_batch([{"evals": [ev]}])
        assert (store.snapshot().eval_by_id(ev.id).status
                == enums.EVAL_STATUS_COMPLETE)

    def test_fresh_placement_supersedes_live_alloc_of_its_slot(self, pkg):
        store, node, job = seeded_store(pkg)
        first = pkg.mock.alloc(job, node, index=0)
        store.upsert_plan_results_batch([{"result_allocs": [first],
                                          "job": job}])
        # a second plan of the same eval, replayed across a failover
        again = pkg.mock.alloc(job, node, index=0)
        assert again.name == first.name and again.id != first.id
        store.upsert_plan_results_batch([{"result_allocs": [again],
                                          "job": job}])
        snap = store.snapshot()
        assert (snap.alloc_by_id(first.id).desired_status
                == enums.ALLOC_DESIRED_STOP)
        live = [a for a in snap.allocs_by_job(job.id)
                if not a.terminal_status()]
        assert [a.id for a in live] == [again.id]

    def test_fresh_placement_supersedes_block_position_of_its_slot(
            self, pkg):
        """A single placement named as a live block position stops that
        position (promoted to a row of its own), and only that one."""
        store, node, job = seeded_store(pkg)
        block = _block(pkg, job, node, 4)
        store.upsert_plan_results_batch([{"alloc_blocks": [block]}])
        again = pkg.mock.alloc(job, node, index=2)
        assert again.name == block.alloc_at(2).name
        store.upsert_plan_results_batch([{"result_allocs": [again],
                                          "job": job}])
        snap = store.snapshot()
        stopped = snap.alloc_by_id(block.alloc_at(2).id)
        assert stopped.desired_status == enums.ALLOC_DESIRED_STOP
        live = sorted(a.id for a in snap.allocs_by_job(job.id)
                      if not a.terminal_status())
        assert live == sorted([again.id] + [block.alloc_at(p).id
                                            for p in (0, 1, 3)])

    def test_rewrite_in_the_plan_is_seen_by_the_supersede(self, pkg):
        """A plan that marks an alloc unknown (its node disconnected) and
        places its replacement, named alike, in one payload: the
        rewrite lands first, so the supersede skips the unknown alloc.
        Both stores emit the same events and stop nothing."""
        store, node, job = seeded_store(pkg)
        other = pkg.mock.node()
        store.upsert_node(other)
        old = pkg.mock.alloc(job, node, index=0)
        store.upsert_plan_results_batch([{"result_allocs": [old],
                                          "job": job}])
        unknown = copy.copy(store.snapshot().alloc_by_id(old.id))
        unknown.client_status = enums.ALLOC_CLIENT_UNKNOWN
        repl = pkg.mock.alloc(job, other, index=0)
        repl.previous_allocation = old.id
        seen = []
        store.add_commit_listener(lambda index, events: seen.extend(
            (kind, getattr(obj, "id", None)) for kind, obj in events))
        store.upsert_plan_results_batch([{"result_allocs": [unknown, repl],
                                          "job": job}])
        assert seen == [("alloc-upsert", old.id), ("alloc-upsert", repl.id)]
        got = store.snapshot().alloc_by_id(old.id)
        assert got.desired_status == enums.ALLOC_DESIRED_RUN
        assert got.client_status == enums.ALLOC_CLIENT_UNKNOWN

    def test_block_payload_landing_twice(self, pkg):
        """ROADMAP §C7: a commit round can land twice (the applier's
        per-plan fallback after a raft wait timed out, then the round
        itself). The reference inserts the block again: its usage and its
        live allocs count twice. The port skips a block id it holds."""
        store, node, job = seeded_store(pkg)
        block = _block(pkg, job, node, 4)
        payload = {"alloc_blocks": [block], "job": job}
        store.upsert_plan_results_batch([payload])
        once = np.array(store.snapshot().node_usage(node.id), dtype=float)
        store.upsert_plan_results_batch([dict(payload, alloc_blocks=[
            copy.copy(block)])])
        snap = store.snapshot()
        twice = pkg is REF
        live = [a for a in snap.allocs_by_job(job.id)
                if not a.terminal_status()]
        assert len(live) == (8 if twice else 4)
        assert np.array_equal(np.array(snap.node_usage(node.id),
                                       dtype=float),
                              once * (2 if twice else 1))


def _block(pkg, job, node, k):
    tg = job.task_groups[0]
    vec = pkg.mock.alloc(job, node).allocated_vec
    return pkg.AllocBlock(
        id="blk-1", eval_id="ev-1", job_id=job.id, job=job,
        task_group=tg.name, name_indices=np.arange(k, dtype=np.int64),
        node_ids=[node.id], node_names=[node.name],
        counts=np.array([k], dtype=np.int64), allocated_vec=vec)


def test_payload_strips_jobs_without_touching_scheduler_objects(pkg):
    store, node, job = seeded_store(pkg)
    a = pkg.mock.alloc(job, node, index=0)
    plan = pkg.Plan(eval_id="e1", job=job)
    plan.append_alloc(a)
    result, rejected = pkg.PlanApplier(store, pkg.PlanQueue())._verify(
        plan, None)
    assert not rejected
    payload = pkg.PlanApplier._payload_for(plan, result)
    assert payload["job"] is job
    assert all(pa.job is None for pa in payload["result_allocs"])
    assert a.job is not None


class AsyncStore:
    """A RaftStore-shaped wrapper over a bare store: propose_async runs
    the mutation on ONE background thread (apply order = propose order,
    as the raft log), behind a gate a test can hold closed; fail_next
    makes the next propose raise, as a lost leadership does."""

    can_propose_async = True

    def __init__(self, pkg, store):
        self._pkg = pkg
        self._store = store
        self._exec = ThreadPoolExecutor(max_workers=1)
        self.gate = threading.Event()
        self.gate.set()
        self.proposed = []
        self.fallback_writes = []
        self.fail_next = False

    def __getattr__(self, name):
        return getattr(self._store, name)

    def propose_async(self, name, *args, **kwargs):
        if self.fail_next:
            self.fail_next = False
            raise self._pkg.NotLeaderError(None)
        self.proposed.append(name)

        def run():
            assert self.gate.wait(30.0), "the test's gate never opened"
            return getattr(self._store, name)(*args, **kwargs)

        return self._exec.submit(run)

    def wait_applied(self, prop, timeout=30.0):
        return prop.result(timeout)

    def upsert_plan_results(self, **payload):
        self.fallback_writes.append(payload)
        return self._store.upsert_plan_results(**payload)

    def close(self):
        self.gate.set()
        self._exec.shutdown(wait=True)


@contextlib.contextmanager
def async_applier(pkg, store):
    wrapped = AsyncStore(pkg, store)
    q = pkg.PlanQueue()
    q.set_enabled(True)
    applier = pkg.PlanApplier(wrapped, q, **pkg.applier_kw)
    applier.start()
    try:
        yield applier, q, wrapped
    finally:
        applier.stop()
        wrapped.close()


class TestPipelinedCommitRounds:
    def test_plans_commit_through_async_rounds(self, pkg):
        store, node, job = seeded_store(pkg)
        with async_applier(pkg, store) as (_applier, q, wrapped):
            pendings = []
            for i in range(3):
                p = pkg.Plan(eval_id=f"e{i}", job=job,
                             snapshot_index=store.latest_index)
                p.append_alloc(pkg.mock.alloc(job, node, index=i))
                pendings.append(q.enqueue(p))
            results = [p.wait(timeout=10.0) for p in pendings]
            assert all(r.alloc_index > 0 for r in results)
            assert set(wrapped.proposed) == {"upsert_plan_results_batch"}
            allocs = store.snapshot().allocs_by_job(job.id)
            assert len(allocs) == 3
            assert all(a.job is not None for a in allocs)

    def test_rounds_overlap_up_to_pipeline_depth(self, pkg):
        store, _, _ = seeded_store(pkg)
        with async_applier(pkg, store) as (applier, _q, wrapped):
            depth = applier.COMMIT_PIPELINE_DEPTH
            order, futs = [], []
            wrapped.gate.clear()
            for i in range(depth + 2):
                ev = pkg.mock.eval_for(pkg.mock.job(),
                                       status=enums.EVAL_STATUS_COMPLETE)
                fut = applier.submit_eval_updates([ev])
                fut.add_done_callback(lambda f, i=i: order.append(i))
                futs.append(fut)
                wait_for(lambda: len(wrapped.proposed) >= min(i + 1, depth),
                         5.0)
            # the proposer took the first extra round and stalls on the
            # backpressure: the queue keeps the second
            wait_for(lambda: len(applier._commit_q) <= 1, 5.0)
            assert len(wrapped.proposed) == depth
            assert not any(f.done() for f in futs)
            wrapped.gate.set()
            for f in futs:
                assert f.result(timeout=10.0) is None
            assert order == sorted(order)
            assert depth < len(wrapped.proposed) <= len(futs)

    def test_propose_failure_falls_back_per_plan(self, pkg):
        store, node, job = seeded_store(pkg)
        with async_applier(pkg, store) as (_applier, q, wrapped):
            wrapped.fail_next = True
            p = pkg.Plan(eval_id="e0", job=job,
                         snapshot_index=store.latest_index)
            a = pkg.mock.alloc(job, node, index=0)
            p.append_alloc(a)
            result = q.enqueue(p).wait(timeout=10.0)
            assert wrapped.proposed == []
            assert len(wrapped.fallback_writes) == 1
            assert result.alloc_index > 0
            assert store.snapshot().alloc_by_id(a.id) is not None
