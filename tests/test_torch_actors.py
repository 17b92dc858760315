"""The lifecycle's background actors (ROADMAP A27), each scenario written
once and run through both packages with pinned ids and the clock pinned:
the heartbeat manager (the cases of ``tests/test_heartbeat.py``, its
``_now`` stubbed and its expiry fired by hand, with no shard thread),
the deployment watcher (``tests/test_deployments.py``'s TestWatcher and
``test_operator_fail_deployment``), the node drainer and core GC
(``tests/test_subsystems.py``'s TestCoreGC, TestDrainer and
TestDeployments), driven by ``_tick()`` and ``force_gc`` on Servers
whose actor threads are held off; the ``mark_nodes_down`` race with a
re-armed TTL; and a ``Server.stop`` that leaves no actor thread. No test
waits on the wall clock for an actor: ``wait_for_idle`` waits for the
workers only. The port's answers (nodes marked down, deployment
statuses, job versions, migrate marks, GC stats, claims, alloc rows)
must equal the reference's."""

import copy
import heapq
import itertools
import time
import types

import pytest

import nomad_tpu.utils as ref_utils
from nomad_tpu import mock as ref_mock
from nomad_tpu.core import core_sched as ref_core_sched
from nomad_tpu.core import deployments as ref_deployments
from nomad_tpu.core import drainer as ref_drainer
from nomad_tpu.core import heartbeat as ref_heartbeat
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.scheduler import reconcile as ref_reconcile
from nomad_tpu.structs import Volume as RefVolume
from nomad_tpu.structs import VolumeRequest as RefVolumeRequest
from nomad_tpu.structs.job import MigrateStrategy as RefMigrate
from nomad_tpu.structs.job import UpdateStrategy as RefUpdate
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.node import DrainStrategy as RefDrain
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import core_sched as port_core_sched
from nomad_tpu_torch.core import deployments as port_deployments
from nomad_tpu_torch.core import drainer as port_drainer
from nomad_tpu_torch.core import heartbeat as port_heartbeat
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.scheduler import reconcile as port_reconcile
from nomad_tpu_torch.structs import Volume, VolumeRequest, enums
from nomad_tpu_torch.structs.job import MigrateStrategy, UpdateStrategy
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.node import DrainStrategy
from nomad_tpu_torch.tensor import solver as port_solver

from test_torch_bulk_scan import over_capacity

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, server=ref_server, hb=ref_heartbeat,
    Update=RefUpdate, Migrate=RefMigrate, Drain=RefDrain, Volume=RefVolume,
    Request=RefVolumeRequest, operator=ref_operator, extra={})
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, server=port_server, hb=port_heartbeat,
    Update=UpdateStrategy, Migrate=MigrateStrategy, Drain=DrainStrategy,
    Volume=Volume, Request=VolumeRequest, operator=port_operator,
    extra={"device": "cpu"})

CLOCKED = (ref_drainer, ref_deployments, ref_core_sched, port_drainer,
           port_deployments, port_core_sched)


class Clock:
    """The actors' ``time``: the wall clock plus a skew the test moves."""

    def __init__(self):
        self.skew = 0.0

    def time(self):
        return time.time() + self.skew

    def advance(self, seconds):
        self.skew += seconds


@pytest.fixture
def clock(monkeypatch):
    """Pinned ids in every module that mints them, and the actors' clock
    pinned."""
    clk = Clock()
    shim = types.SimpleNamespace(time=clk.time, monotonic=time.monotonic,
                                 perf_counter=time.perf_counter,
                                 sleep=time.sleep)
    for mod in CLOCKED:
        monkeypatch.setattr(mod, "time", shim)
    clk.shim = shim

    def pin(mod, name, prefix):
        counter = itertools.count()
        monkeypatch.setattr(mod, name, lambda c=counter:
                            f"{prefix}{next(c):06x}-0000-0000-0000-"
                            "000000000000")

    for pkg_mods in ((ref_server, ref_generic, ref_reconcile,
                      ref_deployments, ref_utils),
                     (port_server, port_generic, port_reconcile,
                      port_deployments, port_drainer)):
        for prefix, mod in zip("abcde", pkg_mods):
            pin(mod, "generate_uuid", f"{prefix}0")
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])
    return clk


def both(fn):
    """``fn(pkg)`` in each package; the answers must be equal."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def threadless(mgr):
    """The heartbeat plane on, with no shard thread: expiries fire only
    through ``fire``."""
    def set_enabled(on):
        for sh in mgr._shards:
            with sh.cond:
                sh.stop = not on
                if not on:
                    sh.deadlines.clear()
                    sh.heap.clear()

    mgr.set_enabled = set_enabled
    return mgr


def fire(mgr):
    """One pass of every shard's expiry loop at ``mgr._now()``."""
    for sh in mgr._shards:
        with sh.cond:
            due = mgr._collect_due_locked(sh, mgr._now())
        if due:
            mgr._expire(due)


def make_server(pkg, n_nodes=8, **kw):
    """A one-worker Server with every actor thread held off and the
    bench-safe TTL; ``n_nodes`` ready nodes with pinned ids."""
    cfg = dict(num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
               gc_interval=3600, nack_timeout=900.0)
    cfg.update(kw)
    srv = pkg.server.Server(pkg.server.ServerConfig(**cfg, **pkg.extra))
    srv.deployment_watcher.start = lambda: None
    srv.drainer.start = lambda: None
    srv.core_gc.start = lambda: None
    threadless(srv.heartbeats)
    for i in range(n_nodes):
        srv.store.upsert_node(pkg.mock.node(id=f"an-{i:03d}",
                                            name=f"an-{i:03d}"))
    return srv


def idle(srv):
    assert srv.wait_for_idle(60.0, include_delayed=False)


def job(pkg, tag, count=3, update=True, **strategy):
    """A service job; ``update=False`` opens no deployment."""
    j = pkg.mock.job(id=tag, name=tag)
    j.task_groups[0].count = count
    j.task_groups[0].update = (pkg.Update(min_healthy_time_s=0.0, **strategy)
                               if update else None)
    return j


def live(srv, job_id):
    return [a for a in srv.store.snapshot().allocs_by_job(job_id)
            if not a.terminal_status() and not a.server_terminal()]


def report(srv, allocs, status=enums.ALLOC_CLIENT_RUNNING, healthy=None):
    """The clients' report of ``allocs``."""
    ups = []
    for a in allocs:
        u = copy.copy(a)
        u.client_status = status
        if healthy is not None:
            u.deployment_status = {"healthy": healthy}
        if status in (enums.ALLOC_CLIENT_FAILED,
                      enums.ALLOC_CLIENT_COMPLETE):
            u.task_finished_at = time.time()
        ups.append(u)
    srv.update_allocs_from_client(ups)


def start_job(srv, j):
    """Register, place, and report every alloc running and healthy."""
    srv.register_job(j)
    idle(srv)
    report(srv, live(srv, j.id), healthy=True)
    return srv.store.snapshot().job_by_id(j.id)


def bump(pkg, srv, j, **update):
    j2 = copy.deepcopy(j)
    j2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
    j2.task_groups[0].update = pkg.Update(min_healthy_time_s=0.0, **update)
    srv.register_job(j2)
    idle(srv)
    return srv.store.snapshot().job_by_id(j.id)


def tick(srv):
    srv.deployment_watcher._tick()
    idle(srv)


def hold_delayed(srv):
    """No delay thread: the broker's delayed evals wait for
    ``release_delayed``."""
    srv.broker._run_delay = lambda gen: None


def release_delayed(srv):
    """Every delayed eval made due, as the broker's delay thread does
    once its ``wait_until`` passes."""
    b = srv.broker
    with b._lock:
        while b._delay:
            _, _, ev = heapq.heappop(b._delay)
            ev = copy.copy(ev)
            ev.wait_until = 0.0
            b._enqueue_locked(ev)
        b._lock.notify_all()
    idle(srv)


def rows(srv, job_id):
    return sorted((a.name, a.node_id, a.job_version, a.desired_status,
                   a.client_status)
                  for a in srv.store.snapshot().allocs_by_job(job_id))


def dep_states(srv, job_id):
    return [(d.job_version, d.status, d.status_description,
             {k: (s.promoted, s.desired_canaries, s.desired_total)
              for k, s in d.task_groups.items()})
            for d in sorted(srv.store.snapshot().deployments_by_job(job_id),
                            key=lambda d: d.create_index)]


# --------------------------------------------------------------------------
# the heartbeat manager (tests/test_heartbeat.py), _now stubbed
# --------------------------------------------------------------------------


class FakeServer:
    """Records mark-down calls; raises when asked (a refused mark)."""

    def __init__(self, fail=False):
        self.marks = []
        self.fail = fail

    def mark_nodes_down(self, node_ids, reason=""):
        if self.fail:
            raise RuntimeError("refused")
        self.marks.extend(node_ids)

    def mark_node_down(self, node_id, reason=""):
        self.mark_nodes_down([node_id], reason=reason)


def manager(pkg, ttl=10.0, shards=4, **kw):
    srv = FakeServer(fail=kw.pop("fail", False))
    mgr = pkg.hb.HeartbeatManager(srv, ttl=ttl, shards=shards, **kw)
    now = [100.0]
    mgr._now = lambda: now[0]
    mgr._bucket_ts = now[0]
    threadless(mgr).set_enabled(True)
    return srv, mgr, now


def test_reset_returns_ttl_and_noops_when_disabled():
    def run(pkg):
        srv = FakeServer()
        mgr = threadless(pkg.hb.HeartbeatManager(srv, ttl=7.5, shards=2))
        out = [mgr.reset("n1"), mgr.active(), mgr.armed("n1")]
        mgr.set_enabled(True)
        out += [mgr.reset("n1"), mgr.armed("n1"), mgr.active()]
        mgr.set_enabled(False)
        return out + [mgr.active(), mgr.enabled]

    assert both(run) == [7.5, 0, False, 7.5, True, 1, 0, False]


def test_expiry_across_shards_marks_batch_down():
    def run(pkg):
        srv, mgr, now = manager(pkg)
        ids = [f"n{i}" for i in range(24)]
        for nid in ids:
            mgr.reset(nid)
        depth = sum(mgr.shard_depths())
        now[0] += 9.9
        fire(mgr)
        early = list(srv.marks)
        now[0] += 0.2
        fire(mgr)
        spans = {round(exp - armed, 6)
                 for _, armed, exp in mgr.expiry_snapshot()}
        return (depth, early, sorted(srv.marks), mgr.active(),
                mgr.stats["invalidated"], spans)

    got = both(run)
    assert got[0] == 24 and got[1] == [] and len(got[2]) == 24
    assert got[5] == {10.1}


def test_heartbeat_before_ttl_prevents_expiry():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=3.0)
        for _ in range(10):             # 3+ TTLs, never silent
            now[0] += 1.0
            mgr.reset("live")
            fire(mgr)
        alive = list(srv.marks)
        now[0] += 3.0
        fire(mgr)
        return alive, srv.marks

    assert both(run) == ([], ["live"])


def test_restore_dedups_ignores_empty_and_arms_unknown_ids():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=2.0)
        armed = mgr.restore(["dup", "dup", "", "ghost"])
        active = mgr.active()
        now[0] += 2.0
        fire(mgr)
        fire(mgr)
        return armed, active, sorted(srv.marks)

    assert both(run) == (2, 2, ["dup", "ghost"])


def test_restore_grace_clamps_preexisting_deadlines():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=4.0)
        mgr.reset("old")                # deadline 104
        now[0] += 3.0
        mgr.restore(["failover"])       # grace horizon 107
        now[0] += 1.5                   # 104.5: "old" is past its deadline
        fire(mgr)
        clamped = list(srv.marks)
        now[0] += 2.5                   # 107: the horizon
        fire(mgr)
        return clamped, sorted(srv.marks)

    assert both(run) == ([], ["failover", "old"])


def test_remove_racing_expiry_never_double_marks():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=0.5, shards=2)
        for rnd in range(30):
            nid = f"race-{rnd}"
            mgr.reset(nid)
            if rnd % 2:
                mgr.remove(nid)
            mgr._invalidate(nid)
            mgr.remove(nid)
        now[0] += 1.0
        fire(mgr)
        return srv.marks

    marks = both(run)
    assert marks == [f"race-{r}" for r in range(0, 30, 2)]


def test_removed_node_is_not_expired():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=1.5)
        mgr.reset("gone")
        mgr.reset("stays")
        mgr.remove("gone")
        state = (mgr.armed("gone"), mgr.armed("stays"))
        now[0] += 5.0
        fire(mgr)
        fire(mgr)
        return state, srv.marks

    assert both(run) == ((False, True), ["stays"])


def test_set_enabled_false_joins_the_shard_threads():
    def run(pkg):
        mgr = pkg.hb.HeartbeatManager(FakeServer(), ttl=3600, shards=3)
        mgr.set_enabled(True)
        mgr.reset("victim")
        threads = [sh.thread for sh in mgr._shards]
        alive = all(t.is_alive() for t in threads)
        mgr.set_enabled(False)
        mgr.reset("victim")             # after disable: no resurrection
        return alive, any(t.is_alive() for t in threads), mgr.active()

    assert both(run) == (True, False, 0)


def test_mark_failure_is_swallowed_and_counted():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=1.0, shards=2, fail=True)
        mgr.reset("n1")
        now[0] += 2.0
        fire(mgr)
        return mgr.stats["mark_failed"], mgr.stats["invalidated"]

    assert both(run) == (1, 1)


def test_expiry_rate_limiter_paces_mass_expiry():
    def run(pkg):
        srv, mgr, now = manager(pkg, ttl=1.0, shards=2, expiry_rate=20.0)
        ids = [f"n{i}" for i in range(40)]
        for nid in ids:
            mgr.reset(nid)
        now[0] += 1.0
        waves = []
        for _ in range(6):
            fire(mgr)
            waves.append(len(srv.marks))
            now[0] += 0.5
        return waves, mgr.stats["rate_limited"], sorted(srv.marks)

    waves, limited, marks = both(run)
    assert waves[0] == 20 and waves[-1] == 40 and limited > 0
    assert marks == sorted(f"n{i}" for i in range(40))


# --------------------------------------------------------------------------
# heartbeats through the Server, and the mark_nodes_down race
# --------------------------------------------------------------------------


def test_silent_nodes_are_marked_down_and_their_allocs_replaced(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=6, heartbeat_ttl=10.0)
        now = [1000.0]
        srv.heartbeats._now = lambda: now[0]
        srv.heartbeats._bucket_ts = now[0]
        with srv:
            srv.register_job(job(pkg, "hb", count=12, max_parallel=12))
            idle(srv)
            live_ids = [f"an-{i:03d}" for i in range(4)]
            for _ in range(3):
                now[0] += 4.0
                assert srv.heartbeat_batch(live_ids) == 10.0
                fire(srv.heartbeats)
            down = sorted(n.id for n in srv.store.snapshot().nodes()
                          if n.status == enums.NODE_STATUS_DOWN)
            idle(srv)
            placed = rows(srv, "hb")
            on_down = [a for a in live(srv, "hb") if a.node_id in down]
            # a down node that heartbeats again comes back
            srv.heartbeat("an-004")
            back = srv.store.snapshot().node_by_id("an-004").status
            assert over_capacity(srv.store) == []
        return down, placed, on_down, back, srv.heartbeats.stats

    down, placed, on_down, back, stats = both(run)
    assert down == ["an-004", "an-005"] and on_down == []
    assert back == enums.NODE_STATUS_READY and stats["invalidated"] == 2
    assert sum(1 for r in placed if r[3] == enums.ALLOC_DESIRED_RUN) == 12


def test_mark_nodes_down_skips_a_node_whose_ttl_was_rearmed(clock):
    """Expiry collection and the mark-down commit are not atomic: a node
    that heartbeated after its expiry was collected is skipped, and one
    whose heartbeat lands while the mark commits flips back to ready."""
    def run(pkg):
        srv = make_server(pkg, n_nodes=0)
        with srv:
            for i in range(3):
                srv.register_node(pkg.mock.node(id=f"rn-{i}", name=f"rn-{i}"))
            srv.mark_nodes_down(["rn-0"])           # armed: skipped
            skipped = srv.store.snapshot().node_by_id("rn-0").status
            for nid in ("rn-1", "rn-2"):
                srv.heartbeats.remove(nid)          # their TTLs fired
            real = srv.store.update_nodes_status

            def racing(node_ids, status, ts=None):
                out = real(node_ids, status, ts=ts)
                if status == enums.NODE_STATUS_DOWN:
                    srv.heartbeats.reset("rn-1")    # a heartbeat lands
                return out

            srv.store.update_nodes_status = racing
            srv.mark_nodes_down(["rn-1", "rn-2"])
            snap = srv.store.snapshot()
            out = (skipped, snap.node_by_id("rn-1").status,
                   snap.node_by_id("rn-2").status,
                   srv.heartbeats.armed("rn-1"), srv.heartbeats.armed("rn-2"))
        return out

    assert both(run) == (enums.NODE_STATUS_READY, enums.NODE_STATUS_READY,
                         enums.NODE_STATUS_DOWN, True, False)


def test_stop_leaves_no_actor_thread():
    def run(pkg):
        srv = pkg.server.Server(pkg.server.ServerConfig(
            num_workers=1, heartbeat_ttl=3600, gc_interval=3600,
            **pkg.extra))
        srv.start()
        srv.register_node(pkg.mock.node(id="st-0", name="st-0"))
        threads = ([sh.thread for sh in srv.heartbeats._shards]
                   + [srv.deployment_watcher._thread, srv.drainer._thread,
                      srv.core_gc._thread])
        started = sorted({t.name.rsplit("-", 1)[0] if "shard" in t.name
                          else t.name for t in threads})
        srv.stop()
        return started, [t.name for t in threads if t.is_alive()]

    started, alive = both(run)
    assert started == ["core-gc", "deployment-watcher", "heartbeat-shard",
                       "node-drainer"]
    assert alive == []


# --------------------------------------------------------------------------
# the deployment watcher (tests/test_deployments.py), clock pinned
# --------------------------------------------------------------------------


def test_operator_fail_deployment(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "op", count=2, canary=1))
            j = bump(pkg, srv, j, canary=1)
            dep = srv.store.snapshot().latest_deployment_by_job(j.id)
            srv.fail_deployment(dep.id)
            with pytest.raises(ValueError):
                srv.fail_deployment(dep.id)
            with pytest.raises(KeyError):
                srv.fail_deployment("nope")
            return dep_states(srv, j.id)

    got = both(run)
    assert got[-1][1] == enums.DEPLOYMENT_STATUS_FAILED


def test_watcher_initial_deployment_succeeds_when_healthy(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            start_job(srv, job(pkg, "ok", count=3))
            tick(srv)
            return dep_states(srv, "ok"), srv.deployment_watcher.stats

    states, stats = both(run)
    assert states[-1][1] == enums.DEPLOYMENT_STATUS_SUCCESSFUL
    assert stats["succeeded"] == 1


def test_watcher_auto_promotes_healthy_canaries(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "ap", count=3, canary=1,
                                   auto_promote=True))
            tick(srv)
            j = bump(pkg, srv, j, canary=1, auto_promote=True)
            tick(srv)
            held = dep_states(srv, j.id)[-1]
            canaries = [a for a in live(srv, j.id) if a.canary]
            report(srv, canaries, healthy=True)
            tick(srv)
            return (held, dep_states(srv, j.id), rows(srv, j.id),
                    srv.deployment_watcher.stats["auto_promoted"])

    held, states, _, promoted = both(run)
    assert not held[3]["web"][0] and states[-1][3]["web"][0]
    assert promoted == 1


def test_watcher_failed_alloc_fails_deployment(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "fa", count=2, canary=1))
            j = bump(pkg, srv, j, canary=1)
            report(srv, [a for a in live(srv, j.id) if a.canary],
                   enums.ALLOC_CLIENT_FAILED)
            tick(srv)
            return dep_states(srv, j.id), srv.deployment_watcher.stats

    states, stats = both(run)
    assert states[-1][1] == enums.DEPLOYMENT_STATUS_FAILED
    assert stats["failed"] == 1 and stats["reverted"] == 0


def test_watcher_auto_revert_restores_prior_version(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "ar", count=2, canary=1,
                                   auto_revert=True))
            j = bump(pkg, srv, j, canary=1, auto_revert=True)
            report(srv, [a for a in live(srv, j.id) if a.canary],
                   enums.ALLOC_CLIENT_FAILED)
            tick(srv)
            reverted = srv.store.snapshot().job_by_id(j.id)
            return (dep_states(srv, j.id), reverted.version,
                    reverted.task_groups[0].tasks[0].config,
                    srv.deployment_watcher.stats["reverted"],
                    rows(srv, j.id))

    states, version, config, reverted, _ = both(run)
    assert states[1][1] == enums.DEPLOYMENT_STATUS_FAILED
    assert (version, config, reverted) == (2, {"command": "/bin/date"}, 1)


def test_rescheduled_canary_opens_a_deployment_of_the_reverted_version(
        clock, monkeypatch):
    """The failed canary's reschedule (its policy's 5 s delay) comes due
    after the auto-revert: the reconciler places its replacement under
    the reverted version, which opens a deployment of that version, and
    stops it at once (its index is past the count). That deployment
    stays running with no alloc left in it, and every live alloc is on
    the reverted version at the group's count, in the reference as in
    the port."""
    for mod in (ref_reconcile, port_reconcile):
        monkeypatch.setattr(mod, "_time", clock.shim)

    def run(pkg):
        srv = make_server(pkg, n_nodes=6)
        hold_delayed(srv)
        with srv:
            j = start_job(srv, job(pkg, "rr", count=4, max_parallel=2))
            tick(srv)
            j = bump(pkg, srv, j, canary=1, max_parallel=2,
                     auto_revert=True)
            report(srv, [a for a in live(srv, j.id) if a.canary],
                   enums.ALLOC_CLIENT_FAILED)
            idle(srv)
            tick(srv)  # fails the deployment, registers the prior version
            reverted = srv.store.snapshot().job_by_id(j.id).version
            before = dep_states(srv, j.id)
            clock.advance(10.0)
            release_delayed(srv)
            tick(srv)
            snap = srv.store.snapshot()
            dep_version = {d.id: d.job_version
                           for d in snap.deployments_by_job(j.id)}
            placed = sorted((a.name, a.job_version, a.canary,
                             dep_version.get(a.deployment_id),
                             a.desired_status, a.client_status)
                            for a in snap.allocs_by_job(j.id))
            by_version = sorted((a.job_version, a.name)
                                for a in live(srv, j.id))
            clock.advance(-10.0)
            return reverted, before, dep_states(srv, j.id), placed, by_version

    reverted, before, states, placed, by_version = both(run)
    assert reverted == 2 and [s[0] for s in before] == [0, 1]
    assert states[-1][:2] == (2, enums.DEPLOYMENT_STATUS_RUNNING)
    assert ("rr.web[4]", 2, False, 2, "stop", "pending") in placed
    assert by_version == [(2, f"rr.web[{i}]") for i in range(4)]


def test_a_stale_canary_plan_rewrites_the_failed_deployment(clock):
    """A canary plan scheduled against the running deployment commits
    after the watcher failed it and reverted the job: the plan's copy of
    the deployment (status running) is written over the failed row, and
    the watcher's next pass cancels it as superseded by the reverted
    version. The reverted job's live allocs are all on its version at
    the group's count all the same; in the reference as in the port."""
    def run(pkg):
        srv = make_server(pkg, n_nodes=6)
        hold_delayed(srv)
        commit = srv.store.upsert_plan_results_batch
        raced = []

        def racing(payloads):
            # the first canary plan of the bad version: the watcher
            # passes between its scheduling and its commit
            if not raced and any(
                    p.get("deployment") is not None
                    and p["deployment"].job_version == 1
                    and any(a.canary for a in p.get("result_allocs", ()))
                    for p in payloads):
                raced.append(True)
                srv.deployment_watcher._tick()
            return commit(payloads)

        with srv:
            j = start_job(srv, job(pkg, "sp", count=4, max_parallel=2))
            tick(srv)
            j = bump(pkg, srv, j, canary=1, max_parallel=2,
                     auto_revert=True)
            srv.store.upsert_plan_results_batch = racing
            report(srv, [a for a in live(srv, j.id) if a.canary],
                   enums.ALLOC_CLIENT_FAILED)
            idle(srv)
            rewritten = dep_states(srv, j.id)
            tick(srv)
            by_version = sorted((a.job_version, a.name)
                                for a in live(srv, j.id))
            return (raced, rewritten, dep_states(srv, j.id),
                    srv.deployment_watcher.stats, by_version)

    raced, rewritten, states, stats, by_version = both(run)
    assert raced == [True]
    assert rewritten[1][:2] == (1, enums.DEPLOYMENT_STATUS_RUNNING)
    assert states[1][:3] == (1, enums.DEPLOYMENT_STATUS_CANCELLED,
                             "superseded by a newer job version")
    assert stats["failed"] == 1 and stats["reverted"] == 1
    assert by_version == [(2, f"sp.web[{i}]") for i in range(4)]


def test_watcher_progress_deadline_fails_deployment(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "pd", count=2, canary=1))
            j = bump(pkg, srv, j, canary=1, progress_deadline_s=60.0)
            tick(srv)
            before = dep_states(srv, j.id)[-1][1]
            clock.advance(120.0)
            tick(srv)
            clock.advance(-120.0)
            return before, dep_states(srv, j.id)

    before, states = both(run)
    assert before == enums.DEPLOYMENT_STATUS_RUNNING
    assert states[-1][1] == enums.DEPLOYMENT_STATUS_FAILED
    assert "deadline" in states[-1][2]


def test_watcher_cancels_a_superseded_deployment(clock):
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "sc", count=2, canary=1))
            j = bump(pkg, srv, j, canary=1)
            j = bump(pkg, srv, j, canary=1)
            tick(srv)
            return dep_states(srv, j.id)

    states = both(run)
    assert states[1][1] == enums.DEPLOYMENT_STATUS_CANCELLED


def test_deployment_rolls_out_and_succeeds(clock):
    """tests/test_subsystems.py::TestDeployments's rolling update: v1
    rolls one alloc at a time as the clients report the new allocs
    healthy and the watcher's follow-up evals move the update on."""
    def run(pkg):
        srv = make_server(pkg)
        with srv:
            j = start_job(srv, job(pkg, "roll", count=3))
            tick(srv)
            j = bump(pkg, srv, j, canary=0)
            for _ in range(12):
                fresh = [a for a in live(srv, j.id)
                         if a.job_version == j.version
                         and a.client_status == enums.ALLOC_CLIENT_PENDING]
                report(srv, fresh, healthy=True)
                tick(srv)
                states = dep_states(srv, j.id)
                if states[-1][1] != enums.DEPLOYMENT_STATUS_RUNNING:
                    break
            return states, rows(srv, j.id)

    states, got = both(run)
    assert [s[1] for s in states] == [enums.DEPLOYMENT_STATUS_SUCCESSFUL] * 2
    assert sum(1 for r in got if r[2] == 1 and r[3] == "run") == 3


# --------------------------------------------------------------------------
# the drainer (tests/test_subsystems.py::TestDrainer), clock pinned
# --------------------------------------------------------------------------


def inflight(srv, node_id):
    """Per (job, group) on the node: allocs marked or stopped that the
    client has not reported terminal."""
    out = {}
    for a in srv.store.snapshot().allocs_by_node(node_id):
        if a.client_terminal():
            continue
        if a.desired_transition.migrate or a.server_terminal():
            out[a.job_id] = out.get(a.job_id, 0) + 1
    return out


def drain_until_done(srv, node_ids, job_ids, max_parallel, rounds=20):
    """Drainer ticks, the workers, and the clients' reports (a stopped
    alloc completes, a new one runs), until every drain ends. Returns
    the marks per tick and the most in flight ever seen."""
    marks, peak = [], 0
    for _ in range(rounds):
        before = srv.drainer.stats["migrations_marked"]
        srv.drainer._tick()
        marks.append(srv.drainer.stats["migrations_marked"] - before)
        for nid in node_ids:
            for n in inflight(srv, nid).values():
                peak = max(peak, n)
        idle(srv)
        snap = srv.store.snapshot()
        stopped = [a for jid in job_ids for a in snap.allocs_by_job(jid)
                   if a.server_terminal() and not a.client_terminal()]
        fresh = [a for jid in job_ids for a in snap.allocs_by_job(jid)
                 if not a.server_terminal()
                 and a.client_status == enums.ALLOC_CLIENT_PENDING]
        report(srv, stopped, enums.ALLOC_CLIENT_COMPLETE)
        report(srv, fresh)
        idle(srv)
        if not any(srv.store.snapshot().node_by_id(n).drain
                   for n in node_ids):
            break
    assert peak <= max_parallel
    return marks, peak


def test_drain_migrates_all_allocs_paced(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=4)
        with srv:
            j = job(pkg, "dr", count=8)
            j.task_groups[0].migrate = pkg.Migrate(max_parallel=2)
            start_job(srv, j)
            node = sorted(a.node_id for a in live(srv, j.id))[0]
            on = len([a for a in live(srv, j.id) if a.node_id == node])
            srv.update_node_drain(node, pkg.Drain(deadline_s=600.0))
            idle(srv)
            marks, peak = drain_until_done(srv, [node], [j.id], 2)
            n = srv.store.snapshot().node_by_id(node)
            left = [a for a in srv.store.snapshot().allocs_by_node(node)
                    if not a.client_terminal()]
            assert over_capacity(srv.store) == []
            return (on, marks, peak, n.drain, n.scheduling_eligibility,
                    left, len(live(srv, j.id)), srv.drainer.stats)

    on, marks, peak, drain, elig, left, n_live, stats = both(run)
    assert on > 2 and peak == 2 and sum(marks) == on
    assert (drain, elig, left, n_live) == (False, "ineligible", [], 8)
    assert stats["drains_completed"] == 1


def test_drain_paces_by_max_parallel(clock):
    """No second node: migrations cannot complete, so the marks stay at
    max_parallel=1."""
    def run(pkg):
        srv = make_server(pkg, n_nodes=1)
        with srv:
            start_job(srv, job(pkg, "one", count=3))
            srv.update_node_drain("an-000", pkg.Drain(deadline_s=3600.0))
            idle(srv)
            for _ in range(3):
                srv.drainer._tick()
                idle(srv)
            return inflight(srv, "an-000"), srv.drainer.stats

    flight, stats = both(run)
    assert flight == {"one": 1} and stats["migrations_marked"] == 1


def test_drain_deadline_forces_the_rest(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=1)
        with srv:
            start_job(srv, job(pkg, "force", count=3))
            srv.update_node_drain("an-000", pkg.Drain(deadline_s=30.0))
            idle(srv)
            srv.drainer._tick()
            paced = srv.drainer.stats["migrations_marked"]
            clock.advance(60.0)
            srv.drainer._tick()
            clock.advance(-60.0)
            idle(srv)
            return paced, srv.drainer.stats["migrations_marked"]

    assert both(run) == (1, 3)


def test_drain_ignores_system_jobs_and_down_nodes_release(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=2)
        with srv:
            sysjob = pkg.mock.system_job(id="sys", name="sys")
            srv.register_job(sysjob)
            idle(srv)
            report(srv, live(srv, "sys"))
            srv.update_node_drain("an-000", pkg.Drain(
                deadline_s=600.0, ignore_system_jobs=True))
            idle(srv)
            srv.drainer._tick()
            ignored = (srv.store.snapshot().node_by_id("an-000").drain,
                       srv.drainer.stats["drains_completed"])
            # a down node: server-terminal allocs no longer hold the drain
            srv.update_node_drain("an-001", pkg.Drain(deadline_s=600.0))
            idle(srv)
            srv.heartbeats.remove("an-001")
            srv.mark_nodes_down(["an-001"])
            idle(srv)
            srv.drainer._tick()
            released = srv.store.snapshot().node_by_id("an-001").drain
            return ignored, released, srv.drainer.stats

    ignored, released, stats = both(run)
    assert ignored == (False, 1) and released is False
    assert stats["drains_completed"] == 2


# --------------------------------------------------------------------------
# core GC (tests/test_subsystems.py::TestCoreGC) with node delete
# --------------------------------------------------------------------------


# the collectors' counts; ``rows_compacted`` counts rows of each
# package's own table layout (the port's compaction also drops the
# index keys that GC emptied), and ``acl_tokens`` is the reference's alone
GC_KEYS = ("evals", "allocs", "jobs", "deployments", "nodes",
           "volume_claims")


def gc_stats(stats):
    return {k: stats[k] for k in GC_KEYS}


def test_gc_dead_job_and_evals(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=2)
        with srv:
            j = job(pkg, "dead", count=2, update=False)
            srv.register_job(j)
            idle(srv)
            srv.deregister_job(j.id)
            idle(srv)
            report(srv, [a for a in srv.store.snapshot().allocs_by_job(j.id)],
                   enums.ALLOC_CLIENT_COMPLETE)
            stats = srv.force_gc()
            assert stats["rows_compacted"] > 0
            snap = srv.store.snapshot()
            return (gc_stats(stats), snap.job_by_id(j.id),
                    snap.evals_by_job(j.id),
                    snap.allocs_by_job(j.id))

    stats, gone, evals, allocs = both(run)
    assert gone is None and evals == [] and allocs == []
    assert stats["jobs"] == 1 and stats["allocs"] == 2


def test_gc_down_node_and_its_slot(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=3)
        with srv:
            srv.register_job(job(pkg, "keep", count=2, update=False))
            idle(srv)
            srv.update_node_status("an-002", enums.NODE_STATUS_DOWN)
            idle(srv)
            stats = srv.core_gc.force_gc(threshold_override=0.0)
            snap = srv.store.snapshot()
            return (stats["nodes"], snap.node_by_id("an-002"),
                    sorted(n.id for n in snap.nodes()))

    n, gone, left = both(run)
    assert (n, gone, left) == (1, None, ["an-000", "an-001"])


def test_gc_keeps_live_jobs(clock):
    def run(pkg):
        srv = make_server(pkg, n_nodes=2)
        with srv:
            srv.register_job(job(pkg, "live", count=10, update=False))
            idle(srv)
            stats = srv.core_gc.force_gc(threshold_override=0.0)
            snap = srv.store.snapshot()
            return (stats["jobs"], snap.job_by_id("live") is not None,
                    len(snap.allocs_by_job("live")))

    assert both(run) == (0, True, 10)


@pytest.fixture
def solvers(monkeypatch):
    """Private solver services for both packages' "tpu-binpack"."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    port_svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port_svc)
    yield
    ref_svc.stop()
    port_svc.stop()


def test_gc_drops_block_positions_deletes_down_nodes_and_reaps_claims(
        clock, solvers):
    """The autopilot phase's GC step at CPU size: a batch job placed as
    one AllocBlock is deregistered and its allocs completed; a CSI
    writer on a node that goes down is replaced in its zone; force_gc
    drops the block's positions, deletes the job, its evals and the down
    node, and releases the dead writer's claim."""
    def run(pkg):
        srv = make_server(pkg, n_nodes=8, sched_config=pkg.operator.
                          SchedulerConfiguration(
                              scheduler_algorithm="tpu-binpack"))
        with srv:
            srv.register_volume(pkg.Volume(
                id="pg", topology_node_ids=["an-001", "an-005"]))
            big = pkg.mock.batch_job(id="blk", name="blk")
            big.task_groups[0].count = 300
            big.task_groups[0].tasks[0].resources.cpu = 10
            big.task_groups[0].tasks[0].resources.memory_mb = 8
            srv.register_job(big)
            csi = job(pkg, "csi", count=1, update=False)
            csi.task_groups[0].volumes = {"pg": pkg.Request(
                name="pg", type="csi", source="pg")}
            srv.register_job(csi)
            idle(srv)
            blocks = [bid for bid, _ in srv.store._alloc_blocks.iterate(
                srv.store.latest_index)]
            (writer,) = live(srv, "csi")
            srv.heartbeats.remove(writer.node_id)
            srv.mark_nodes_down([writer.node_id])
            idle(srv)
            (repl,) = live(srv, "csi")
            srv.deregister_job("blk")
            idle(srv)
            report(srv, [a for a in srv.store.snapshot().allocs_by_job("blk")
                         if not a.client_terminal()],
                   enums.ALLOC_CLIENT_COMPLETE)
            stats = srv.force_gc()
            snap = srv.store.snapshot()
            vol = snap.volume_by_id("pg")
            return (len(blocks), writer.node_id, repl.node_id,
                    gc_stats(stats),
                    snap.job_by_id("blk"), snap.allocs_by_job("blk"),
                    snap.node_by_id(writer.node_id),
                    sorted(vol.claims), srv.store._alloc_blocks.get_latest(
                        blocks[0]) if blocks else None)

    (n_blocks, old, new, stats, job_left, allocs_left, node_left, claims,
     block_left) = both(run)
    assert n_blocks == 1 and {old, new} == {"an-001", "an-005"}
    assert (job_left, allocs_left, node_left, block_left) == (
        None, [], None, None)
    assert stats["jobs"] == 1 and stats["nodes"] == 1
    assert stats["allocs"] >= 300 and stats["volume_claims"] == 1
    assert len(claims) == 1
