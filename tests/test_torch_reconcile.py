"""The allocation lifecycle through both packages' Harnesses
(nomad_tpu_torch/scheduler/reconcile.py, generic_sched.py, util.py and
the store's lifecycle writes, against nomad_tpu's): every scenario of
tests/test_reconcile_scenarios.py (canaries, promotion, failed
deployments, disconnect, reconnect), the lifecycle cases of
tests/test_generic_sched.py (failed now and later, node down, drain,
destructive update, scale down, batch complete, exhausted policy, scale
down during migration), an in-place update, a bulk-filled group of
AllocBlocks losing a node, and more than 16 rescheduled requests
through the per-eval kernel (B9) with their node penalties. Each
scenario is written once and run on both packages with pinned ids and a
pinned clock; the rows (each alloc's name, node, job version, statuses,
predecessor's name, next/follow-up links and canary flag, each created
eval's trigger and wait_until, each deployment's group states and each
eval's final status) must be exactly equal. Also should_reschedule and
reschedule_delay over a grid of policies and attempts, and
tasks_updated over a table of spec changes."""

import copy
import itertools
import types

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.scheduler import reconcile as ref_reconcile
from nomad_tpu.scheduler import system_sched as ref_system
from nomad_tpu.scheduler import util as ref_util
from nomad_tpu.structs import Affinity as RefAffinity
from nomad_tpu.structs import Constraint as RefConstraint
from nomad_tpu.structs import DrainStrategy as RefDrain
from nomad_tpu.structs import Spread as RefSpread
from nomad_tpu.structs import enums as ref_enums
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.alloc import DesiredTransition as RefTransition
from nomad_tpu.structs.alloc import RescheduleEvent as RefEvent
from nomad_tpu.structs.alloc import RescheduleTracker as RefTracker
from nomad_tpu.structs.job import ReschedulePolicy as RefPolicy
from nomad_tpu.structs.job import UpdateStrategy as RefUpdate
from nomad_tpu.structs.resources import NetworkResource as RefNetwork
from nomad_tpu.structs.resources import RequestedDevice as RefDevice
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.scheduler import reconcile as port_reconcile
from nomad_tpu_torch.scheduler import system_sched as port_system
from nomad_tpu_torch.scheduler import util as port_util
from nomad_tpu_torch.structs import (Affinity, Constraint, DesiredTransition,
                                     DrainStrategy, RescheduleEvent,
                                     RescheduleTracker, Spread, enums)
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.job import ReschedulePolicy, UpdateStrategy
from nomad_tpu_torch.structs.resources import NetworkResource, RequestedDevice
from nomad_tpu_torch.tensor import kernels as port_kernels
from nomad_tpu_torch.tensor import placer as port_placer
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_bulk_scan import over_capacity
from test_torch_pipeline import port_service  # noqa: F401

T0 = 1_700_000_000.0   # the pinned clock
WINDOW = 60.0          # max_client_disconnect of the disconnect cases

REF = types.SimpleNamespace(
    name="ref", mock=ref_mock, enums=ref_enums, harness=RefHarness,
    Update=RefUpdate, Drain=RefDrain, Transition=RefTransition,
    Policy=RefPolicy, Tracker=RefTracker, Event=RefEvent,
    Constraint=RefConstraint, Affinity=RefAffinity, Spread=RefSpread,
    Network=RefNetwork, Device=RefDevice, reconcile=ref_reconcile,
    util=ref_util, config=ref_operator.SchedulerConfiguration,
    modules=(ref_generic, ref_reconcile, ref_system))
PORT = types.SimpleNamespace(
    name="port", mock=port_mock, enums=enums,
    harness=lambda: PortHarness(device="cpu"),
    Update=UpdateStrategy, Drain=DrainStrategy, Transition=DesiredTransition,
    Policy=ReschedulePolicy, Tracker=RescheduleTracker, Event=RescheduleEvent,
    Constraint=Constraint, Affinity=Affinity, Spread=Spread,
    Network=NetworkResource, Device=RequestedDevice,
    reconcile=port_reconcile, util=port_util,
    config=port_operator.SchedulerConfiguration,
    modules=(port_generic, port_reconcile, port_system))


@pytest.fixture
def pinned(monkeypatch):
    """One id counter a scheduler module and the pinned clock, in both
    packages."""
    clock = types.SimpleNamespace(time=lambda: T0)
    for pk in (REF, PORT):
        for mod in pk.modules:
            counter = itertools.count()
            tag = mod.__name__.split(".")[-1][:4]
            monkeypatch.setattr(
                mod, "generate_uuid",
                lambda c=counter, t=tag: f"{t}{next(c):08x}")
            monkeypatch.setattr(mod, "_time" if mod in (
                ref_reconcile, port_reconcile) else "time", clock)
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])


class Run:
    """One package's Harness driving a scenario: nodes and jobs with
    fixed ids, evals with fixed ids (the host shuffle's seeds)."""

    def __init__(self, pk, algorithm="binpack"):
        self.pk = pk
        self.e = pk.enums
        self.h = pk.harness()
        self.h.store._clock = lambda: T0
        self.cfg = pk.config(scheduler_algorithm=algorithm)
        self.jobs = []
        self._evs = itertools.count()
        self._nodes = itertools.count()

    # -- cluster --

    def nodes(self, n, cpu=None, mem=None):
        out = []
        for _ in range(n):
            i = next(self._nodes)
            node = self.pk.mock.node(id=f"node-{i:04d}", name=f"node-{i}")
            if cpu is not None:
                node.resources.cpu = cpu
                node.resources.memory_mb = mem
                node.compute_class()
            self.h.store.upsert_node(node)
            out.append(node)
        return out

    def job(self, kind="job", **tg_fields):
        j = getattr(self.pk.mock, kind)(id=f"job-{len(self.jobs)}")
        for k, v in tg_fields.items():
            setattr(j.task_groups[0], k, v)
        self.h.store.upsert_job(j)
        self.jobs.append(j.id)
        return self.h.snapshot().job_by_id(j.id)

    def stored(self, job):
        return self.h.snapshot().job_by_id(job.id)

    def submit(self, job):
        self.h.store.upsert_job(job)
        return self.stored(job)

    def process(self, job, trigger=None):
        ev = self.pk.mock.eval_for(
            job, id=f"ev-{next(self._evs):04d}",
            triggered_by=trigger or self.e.TRIGGER_JOB_REGISTER)
        self.h.process(ev, sched_config=self.cfg)

    def watcher(self, job):
        self.process(job, self.e.TRIGGER_DEPLOYMENT_WATCHER)

    def run_until_stable(self, job, max_evals=20):
        for _ in range(max_evals):
            before = self.h.store.latest_index
            self.watcher(job)
            if self.h.store.latest_index == before:
                return
        raise AssertionError(f"no fixpoint after {max_evals} evals")

    # -- reads --

    def allocs(self, job):
        return self.h.snapshot().allocs_by_job(job.id)

    def live(self, job):
        return [a for a in self.allocs(job)
                if not a.terminal_status() and not a.server_terminal()
                and a.client_status != self.e.ALLOC_CLIENT_UNKNOWN]

    def unknown(self, job):
        return [a for a in self.allocs(job)
                if a.client_status == self.e.ALLOC_CLIENT_UNKNOWN
                and not a.server_terminal()]

    def get(self, alloc_id):
        return self.h.snapshot().alloc_by_id(alloc_id)

    # -- writes the caller plays (client, drainer, watcher, operator) --

    def client(self, allocs, status, finished=0.0, healthy=None):
        upds = []
        for a in allocs:
            u = a.copy_for_update()
            u.client_status = status
            u.task_finished_at = finished
            if healthy is not None:
                u.deployment_status = {"healthy": healthy}
            upds.append(u)
        self.h.store.update_allocs_from_client(upds)

    def node_status(self, node_id, status, ts=T0):
        self.h.store.update_node_status(node_id, status, ts=ts)

    def drain(self, node_id):
        self.h.store.update_node_drain(node_id,
                                       self.pk.Drain(deadline_s=600))

    def migrate(self, allocs):
        self.h.store.update_alloc_desired_transitions(
            {a.id: self.pk.Transition(migrate=True) for a in allocs})

    def erase(self, alloc):
        gone = alloc.copy_for_update()
        gone.desired_status = self.e.ALLOC_DESIRED_STOP
        gone.client_status = self.e.ALLOC_CLIENT_LOST
        self.h.store.upsert_plan_results([gone])

    def promote(self, job):
        dep = self.h.snapshot().latest_deployment_by_job(job.id)
        upd = copy.deepcopy(dep)
        for s in upd.task_groups.values():
            s.promoted = True
        self.h.store.upsert_deployment(upd)

    def fail_deployment(self, job):
        dep = self.h.snapshot().latest_deployment_by_job(job.id)
        upd = copy.deepcopy(dep)
        upd.status = self.e.DEPLOYMENT_STATUS_FAILED
        self.h.store.upsert_deployment(upd)

    def bump(self, job, canary=None, max_parallel=1):
        j2 = copy.deepcopy(self.stored(job))
        j2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
        if canary is not None:
            j2.task_groups[0].update = self.pk.Update(
                canary=canary, max_parallel=max_parallel)
        return self.submit(j2)

    def setup(self, count=3, n_nodes=6, canary=0, max_parallel=1,
              max_client_disconnect=None):
        self.nodes(n_nodes)
        job = self.job(count=count, update=self.pk.Update(
            canary=canary, max_parallel=max_parallel),
            max_client_disconnect_s=max_client_disconnect)
        self.process(job)
        assert len(self.live(job)) == count
        return job

    # -- the compared rows --

    def rows(self):
        snap = self.h.snapshot()
        allocs, deps = [], []
        for jid in self.jobs:
            for a in snap.allocs_by_job(jid):
                prev = (snap.alloc_by_id(a.previous_allocation).name
                        if a.previous_allocation else "")
                allocs.append((a.name, a.node_name, a.job_version,
                               a.desired_status, a.client_status, prev,
                               bool(a.next_allocation),
                               bool(a.follow_up_eval_id), a.canary))
            dep = snap.latest_deployment_by_job(jid)
            if dep is not None:
                deps.append((jid, dep.job_version, dep.status, sorted(
                    (g, s.desired_canaries, s.desired_total,
                     len(s.placed_canaries), s.promoted)
                    for g, s in dep.task_groups.items())))
        evals = sorted((e.triggered_by, e.wait_until, e.status)
                       for e in self.h.created_evals)
        statuses = [(e.status, e.status_description) for e in self.h.evals]
        return sorted(allocs), evals, deps, statuses


# --------------------------------------------------------------------------
# the scenarios, one function each, run on both packages
# --------------------------------------------------------------------------

SCENARIOS = {}


def scenario(*params, ids=None):
    """Register ``fn(run, *args)`` once per parameter tuple."""
    def wrap(fn):
        for args in (params or [()]):
            tag = "-".join(map(str, args))
            SCENARIOS[fn.__name__ + (f"[{tag}]" if tag else "")] = (fn, args)
        return fn
    return wrap


# test_reconcile_scenarios.py::TestCanaryPlacement


@scenario((3, 1), (5, 2), (10, 3), (2, 2))
def canary_places_exactly_n(r, count, canary):
    job = r.setup(count=count, canary=canary)
    job = r.bump(job, canary=canary)
    r.process(job)
    allocs = r.live(job)
    assert sum(a.canary for a in allocs) == canary
    assert sum(a.job_version != job.version for a in allocs) == count


@scenario((1,), (3,))
def canary_repeat_evals_add_none(r, extra):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    for _ in range(extra):
        r.watcher(job)
    assert len(r.live(job)) == 4


@scenario()
def canary_initial_version_places_none(r):
    job = r.setup(count=3, canary=2)
    for _ in range(2):
        r.watcher(job)
    assert not any(a.canary for a in r.live(job))


@scenario()
def canary_deployment_records_desired(r):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    dep = r.h.snapshot().latest_deployment_by_job(job.id)
    assert dep.task_groups["web"].desired_canaries == 1


@scenario()
def canary_zero_rolls_destructively(r):
    job = r.setup(count=3, canary=0)
    job = r.bump(job, canary=0)
    r.run_until_stable(job)
    assert all(a.job_version == job.version for a in r.live(job))


@scenario()
def canary_hold_survives_losing_old(r):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    for a in list(r.live(job)):
        if a.job_version != job.version:
            r.erase(a)
    r.watcher(job)
    assert sum(a.job_version == job.version for a in r.live(job)) == 1


@scenario()
def canary_all_old_down_skips_canaries(r):
    job = r.setup(count=3, canary=1, n_nodes=8)
    for node_id in {a.node_id for a in r.live(job)}:
        r.node_status(node_id, r.e.NODE_STATUS_DOWN)
    job = r.bump(job, canary=1)
    r.process(job)
    r.watcher(job)
    assert len(r.live(job)) == 3


@scenario()
def canary_lost_old_replaced(r):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    victim = next(a for a in r.live(job) if a.job_version != job.version)
    r.node_status(victim.node_id, r.e.NODE_STATUS_DOWN)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert len(r.live(job)) == 4


# test_reconcile_scenarios.py::TestPromotionRollout


@scenario((3, 1, 1), (5, 2, 2), (4, 1, 3))
def promotion_completes_rollout(r, count, canary, max_parallel):
    job = r.setup(count=count, canary=canary, max_parallel=max_parallel,
                  n_nodes=10)
    job = r.bump(job, canary=canary, max_parallel=max_parallel)
    r.process(job)
    r.promote(job)
    r.run_until_stable(job)
    allocs = r.live(job)
    assert len(allocs) == count
    assert all(a.job_version == job.version for a in allocs)


@scenario()
def promotion_unpromoted_never_rolls(r):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    for _ in range(5):
        r.watcher(job)
    assert sum(a.job_version != job.version for a in r.live(job)) == 3


@scenario()
def promotion_max_parallel_paces(r):
    job = r.setup(count=4, canary=1, max_parallel=1, n_nodes=10)
    job = r.bump(job, canary=1, max_parallel=1)
    r.process(job)
    r.promote(job)
    r.watcher(job)
    assert sum(a.job_version != job.version for a in r.live(job)) >= 2


@scenario()
def promotion_failed_deployment_halts(r):
    job = r.setup(count=3, canary=2)
    job = r.bump(job, canary=2)
    r.process(job)
    r.fail_deployment(job)
    r.erase([a for a in r.live(job) if a.canary][0])
    r.watcher(job)
    assert sum(a.canary for a in r.live(job)) == 1


@scenario()
def promotion_old_hold_while_failed(r):
    job = r.setup(count=3, canary=1)
    job = r.bump(job, canary=1)
    r.process(job)
    r.fail_deployment(job)
    for _ in range(3):
        r.watcher(job)
    assert sum(a.job_version != job.version for a in r.live(job)) == 3


# test_reconcile_scenarios.py::TestDisconnect


@scenario()
def disconnect_within_window(r):
    job = r.setup(count=2, max_client_disconnect=WINDOW)
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert r.get(victim.id).client_status == r.e.ALLOC_CLIENT_UNKNOWN
    assert [e.wait_until for e in r.h.created_evals] == [T0 + WINDOW]


@scenario()
def disconnect_repeat_evals(r):
    job = r.setup(count=2, max_client_disconnect=WINDOW)
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    for _ in range(3):
        r.watcher(job)
    assert len(r.live(job)) == 2 and len(r.unknown(job)) == 1


@scenario((None, 0.0), (WINDOW, WINDOW + 5))
def disconnect_lost(r, window, ago):
    """Without the stanza, or past the window, the alloc is lost."""
    job = r.setup(count=2, max_client_disconnect=window)
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED,
                  ts=T0 - ago)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert r.get(victim.id).client_status == r.e.ALLOC_CLIENT_LOST


@scenario()
def disconnect_unknown_expires(r):
    job = r.setup(count=2, max_client_disconnect=WINDOW)
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED,
                  ts=T0 - WINDOW - 5)
    r.process(job, r.e.TRIGGER_MAX_DISCONNECT_TIMEOUT)
    assert r.get(victim.id).client_status == r.e.ALLOC_CLIENT_LOST


@scenario()
def disconnect_many_on_one_node(r):
    job = r.setup(count=4, n_nodes=2, max_client_disconnect=WINDOW)
    by_node = {}
    for a in r.live(job):
        by_node.setdefault(a.node_id, []).append(a)
    node_id, victims = max(by_node.items(), key=lambda kv: len(kv[1]))
    r.node_status(node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert len(r.unknown(job)) == len(victims) >= 2


# test_reconcile_scenarios.py::TestReconnect


def _unknown_with_replacement(r, job):
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    return victim


@scenario()
def reconnect_keeps_original(r):
    job = r.setup(count=2, max_client_disconnect=WINDOW)
    victim = _unknown_with_replacement(r, job)
    r.node_status(victim.node_id, r.e.NODE_STATUS_READY)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.client([r.get(victim.id)], r.e.ALLOC_CLIENT_RUNNING)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert victim.id in {a.id for a in r.live(job)}


@scenario()
def reconnect_outdated_stops_original(r):
    job = r.setup(count=2, max_client_disconnect=WINDOW)
    victim = _unknown_with_replacement(r, job)
    j2 = copy.deepcopy(job)
    j2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
    j2.task_groups[0].update = None
    job = r.submit(j2)
    r.process(job)
    r.node_status(victim.node_id, r.e.NODE_STATUS_READY)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.run_until_stable(job)
    assert r.get(victim.id).desired_status == r.e.ALLOC_DESIRED_STOP


@scenario()
def reconnect_before_replacement(r):
    r.nodes(1)
    job = r.job(count=1, update=r.pk.Update(max_parallel=1),
                max_client_disconnect_s=WINDOW)
    r.process(job)
    victim = r.live(job)[0]
    r.node_status(victim.node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.node_status(victim.node_id, r.e.NODE_STATUS_READY)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.client([r.get(victim.id)], r.e.ALLOC_CLIENT_RUNNING)
    r.run_until_stable(job)
    assert [a.id for a in r.live(job)] == [victim.id]


@scenario()
def reconnect_two_unknowns(r):
    job = r.setup(count=3, n_nodes=2, max_client_disconnect=WINDOW)
    by_node = {}
    for a in r.live(job):
        by_node.setdefault(a.node_id, []).append(a)
    node_id, victims = max(by_node.items(), key=lambda kv: len(kv[1]))
    r.node_status(node_id, r.e.NODE_STATUS_DISCONNECTED)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.node_status(node_id, r.e.NODE_STATUS_READY)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    r.client([r.get(v.id) for v in victims], r.e.ALLOC_CLIENT_RUNNING)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert len(r.live(job)) == 3


# test_generic_sched.py's lifecycle cases, and the in-place update


@scenario((3600.0,), (1.0,))
def failed_alloc_reschedules(r, ago):
    """Failed an hour ago: rescheduled now, away from its node; failed a
    second ago: a follow-up eval when the 5 s delay has passed."""
    r.nodes(5)
    job = r.job()
    r.process(job)
    victim = r.allocs(job)[0]
    r.client([victim], r.e.ALLOC_CLIENT_FAILED, finished=T0 - ago)
    r.process(job, r.e.TRIGGER_RETRY_FAILED_ALLOC)
    repl = [a for a in r.allocs(job) if a.previous_allocation == victim.id]
    if ago > 5:
        assert len(repl) == 1 and repl[0].node_id != victim.node_id
        assert r.get(victim.id).next_allocation == repl[0].id
    else:
        assert repl == [] and r.get(victim.id).follow_up_eval_id
        assert [e.wait_until for e in r.h.created_evals] == [T0 - ago + 5]


@scenario()
def failed_twice_extends_tracker(r):
    r.nodes(5)
    job = r.job()
    r.process(job)
    victim = r.allocs(job)[0]
    r.client([victim], r.e.ALLOC_CLIENT_FAILED, finished=T0 - 3600)
    r.process(job, r.e.TRIGGER_RETRY_FAILED_ALLOC)
    repl = next(a for a in r.allocs(job)
                if a.previous_allocation == victim.id)
    r.client([repl], r.e.ALLOC_CLIENT_FAILED, finished=T0 - 3600)
    r.process(job, r.e.TRIGGER_RETRY_FAILED_ALLOC)
    third = next(a for a in r.allocs(job) if a.previous_allocation == repl.id)
    assert len(third.reschedule_tracker.events) == 2


@scenario()
def node_down_lost(r):
    nodes = r.nodes(3)
    job = r.job()
    r.process(job)
    down = r.allocs(job)[0].node_id
    r.node_status(down, r.e.NODE_STATUS_DOWN)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert len(r.live(job)) == 10 and nodes
    assert all(a.node_id != down for a in r.live(job))


@scenario()
def drain_migrates(r):
    r.nodes(3)
    job = r.job()
    r.process(job)
    drained = r.allocs(job)[0].node_id
    on = [a for a in r.allocs(job) if a.node_id == drained]
    r.drain(drained)
    r.migrate(on)
    r.process(job, r.e.TRIGGER_NODE_DRAIN)
    assert all(a.node_id != drained for a in r.live(job))


@scenario()
def destructive_update_replaces(r):
    r.nodes(5)
    job = r.job()
    r.process(job)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].tasks[0].resources.cpu = 600
    j2.task_groups[0].update = None
    job = r.submit(j2)
    r.process(job)
    assert all(a.job_version == job.version for a in r.live(job))


@scenario()
def scale_down_restamped(r):
    """test_generic_sched.py's scale down: the allocs restamped to the
    new version so only the count math runs."""
    r.nodes(10)
    job = r.job()
    r.process(job)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].count = 4
    job = r.submit(j2)
    restamped = []
    for a in r.allocs(job):
        a = copy.copy(a)
        a.job_version = job.version
        restamped.append(a)
    r.h.store.upsert_allocs(restamped)
    r.process(job)
    assert {a.index() for a in r.live(job)} == {0, 1, 2, 3}


@scenario((4,), (14,))
def inplace_update_and_scale(r, count):
    """A count and update-strategy change: every alloc updates in place,
    and the group scales down or up."""
    r.nodes(10)
    job = r.job()
    r.process(job)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].count = count
    j2.task_groups[0].update = r.pk.Update(max_parallel=3)
    job = r.submit(j2)
    r.process(job)
    live = r.live(job)
    assert len(live) == count
    assert all(a.job_version == job.version for a in live)


@scenario()
def batch_complete_not_replaced(r):
    r.nodes(5)
    job = r.job("batch_job")
    r.process(job)
    r.client(r.allocs(job), r.e.ALLOC_CLIENT_COMPLETE)
    r.process(job)
    assert len(r.allocs(job)) == 10


@scenario()
def exhausted_policy_keeps_slot(r):
    r.nodes(3)
    job = r.job(count=2, reschedule_policy=r.pk.Policy(
        attempts=0, unlimited=False))
    r.process(job)
    r.client([r.allocs(job)[0]], r.e.ALLOC_CLIENT_FAILED)
    r.process(job, r.e.TRIGGER_RETRY_FAILED_ALLOC)
    assert len(r.allocs(job)) == 2


@scenario()
def scale_down_during_migration(r):
    r.nodes(2)
    job = r.job(count=2)
    r.process(job)
    for nid in sorted({a.node_id for a in r.allocs(job)}):
        r.drain(nid)
    r.nodes(1)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].count = 1
    job = r.submit(j2)
    r.process(job, r.e.TRIGGER_NODE_DRAIN)
    assert len(r.live(job)) <= 1


@scenario()
def stop_alloc_transition(r):
    """An alloc stop's reschedule transition: stopped where it is and
    replaced elsewhere."""
    r.nodes(4)
    job = r.job(count=3)
    r.process(job)
    victim = r.allocs(job)[0]
    r.h.store.update_alloc_desired_transitions(
        {victim.id: r.pk.Transition(reschedule=True)})
    r.process(job, "alloc-stop")
    assert r.get(victim.id).desired_status == r.e.ALLOC_DESIRED_STOP
    assert len(r.live(job)) == 3


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_rows_equal_reference(name, pinned):
    fn, args = SCENARIOS[name]
    got = {}
    for pk in (REF, PORT):
        r = Run(pk)
        fn(r, *args)
        got[pk.name] = r.rows()
    assert over_capacity(r.h.store) == []
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1:] == got["ref"][1:]


# --------------------------------------------------------------------------
# AllocBlocks and the per-eval kernel's penalty column ("tpu-binpack")
# --------------------------------------------------------------------------


@pytest.fixture
def ref_service(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", svc)
    yield svc
    svc.stop()


def _capture_penalties(monkeypatch):
    """Every B9 launch's penalty column, as the port's placer packs it."""
    seen = []
    real = port_kernels.pack_solve_args

    def spy(*args, **kw):
        seen.append(np.asarray(args[7]).copy())   # penalty_idx
        return real(*args, **kw)
    monkeypatch.setattr(port_placer, "pack_solve_args", spy)
    return seen


def test_block_group_losing_a_node(pinned, ref_service, port_service):
    """A 300-alloc group placed as one AllocBlock loses a node: the
    block positions there are stopped lost (each promoted to a row of
    its own, shown once) and replaced; then the node's allocs of a
    second block fail and are rescheduled."""
    got = {}
    for pk in (REF, PORT):
        r = Run(pk, algorithm="tpu-binpack")
        r.nodes(24, cpu=16000, mem=32768)
        job = r.job(count=300)
        job.task_groups[0].tasks[0].resources.cpu = 100
        r.process(job)
        assert len(list(r.h.snapshot().alloc_blocks())) == 1
        node = max({a.node_id for a in r.allocs(job)},
                   key=lambda n: sum(a.node_id == n for a in r.allocs(job)))
        on = [a for a in r.allocs(job) if a.node_id == node]
        r.node_status(node, r.e.NODE_STATUS_DOWN)
        r.process(job, r.e.TRIGGER_NODE_UPDATE)
        allocs = r.allocs(job)
        ids = [a.id for a in allocs]
        assert len(ids) == len(set(ids)) == 300 + len(on)
        by_node = [a.id for a in r.h.snapshot().allocs_by_node(node)]
        assert sorted(by_node) == sorted(a.id for a in on)
        assert all(r.get(a.id).client_status == r.e.ALLOC_CLIENT_LOST
                   for a in on)
        got[pk.name] = r.rows()
    assert over_capacity(r.h.store) == []
    assert got["port"] == got["ref"]


def test_many_reschedules_take_the_kernel_with_penalties(
        pinned, ref_service, port_service, monkeypatch):
    """40 allocs placed per request by B9, then 24 of them fail an hour
    ago: 24 rescheduled requests (more than the host cutover of 16) go
    through ONE per-eval launch with each old node in the penalty
    column, and land on the same nodes in both packages."""
    seen = _capture_penalties(monkeypatch)
    got = {}
    for pk in (REF, PORT):
        r = Run(pk, algorithm="tpu-binpack")
        r.nodes(32, cpu=8000, mem=16384)
        job = r.job(count=40, update=None)
        r.process(job)
        failed = r.allocs(job)[:24]
        r.client(failed, r.e.ALLOC_CLIENT_FAILED, finished=T0 - 3600)
        r.process(job, r.e.TRIGGER_RETRY_FAILED_ALLOC)
        repl = [a for a in r.allocs(job) if a.previous_allocation]
        assert len(repl) == 24
        got[pk.name] = r.rows()
    assert got["port"] == got["ref"]
    assert len(seen) == 2                  # the fill and the reschedule
    pen = seen[1]
    assert (pen[:24] >= 0).all() and (pen[24:] == -1).all()
    assert port_placer.TorchPlacer.HOST_CUTOVER < 24


# --------------------------------------------------------------------------
# reschedule policy and the spec diff
# --------------------------------------------------------------------------

POLICIES = [
    dict(attempts=2, interval_s=600, delay_s=5, delay_function="constant",
         unlimited=False),
    dict(attempts=3, interval_s=3600, delay_s=30,
         delay_function="exponential", max_delay_s=300, unlimited=False),
    dict(delay_s=10, delay_function="fibonacci", max_delay_s=200,
         unlimited=True),
    dict(attempts=0, unlimited=False),
    None,
]


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("pi", range(len(POLICIES)))
def test_should_reschedule_equals_reference(pi, batch):
    for attempts in range(6):
        for delay in (0.0, 10.0, 100.0, 1000.0):
            for recent in (0, 1):
                out = []
                for pk in (REF, PORT):
                    pol = (None if POLICIES[pi] is None
                           else pk.Policy(**POLICIES[pi]))
                    events = [pk.Event(reschedule_time=T0 - 7200 * (1 - recent)
                                       - i) for i in range(attempts)]
                    a = pk.mock.alloc(
                        client_status="failed", task_finished_at=T0 - delay,
                        reschedule_tracker=pk.Tracker(events=events))
                    out.append(pk.reconcile.should_reschedule(
                        a, pol, T0, batch))
                    if pol is not None:
                        out.append(pk.reconcile.reschedule_delay(
                            pol, attempts))
                assert out[:len(out) // 2] == out[len(out) // 2:]


def _tg_change(name):
    """A spec change applied to one package's task group."""
    def f(pk, tg):
        t = tg.tasks[0]
        {
            "count": lambda: setattr(tg, "count", tg.count + 3),
            "update": lambda: setattr(tg, "update", pk.Update(
                max_parallel=4, canary=2)),
            "reschedule": lambda: setattr(tg, "reschedule_policy",
                                          pk.Policy(attempts=9)),
            "disconnect": lambda: setattr(tg, "max_client_disconnect_s",
                                          30.0),
            "cpu": lambda: setattr(t.resources, "cpu", 900),
            "memory": lambda: setattr(t.resources, "memory_mb", 999),
            "disk": lambda: setattr(t.resources, "disk_mb", 10),
            "cores": lambda: setattr(t.resources, "cores", 2),
            "numa": lambda: setattr(t.resources, "numa_affinity",
                                    "require"),
            "config": lambda: setattr(t, "config", {"command": "/x"}),
            "env": lambda: setattr(t, "env", {"K": "V"}),
            "driver": lambda: setattr(t, "driver", "docker"),
            "user": lambda: setattr(t, "user", "nobody"),
            "task_constraint": lambda: t.constraints.append(pk.Constraint(
                "${attr.arch}", "x86_64", "=")),
            "task_affinity": lambda: t.affinities.append(pk.Affinity(
                "${attr.arch}", "x86_64", "=", 20)),
            "group_constraint": lambda: tg.constraints.append(
                pk.Constraint("${attr.arch}", "x86_64", "=")),
            "group_affinity": lambda: tg.affinities.append(pk.Affinity(
                "${attr.arch}", "x86_64", "=", 20)),
            "spread": lambda: tg.spreads.append(pk.Spread(
                attribute="${attr.rack}", weight=50)),
            "ephemeral_size": lambda: setattr(tg.ephemeral_disk, "size_mb",
                                              500),
            "ephemeral_migrate": lambda: setattr(tg.ephemeral_disk,
                                                 "migrate", True),
            "group_port": lambda: tg.networks.append(pk.Network(
                dynamic_ports=["http"])),
            "task_port": lambda: t.resources.networks.append(pk.Network(
                reserved_ports=[("admin", 9000)])),
            "device": lambda: t.resources.devices.append(pk.Device(
                name="nvidia/gpu", count=1)),
            "rename_task": lambda: setattr(t, "name", "other"),
            "add_task": lambda: tg.tasks.append(copy.deepcopy(t)) or setattr(
                tg.tasks[-1], "name", "sidecar"),
        }[name]()
    return f


IN_PLACE = ("count", "update", "reschedule", "disconnect")
DESTRUCTIVE = ("cpu", "memory", "disk", "cores", "numa", "config", "env",
               "driver", "user", "task_constraint", "task_affinity",
               "group_constraint", "group_affinity", "spread",
               "ephemeral_size", "ephemeral_migrate", "group_port",
               "task_port", "device", "rename_task", "add_task")


@pytest.mark.parametrize("change", IN_PLACE + DESTRUCTIVE)
def test_tasks_updated_equals_reference(change):
    out = []
    for pk in (REF, PORT):
        old = pk.mock.job().task_groups[0]
        new = copy.deepcopy(old)
        _tg_change(change)(pk, new)
        out.append((pk.util.tasks_updated(old, new),
                    pk.util.tasks_updated(old, copy.deepcopy(old)),
                    pk.util.tasks_updated(None, old)))
    assert out[0] == out[1] == ((change in DESTRUCTIVE), False, True)


def test_alloc_name_index_equals_reference():
    for used in ([], [0, 1, 2], [1, 3, 7], list(range(0, 40, 3))):
        got = []
        for pk in (REF, PORT):
            j = pk.mock.job(id="job-x")
            allocs = [pk.mock.alloc(j, index=i) for i in used]
            idx = pk.util.AllocNameIndex("job-x", "web", 10, in_use=allocs)
            names = idx.next_batch(5)
            got.append((names, idx.next_batch_indices(7).tolist()))
        assert got[0] == got[1]
        assert np.all(np.diff(got[1][1]) > 0)
