"""The system and sysbatch scheduler (nomad_tpu_torch/scheduler/
system_sched.py against nomad_tpu/scheduler/system_sched.py): the cases
of tests/test_generic_sched.py::TestSystemScheduling and the lifecycle
of a system job (a node down, drained or ineligible, a destructive
update, a stopped job, a removed group, a sysbatch job rerun only at a
new version) through both packages' Harnesses, with pinned ids and
clock; each case's rows must be exactly equal."""

import copy

import pytest

from test_torch_bulk_scan import over_capacity
from test_torch_reconcile import PORT, REF, Run, pinned  # noqa: F401

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _live(r, job):
    return [a for a in r.allocs(job)
            if not a.terminal_status() and not a.server_terminal()]


@case
def place_on_every_node(r):
    nodes = r.nodes(7)
    job = r.job("system_job")
    r.process(job)
    assert {a.node_id for a in r.allocs(job)} == {n.id for n in nodes}


@case
def new_node_gets_system_alloc(r):
    r.nodes(3)
    job = r.job("system_job")
    r.process(job)
    new = r.nodes(1)[0]
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert new.id in {a.node_id for a in _live(r, job)}


@case
def ineligible_node_keeps_running(r):
    nodes = r.nodes(3)
    job = r.job("system_job")
    r.process(job)
    r.h.store.update_node_eligibility(nodes[0].id,
                                      r.e.NODE_SCHED_INELIGIBLE)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert len(_live(r, job)) == 3


@case
def node_outside_datacenters_stops(r):
    nodes = r.nodes(2)
    job = r.job("system_job")
    r.process(job)
    moved = copy.copy(r.h.snapshot().node_by_id(nodes[0].id))
    moved.datacenter = "dc-elsewhere"
    r.h.store.upsert_node(moved)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    assert {a.node_id for a in _live(r, job)} == {nodes[1].id}


@case
def sysbatch_does_not_rerun_complete(r):
    r.nodes(3)
    job = r.job("sysbatch_job")
    r.process(job)
    r.client(r.allocs(job), r.e.ALLOC_CLIENT_COMPLETE)
    r.process(job)
    assert len(r.allocs(job)) == 3


@case
def sysbatch_reruns_at_a_new_version(r):
    r.nodes(3)
    job = r.job("sysbatch_job")
    r.process(job)
    r.client(r.allocs(job)[:2], r.e.ALLOC_CLIENT_COMPLETE)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
    job = r.submit(j2)
    r.process(job)
    assert sum(a.job_version == job.version for a in r.allocs(job)) == 3


@case
def node_down_marks_lost(r):
    nodes = r.nodes(4)
    job = r.job("system_job")
    r.process(job)
    r.node_status(nodes[1].id, r.e.NODE_STATUS_DOWN)
    r.process(job, r.e.TRIGGER_NODE_UPDATE)
    lost = [a for a in r.allocs(job) if a.node_id == nodes[1].id]
    assert [a.client_status for a in lost] == [r.e.ALLOC_CLIENT_LOST]


@case
def drained_node_keeps_alloc_places_nothing(r):
    nodes = r.nodes(4)
    job = r.job("system_job")
    r.process(job)
    r.drain(nodes[2].id)
    other = r.job("sysbatch_job")
    r.process(job, r.e.TRIGGER_NODE_DRAIN)
    r.process(other)
    assert len(_live(r, job)) == 4
    assert nodes[2].id not in {a.node_id for a in r.allocs(other)}


@case
def destructive_update_replaces_on_each_node(r):
    r.nodes(5)
    job = r.job("system_job")
    r.process(job)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].tasks[0].resources.cpu = 700
    job = r.submit(j2)
    r.process(job)
    live = _live(r, job)
    assert len(live) == 5 and all(a.previous_allocation for a in live)


@case
def stopped_job_stops_all(r):
    r.nodes(3)
    job = r.job("system_job")
    r.process(job)
    r.h.store.delete_job(job.id, purge=False)
    r.process(job, r.e.TRIGGER_JOB_DEREGISTER)
    assert _live(r, job) == []


@case
def removed_group_stops(r):
    r.nodes(3)
    job = r.job("system_job")
    r.process(job)
    j2 = copy.deepcopy(r.stored(job))
    j2.task_groups[0].name = "api"
    job = r.submit(j2)
    r.process(job)
    assert {a.task_group for a in _live(r, job)} == {"api"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_system_rows_equal_reference(name, pinned):  # noqa: F811
    got = {}
    for pk in (REF, PORT):
        r = Run(pk)
        CASES[name](r)
        got[pk.name] = r.rows()
    assert over_capacity(r.h.store) == []
    assert got["port"] == got["ref"]
