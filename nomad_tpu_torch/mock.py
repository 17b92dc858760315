"""Fixtures (reference ``nomad_tpu/mock.py:27-155``) plus a copy of the
benchmark's seeded cluster (reference ``bench.py:72-85`` ``build_nodes``)
and job shape (``bench.py:88-105`` ``service_job``)."""

from __future__ import annotations

import itertools
import random

from .structs import (Allocation, Constraint, Evaluation, Job, Node,
                      NodeResources, Resources, Task, TaskGroup, alloc_name,
                      enums)
from .structs.job import ReschedulePolicy, UpdateStrategy
from .utils.ids import generate_uuid

_counter = itertools.count()

RACKS = 20
ZONES = 4
KERNELS = ["4.14.0", "4.19.0", "5.10.0"]
ITYPES = ["small", "large"]


def node(**overrides) -> Node:
    """A 4-core/4GHz, 8GB, 100GB linux node."""
    i = next(_counter)
    n = Node(
        id=generate_uuid(),
        name=f"node-{i}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86_64",
            "cpu.arch": "amd64",
            "nomad.version": "0.1.0",
            "driver.exec": "1",
            "driver.mock": "1",
            "unique.hostname": f"node-{i}.local",
        },
        resources=NodeResources(cpu=4000, memory_mb=8192,
                                disk_mb=100 * 1024, total_cores=4),
        drivers={"exec": True, "mock": True, "raw_exec": True},
        status=enums.NODE_STATUS_READY,
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    n.compute_class()
    return n


def job(**overrides) -> Job:
    """A service job: 10x web group, 500MHz/256MB, exec driver."""
    j = Job(
        id=f"job-{generate_uuid()[:8]}",
        name="my-job",
        type=enums.JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}",
                                rtarget="linux", operand="=")],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                tasks=[Task(name="web", driver="exec",
                            config={"command": "/bin/date"},
                            resources=Resources(cpu=500, memory_mb=256))],
                reschedule_policy=ReschedulePolicy(
                    attempts=2, interval_s=10 * 60, delay_s=5,
                    delay_function="constant", unlimited=False),
                update=UpdateStrategy(max_parallel=1),
            )
        ],
        status=enums.JOB_STATUS_PENDING,
    )
    j.name = j.id
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def batch_job(**overrides) -> Job:
    j = job(**overrides)
    j.type = enums.JOB_TYPE_BATCH
    for tg in j.task_groups:
        tg.update = None
    return j


def system_job(**overrides) -> Job:
    """A system job: one alloc of each group on every node, priority
    100 (reference ``mock.py:97-106``)."""
    j = job(**overrides)
    j.type = enums.JOB_TYPE_SYSTEM
    j.priority = 100
    for tg in j.task_groups:
        tg.count = 1
        tg.update = None
        tg.reschedule_policy = None
    return j


def sysbatch_job(**overrides) -> Job:
    """A system job run once a node (reference ``mock.py:109-113``)."""
    j = system_job(**overrides)
    j.type = enums.JOB_TYPE_SYSBATCH
    j.priority = 50
    return j


def eval_for(j: Job, **overrides) -> Evaluation:
    ev = Evaluation(
        id=generate_uuid(),
        namespace=j.namespace,
        priority=j.priority,
        type=j.type,
        job_id=j.id,
        triggered_by=enums.TRIGGER_JOB_REGISTER,
        status=enums.EVAL_STATUS_PENDING,
    )
    for k, v in overrides.items():
        setattr(ev, k, v)
    return ev


def build_nodes(store, n_nodes: int, seed: int = 0) -> None:
    """Register ``n_nodes`` seeded nodes: cpu in {8000, 16000, 32000} MHz,
    memory in {16, 32, 64} GiB, rack/zone/kernel/instance attributes."""
    rng = random.Random(seed)
    for i in range(n_nodes):
        n = node()
        n.attributes["rack"] = f"r{i % RACKS}"
        n.attributes["zone"] = f"z{i % ZONES}"
        n.attributes["kernel.version"] = KERNELS[i % len(KERNELS)]
        n.attributes["instance.type"] = ITYPES[i % len(ITYPES)]
        n.resources.cpu = rng.choice([8000, 16000, 32000])
        n.resources.memory_mb = rng.choice([16384, 32768, 65536])
        n.compute_class()
        store.upsert_node(n)


def alloc(j: Job = None, n: Node = None, index: int = 0,
          **overrides) -> Allocation:
    """A placed, running alloc of the job's first group on the node."""
    if j is None:
        j = job()
    if n is None:
        n = node()
    tg = j.task_groups[0]
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        name=alloc_name(j.id, tg.name, index),
        namespace=j.namespace,
        node_id=n.id,
        node_name=n.name,
        job_id=j.id,
        job=j,
        job_version=j.version,
        task_group=tg.name,
        allocated_vec=tg.combined_resources().vec(),
        desired_status=enums.ALLOC_DESIRED_RUN,
        client_status=enums.ALLOC_CLIENT_RUNNING,
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    return a


def service_job(count: int, cpu: int = 100, mem: int = 64, *,
                spreads=None, constraints=None, affinities=None,
                batch: bool = False, priority: int = 50) -> Job:
    """The benchmark's one-group job shape (reference ``bench.py``
    ``service_job``): spreads, constraints and affinities replace the
    group's own."""
    j = batch_job() if batch else job()
    j.priority = priority
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    if spreads:
        tg.spreads = list(spreads)
    if constraints:
        tg.constraints = list(constraints)
    if affinities:
        tg.affinities = list(affinities)
    return j
