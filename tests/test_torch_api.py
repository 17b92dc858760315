"""The HTTP API on both packages: the reference's agent (JAX on the CPU)
and the port's (``device="cpu"``) over Servers holding the same 64
nodes, with pinned ids, driven through the same HTTP requests.

- every route the port serves answers as the reference's: the status
  code and the JSON reply, compared field by field
  (``same_on_port_fields``: every key of the port's reply is the
  reference's, with an equal value) after dropping the wall-clock fields
  ``WALL_CLOCK``;
- the rules of every route: 400 for malformed JSON, 413 for an oversized
  body (before any store access), 404 for an unknown route and for the
  routes left for later, 504 past ``X-Nomad-Deadline``;
- blocking queries: the waiter table (the reference's
  tests/test_readpath.py ``TestWatchTable``), ``X-Nomad-Index`` the read
  snapshot's and never ahead of the store, a query parked over HTTP
  woken by a commit, ``wait`` in seconds or a Go duration;
- the dry-run plan (tests/test_job_plan.py ``TestPlanEndpoint``): the
  same annotations and diff, nothing committed, and under "tpu-binpack"
  a bulk job's plan leaves no phantom usage: the job registered after it
  places as on the reference;
- a three-server cluster of each package: a write through a follower's
  agent is forwarded, the follower reads with ``X-Nomad-KnownLeader``
  and ``X-Nomad-LastContact``, ``/v1/status/leader`` and the raft
  configuration name the leader, and a leader crash moves them.

Every agent binds port 0 and stops, with its Server or cluster, in a
``finally``; every wait has an explicit timeout.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import types
from urllib.parse import urlparse

import numpy as np
import pytest

import bench
from nomad_tpu.api import codec as ref_codec
from nomad_tpu.api import http as ref_http
from nomad_tpu.core import server as ref_server
from nomad_tpu.raft.cluster import RaftCluster as RefRaftCluster
from nomad_tpu.state.store import StateStore as RefStateStore
from nomad_tpu.state.watch import WatchTable as RefWatchTable
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs import wire as ref_wire
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu_torch import convert
from nomad_tpu_torch.api import http as port_http
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.raft.cluster import RaftCluster as PortRaftCluster
from nomad_tpu_torch.state.store import StateStore as PortStateStore
from nomad_tpu_torch.state.watch import WatchTable as PortWatchTable
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor import solver as port_solver

from test_torch_jobspec import same_on_port_fields
from test_torch_pipeline import fingerprint, node_record
from test_torch_server import _pin_ids

# wall-clock fields, dropped before a reply is compared: each is a time
# the server stamped when it ran, not a result
WALL_CLOCK = ("create_time", "modify_time", "allocated_at",
              "task_finished_at", "status_updated_at", "submit_time", "time",
              "wait_until", "reschedule_time", "require_progress_by",
              "allocation_time_s")

REF = types.SimpleNamespace(
    name="ref", http=ref_http, server=ref_server, operator=ref_operator,
    RaftCluster=RefRaftCluster, StateStore=RefStateStore,
    WatchTable=RefWatchTable,
    cfg=lambda **kw: ref_server.ServerConfig(**kw))
PORT = types.SimpleNamespace(
    name="port", http=port_http, server=port_server, operator=port_operator,
    RaftCluster=PortRaftCluster, StateStore=PortStateStore,
    WatchTable=PortWatchTable,
    cfg=lambda **kw: port_server.ServerConfig(device="cpu", **kw))
PKGS = [pytest.param(REF, id="ref"), pytest.param(PORT, id="port")]

N_NODES = 64


def drop_wall_clock(value):
    if isinstance(value, dict):
        return {k: drop_wall_clock(v) for k, v in value.items()
                if k not in WALL_CLOCK}
    if isinstance(value, list):
        return [drop_wall_clock(v) for v in value]
    return value


def call(addr: str, method: str, path: str, body=None, headers=None,
         raw: bytes = None, timeout: float = 10.0):
    """One request on its own connection: (status, payload, headers)."""
    u = urlparse(addr)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        text = r.read()
    finally:
        conn.close()
    try:
        payload = json.loads(text) if text else None
    except ValueError:
        payload = text.decode()
    return r.status, payload, {k.lower(): v for k, v in r.getheaders()}


def oversized(addr: str, limit: int):
    """A POST announcing ``limit + 1`` bytes and sending none: the
    agent must refuse it from the header alone."""
    u = urlparse(addr)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.putrequest("POST", "/v1/jobs")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(limit + 1))
        conn.endheaders()
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ref_nodes():
    """64 reference nodes (bench.build_nodes, seed 0)."""
    src = RefStateStore()
    bench.build_nodes(src, N_NODES)
    return list(src.snapshot().nodes())


@pytest.fixture(scope="module")
def cluster_nodes(ref_nodes):
    """The same nodes as records, for the port."""
    return [node_record(n) for n in ref_nodes]


def nodes_for(pkg, records, ref_nodes):
    if pkg is PORT:
        return convert.nodes_from_records(records)
    return [ref_wire.wire_decode(ref_wire.wire_encode(n))
            for n in ref_nodes]


class Stack:
    """A Server of one package with the test nodes and an agent on port
    0; the deployment watcher and the drainer held off (a test plays
    them)."""

    def __init__(self, pkg, nodes, alg="binpack", workers=1):
        self.pkg = pkg
        self.srv = pkg.server.Server(pkg.cfg(
            num_workers=workers, eval_batch_size=1, heartbeat_ttl=3600,
            gc_interval=3600, nack_timeout=900.0,
            sched_config=pkg.operator.SchedulerConfiguration(
                scheduler_algorithm=alg)))
        self.srv.deployment_watcher.start = lambda: None
        self.srv.drainer.start = lambda: None
        for n in nodes:
            self.srv.store.upsert_node(n)
        self.agent = None

    def __enter__(self):
        self.srv.start()
        try:
            self.agent = self.pkg.http.HTTPAgent(self.srv, port=0).start()
        except BaseException:
            self.srv.stop()
            raise
        return self

    def __exit__(self, *exc):
        try:
            self.agent.stop()
        finally:
            self.srv.stop()

    def call(self, method, path, body=None, **kw):
        return call(self.agent.address, method, path, body, **kw)

    def idle(self):
        assert self.srv.wait_for_idle(10.0, include_delayed=False)


def ref_job_json(count, batch=False, cpu=50, mem=32, scaling=None):
    """A reference job as the JSON both agents are sent."""
    j = bench.service_job(count, cpu=cpu, mem=mem, batch=batch)
    d = ref_codec.to_dict(j)
    if scaling is not None:
        d["task_groups"][0]["scaling"] = scaling
    return d


HCL = '''
job "parsed" {
  datacenters = ["dc1"]
  type = "batch"
  group "g" {
    count = 5
    scaling { min = 1 max = 10 }
    task "t" {
      driver = "mock"
      resources { cpu = 50 memory = 32 }
    }
  }
}
'''


def scenario(st: Stack, jobs):
    """The route walk: returns [(label, status, reply)], each reply with
    its wall-clock fields dropped."""
    out = []

    def rec(label, method, path, body=None, idle=False, **kw):
        status, payload, _ = st.call(method, path, body, **kw)
        if idle:
            st.idle()
        out.append((label, status, drop_wall_clock(payload)))
        return payload

    a, b = jobs
    rec("namespaces", "GET", "/v1/namespaces")
    rec("ns put", "POST", "/v1/namespace/team-a",
        {"description": "the a team"})
    rec("ns get", "GET", "/v1/namespace/team-a")
    rec("ns missing", "GET", "/v1/namespace/nope")
    rec("pools", "GET", "/v1/node/pools")
    rec("pool put", "POST", "/v1/node/pool/gpu", {"description": "gpus"})
    rec("pool builtin", "POST", "/v1/node/pool/default", {})
    rec("pool get", "GET", "/v1/node/pool/gpu")
    rec("nodes", "GET", "/v1/nodes")
    node_id = sorted(n["id"] for n in st.call("GET", "/v1/nodes")[1])[0]
    rec("node", "GET", f"/v1/node/{node_id}")
    rec("parse", "POST", "/v1/jobs/parse", {"job_hcl": HCL})
    rec("parse bad", "POST", "/v1/jobs/parse", {"job_hcl": 'job "x" { }'})
    rec("parse empty", "POST", "/v1/jobs/parse", {})
    rec("register bad ns", "POST", "/v1/jobs?namespace=nope",
        {"job": {**a, "namespace": "nope"}})
    rec("register a", "POST", "/v1/jobs", {"job": a}, idle=True)
    rec("register b", "POST", "/v1/jobs", {"job": b}, idle=True)
    rec("jobs", "GET", "/v1/jobs")
    rec("job", "GET", f"/v1/job/{a['id']}")
    rec("job missing", "GET", "/v1/job/nope")
    rec("versions", "GET", f"/v1/job/{a['id']}/versions")
    allocs = rec("job allocs", "GET", f"/v1/job/{a['id']}/allocations")
    rec("job evals", "GET", f"/v1/job/{a['id']}/evaluations")
    rec("job deployments", "GET", f"/v1/job/{a['id']}/deployments")
    # the dry run: a count change, then a brand-new job
    index0 = st.srv.store.latest_index
    plan = {**a, "task_groups": [{**a["task_groups"][0], "count": 6}]}
    rec("plan update", "POST", f"/v1/job/{a['id']}/plan", {"job": plan})
    rec("plan new", "POST", "/v1/job/planned/plan",
        {"job": {**a, "id": "planned", "name": "planned"}})
    assert st.srv.store.latest_index == index0, "a dry run committed"
    rec("scale", "POST", f"/v1/job/{a['id']}/scale",
        {"task_group": a["task_groups"][0]["name"], "count": 4}, idle=True)
    rec("scale out of bounds", "POST", f"/v1/job/{a['id']}/scale",
        {"task_group": a["task_groups"][0]["name"], "count": 50})
    rec("scale missing", "POST", "/v1/job/nope/scale",
        {"task_group": "g", "count": 1})
    rec("scale status", "GET", f"/v1/job/{a['id']}/scale")
    rec("policies", "GET", "/v1/scaling/policies")
    rec("policy", "GET",
        f"/v1/scaling/policy/default/{a['id']}/{a['task_groups'][0]['name']}")
    rec("policy missing", "GET", "/v1/scaling/policy/nope")
    rec("revert", "POST", f"/v1/job/{a['id']}/revert", {"job_version": 0},
        idle=True)
    rec("revert current", "POST", f"/v1/job/{a['id']}/revert",
        {"job_version": 2})
    rec("evaluate", "POST", f"/v1/job/{a['id']}/evaluate", idle=True)
    rec("evaluate missing", "POST", "/v1/job/nope/evaluate")
    rec("allocations", "GET", "/v1/allocations")
    first = sorted(x["id"] for x in allocs)[0]
    rec("allocation", "GET", f"/v1/allocation/{first}")
    rec("alloc stop", "POST", f"/v1/allocation/{first}/stop", idle=True)
    rec("alloc stop missing", "POST", "/v1/allocation/nope/stop")
    rec("evaluations", "GET", "/v1/evaluations")
    ev = sorted(e["id"] for e in st.call("GET", "/v1/evaluations")[1])[0]
    rec("evaluation", "GET", f"/v1/evaluation/{ev}")
    rec("deployments", "GET", "/v1/deployments")
    rec("deployment missing", "GET", "/v1/deployment/nope")
    rec("promote missing", "POST", "/v1/deployment/promote/nope", {})
    rec("fail missing", "POST", "/v1/deployment/fail/nope", {})
    rec("search", "GET", f"/v1/search?prefix={a['id'][:4]}")
    rec("search nodes", "GET", f"/v1/search?prefix={node_id[:3]}"
        "&context=nodes")
    rec("search bad", "GET", "/v1/search?context=bogus")
    rec("node allocs", "GET", f"/v1/node/{node_id}/allocations")
    rec("volume put", "POST", "/v1/volume/csi/vol-1",
        {"name": "vol-1", "access_mode": "multi-node-reader"})
    rec("volume bad ns", "POST", "/v1/volume/csi/vol-2?namespace=nope", {})
    rec("volumes", "GET", "/v1/volumes")
    rec("volume", "GET", "/v1/volume/csi/vol-1")
    rec("volume delete", "DELETE", "/v1/volume/csi/vol-1")
    rec("eligibility", "POST", f"/v1/node/{node_id}/eligibility",
        {"eligibility": "ineligible"})
    rec("drain", "POST", f"/v1/node/{node_id}/drain",
        {"drain_spec": {"deadline_s": 60.0}}, idle=True)
    rec("node after", "GET", f"/v1/node/{node_id}")
    rec("sched config", "GET", "/v1/operator/scheduler/configuration")
    rec("sched config put", "PUT", "/v1/operator/scheduler/configuration",
        {"scheduler_algorithm": "spread"})
    rec("sched config after", "GET", "/v1/operator/scheduler/configuration")
    rec("leader", "GET", "/v1/status/leader")
    rec("raft config", "GET", "/v1/operator/raft/configuration")
    rec("ns delete busy", "DELETE", "/v1/namespace/team-a?x=1")
    rec("ns delete", "DELETE", "/v1/namespace/team-a")
    rec("ns delete missing", "DELETE", "/v1/namespace/team-a")
    rec("pool delete", "DELETE", "/v1/node/pool/gpu")
    rec("pool delete builtin", "DELETE", "/v1/node/pool/default")
    rec("deregister", "DELETE", f"/v1/job/{b['id']}", idle=True)
    rec("deregister purge", "DELETE", f"/v1/job/{b['id']}?purge=true",
        idle=True)
    rec("gc", "PUT", "/v1/system/gc", {})
    rec("jobs after", "GET", "/v1/jobs")
    rec("unknown", "GET", "/v1/nope")
    rec("unknown post", "POST", "/v1/nope", {})
    rec("unknown delete", "DELETE", "/v1/nope")
    return out


def run_scenario(pkg, monkeypatch, nodes, jobs):
    _pin_ids(monkeypatch)
    with Stack(pkg, nodes) as st:
        return scenario(st, jobs)


def test_routes_answer_as_the_reference(monkeypatch, cluster_nodes,
                                        ref_nodes):
    jobs = (ref_job_json(3, scaling={"min": 1, "max": 5, "enabled": True,
                                     "policy": {}}),
            ref_job_json(20, batch=True))
    ref = run_scenario(REF, monkeypatch,
                       nodes_for(REF, cluster_nodes, ref_nodes), jobs)
    port = run_scenario(PORT, monkeypatch,
                        nodes_for(PORT, cluster_nodes, ref_nodes), jobs)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (label, status, payload), (_, want_status, want) in zip(port, ref):
        assert status == want_status, (label, payload, want)
        if status >= 400:
            # the message may word a trimmed struct differently; the
            # code is the contract
            assert set(payload) == {"error"}, label
            continue
        if label == "allocation":
            # ROADMAP §C11: after the scale and the revert the alloc was
            # updated in place to job version 2; the port's row carries
            # that job, the reference's keeps the job it was placed with
            assert payload["job_version"] == want["job_version"] == 2
            assert payload["job"]["version"] == 2
            assert want["job"]["version"] == 0
            payload = {k: v for k, v in payload.items() if k != "job"}
        if label == "gc":
            # each package compacts its own tables (and a live snapshot
            # pins rows): tests/test_torch_actors.py does not compare it
            # either
            payload = {k: v for k, v in payload.items()
                       if k != "rows_compacted"}
        same_on_port_fields(payload, want, label)


@pytest.fixture(params=PKGS)
def stack(request, cluster_nodes, ref_nodes):
    pkg = request.param
    with Stack(pkg, nodes_for(pkg, cluster_nodes, ref_nodes)) as st:
        yield st


LEFT_FOR_LATER = [
    ("GET", "/v1/acl/tokens"), ("GET", "/v1/acl/policies"),
    ("GET", "/v1/vars"), ("GET", "/v1/var/a/b"), ("GET", "/v1/regions"),
    ("GET", "/v1/operator/regions"), ("GET", "/v1/agent/members"),
    ("GET", "/"), ("GET", "/ui"),
    ("POST", "/v1/acl/bootstrap"), ("POST", "/v1/acl/token"),
    ("POST", "/v1/var/a"), ("POST", "/v1/job/x/dispatch"),
    ("POST", "/v1/agent/join"), ("POST", "/v1/operator/region/r2"),
    ("POST", "/v1/client/allocation/x/exec"), ("DELETE", "/v1/var/a"),
    ("DELETE", "/v1/acl/role/r")]


def test_routes_left_for_later_answer_404():
    with Stack(PORT, []) as st:
        for method, path in LEFT_FOR_LATER:
            status, payload, _ = st.call(method, path,
                                         {} if method == "POST" else None)
            assert status == 404, (method, path, payload)


def test_body_and_deadline_rules(stack):
    """413 from the header alone, 400 for malformed JSON, both before
    any store access; 504 once X-Nomad-Deadline passed; 404 unknown."""
    pkg = PORT if isinstance(stack.srv, port_server.Server) else REF
    index0 = stack.srv.store.latest_index
    status, payload = oversized(stack.agent.address,
                                pkg.http.MAX_BODY_BYTES)
    assert status == 413 and "too large" in payload["error"]
    status, payload, _ = stack.call("POST", "/v1/jobs", raw=b"{not json")
    assert status == 400 and "malformed JSON" in payload["error"]
    past = {"X-Nomad-Deadline": f"{time.time() - 1:.6f}"}
    for method in ("GET", "POST", "DELETE"):
        status, payload, _ = stack.call(method, "/v1/jobs", headers=past)
        assert status == 504, method
    status, _, _ = stack.call("GET", "/v1/jobs", headers={
        "X-Nomad-Deadline": f"{time.time() + 30:.6f}"})
    assert status == 200
    assert stack.srv.store.latest_index == index0
    assert stack.call("GET", "/v1/no/such/route")[0] == 404


def test_reads_metrics_traces_events_and_agent(stack):
    """The agent's own routes: metrics as JSON with the live gauges and
    as prometheus text that parses, the trace export, the event stream
    seeing a registration, the thread dump, a profile, the monitor."""
    out = {}

    def stream():
        out["events"] = call(stack.agent.address, "GET",
                             "/v1/event/stream?topic=Job&wait=2s",
                             timeout=15)
    # other subscribers may be parked already: wait for this one's park
    parked0 = stack.srv.events.waiter_count()
    t = threading.Thread(target=stream)
    t.start()
    _wait(lambda: stack.srv.events.waiter_count() > parked0)
    job = ref_job_json(2)
    assert stack.call("POST", "/v1/jobs", {"job": job})[0] == 200
    stack.idle()
    t.join(15)
    status, body, _ = out["events"]
    assert status == 200
    # one event parses as a dict, several as ndjson text
    lines = ([json.loads(x) for x in body.splitlines()]
             if isinstance(body, str) else [body])
    assert any(e["Topic"] == "Job" and e["Key"] == job["id"]
               for e in lines)
    status, metrics, _ = stack.call("GET", "/v1/metrics")
    assert status == 200
    for key in ("nomad.broker.total_unacked", "nomad.reads.parked",
                "nomad.reads.event_waiters", "nomad.state.live_snapshots",
                "nomad.blocked_evals.total_blocked", "broker", "plan"):
        assert key in metrics, key
    status, text, hdrs = stack.call("GET", "/v1/metrics?format=prometheus")
    assert status == 200 and hdrs["content-type"].startswith("text/plain")
    samples = [x for x in text.splitlines() if x and not x.startswith("#")]
    assert samples
    for line in samples:
        name, value = line.split(" ")
        assert name.replace("_", "").isalnum()
        float(value)
    status, traces, _ = stack.call("GET", "/v1/traces?limit=50")
    assert status == 200
    assert set(traces) == {"enabled", "total_spans", "phases", "trace"}
    assert len(traces["trace"]["traceEvents"]) <= 50
    status, me, _ = stack.call("GET", "/v1/agent/self")
    assert status == 200 and set(me["stats"]) == {
        "broker", "plan_applier", "blocked_evals"}
    status, dump, _ = stack.call("GET", "/v1/agent/pprof/threads")
    assert status == 200 and dump["threads"] >= 1
    status, prof, _ = stack.call(
        "GET", "/v1/agent/pprof/profile?seconds=0.05&hz=100")
    assert status == 200 and prof["samples"] >= 1
    assert stack.call("GET", "/v1/agent/pprof/profile?seconds=x")[0] == 400
    status, _, hdrs = stack.call("GET", "/v1/agent/monitor?wait=0.05")
    assert status == 200
    assert stack.call("GET", "/v1/event/stream?wait=bogus")[0] == 400


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_save_and_restore(pkg, cluster_nodes, ref_nodes):
    """GET /v1/operator/snapshot dumps the store; POST restores it."""
    with Stack(pkg, nodes_for(pkg, cluster_nodes, ref_nodes)) as st:
        st.call("POST", "/v1/namespace/team-b", {})
        status, dump, _ = st.call("GET", "/v1/operator/snapshot")
        assert status == 200 and len(dump["nodes"]) == N_NODES
        assert [x["__f"]["name"] for x in dump["namespaces"]] == ["team-b"]
        st.call("DELETE", "/v1/namespace/team-b")
        status, out, _ = st.call("POST", "/v1/operator/snapshot", dump)
        assert status == 200 and out["restored"]
        names = [n["name"] for n in st.call("GET", "/v1/namespaces")[1]]
        assert "team-b" in names


# -- blocking queries ------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
class TestWatchTable:
    def test_immediate_when_past(self, pkg):
        st = pkg.StateStore()
        st.upsert_node(_node(pkg))
        assert st.watches.wait_min_index(1, 0.5) == (st.latest_index, None)

    def test_timeout_returns_current(self, pkg):
        st = pkg.StateStore()
        t0 = time.time()
        idx, ts = st.watches.wait_min_index(5, 0.05)
        assert idx == 0 and ts is None and time.time() - t0 < 2.0
        assert st.watches.parked() == 0

    def test_commit_wakes_parked_selectively(self, pkg):
        st = pkg.StateStore()
        got = {}

        def park(name, want):
            got[name] = st.watches.wait_min_index(want, 10.0)
        near = threading.Thread(target=park, args=("near", 1))
        far = threading.Thread(target=park, args=("far", 3))
        near.start()
        far.start()
        _wait(lambda: st.watches.parked() == 2)
        st.upsert_node(_node(pkg))
        near.join(10)
        assert got["near"][0] == 1 and got["near"][1] is not None
        assert "far" not in got and st.watches.parked() == 1
        st.upsert_node(_node(pkg))
        st.upsert_node(_node(pkg))
        far.join(10)
        assert got["far"][0] == 3 and st.watches.parked() == 0

    def test_many_waiters_one_batch(self, pkg):
        st = pkg.StateStore()
        threads = [threading.Thread(target=st.watches.wait_min_index,
                                    args=(1, 10.0)) for _ in range(16)]
        for t in threads:
            t.start()
        _wait(lambda: st.watches.parked() == 16)
        st.upsert_node(_node(pkg))
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert st.watches.parked() == 0


def test_teardown_wakes_every_parked_waiter():
    """The port's Server.stop wakes its store's parked queries (the
    reference's teardown only flushes its coalescing window)."""
    st = PortStateStore()
    threads = [threading.Thread(target=st.watches.wait_min_index,
                                args=(10, 30.0)) for _ in range(4)]
    for t in threads:
        t.start()
    _wait(lambda: st.watches.parked() == 4)
    st.watches.teardown()
    for t in threads:
        t.join(5)
    assert not any(t.is_alive() for t in threads)
    assert st.watches.parked() == 0


def _node(pkg):
    from nomad_tpu import mock as ref_mock
    from nomad_tpu_torch import mock as port_mock

    return (port_mock if pkg is PORT else ref_mock).node()


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out"
        time.sleep(0.005)


def test_blocking_query_over_http(stack):
    """A GET with ``index`` parks until a commit passes it; its
    X-Nomad-Index is the snapshot it read, never ahead of the store;
    ``wait`` takes seconds or a Go duration and bounds the park."""
    status, jobs, hdrs = stack.call("GET", "/v1/jobs")
    idx = int(hdrs["x-nomad-index"])
    assert status == 200 and idx <= stack.srv.store.latest_index
    out = {}

    def block():
        t0 = time.time()
        out["r"] = stack.call("GET", f"/v1/jobs?index={idx}&wait=10s",
                              timeout=20)
        out["s"] = time.time() - t0
    t = threading.Thread(target=block)
    t.start()
    _wait(lambda: stack.srv.store.watches.parked() >= 1)
    job = ref_job_json(2)
    stack.call("POST", "/v1/jobs", {"job": job})
    t.join(15)
    status, jobs, hdrs = out["r"]
    woke = int(hdrs["x-nomad-index"])
    assert status == 200 and woke > idx and out["s"] < 10.0
    assert woke <= stack.srv.store.latest_index
    assert job["id"] in [j["id"] for j in jobs]
    stack.idle()
    for wait in ("0.2", "200ms"):
        now = stack.srv.store.latest_index
        t0 = time.time()
        status, _, hdrs = stack.call("GET",
                                     f"/v1/jobs?index={now}&wait={wait}")
        assert status == 200 and int(hdrs["x-nomad-index"]) == now
        assert 0.15 < time.time() - t0 < 2.0, wait


@pytest.mark.parametrize("raw,want", [
    ("10", 10.0), ("2.5", 2.5), ("10s", 10.0), ("250ms", 0.25),
    ("1m", 60.0), ("1h", 3600.0), ("", None), ("bogus", None),
    ("5x", None), ("ms", None)])
def test_wait_values_parse_as_the_reference(raw, want):
    """Plain seconds or a Go duration; garbage is None, which a blocking
    query turns into its 5 s default and the event stream into a 400."""
    assert port_http._parse_wait(raw) == ref_http._parse_wait(raw) == want


def test_parked_query_returns_when_the_agent_stops(cluster_nodes, ref_nodes):
    """HTTPAgent.stop wakes a parked blocking query and joins its
    handler thread: nothing of the agent outlives it."""
    before = {t.ident for t in threading.enumerate()}
    with Stack(PORT, nodes_for(PORT, cluster_nodes, ref_nodes)) as st:
        idx = st.srv.store.latest_index
        out = {}

        def block():
            try:
                out["r"] = st.call("GET", f"/v1/jobs?index={idx}&wait=30",
                                   timeout=40)
            except OSError as e:  # the agent shut the connection
                out["r"] = e
        t = threading.Thread(target=block)
        t.start()
        _wait(lambda: st.srv.store.watches.parked() >= 1)
        st.agent.stop()
        t.join(10)
        assert not t.is_alive()
        st.agent.stop = lambda: None
    left = [t for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
    assert left == [], left


# -- the dry-run plan -------------------------------------------------------


@pytest.fixture
def services(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    port_svc = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port_svc)
    yield port_svc
    ref_svc.stop()
    port_svc.stop()


def test_bulk_plan_commits_nothing_and_leaves_no_phantom(
        monkeypatch, services, cluster_nodes, ref_nodes):
    """Under "tpu-binpack": a placed bulk job, then the dry run of a
    second (B1 solves it against the service's carry; every planned node
    comes back rejected, so its usage is corrected out), then that job
    registered. The plan reply equals the reference's, the store's index
    does not move, and the registered job places as on the reference:
    a phantom left in the carry would move its placements."""
    base = ref_job_json(600, batch=True)
    planned = ref_job_json(800, batch=True)
    got = {}
    for pkg in (REF, PORT):
        _pin_ids(monkeypatch)
        with Stack(pkg, nodes_for(pkg, cluster_nodes, ref_nodes),
                   alg="tpu-binpack") as st:
            st.call("POST", "/v1/jobs", {"job": base})
            st.idle()
            index0 = st.srv.store.latest_index
            status, plan, _ = st.call(
                "POST", f"/v1/job/{planned['id']}/plan", {"job": planned})
            assert status == 200
            assert st.srv.store.latest_index == index0
            assert plan["annotations"][planned["task_groups"][0]["name"]][
                "place"] == 800
            st.call("POST", "/v1/jobs", {"job": planned})
            st.idle()
            jobs = [types.SimpleNamespace(id=base["id"]),
                    types.SimpleNamespace(id=planned["id"])]
            got[pkg.name] = (drop_wall_clock(plan),
                             fingerprint(st.srv.store, jobs))
    same_on_port_fields(got["port"][0], got["ref"][0])
    for jid, want in got["ref"][1].items():
        have = got["port"][1][jid]
        assert have[:2] == want[:2], jid
        assert np.allclose(have[2], want[2], rtol=0, atol=1e-12), jid


# -- the replicated cluster --------------------------------------------------


def replicated(pkg):
    def cfg(i):
        return pkg.cfg(num_workers=1, heartbeat_ttl=3600, gc_interval=3600)
    if pkg is PORT:
        return pkg.RaftCluster(3, config_fn=cfg, election_timeout=1.0)
    c = pkg.RaftCluster(3, config_fn=cfg)
    for s in c.servers.values():
        s.raft.election_timeout = 1.0
    return c


@pytest.mark.parametrize("pkg", PKGS)
def test_follower_agent_forwards_writes_and_reads_with_headers(pkg):
    c = replicated(pkg)
    agents = {}
    try:
        c.start()
        leader = c.wait_for_leader(10.0)
        assert leader is not None
        for sid, s in c.servers.items():
            agents[sid] = pkg.http.HTTPAgent(s.server, port=0,
                                             writer=s).start()
        follower = next(s for s in c.servers.values() if s is not leader)
        fa = agents[follower.id].address
        la = agents[leader.id].address
        # a write through the follower's agent lands on the leader
        status, _, _ = call(fa, "POST", "/v1/namespace/team-c", {})
        assert status == 200
        status, nss, hdrs = call(fa, "GET", "/v1/namespaces")
        assert status == 200 and "team-c" in [n["name"] for n in nss]
        assert hdrs["x-nomad-knownleader"] == "true"
        assert 0 <= int(hdrs["x-nomad-lastcontact"]) < 5000
        assert int(hdrs["x-nomad-index"]) <= \
            follower.local_store.latest_index
        assert call(la, "GET", "/v1/namespaces")[2][
            "x-nomad-lastcontact"] == "0"
        for mode in ("stale=true", "consistent=true"):
            status, nss, _ = call(fa, "GET", f"/v1/namespaces?{mode}")
            assert status == 200 and "team-c" in [n["name"] for n in nss]
        status, who, _ = call(fa, "GET", "/v1/status/leader")
        assert who == {"leader": leader.id, "is_leader": False}
        status, cfg, _ = call(fa, "GET", "/v1/operator/raft/configuration")
        assert cfg["leader"] == leader.id and cfg["mode"] == "raft"
        assert sorted(s["id"] for s in cfg["servers"]) == sorted(c.servers)
        # the follower's blocking query wakes on the leader's commit
        idx = int(call(fa, "GET", "/v1/namespaces")[2]["x-nomad-index"])
        out = {}

        def block():
            out["r"] = call(fa, "GET",
                            f"/v1/namespaces?index={idx}&wait=10",
                            timeout=20)
        t = threading.Thread(target=block)
        t.start()
        _wait(lambda: follower.local_store.watches.parked() >= 1)
        call(la, "POST", "/v1/namespace/team-d", {})
        t.join(15)
        assert int(out["r"][2]["x-nomad-index"]) > idx
        # the leader crashes: the follower names the new one
        agents.pop(leader.id).stop()
        c.crash(leader.id)
        new = None
        deadline = time.time() + 10
        while new is None and time.time() < deadline:
            new = next((s for s in c.servers.values()
                        if not getattr(s, "crashed", False)
                        and s.is_leader()), None)
            time.sleep(0.01)
        assert new is not None
        _wait(lambda: call(fa, "GET", "/v1/status/leader")[1]["leader"]
              == new.id)
        assert call(fa, "POST", "/v1/namespace/team-e", {})[0] == 200
    finally:
        for a in agents.values():
            a.stop()
        c.stop()
