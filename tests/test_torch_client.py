"""The port's client (nomad_tpu_torch/client/) against the reference's
(nomad_tpu/client/): the host fingerprint, the card fingerprinted as an
``nvidia/gpu`` group (a fake ``torch.cuda`` beside the reference's fake
JAX) and a GPU ask placed onto it, the drivers, the state DB, the
executor without torch, a restarted client re-attaching a running
raw_exec task, and one pinned scenario through both packages' Servers
and clients: a batch group of 300 (the bulk path), a 32-alloc spread
group with a service, a task failing past its restart policy and a job
stop -- each alloc's node, statuses, task events and restarts, the
retry-failed-alloc evals and the service registrations equal. Every
wait has its own deadline."""

import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

import bench
from nomad_tpu import mock as ref_mock
from nomad_tpu.client import Client as RefClient
from nomad_tpu.client import ClientConfig as RefClientConfig
from nomad_tpu.client import drivers as ref_drivers
from nomad_tpu.client import fingerprint as ref_fingerprint
from nomad_tpu.client.state_db import ClientStateDB as RefStateDB
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.structs import Spread as RefSpread
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.structs.job import ReschedulePolicy as RefReschedule
from nomad_tpu.structs.job import RestartPolicy as RefRestart
from nomad_tpu.structs.job import Service as RefService
from nomad_tpu.structs.job import Task as RefTask
from nomad_tpu.structs.resources import RequestedDevice as RefDevice
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness as RefHarness
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.client import drivers as port_drivers
from nomad_tpu_torch.client import fingerprint as port_fingerprint
from nomad_tpu_torch.client.state_db import ClientStateDB
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.structs import Spread
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.structs.job import (ReschedulePolicy, RestartPolicy,
                                         Service, Task)
from nomad_tpu_torch.structs.resources import RequestedDevice
from nomad_tpu_torch.testing import Harness

from test_torch_pipeline import node_record, port_service  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
EXECUTOR = REPO / "nomad_tpu_torch" / "client" / "executor.py"


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --------------------------------------------------------------------------
# fingerprint
# --------------------------------------------------------------------------


def _fixed_disk(monkeypatch):
    """Both packages read the disk's free space through shutil: pin it,
    so two fingerprints a moment apart agree."""
    usage = shutil.disk_usage("/")
    monkeypatch.setattr(shutil, "disk_usage", lambda path: usage)


def test_fingerprint_equals_the_reference(monkeypatch, tmp_path):
    """On this host: the same attributes, resources, drivers and computed
    class (no card here: neither package finds an accelerator)."""
    _fixed_disk(monkeypatch)
    ref = ref_fingerprint.fingerprint(node_id="n-1", data_dir=str(tmp_path))
    got = port_fingerprint.fingerprint(node_id="n-1",
                                       data_dir=str(tmp_path))
    assert got.attributes == ref.attributes
    assert got.drivers == ref.drivers
    for key in ("cpu", "memory_mb", "disk_mb", "total_cores"):
        assert getattr(got.resources, key) == getattr(ref.resources, key)
    assert got.resources.devices == [] == ref.resources.devices
    assert got.computed_class == ref.computed_class
    assert got.ready() and got.name == ref.name


def _fake_torch(names):
    cuda = types.SimpleNamespace(
        is_available=lambda: True, device_count=lambda: len(names),
        get_device_name=lambda i: names[i])
    return types.SimpleNamespace(cuda=cuda)


def _fake_jax(names):
    devices = [types.SimpleNamespace(id=i, platform="gpu", device_kind=n)
               for i, n in enumerate(names)]
    return types.SimpleNamespace(devices=lambda: devices)


def test_card_fingerprints_as_nvidia_gpu_and_places(monkeypatch, tmp_path):
    """Two cards through a fake torch.cuda beside the reference's fake
    JAX (tests/test_client.py:426-474): one group of the same type, name,
    instance ids and attributes; the vendor is ``nvidia`` where the
    reference says ``gpu`` (ROADMAP §C); a two-card ask lands on the node
    in both packages."""
    names = ["NVIDIA H100 80GB HBM3"] * 2
    monkeypatch.setitem(sys.modules, "torch", _fake_torch(names))
    port_node = port_fingerprint.fingerprint(data_dir=str(tmp_path))
    monkeypatch.setitem(sys.modules, "jax", _fake_jax(names))
    ref_node = ref_fingerprint.fingerprint(data_dir=str(tmp_path))
    monkeypatch.undo()
    (g,), (rg,) = port_node.resources.devices, ref_node.resources.devices
    assert (g.type, g.name, g.instance_ids, g.attributes) == (
        rg.type, rg.name, rg.instance_ids, rg.attributes)
    assert g.id == "nvidia/gpu/nvidia-h100-80gb-hbm3"
    assert (g.vendor, rg.vendor) == ("nvidia", "gpu")
    assert g.instance_ids == ["gpu-0", "gpu-1"]
    assert port_node.attributes[f"device.{g.id}.count"] == "2"
    assert ref_node.attributes[f"device.{rg.id}.count"] == "2"

    for pk, node, ask, H in (
            (port_mock, port_node, RequestedDevice, Harness),
            (ref_mock, ref_node, RefDevice, RefHarness)):
        h = H(device="cpu") if H is Harness else H()
        h.store.upsert_node(node)
        h.store.upsert_node(pk.node())
        job = pk.job()
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].resources.devices = [
            ask(name=f"{node.resources.devices[0].vendor}/gpu", count=2)]
        h.store.upsert_job(job)
        h.process(pk.eval_for(job))
        (alloc,) = [a for a in h.store.snapshot().allocs_by_job(job.id)
                    if not a.terminal_status()]
        assert alloc.node_id == node.id
        assert alloc.allocated_devices == {
            node.resources.devices[0].id: ["gpu-0", "gpu-1"]}


def test_fingerprint_leaves_cuda_alone_without_torch(monkeypatch, tmp_path):
    """Without torch imported the fingerprint does not import it."""
    monkeypatch.delitem(sys.modules, "torch")
    node = port_fingerprint.fingerprint(data_dir=str(tmp_path))
    assert "torch" not in sys.modules
    assert node.resources.devices == []


# --------------------------------------------------------------------------
# drivers, state DB, executor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_mock_driver(pkg):
    drivers, T = ((port_drivers, Task) if pkg == "port"
                  else (ref_drivers, RefTask))
    d = drivers.MockDriver()
    res = d.start_task(T(driver="mock", config={"run_for": 0.05}), {},
                       "").wait(timeout=2.0)
    assert res.successful()
    res = d.start_task(T(driver="mock", config={"exit_code": 3}), {},
                       "").wait(timeout=2.0)
    assert not res.successful() and res.exit_code == 3
    h = d.start_task(T(driver="mock", config={"run_for": 60}), {}, "")
    h.kill()
    assert h.wait(1.0).signal == 9 and not h.is_running()
    with pytest.raises(drivers.DriverError, match="boom"):
        d.start_task(T(driver="mock", config={"start_error": "boom"}), {}, "")


def _exec_results(drivers, T, tmp_path):
    """raw_exec and exec: a command's exit code and output, a kill, and
    exec's scrubbed environment."""
    out = {}
    for name in ("raw_exec", "exec"):
        d = drivers.get_driver(name)
        td = tmp_path / name
        td.mkdir(parents=True)
        h = d.start_task(T(name="t", driver=name, config={
            "command": "/bin/sh",
            "args": ["-c", "echo hi > out.txt; echo ${SECRET_X:-none} "
                           ">> out.txt; exit 3"]}),
            {"NOMAD_TASK_NAME": "t"}, str(td))
        res = h.wait(timeout=10.0)
        out[name] = (res.exit_code, res.signal,
                     (td / "out.txt").read_text().split())
        h = d.start_task(T(name="s", driver=name, config={
            "command": "/bin/sleep", "args": ["60"]}), {}, str(td))
        assert h.is_running()
        h.kill(grace_s=1.0)
        out[name + "-kill"] = h.is_running()
    return out


def test_exec_drivers_equal_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("SECRET_X", "agent-env")
    got = _exec_results(port_drivers, Task, tmp_path / "port")
    want = _exec_results(ref_drivers, RefTask, tmp_path / "ref")
    assert got == want
    assert got["raw_exec"] == (3, 0, ["hi", "agent-env"])
    assert got["exec"][2] == ["hi", "none"]     # exec scrubs the env
    assert got["raw_exec-kill"] is False
    assert sorted(port_drivers.available_drivers()) == sorted(
        ref_drivers.available_drivers())
    with pytest.raises(port_drivers.DriverError):
        port_drivers.get_driver("docker")


def test_state_db_round_trip(tmp_path):
    """The state DB's file across a reopen, with the reference's cases
    (tests/test_client.py::test_state_db_roundtrip) and the batch
    writes."""
    db = ClientStateDB(str(tmp_path / "db"))
    db.set_node_id("n-123")
    a, b = port_mock.alloc(), port_mock.alloc()
    db.put_allocs([a, b])
    db.put_task_handle(a.id, "web", {"pid": 42, "starttime": 99})
    db.put_task_handle(b.id, "web", None)
    db.update_client_statuses({a.id: "running", b.id: "complete"})
    with open(tmp_path / "db" / "client_state.json") as f:
        assert json.load(f) == db._data
    db2 = ClientStateDB(str(tmp_path / "db"))
    assert db2.node_id == "n-123"
    got = {x.id: (x, h) for x, h in db2.restore_allocs()}
    assert set(got) == {a.id, b.id}
    assert got[a.id][1] == {"web": {"pid": 42, "starttime": 99}}
    assert got[b.id][1] == {}
    assert got[a.id][0].client_status == "running"
    assert got[b.id][0].client_status == "complete"
    assert got[a.id][0].job.id == a.job.id
    db2.remove_allocs([a.id, b.id])
    assert ClientStateDB(str(tmp_path / "db")).restore_allocs() == []
    # the reference's file for the same writes holds the same records
    ref = RefStateDB(str(tmp_path / "ref"))
    ra = ref_mock.alloc()
    ref.put_alloc(ra)
    ref.update_client_status(ra.id, "running")
    with open(tmp_path / "ref" / "client_state.json") as f:
        rec = json.load(f)["allocs"][ra.id]
    assert set(rec) == {"alloc", "handles", "client_status"}


def test_executor_runs_without_torch(tmp_path):
    """The executor runs as a plain script (the drivers' ``python -S
    executor.py -``): no torch, no package, and the task's exit code in
    its status file."""
    spec = {"argv": ["/bin/sh", "-c", "echo out; exit 5"], "env": {},
            "cwd": str(tmp_path), "task_name": "t",
            "logs_dir": str(tmp_path), "max_files": 2,
            "max_file_size_mb": 1, "grace_s": 1.0,
            "status_file": str(tmp_path / "status.json")}
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(EXECUTOR.parent)!r})\n"
        "import executor\n"
        f"rc = executor.run({str(tmp_path / 'spec.json')!r})\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules if m == "
        "'torch' or m.startswith(('torch.', 'nomad_tpu')))]))\n")
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-S", "-c", code],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
    status = json.loads((tmp_path / "status.json").read_text())
    assert status["exit_code"] == 5
    assert (tmp_path / "t.stdout.0").read_text() == "out\n"
    # and as the drivers start it, the spec on stdin
    spec["status_file"] = str(tmp_path / "status2.json")
    spec["task_name"] = "u"
    out = subprocess.run([sys.executable, "-S", str(EXECUTOR), "-"],
                         input=json.dumps(spec), capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads((tmp_path / "status2.json").read_text())[
        "exit_code"] == 5


# --------------------------------------------------------------------------
# the agent loop
# --------------------------------------------------------------------------


def test_restart_reattaches_a_running_raw_exec_task(tmp_path):
    """A client shut down with its raw_exec task running: a new client on
    its data dir re-attaches the same executor (a "Restored" event, no
    new process), and stop leaves neither process alive."""
    srv = port_server.Server(port_server.ServerConfig(
        device="cpu", heartbeat_ttl=30.0, gc_interval=3600))
    with srv:
        node = port_mock.node()
        c = Client(srv, ClientConfig(data_dir=str(tmp_path / "c"),
                                     heartbeat_interval=0.5), node=node)
        c.start()
        try:
            job = port_mock.job()
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0] = Task(
                name="long", driver="raw_exec",
                config={"command": "/bin/sleep", "args": ["60"]})
            srv.register_job(job)
            assert _wait(lambda: [
                a.client_status for a in
                srv.store.snapshot().allocs_by_job(job.id)] == ["running"])
            (alloc,) = srv.store.snapshot().allocs_by_job(job.id)
            pid = c.runners[alloc.id].task_runners["long"]._handle._proc.pid
            c.shutdown()
            os.kill(pid, 0)
            c2 = Client(srv, ClientConfig(data_dir=c.config.data_dir,
                                          heartbeat_interval=0.5))
            c2.start()
            try:
                assert c2.node.id == node.id and alloc.id in c2.runners
                assert _wait(lambda: (
                    c2.runners[alloc.id].task_runners.get("long")
                    is not None and c2.runners[alloc.id].task_runners[
                        "long"]._handle is not None))
                tr = c2.runners[alloc.id].task_runners["long"]
                assert tr._handle.handle_data()["executor_pid"] == pid
                assert _wait(lambda: any(e.type == "Started"
                                         for e in tr.state.events))
                assert [e.type for e in tr.state.events] == [
                    "Received", "Restored", "Started"]
                os.kill(pid, 0)
            finally:
                c2.stop()
            assert _wait(lambda: not _alive(pid), 10.0)
        finally:
            c.stop()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _pin_ids(monkeypatch):
    for mod in (ref_server, ref_generic, port_server, port_generic):
        counter = itertools.count()
        monkeypatch.setattr(
            mod, "generate_uuid",
            lambda c=counter, m=mod.__name__.split(".")[-1]:
            f"{next(c):08x}-{len(m):04x}-0000-0000-000000000000")
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])


REF = types.SimpleNamespace(
    name="ref", Client=RefClient, ClientConfig=RefClientConfig,
    Task=RefTask, Spread=RefSpread, Service=RefService,
    Restart=RefRestart, Reschedule=RefReschedule)
PORT = types.SimpleNamespace(
    name="port", Client=Client, ClientConfig=ClientConfig, Task=Task,
    Spread=Spread, Service=Service, Restart=RestartPolicy,
    Reschedule=ReschedulePolicy)


def _scenario_jobs(pk):
    batch = bench.service_job(300, cpu=50, mem=32, batch=True)
    batch.id = batch.name = "cl-batch"
    batch.task_groups[0].tasks[0] = pk.Task(
        name="work", driver="mock", config={"run_for": 0.2},
        resources=batch.task_groups[0].tasks[0].resources)
    spread = bench.service_job(
        32, cpu=50, mem=32,
        spreads=[pk.Spread(attribute="${attr.rack}", weight=50)])
    spread.id = spread.name = "cl-spread"
    tg = spread.task_groups[0]
    tg.tasks[0] = pk.Task(name="web", driver="mock",
                          config={"run_for": 600.0},
                          resources=tg.tasks[0].resources)
    tg.services = [pk.Service(name="cl-web", tags=["a", "b"])]
    fail = bench.service_job(1, cpu=50, mem=32, batch=True)
    fail.id = fail.name = "cl-fail"
    tg = fail.task_groups[0]
    tg.tasks[0] = pk.Task(name="bad", driver="mock",
                          config={"run_for": 0.05, "exit_code": 1},
                          resources=tg.tasks[0].resources)
    tg.restart_policy = pk.Restart(attempts=1, interval_s=600.0,
                                   delay_s=0.0, mode="fail")
    tg.reschedule_policy = pk.Reschedule(attempts=0, unlimited=False)
    return batch, spread, fail


def _run_scenario(pk, srv, nodes, tmp_path):
    """Register the scenario's jobs on 8 clients in turn, stop the spread
    job; -> the rows compared."""
    clients = []
    out = {}
    with srv:
        try:
            for i, n in enumerate(nodes):
                c = pk.Client(srv, pk.ClientConfig(
                    data_dir=str(tmp_path / f"{pk.name}{i}")), node=n)
                c.start()
                clients.append(c)
            batch, spread, fail = _scenario_jobs(pk)

            def st(jid):
                return sorted(a.client_status for a in
                              srv.store.snapshot().allocs_by_job(jid))

            srv.register_job(batch)
            assert _wait(lambda: st("cl-batch") == ["complete"] * 300, 60)
            srv.register_job(spread)
            assert _wait(lambda: st("cl-spread") == ["running"] * 32, 30)
            srv.register_job(fail)
            assert _wait(lambda: st("cl-fail") == ["failed"], 30)
            assert srv.wait_for_idle(30.0, include_delayed=False)
            snap = srv.store.snapshot()
            out["services"] = sorted(
                (r.service_name, snap.alloc_by_id(r.alloc_id).name,
                 r.node_id, r.task_name, r.address, r.port, r.tags, r.id)
                for r in snap.service_registrations())
            srv.deregister_job("cl-spread")
            assert _wait(lambda: st("cl-spread") == ["complete"] * 32, 30)
            assert srv.wait_for_idle(30.0, include_delayed=False)
            snap = srv.store.snapshot()
            out["services_after_stop"] = list(snap.service_registrations())
            rows = []
            for jid in ("cl-batch", "cl-spread", "cl-fail"):
                for a in snap.allocs_by_job(jid):
                    rows.append((a.id, a.name, a.node_id, a.client_status,
                                 a.desired_status, sorted(
                                     (name, [e.type for e in s.events],
                                      s.restarts, s.state, s.failed)
                                     for name, s in a.task_states.items())))
            out["rows"] = sorted(rows)
            # one a sync round that carries the failed status: a client
            # may report it in one round or two, so the kinds compare
            out["evals"] = sorted({
                (e.job_id, e.triggered_by, e.status) for e in snap.evals()
                if e.triggered_by == "alloc-failure"})
        finally:
            for c in clients:
                c.stop()
    return out


def test_pinned_scenario_equals_the_reference(monkeypatch, tmp_path,
                                              port_service):
    """Both packages' Servers (one worker, one eval a dequeue, pinned
    ids, "tpu-binpack") with 8 clients on the same nodes: the batch group
    of 300 through the bulk path (B1's plain version in the port), the
    spread group of 32 with its services, the failing task and the job
    stop give the same rows."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    _pin_ids(monkeypatch)
    ref_svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref_svc)
    try:
        ref = ref_server.Server(ref_server.ServerConfig(
            num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
            gc_interval=3600, nack_timeout=900.0,
            sched_config=ref_operator.SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack")))
        bench.build_nodes(ref.store, 8)
        ref_nodes = list(ref.store.snapshot().nodes())
        records = [node_record(n) for n in ref_nodes]
        want = _run_scenario(REF, ref, ref_nodes, tmp_path)
    finally:
        ref_svc.stop()
    srv = port_server.Server(port_server.ServerConfig(
        device="cpu", num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0,
        sched_config=port_operator.SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack")))
    nodes = convert.nodes_from_records(records)
    for n in nodes:
        srv.store.upsert_node(n)
    got = _run_scenario(PORT, srv, nodes, tmp_path)
    assert port_service.stats["launches"] >= 1
    assert len(got["services"]) == 32
    assert got["services_after_stop"] == want["services_after_stop"] == []
    assert got["evals"] == want["evals"] == [
        ("cl-fail", "alloc-failure", "complete")]
    fail = [r for r in got["rows"] if r[1].startswith("cl-fail")]
    assert fail[0][5] == [("bad", [
        "Received", "Started", "Terminated", "Restarting", "Started",
        "Terminated", "Not Restarting"], 1, "dead", True)]
    assert got["services"] == want["services"]
    assert got["rows"] == want["rows"]
