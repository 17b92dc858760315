"""The port's command line (nomad_tpu_torch/cli.py, agent_config.py,
__main__.py) against the reference's: the agent config fixtures of
tests/test_agent_config.py parsed to the same values; ``job run``,
``job status``, ``job stop``, ``node status``, ``alloc status``,
``alloc logs``, ``alloc fs`` and ``service list`` / ``info`` printing
the same output against each package's own agent
and clients (ids and times masked); ``python -m nomad_tpu_torch agent
--device cpu`` started from a config file, placing and running a job
through the CLI, reloading its algorithm on SIGHUP and stopping on
SIGTERM with exit 0; the flags of parts not ported refused with their
ROADMAP item; no command whose route the port's agent answers 404."""

import argparse
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import pytest
import torch

import bench
from nomad_tpu import agent_config as ref_agent_config
from nomad_tpu import cli as ref_cli
from nomad_tpu.api import http as ref_http
from nomad_tpu.client import Client as RefClient
from nomad_tpu.client import ClientConfig as RefClientConfig
from nomad_tpu.core import server as ref_server
from nomad_tpu.state.store import StateStore as RefStateStore
from nomad_tpu_torch import agent_config as port_agent_config
from nomad_tpu_torch import cli as port_cli
from nomad_tpu_torch import convert
from nomad_tpu_torch.api import http as port_http
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.core import server as port_server

from test_agent_config import HCL
from test_torch_api import WALL_CLOCK
from test_torch_jobspec import same_on_port_fields
from test_torch_pipeline import node_record
from test_torch_server import _pin_ids

REPO = Path(__file__).resolve().parent.parent
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
# a task state's clock readings beside the API's wall-clock fields, and
# the store's indexes: each client status round is a commit, and how the
# clients' rounds fall depends on timing
CLOCK = WALL_CLOCK + ("started_at", "finished_at", "last_restart",
                      "create_index", "modify_index", "job_modify_index",
                      "alloc_modify_index")


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --------------------------------------------------------------------------
# agent config
# --------------------------------------------------------------------------


@pytest.mark.parametrize("text,path", [
    (HCL, "<config>"),
    (json.dumps({"http_port": 1, "server": {"workers": 9},
                 "client": {"enabled": False}}), "agent.json"),
    (json.dumps({"data_dir": "/d", "server": {
        "algorithm": "tpu-binpack", "peers": "a=b:1", "server_id": "a"},
        "client": {"count": 3, "plugin_dir": "/p"}}), "agent.json")])
def test_agent_config_parses_as_the_reference(text, path):
    got = dataclasses.asdict(port_agent_config.parse_agent_config(text, path))
    want = dataclasses.asdict(ref_agent_config.parse_agent_config(text, path))
    assert got == want


def test_flags_override_the_file_as_the_reference():
    """The parsers' defaults of the file's keys are the reference's, and
    the merge gives the same arguments."""
    out = {}
    for cli, cfg in ((port_cli, port_agent_config),
                     (ref_cli, ref_agent_config)):
        defaults_ns = cli.build_parser().parse_args(["agent"])
        defaults = {k: getattr(defaults_ns, k) for k in cli.AGENT_FLAG_KEYS}
        args = argparse.Namespace(**defaults)
        args.workers = 8
        cfg.apply_to_args(cfg.parse_agent_config(HCL), args, defaults)
        out[cli.__name__] = (defaults, vars(args))
    assert port_cli.AGENT_FLAG_KEYS == ref_cli.AGENT_FLAG_KEYS
    assert out["nomad_tpu_torch.cli"] == out["nomad_tpu.cli"]
    args = out["nomad_tpu_torch.cli"][1]
    assert (args["workers"], args["port"], args["algorithm"],
            args["clients"]) == (8, 14747, "spread", 2)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("argv,item", [
    (["--peers", "s0=127.0.0.1:7101"], "A10.2"),
    (["--join", "127.0.0.1:7101"], "A10.2"),
    (["--gossip", "127.0.0.1:7102"], "A10.2"),
    (["--retry-join", "127.0.0.1:7102"], "A10.2"),
    (["--server-id", "s1"], "A10.2"),
    (["--plugin-dir", "/plugins"], "A10.10"),
    (["--region", "eu"], "federation")])
def test_agent_refuses_what_is_not_ported(argv, item, capsys):
    assert port_cli.main(["agent", "--device", "cpu", *argv]) == 1
    assert item in capsys.readouterr().err


def test_agent_config_file_with_peers_is_refused(tmp_path, capsys):
    conf = tmp_path / "agent.hcl"
    conf.write_text('server {\n  peers = "s0=127.0.0.1:7101"\n}\n')
    assert port_cli.main(["agent", "--device", "cpu", "-config",
                          str(conf)]) == 1
    assert "A10.2" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["job", "dispatch", "j"], ["alloc", "exec", "a", "sh"], ["var", "list"],
    ["acl", "bootstrap"], ["region", "list"], ["server", "join", "x"],
    ["operator", "debug"]])
def test_commands_on_404_routes_are_not_registered(argv, capsys):
    with pytest.raises(SystemExit):
        port_cli.main(argv)
    assert ref_cli.build_parser().parse_args(argv)


def test_agent_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the agent runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        port_cli.build_agent(clients=0, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        port_cli.main(["agent", "--clients", "0", "--port", "0"])


# --------------------------------------------------------------------------
# the commands against each package's own agent
# --------------------------------------------------------------------------

BATCH_HCL = """
job "cli-batch" {
  datacenters = ["dc1"]
  type = "batch"
  group "work" {
    count = 4
    task "work" {
      driver = "mock"
      config {
        run_for = 0.1
        stdout_string = "hello from a mock task"
      }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""

ECHO_HCL = """
job "cli-echo" {
  datacenters = ["dc1"]
  type = "batch"
  group "sh" {
    count = 1
    task "sh" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args = ["-c", "echo hello from the cli"]
      }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""

SVC_HCL = """
job "cli-svc" {
  datacenters = ["dc1"]
  group "web" {
    count = 2
    service "cli-web" {
      tags = ["a", "b"]
    }
    task "web" {
      driver = "mock"
      config { run_for = 600 }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""

REF = types.SimpleNamespace(
    name="ref", cli=ref_cli, http=ref_http, Client=RefClient,
    ClientConfig=RefClientConfig,
    server=lambda **kw: ref_server.Server(ref_server.ServerConfig(**kw)))
PORT = types.SimpleNamespace(
    name="port", cli=port_cli, http=port_http, Client=Client,
    ClientConfig=ClientConfig,
    server=lambda **kw: port_server.Server(port_server.ServerConfig(
        device="cpu", **kw)))


def _masked(text: str) -> str:
    return UUID.sub("<id>", text)


def _no_clock(value):
    if isinstance(value, dict):
        return {k: _no_clock(v) for k, v in value.items()
                if k not in CLOCK}
    if isinstance(value, list):
        return [_no_clock(v) for v in value]
    return value


def _session(pk, nodes, tmp_path, capsys):
    """Each command's output against the package's own agent: text
    masked, JSON parsed."""
    srv = pk.server(num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
                    gc_interval=3600)
    out = []
    with srv:
        agent = pk.http.HTTPAgent(srv, port=0).start()
        clients = []
        try:
            for i, n in enumerate(nodes):
                c = pk.Client(srv, pk.ClientConfig(
                    data_dir=str(tmp_path / f"{pk.name}{i}")), node=n)
                c.start()
                clients.append(c)
            agent.clients = clients

            def run(*argv, as_json=False):
                rc = pk.cli.main(["--address", agent.address, *argv])
                text = capsys.readouterr().out
                out.append((argv[:2], rc, json.loads(text) if as_json
                            else _masked(text)))
                return text

            def done(jid, n):
                allocs = srv.store.snapshot().allocs_by_job(jid)
                return len(allocs) == n and all(
                    a.client_status == "complete" for a in allocs)

            # one job at a time, each run to its end: a placement's scores
            # read the usage, which a running alloc still holds
            for name, text, jid, n in (("echo", ECHO_HCL, "cli-echo", 1),
                                       ("batch", BATCH_HCL, "cli-batch", 4)):
                path = tmp_path / f"{pk.name}-{name}.hcl"
                path.write_text(text)
                run("job", "run", str(path))
                assert _wait(lambda: done(jid, n))
                assert srv.wait_for_idle(10.0, include_delayed=False)
            run("job", "status", "cli-batch")
            run("job", "status", as_json=True)
            run("node", "status", as_json=True)
            run("node", "status", nodes[0].id, as_json=True)
            (echo,) = srv.store.snapshot().allocs_by_job("cli-echo")
            first = srv.store.snapshot().allocs_by_job("cli-batch")[0]
            run("alloc", "status", echo.id, as_json=True)
            run("alloc", "logs", first.id)
            # the raw_exec task's line through the executor, the port's
            # only: the reference's executor can exit before its log
            # reader drains the pipe (ROADMAP §C14)
            echo_log = pk.cli.main(["--address", agent.address, "alloc",
                                    "logs", echo.id])
            text = capsys.readouterr().out
            out.append((("echo", "logs"), echo_log,
                        text if pk is PORT else None))
            run("alloc", "fs", echo.id, "/")
            with urllib.request.urlopen(
                    f"{agent.address}/v1/client/stats", timeout=10) as r:
                stats = json.loads(r.read())
            out.append((("client", "stats"), 0,
                        sorted(sorted(s) for s in stats)))
            run("job", "stop", "cli-batch")
            path = tmp_path / f"{pk.name}-svc.hcl"
            path.write_text(SVC_HCL)
            run("job", "run", str(path))
            assert _wait(lambda: len(list(
                srv.store.snapshot().service_registrations())) == 2)
            run("service", "list")
            run("service", "info", "cli-web")
            run("job", "stop", "cli-svc")
            assert _wait(lambda: not list(
                srv.store.snapshot().service_registrations()))
        finally:
            agent.stop()
            for c in clients:
                c.stop()
    return out


def test_commands_print_as_the_reference(monkeypatch, tmp_path, capsys):
    src = RefStateStore()
    bench.build_nodes(src, 2)
    ref_nodes = list(src.snapshot().nodes())
    records = [node_record(n) for n in ref_nodes]
    _pin_ids(monkeypatch)
    want = _session(REF, ref_nodes, tmp_path, capsys)
    _pin_ids(monkeypatch)
    got = _session(PORT, convert.nodes_from_records(records), tmp_path,
                   capsys)
    assert [o[:2] for o in got] == [o[:2] for o in want]
    assert all(rc == 0 for _, rc, _ in got)
    for (cmd, _, payload), (_, _, ref) in zip(got, want):
        if cmd == ("client", "stats"):
            # one sample a client, the reference's keys but its device
            # plugins' (A10.10)
            assert len(payload) == len(ref) == 2
            assert all(set(p) == set(r) - {"device_stats"}
                       for p, r in zip(payload, ref)), (payload, ref)
        elif cmd == ("echo", "logs"):
            continue
        elif cmd == ("service", "info"):
            # the registrations in the order their clients made them
            assert sorted(payload.splitlines()) == sorted(
                ref.splitlines()), cmd
        elif isinstance(payload, str):
            assert payload == ref, cmd
        else:
            same_on_port_fields(_no_clock(payload), _no_clock(ref),
                                " ".join(cmd))
    logs = [p for cmd, _, p in got if cmd == ("alloc", "logs")]
    assert logs == ["hello from a mock task"]
    assert [p for cmd, _, p in got if cmd == ("echo", "logs")] == [
        "hello from the cli\n"]
    status = [p for cmd, _, p in got if cmd == ("job", "status")][0]
    assert status.count("complete") == 4
    services = [p for cmd, _, p in got if cmd == ("service", "list")]
    assert services == ["cli-web\t2 instance(s)\ttags=a,b\n"]


# --------------------------------------------------------------------------
# python -m nomad_tpu_torch agent
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_agent_process_runs_a_job_reloads_and_stops(tmp_path):
    """The agent from a config file on the CPU with two clients: a job
    run through the CLI completes on them, SIGHUP reloads the algorithm,
    SIGTERM ends the process with exit 0."""
    port = _free_port()
    conf = tmp_path / "agent.hcl"
    conf.write_text(f'data_dir = "{tmp_path}/data"\nhttp_port = {port}\n'
                    'server {\n  workers = 1\n  algorithm = "binpack"\n}\n'
                    'client {\n  count = 2\n}\n')
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    log = open(tmp_path / "agent.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "--device", "cpu",
         "-config", str(conf)],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    addr = f"http://127.0.0.1:{port}"

    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "--address", addr,
             *argv], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=60)

    try:
        assert _wait(lambda: "agent started" in
                     (tmp_path / "agent.log").read_text(), 60.0)
        nodes = json.loads(cli("node", "status").stdout)
        assert len(nodes) == 2
        spec = tmp_path / "batch.hcl"
        spec.write_text(BATCH_HCL)
        run = cli("job", "run", str(spec))
        assert run.returncode == 0, run.stderr
        assert "-> complete" in run.stdout
        assert _wait(lambda: cli("job", "status", "cli-batch").stdout.count(
            "complete") == 4, 30.0)
        conf.write_text(conf.read_text().replace('"binpack"', '"spread"'))
        proc.send_signal(signal.SIGHUP)
        assert _wait(lambda: json.loads(cli(
            "operator", "scheduler", "get-config").stdout)[
            "scheduler_algorithm"] == "spread", 30.0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        text = (tmp_path / "agent.log").read_text()
        assert "config reloaded: algorithm=spread" in text
        assert "agent stopped" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()


def test_jobspec_takes_an_ephemeral_disk_stanza():
    """The port's parser reads a group's ``ephemeral_disk`` (Nomad's
    jobspec has it; the reference's parser skips it)."""
    from nomad_tpu.api.jobspec import parse_hcl_like as ref_parse
    from nomad_tpu_torch.api.jobspec import parse_hcl_like

    text = BATCH_HCL.replace(
        "count = 4", "count = 4\n    ephemeral_disk {\n      size = 10\n"
        "      sticky = true\n    }")
    tg = parse_hcl_like(text).task_groups[0]
    assert (tg.ephemeral_disk.size_mb, tg.ephemeral_disk.sticky,
            tg.ephemeral_disk.migrate) == (10, True, False)
    assert ref_parse(text).task_groups[0].ephemeral_disk.size_mb == 300
    assert parse_hcl_like(BATCH_HCL).task_groups[0].ephemeral_disk.size_mb \
        == 300
