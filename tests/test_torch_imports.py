"""The port stands alone: nomad_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, and neither falls back to the CPU when asked
for the card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nomad_tpu_torch.device import resolve

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "nomad_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_importing_the_port_leaves_jax_and_reference_out():
    code = (
        "import json, sys\n"
        "import nomad_tpu_torch, nomad_tpu_torch.testing\n"
        "import nomad_tpu_torch.tensor.solver, nomad_tpu_torch.tensor.placer\n"
        "import nomad_tpu_torch.convert, chip_smoke\n"
        "import nomad_tpu_torch.scheduler.rank, nomad_tpu_torch.scheduler.spread\n"
        "import nomad_tpu_torch.scheduler.generic_sched\n"
        "import nomad_tpu_torch.tensor.overlay, nomad_tpu_torch.tensor.kernels\n"
        "import nomad_tpu_torch.structs.deployment, nomad_tpu_torch.structs.funcs\n"
        "import nomad_tpu_torch.tensor.batch_solver\n"
        "import nomad_tpu_torch.scheduler.preemption\n"
        "import nomad_tpu_torch.scheduler.system_sched\n"
        "import nomad_tpu_torch.tensor.sharding, nomad_tpu_torch.graft_entry\n"
        "import nomad_tpu_torch.obs, nomad_tpu_torch.obs.trace\n"
        "import nomad_tpu_torch.obs.recorder, nomad_tpu_torch.core\n"
        "import nomad_tpu_torch.obs.metrics, nomad_tpu_torch.core.broker\n"
        "import nomad_tpu_torch.core.blocked, nomad_tpu_torch.core.plan_apply\n"
        "import nomad_tpu_torch.core.worker, nomad_tpu_torch.core.server\n"
        "import nomad_tpu_torch.core.events, nomad_tpu_torch.state.deltas\n"
        "import nomad_tpu_torch.tensor.incremental\n"
        "import nomad_tpu_torch.scheduler.placer\n"
        "import nomad_tpu_torch.scheduler.util\n"
        "import nomad_tpu_torch.scheduler.reconcile\n"
        "import nomad_tpu_torch.core.deployments\n"
        "import nomad_tpu_torch.structs.volumes\n"
        "import nomad_tpu_torch.core.heartbeat, nomad_tpu_torch.core.drainer\n"
        "import nomad_tpu_torch.core.core_sched\n"
        "import nomad_tpu_torch.raft, nomad_tpu_torch.raft.cluster\n"
        "import nomad_tpu_torch.raft.node, nomad_tpu_torch.raft.durable\n"
        "import nomad_tpu_torch.raft.fsm, nomad_tpu_torch.raft.log\n"
        "import nomad_tpu_torch.raft.transport\n"
        "import nomad_tpu_torch.state.persist, nomad_tpu_torch.structs.wire\n"
        "import nomad_tpu_torch.utils.backoff\n"
        "import nomad_tpu_torch.utils.files\n"
        "import nomad_tpu_torch.api, nomad_tpu_torch.api.http\n"
        "import nomad_tpu_torch.api.client, nomad_tpu_torch.api.codec\n"
        "import nomad_tpu_torch.api.jobspec, nomad_tpu_torch.state.watch\n"
        "import nomad_tpu_torch.obs.export, nomad_tpu_torch.obs.__main__\n"
        "import nomad_tpu_torch.client, nomad_tpu_torch.core.allocsync\n"
        "import nomad_tpu_torch.structs.services, nomad_tpu_torch.cli\n"
        "import nomad_tpu_torch.agent_config, nomad_tpu_torch.__main__\n"
        "from nomad_tpu_torch.core import Server, ServerConfig\n"
        "from nomad_tpu_torch.core import RaftCluster, ReplicatedServer\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'nomad_tpu.')) or m == 'nomad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.structs.volumes", "nomad_tpu_torch.core.heartbeat",
    "nomad_tpu_torch.core.drainer", "nomad_tpu_torch.core.core_sched",
    "nomad_tpu_torch.core.deployments"])
def test_lifecycle_modules_import_alone(module):
    """Each module of the lifecycle's actors and of volumes, imported on
    its own in a fresh interpreter, pulls in neither jax nor the
    reference."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'nomad_tpu.')) or m == 'nomad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.client", "nomad_tpu_torch.client.client",
    "nomad_tpu_torch.client.alloc_runner",
    "nomad_tpu_torch.client.task_runner", "nomad_tpu_torch.client.drivers",
    "nomad_tpu_torch.client.executor", "nomad_tpu_torch.client.logmon",
    "nomad_tpu_torch.client.fingerprint", "nomad_tpu_torch.client.hoststats",
    "nomad_tpu_torch.client.checks", "nomad_tpu_torch.client.state_db",
    "nomad_tpu_torch.client.allocdir", "nomad_tpu_torch.client.taskenv",
    "nomad_tpu_torch.core.allocsync", "nomad_tpu_torch.structs.services",
    "nomad_tpu_torch.cli", "nomad_tpu_torch.agent_config",
    "nomad_tpu_torch.__main__"])
def test_client_modules_import_alone(module):
    """Each module of the client, the alloc sync and the command line,
    imported on its own in a fresh interpreter, pulls in neither jax nor
    the reference."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'nomad_tpu.')) or m == 'nomad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_executor_and_logmon_are_standard_library_only():
    """The executor and the log capture it imports as a plain script
    import nothing outside the standard library (a task launch pays no
    torch import and never touches the card)."""
    allowed = set(sys.stdlib_module_names) | {"logmon", "__future__"}
    for name in ("executor.py", "logmon.py"):
        path = REPO / "nomad_tpu_torch" / "client" / name
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] in allowed for n in names), (
                name, names)


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.raft", "nomad_tpu_torch.raft.cluster",
    "nomad_tpu_torch.raft.node", "nomad_tpu_torch.raft.durable",
    "nomad_tpu_torch.raft.fsm", "nomad_tpu_torch.raft.log",
    "nomad_tpu_torch.raft.transport", "nomad_tpu_torch.state.persist",
    "nomad_tpu_torch.structs.wire", "nomad_tpu_torch.utils.backoff",
    "nomad_tpu_torch.utils.files"])
def test_replicated_modules_import_alone(module):
    """Each module of the replicated control plane, imported on its own
    in a fresh interpreter, pulls in neither jax nor the reference."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'nomad_tpu.')) or m == 'nomad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _sources():
    files = sorted((REPO / "nomad_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_no_source_imports_jax_or_the_reference():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad.extend(f"{path.relative_to(REPO)}: {n}" for n in names
                       if _forbidden(n))
    assert len(_sources()) > 20
    for pkg in ("obs", "core"):
        assert (REPO / "nomad_tpu_torch" / pkg / "__init__.py") in _sources()
    for mod in ("core/events.py", "state/deltas.py", "tensor/incremental.py",
                "scheduler/placer.py", "scheduler/util.py",
                "core/deployments.py", "raft/__init__.py",
                "raft/cluster.py", "raft/node.py", "raft/durable.py",
                "raft/fsm.py", "raft/log.py", "raft/transport.py",
                "state/persist.py", "structs/wire.py",
                "utils/backoff.py", "utils/files.py", "api/__init__.py",
                "api/http.py", "api/client.py", "api/codec.py",
                "api/jobspec.py", "state/watch.py", "obs/export.py",
                "obs/__main__.py", "client/__init__.py", "client/client.py",
                "client/alloc_runner.py", "client/task_runner.py",
                "client/drivers.py", "client/executor.py",
                "client/logmon.py", "client/fingerprint.py",
                "client/hoststats.py", "client/checks.py",
                "client/state_db.py", "client/allocdir.py",
                "client/taskenv.py", "core/allocsync.py",
                "structs/services.py", "cli.py", "agent_config.py",
                "__main__.py"):
        assert (REPO / "nomad_tpu_torch" / mod) in _sources()
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device found" in out.stderr
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            resolve()
    assert resolve("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        from nomad_tpu_torch.raft import RaftCluster

        # a replicated server with no device given is on the card too
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            RaftCluster(3)
        from nomad_tpu_torch.core import Server
        from nomad_tpu_torch.obs.__main__ import main as obs_main

        # so is the Server an HTTP agent serves, and the trace CLI's
        # demo cluster
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            Server()
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            obs_main(["--trace-smoke"])
    with pytest.raises(ValueError):
        resolve("meta")
