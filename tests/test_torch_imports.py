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
        "from nomad_tpu_torch.core import Server, ServerConfig\n"
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
                "scheduler/placer.py"):
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
    with pytest.raises(ValueError):
        resolve("meta")
