"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface under ``build/nomad_tpu_torch/`` at the repository root, and
loaded with ``ctypes``. A library's file name carries a hash of its
source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` turns a non-zero
code into an exception.

No fast math: the capacity ``floor(free / ask)`` and the per-eval score
need correctly rounded division and the fit formula the same ``powf``
that torch runs on CUDA.
``--fmad=false`` keeps the compiler from contracting a multiply and an
add into one differently rounded instruction.

:data:`COUNTS` holds a plain launch count per kernel, bumped by the
wrappers where they launch, and a count of plain-version runs on CUDA
tensors, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "nomad_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-shared", "-Xcompiler",
                           "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> (library, argtypes)
_SIGNATURES = {
    "nt_jitter": ("jitter", [_P, _P, _I, _I, ctypes.c_float, _P]),
    "nt_scatter_add": ("scatter", [_P, _P, _P, _I, _I, _I, _P]),
    "nt_bulk_fill": ("bulk_fill", [_P] * 8 + [_I, _I, _P]),
    "nt_score_nodes": ("task_group", [_P] * 8 + [_I] * 7 + [_P]),
    "nt_solve_task_group": ("task_group", [_P] * 10 + [_I] * 7 + [_P]),
}
LIBRARIES = tuple(sorted({lib for lib, _ in _SIGNATURES.values()}))


class LaunchCounts:
    """Per-kernel launch counts plus plain-version runs on CUDA tensors."""

    def __init__(self, names: Iterable[str]):
        self._lock = threading.Lock()
        self.launches: Dict[str, int] = dict.fromkeys(names, 0)
        self.plain_on_cuda: Dict[str, int] = dict.fromkeys(names, 0)

    def launched(self, name: str) -> None:
        with self._lock:
            self.launches[name] += 1

    def plain(self, name: str, tensor) -> None:
        if tensor.is_cuda:
            with self._lock:
                self.plain_on_cuda[name] += 1

    def reset(self) -> None:
        with self._lock:
            for d in (self.launches, self.plain_on_cuda):
                for k in d:
                    d[k] = 0

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"launches": dict(self.launches),
                    "plain_on_cuda": dict(self.plain_on_cuda)}


COUNTS = LaunchCounts(("jitter", "scatter_add", "bulk_fill", "score_nodes",
                       "solve_task_group"))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "nomad_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnt_{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all in
    parallel. Returns {name: {"path", "seconds", "cached", "ptxas"}}."""
    names = tuple(names or LIBRARIES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        target = _lib_path(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "cached": True,
                         "ptxas": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp),
                                        str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target),
                     "seconds": time.perf_counter() - t0, "cached": False,
                     "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def entry(fn_name: str):
    """The ctypes function ``fn_name``, building and loading its library
    on first use."""
    lib_name, argtypes = _SIGNATURES[fn_name]
    lib = _libs.get(lib_name)
    if lib is None:
        with _lock:
            lib = _libs.get(lib_name)
            if lib is None:
                missing = [n for n in LIBRARIES if n not in _libs]
                built = build(missing)
                for n in missing:
                    _libs[n] = ctypes.CDLL(built[n]["path"])
                lib = _libs[lib_name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_handle(device) -> int:
    """The raw handle of the current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
