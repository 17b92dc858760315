"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface under ``build/nomad_tpu_torch/`` at the repository root, and
loaded with ``ctypes``. A library's file name carries a hash of its
source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`launch` turns a non-zero
code into an exception.

No fast math: the capacity ``floor(free / ask)`` and the per-eval score
need correctly rounded division and the fit formula the same ``powf``
that torch runs on CUDA.
``--fmad=false`` keeps the compiler from contracting a multiply and an
add into one differently rounded instruction.

:data:`COUNTS` holds a plain launch count per kernel, bumped by
:func:`launch` (one a kernel launched), and a count of plain-version
runs on CUDA tensors, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
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
_F = ctypes.c_float
# C entry point -> (library, argtypes)
_SIGNATURES = {
    "nt_jitter": ("jitter", [_P, _P, _I, _I, _F, _I, _P]),
    "nt_jitter_fold": ("jitter", [_P, ctypes.POINTER(_F), _I, _P, _I, _I,
                                  _I, _P]),
    "nt_scatter_add": ("scatter", [_P, _P, _P, _I, _I, _I, _P]),
    "nt_bulk_fill": ("bulk_fill", [_P] * 11 + [_I] * 4 + [_F, _P]),
    "nt_score_nodes": ("task_group", [_P] * 8 + [_I] * 7 + [_P]),
    "nt_solve_task_group": ("task_group", [_P] * 10 + [_I] * 8 + [_P]),
    "nt_auction": ("batch_solve", [_P] * 17 + [_I] * 4 + [_P]),
    "nt_batch_pick": ("batch_solve", [_P] * 11 + [_I] * 4 + [_P]),
    "nt_preempt_solve": ("preempt", [_P] * 14 + [_I] * 5 + [_P]),
    "nt_preempt_pick": ("preempt", [_P] * 9 + [_I] * 4 + [_P]),
    "nt_bulk_scan": ("bulk_scan", [_P] * 12 + [_I] * 8 + [_P]),
    "nt_tie_perm": ("bulk_scan", [ctypes.c_uint32, _I, _I, _P, _P, _I,
                                  _P]),
    "nt_scatter_shards": ("sharded", [_P] * 4 + [_I] * 4 + [_P]),
    "nt_bulk_shard_solve": ("sharded", [_P] * 13 + [_I] * 5 + [_F, _P]),
    "nt_joint_shard_solve": ("sharded", [_P] * 18 + [_I] * 9 + [_P]),
    "nt_mesh_barrier_probe": ("sharded", [_P] * 2 + [_I] * 4 + [_P]),
    "nt_task_group_shard_solve": ("task_group_shard",
                                  [_P] * 13 + [_I] * 10 + [_P]),
}
# C size query -> (library, argtypes): the f32 words of a kernel's
# scratch at the sizes given, as a long long (no launch, no card)
_QUERIES = {
    "nt_bulk_fill_scratch_words": ("bulk_fill", [_I]),
    "nt_auction_scratch_words": ("batch_solve", [_I] * 2),
    "nt_batch_pick_scratch_words": ("batch_solve", [_I] * 2),
    "nt_solve_task_group_scratch_words": ("task_group", [_I] * 6),
    "nt_bulk_scan_scratch_words": ("bulk_scan", [_I] * 4),
    "nt_tie_perm_scratch_words": ("bulk_scan", [_I] * 2),
    "nt_preempt_solve_scratch_words": ("preempt", [_I] * 2),
    "nt_preempt_pick_scratch_words": ("preempt", [_I] * 2),
    "nt_bulk_shard_solve_scratch_words": ("sharded", [_I] * 4),
    "nt_joint_shard_solve_scratch_words": ("sharded", [_I] * 6),
    "nt_task_group_shard_solve_scratch_words": ("task_group_shard", [_I] * 7),
}
LIBRARIES = tuple(sorted({lib for lib, _ in _SIGNATURES.values()}))


class LaunchCounts:
    """Per-kernel launch counts plus plain-version runs on CUDA tensors."""

    def __init__(self, names: Iterable[str]):
        self._lock = threading.Lock()
        self.launches: Dict[str, int] = dict.fromkeys(names, 0)
        self.plain_on_cuda: Dict[str, int] = dict.fromkeys(names, 0)

    def launched(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.launches[name] += n

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
                       "solve_task_group", "jitter_fold", "auction",
                       "batch_pick", "preempt_solve", "preempt_pick",
                       "bulk_scan", "tie_perm", "scatter_shard",
                       "bulk_shard", "joint_shard", "mesh_barrier",
                       "task_group_shard"))

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}  # entry point -> its typed ctypes function
_cuda_fns = None


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
    """The typed ctypes function ``fn_name``: one dict lookup once its
    library is loaded."""
    fn = _fns.get(fn_name)
    return fn if fn is not None else _load(fn_name)


def _load(fn_name: str):
    """Build and load the missing libraries, and type every entry point
    and size query of the loaded ones once (under the lock: worker
    threads reach :func:`entry` together)."""
    with _lock:
        lib_of = _SIGNATURES.get(fn_name) or _QUERIES[fn_name]
        if lib_of[0] not in _libs:
            missing = [n for n in LIBRARIES if n not in _libs]
            built = build(missing)
            for n in missing:
                _libs[n] = ctypes.CDLL(built[n]["path"])
        for table, restype in ((_SIGNATURES, ctypes.c_int),
                               (_QUERIES, ctypes.c_longlong)):
            for name, (lib_name, argtypes) in table.items():
                if name not in _fns and lib_name in _libs:
                    fn = getattr(_libs[lib_name], name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                    _fns[name] = fn
        return _fns[fn_name]


@functools.lru_cache(maxsize=None)
def scratch_words(query: str, *sizes: int) -> int:
    """The f32 words of a kernel's scratch at ``sizes``, from the size
    query ``query`` of its library (which owns the layout): one call a
    shape."""
    return int(entry(query)(*sizes))


def _cuda():
    """torch's current-device getter and setter and its reader of a
    card's current stream handle (no ``torch.cuda.Stream`` built), bound
    on first use: they exist only in CUDA builds of torch."""
    global _cuda_fns
    if _cuda_fns is None:
        import torch

        _cuda_fns = (torch._C._cuda_getDevice, torch._C._cuda_setDevice,
                     torch._C._cuda_getCurrentRawStream)
    return _cuda_fns


def launch(what: str, device, fn, *args) -> None:
    """Call the entry point ``fn`` with ``args`` and the handle of the
    current stream of ``device``, raise on a CUDA error, and count the
    launch under ``what``.

    ``device`` is one device, made current for the call only when it is
    not (a stream, and a kernel's shared-memory attribute, belong to the
    current device; a mesh's shards launch on cards that are not); a
    device with no index is the current card. Or it is a mesh's device
    tuple (each with its index), for an entry point that launches once
    on each of its devices: the last argument is then the array of their
    stream handles, the entry point makes each device current for its
    launch, and the count goes up by one a device."""
    get_device, set_device, raw_stream = _cuda_fns or _cuda()
    if type(device) is tuple:
        streams = (ctypes.c_void_p * len(device))(
            *[raw_stream(d.index) for d in device])
        code = fn(*args, streams)
        n = len(device)
    else:
        index, prev = device.index, get_device()
        if index is None or index == prev:
            code = fn(*args, raw_stream(prev))
        else:
            set_device(index)
            try:
                code = fn(*args, raw_stream(index))
            finally:
                set_device(prev)
        n = 1
    if code:
        raise RuntimeError(f"{what} launch: CUDA error {code}")
    COUNTS.launched(what, n)
