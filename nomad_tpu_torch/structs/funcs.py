"""Host-side fit and scoring math (reference ``nomad_tpu/structs/funcs.py``):
the scalar float64 formulas of the host oracle, and ``allocs_fit``, the
exact fit check of the host scorer and the plan applier (dense vector,
core overlap, port collisions, device oversubscription)."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from .network import check_port_collisions
from .resources import R_CPU, R_MEM, RESOURCE_DIMS

BINPACK_MAX_FIT_SCORE = 18.0
_DIM_NAMES = ("cpu", "memory", "disk", "ports")


def compute_free_percentage(available_vec: np.ndarray,
                            util_vec: np.ndarray) -> Tuple[float, float]:
    """Free fraction of cpu/mem after ``util`` is placed: x/0 -> -inf,
    0/0 -> 0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        free_cpu = 1.0 - (util_vec[R_CPU] / available_vec[R_CPU])
        free_mem = 1.0 - (util_vec[R_MEM] / available_vec[R_MEM])
    if np.isnan(free_cpu):
        free_cpu = 0.0
    if np.isnan(free_mem):
        free_mem = 0.0
    return free_cpu, free_mem


def score_fit_binpack(available_vec: np.ndarray, util_vec: np.ndarray) -> float:
    """BestFit-v3: 20 - (10^freeCpu + 10^freeMem), clamped to [0, 18]."""
    free_cpu, free_mem = compute_free_percentage(available_vec, util_vec)
    total = 10.0 ** free_cpu + 10.0 ** free_mem
    return float(np.clip(20.0 - total, 0.0, BINPACK_MAX_FIT_SCORE))


def score_fit_spread(available_vec: np.ndarray, util_vec: np.ndarray) -> float:
    """WorstFit: (10^freeCpu + 10^freeMem) - 2, clamped to [0, 18]."""
    free_cpu, free_mem = compute_free_percentage(available_vec, util_vec)
    total = 10.0 ** free_cpu + 10.0 ** free_mem
    return float(np.clip(total - 2.0, 0.0, BINPACK_MAX_FIT_SCORE))


def allocs_fit(node, allocs: Iterable, check_devices: bool = False):
    """Do these allocs fit on the node? -> (fit, failing dimension, used
    vector) (reference ``funcs.py:59``). Client-terminal allocs are free;
    reserved cores must not overlap; assigned ports must not collide with
    each other or the node's reserved ports; used must not exceed
    available; with ``check_devices``, no device group may hold more
    instances than it has."""
    allocs = list(allocs)
    used = np.zeros(RESOURCE_DIMS, dtype=np.float64)
    seen_cores: set = set()
    core_overlap = False
    dev_used: dict = {}
    any_ports = False
    for alloc in allocs:
        if not alloc.should_count_for_usage():
            continue
        used += alloc.allocated_vec
        any_ports = any_ports or bool(alloc.allocated_ports)
        for core in alloc.allocated_cores:
            if core in seen_cores:
                core_overlap = True
            seen_cores.add(core)
        if check_devices:
            for dev_id, inst in alloc.allocated_devices.items():
                dev_used[dev_id] = dev_used.get(dev_id, 0) + len(inst)
    if core_overlap:
        return False, "cores", used
    if any_ports:
        colliding = check_port_collisions(node, allocs)
        if colliding:
            return False, f"port collision {colliding[0]}", used
    over = used > node.available_vec()
    if over.any():
        return False, _DIM_NAMES[int(np.argmax(over))], used
    if check_devices:
        for group in node.resources.devices:
            if dev_used.get(group.id, 0) > len(group.instance_ids):
                return False, "device oversubscribed", used
    return True, "", used
