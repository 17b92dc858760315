"""Host-side fit and scoring math (reference ``nomad_tpu/structs/funcs.py``):
the scalar float64 formulas of the host oracle. Ports, cores and device
instances are not modelled by the port yet, so ``allocs_fit`` checks the
dense resource vector only."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

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


def allocs_fit(node, allocs: Iterable):
    """Do these allocs fit on the node? -> (fit, failing dimension,
    used vector). Client-terminal allocs are free."""
    used = np.zeros(RESOURCE_DIMS, dtype=np.float64)
    for alloc in allocs:
        if alloc.should_count_for_usage():
            used += alloc.allocated_vec
    over = used > node.available_vec()
    if over.any():
        return False, _DIM_NAMES[int(np.argmax(over))], used
    return True, "", used
