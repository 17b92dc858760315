"""Placement backend factory (reference ``nomad_tpu/scheduler/placer.py``
``placer_for_algorithm``). "tpu-binpack" maps to the port's
:class:`~nomad_tpu_torch.tensor.placer.TorchPlacer`; the host greedy
placer and the "tpu-solve" tier are later slices."""

from __future__ import annotations

from ..structs import enums


def placer_for_algorithm(algorithm: str, device=None):
    if algorithm == enums.SCHED_ALG_TPU_BINPACK:
        from ..tensor.placer import TorchPlacer

        return TorchPlacer(device=device)
    if algorithm == enums.SCHED_ALG_TPU_SOLVE:
        raise NotImplementedError(
            "scheduler algorithm 'tpu-solve': ROADMAP queue A, slice 2 "
            "(B5, B6)")
    raise NotImplementedError(
        f"scheduler algorithm {algorithm!r}: the host placer is ROADMAP "
        f"queue A, slice 4 (the per-eval general path)")
