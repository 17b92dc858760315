"""Placement backend factory (reference ``nomad_tpu/scheduler/placer.py``
``placer_for_algorithm``). "tpu-binpack" and "tpu-solve" map to the
port's :class:`~nomad_tpu_torch.tensor.placer.TorchPlacer` (under
"tpu-solve" its bulk solves go to the joint auction tier); the host
placer behind "binpack"/"spread" is a later slice."""

from __future__ import annotations

from ..structs import enums


def placer_for_algorithm(algorithm: str, device=None):
    if algorithm == enums.SCHED_ALG_TPU_BINPACK:
        from ..tensor.placer import TorchPlacer

        return TorchPlacer(device=device)
    if algorithm == enums.SCHED_ALG_TPU_SOLVE:
        from ..tensor.placer import TorchPlacer

        return TorchPlacer(algorithm=enums.SCHED_ALG_TPU_SOLVE, device=device)
    raise NotImplementedError(
        f"scheduler algorithm {algorithm!r}: the host placer is ROADMAP "
        f"queue A1")
