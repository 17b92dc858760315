"""The one explicit device choice of the port.

The default is the CUDA card; without one it raises rather than running
somewhere else. The CPU is used only when a caller asks for it
(``device="cpu"``), as the tests do. Callers thread the resolved device
down explicitly: ``Harness(device=...)`` -> ``TorchPlacer(device=...)`` ->
``get_service(device)`` -> every tensor.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``cuda`` without a card raises; ``cpu`` only
    when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: nomad_tpu_torch runs on the card by "
                "default; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
