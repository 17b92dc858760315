"""UUID helpers (reference ``nomad_tpu/utils/ids.py``): a process-local
PRNG seeded once from os.urandom mints object names cheaply."""

import os
import random

_rng = random.Random(int.from_bytes(os.urandom(16), "big"))


def _format_uuid(h: str) -> str:
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def generate_uuid() -> str:
    """Fast non-cryptographic uuid for object names (allocs, evals)."""
    return _format_uuid(f"{_rng.getrandbits(128):032x}")
