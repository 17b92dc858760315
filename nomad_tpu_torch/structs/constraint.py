"""Constraints, affinities and spreads (reference
``nomad_tpu/structs/constraint.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass(slots=True, frozen=True)
class Constraint:
    """A hard placement constraint: ltarget/rtarget are interpolation
    strings like "${attr.kernel.name}"."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="


@dataclass(slots=True, frozen=True)
class Affinity:
    """A soft placement preference with weight in [-100, 100]."""

    ltarget: str = ""
    rtarget: str = ""
    operand: str = "="
    weight: int = 50


@dataclass(slots=True, frozen=True)
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass(slots=True)
class Spread:
    """Spread allocations across values of an attribute."""

    attribute: str = ""
    weight: int = 50
    targets: List[SpreadTarget] = field(default_factory=list)
