"""Plan / PlanResult (reference ``nomad_tpu/structs/plan.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(slots=True)
class Plan:
    eval_id: str = ""
    priority: int = 50
    job: object = None
    all_at_once: bool = False
    node_update: Dict[str, list] = field(default_factory=dict)
    node_allocation: Dict[str, list] = field(default_factory=dict)
    node_preemptions: Dict[str, list] = field(default_factory=dict)
    # columnar bulk placements: one AllocBlock per (eval, task group)
    alloc_blocks: List[object] = field(default_factory=list)
    # callbacks invoked with the PlanResult right after the planner
    # applies this plan; the bulk solver service confirms or corrects
    # its usage overlay through them (tensor/solver.py ledger)
    post_apply_hooks: List[object] = field(default_factory=list)
    # a Deployment this plan opens (a fresh job version with an update
    # stanza and per-request placements)
    deployment: object = None

    def append_alloc(self, alloc) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_block(self, block) -> None:
        self.alloc_blocks.append(block)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.node_preemptions and not self.alloc_blocks
                and self.deployment is None)


@dataclass(slots=True)
class PlanResult:
    """What the planner committed."""

    node_update: Dict[str, list] = field(default_factory=dict)
    node_allocation: Dict[str, list] = field(default_factory=dict)
    node_preemptions: Dict[str, list] = field(default_factory=dict)
    alloc_blocks: List[object] = field(default_factory=list)
    deployment: object = None
    refresh_index: int = 0
    alloc_index: int = 0
    rejected_nodes: List[str] = field(default_factory=list)

    def full_commit(self, plan: Plan) -> tuple:
        """(fully_committed, num_expected, num_actual)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        expected += sum(b.size for b in plan.alloc_blocks)
        actual = sum(len(v) for v in self.node_allocation.values())
        actual += sum(b.live_size() for b in self.alloc_blocks)
        return expected == actual, expected, actual
