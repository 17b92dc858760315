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
    # eval rows committed in the same write as the plan's results
    eval_updates: List[object] = field(default_factory=list)
    # the store index the scheduler planned against: the applier waits
    # for it before re-checking fit (core/plan_apply.py)
    snapshot_index: int = 0

    def append_alloc(self, alloc) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc, preempting_alloc_id: str) -> None:
        """Evict ``alloc`` for the placement ``preempting_alloc_id``
        (reference ``structs/plan.py:68-75``)."""
        from . import enums

        updated = alloc.copy_for_update()
        updated.desired_status = enums.ALLOC_DESIRED_EVICT
        updated.desired_description = (
            f"Preempted by alloc ID {preempting_alloc_id}")
        updated.preempted_by_allocation = preempting_alloc_id
        self.node_preemptions.setdefault(alloc.node_id, []).append(updated)

    def append_block(self, block) -> None:
        self.alloc_blocks.append(block)

    def block_allocs_for_node(self, node_id: str) -> list:
        """The plan's block placements on one node, materialized (the
        applier's exact per-node check)."""
        out = []
        for b in self.alloc_blocks:
            out.extend(b.allocs_for_node(node_id))
        return out

    def append_stopped_alloc(self, alloc, desired_desc: str,
                             client_status: str = "") -> None:
        """Stop ``alloc`` (reference ``structs/plan.py:57-66``); a block
        position's copy is promoted to a row of its own at commit."""
        from . import enums

        updated = alloc.copy_for_update()
        updated.desired_status = enums.ALLOC_DESIRED_STOP
        updated.desired_description = desired_desc
        if client_status:
            updated.client_status = client_status
        self.node_update.setdefault(alloc.node_id, []).append(updated)

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.node_preemptions and not self.alloc_blocks
                and self.deployment is None)


@dataclass(slots=True)
class PlanResult:
    """What the planner committed. The plan applier fills it: the nodes
    it kept (a block with its rejected rows marked, ``without_nodes``),
    and on a partial commit the rejected node ids and a refresh index
    the scheduler retries from."""

    node_update: Dict[str, list] = field(default_factory=dict)
    node_allocation: Dict[str, list] = field(default_factory=dict)
    node_preemptions: Dict[str, list] = field(default_factory=dict)
    alloc_blocks: List[object] = field(default_factory=list)
    deployment: object = None
    # set on a partial commit: snapshot at least this index and retry
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
