"""The event kinds the incremental feed folds (a trimmed copy of
``nomad_tpu/state/deltas.py:30-41``). The reference's ``EntryReplica``
and ``usage_columns`` serve its shadow sanitizer, which the port does
not have (ROADMAP A8)."""

from __future__ import annotations

NODE_KINDS = ("node-upsert", "node-status", "node-eligibility",
              "node-drain")
ALLOC_ROW_KINDS = ("alloc-upsert", "alloc-stop", "alloc-preempt",
                   "alloc-client-update", "alloc-transition")
CLIENT_TERMINAL = ("complete", "failed", "lost")


def client_terminal(status: str) -> bool:
    return status in CLIENT_TERMINAL
