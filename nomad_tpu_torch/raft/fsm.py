"""The FSM: replicated commands become state-store mutations (a trimmed
copy of ``nomad_tpu/raft/fsm.py``).

A command is ``(op, args, kwargs)`` where ``op`` names a StateStore
mutation. Every replica deep-copies the payload before applying it, so
replicas never share mutable objects, and because every replica applies
the same command sequence, store indexes agree across the cluster.

``RaftStore`` presents the StateStore surface: reads hit the local
store, mutations propose through the raft node and block until they are
committed and applied locally, the write path every Server subsystem
already uses. ``MUTATIONS`` is every mutator of the port's store; a
write that bypassed the facade would land on one replica only.
"""

from __future__ import annotations

import copy
import time
from typing import Any

MUTATIONS = {
    "upsert_node", "upsert_nodes", "update_node_status",
    "update_nodes_status", "update_node_eligibility",
    "update_node_drain", "delete_node", "upsert_node_pool",
    "delete_node_pool", "upsert_namespace", "delete_namespace",
    "upsert_job", "delete_job", "update_job_status", "append_scaling_event",
    "upsert_evals", "delete_evals",
    "upsert_allocs", "update_allocs_from_client",
    "update_alloc_desired_transitions",
    "upsert_plan_results", "upsert_plan_results_batch",
    "upsert_deployment", "delete_deployment",
    "upsert_volume", "delete_volume", "reap_volume_claims",
    "set_scheduler_configuration", "upsert_service_registrations",
    "delete_service_registrations", "delete_services_by_alloc",
    "gc_terminal_allocs", "compact", "restore_dump",
}

# Mutations that stamp wall-clock times take the time from the proposer
# inside the replicated command: a follower replaying the log at
# catch-up time would otherwise stamp replay time and diverge from the
# leader on time-gated decisions (GC cutoffs).
TIMESTAMPED = {
    "upsert_evals", "upsert_allocs", "update_allocs_from_client",
    "upsert_plan_results", "upsert_plan_results_batch",
    "update_node_status", "update_nodes_status",
    "update_alloc_desired_transitions",
}


def _refuse_wallclock() -> float:
    raise RuntimeError(
        "wall-clock read during a replicated apply: a timestamped command "
        "reached the store without an explicit ts - the proposer must stamp "
        "it (RaftStore fills ts for every TIMESTAMPED op)")


class FSM:
    def __init__(self, store):
        self.store = store
        # a replica applying the shared log must never stamp local time:
        # any mutator that would read the clock fails loudly instead of
        # silently diverging from its peers
        store._clock = _refuse_wallclock

    def prepare(self, command: tuple) -> tuple:
        """The checked command with this replica's own copy of its
        payload (each replica must own its objects). The raft node calls
        it outside its lock (``RaftNode.fsm_prepare``)."""
        op, args, kwargs = command
        if op == "noop":
            return command  # the leader's barrier entry
        if op not in MUTATIONS:
            raise ValueError(f"unknown FSM op {op!r}")
        if op in TIMESTAMPED and kwargs.get("ts") is None:
            raise ValueError(
                f"replicated {op!r} command carries no ts: replicas "
                "would each stamp their own apply time and diverge")
        return (op, copy.deepcopy(args), copy.deepcopy(kwargs))

    def apply_prepared(self, command: tuple) -> Any:
        op, args, kwargs = command
        if op == "noop":
            return None
        return getattr(self.store, op)(*args, **kwargs)

    def apply(self, command: tuple) -> Any:
        return self.apply_prepared(self.prepare(command))


# seconds a replicated write waits for its commit and local apply (the
# reference's 5 s is the node's default): one C2M node registration,
# 10,240 nodes in one command, is copied and encoded on every replica of
# an in-process cluster first, seconds of host work
APPLY_TIMEOUT = 60.0


class RaftStore:
    """StateStore facade: local reads, replicated writes."""

    def __init__(self, store, raft_node):
        self._store = store
        self._raft = raft_node

    def __getattr__(self, name: str):
        if name in MUTATIONS:
            def propose(*args, **kwargs):
                if name in TIMESTAMPED and kwargs.get("ts") is None:
                    kwargs["ts"] = time.time()
                return self._raft.apply((name, args, kwargs),
                                        timeout=APPLY_TIMEOUT)

            return propose
        return getattr(self._store, name)

    # the node's group-commit log writer serves propose_async /
    # wait_applied: the plan applier probes this to overlap its rounds
    can_propose_async = True

    def propose_async(self, name: str, *args, **kwargs):
        """Start a replicated mutation without waiting for its commit;
        returns a proposal handle for wait_applied. The ts is fixed at
        propose time, as on the synchronous path. Proposal order at the
        raft node is log order, so a single proposer pipelining rounds
        through this call gets FSM apply order equal to its propose
        order."""
        if name not in MUTATIONS:
            raise AttributeError(f"{name} is not a replicated mutation")
        if name in TIMESTAMPED and kwargs.get("ts") is None:
            kwargs["ts"] = time.time()
        return self._raft.apply_async((name, args, kwargs))

    def wait_applied(self, prop, timeout: float = 30.0):
        """Block until a propose_async proposal is committed and applied
        locally; returns the FSM result (the store index)."""
        return self._raft.apply_wait(prop, timeout)

    @property
    def latest_index(self) -> int:
        return self._store.latest_index
