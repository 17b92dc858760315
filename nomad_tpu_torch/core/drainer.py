"""Node drainer (a copy of ``nomad_tpu/core/drainer.py``).

Migrates the allocs off draining nodes at a paced rate: for each
(job, task group) on a node at most ``migrate.max_parallel`` allocs are
in flight at once, an alloc counting as in flight from its migrate mark
until its client reports it terminal (stopped by the server but still
running counts). When a node's drain deadline passes, everything left is
marked at once. On a down or disconnected node a server-terminal alloc
no longer holds the drain open, since its client never reports. A node
with nothing left to migrate has its drain cleared and stays
ineligible; ``ignore_system_jobs`` leaves system and sysbatch allocs
where they are.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..structs import enums
from ..structs.alloc import DesiredTransition
from ..structs.evaluation import Evaluation
from ..utils.ids import generate_uuid


# seconds between the drainer's passes
INTERVAL = 0.2


class NodeDrainer:
    def __init__(self, server):
        self.server = server
        self._stop = threading.Event()
        self._thread = None
        # node id -> absolute deadline
        self._deadlines: Dict[str, float] = {}
        self.stats = {"migrations_marked": 0, "drains_completed": 0}

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="node-drainer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(INTERVAL):
            try:
                self._tick()
            except Exception:
                if self.server.logger:
                    self.server.logger.exception("drainer tick failed")

    def _tick(self) -> None:
        snap = self.server.store.snapshot()
        now = time.time()
        for node in list(snap.nodes()):
            if not node.drain:
                self._deadlines.pop(node.id, None)
                continue
            strat = node.drain_strategy
            if node.id not in self._deadlines:
                self._deadlines[node.id] = (
                    now + strat.deadline_s if strat.deadline_s > 0 else float("inf"))
            deadline = self._deadlines[node.id]

            # anything not yet finished client-side is still occupying the
            # node: stopped-but-running allocs count against max_parallel
            # (availability is only restored once the task actually exits)
            allocs = [a for a in snap.allocs_by_node(node.id)
                      if not a.client_terminal()]
            if node.status in (enums.NODE_STATUS_DOWN,
                               enums.NODE_STATUS_DISCONNECTED):
                # a dead client never reports its allocs terminal, so
                # waiting for client_terminal strands the drain forever;
                # once the server has decided an alloc's fate
                # (server-terminal) it no longer holds the drain open
                allocs = [a for a in allocs if not a.server_terminal()]
            if strat.ignore_system_jobs:
                allocs = [a for a in allocs
                          if a.job is None
                          or a.job.type not in (enums.JOB_TYPE_SYSTEM,
                                                enums.JOB_TYPE_SYSBATCH)]
            if not allocs:
                # drain complete: clear the strategy, stay ineligible
                self.server.store.update_node_drain(node.id, None)
                self._deadlines.pop(node.id, None)
                self.stats["drains_completed"] += 1
                continue

            force = now >= deadline
            to_mark: List[str] = []
            # pace per (job, task group): max_parallel in flight at once
            by_group: Dict[tuple, List] = {}
            for a in allocs:
                by_group.setdefault((a.namespace, a.job_id, a.task_group), []).append(a)
            for key, group_allocs in by_group.items():
                inflight = sum(1 for a in group_allocs
                               if a.desired_transition.migrate or a.server_terminal())
                tg = None
                if group_allocs[0].job is not None:
                    tg = group_allocs[0].job.lookup_task_group(key[2])
                max_parallel = 1
                if tg is not None and tg.migrate is not None:
                    max_parallel = max(1, tg.migrate.max_parallel)
                budget = len(group_allocs) if force else max(0, max_parallel - inflight)
                for a in group_allocs:
                    if budget <= 0:
                        break
                    if not a.desired_transition.migrate and not a.server_terminal():
                        to_mark.append(a.id)
                        budget -= 1
            if to_mark:
                self.stats["migrations_marked"] += len(to_mark)
                self._mark(snap, to_mark)

    def _mark(self, snap, alloc_ids: List[str]) -> None:
        """Set the migrate transition and create the evals of the
        affected jobs, in one store write."""
        transition = DesiredTransition(migrate=True)
        jobs = {}
        for aid in alloc_ids:
            a = snap.alloc_by_id(aid)
            if a is None:
                continue
            job = snap.job_by_id(a.job_id, a.namespace)
            if job is not None:
                jobs[(a.namespace, a.job_id)] = job
        evals = []
        for job in jobs.values():
            evals.append(Evaluation(
                id=generate_uuid(),
                namespace=job.namespace,
                priority=job.priority,
                type=job.type,
                triggered_by=enums.TRIGGER_NODE_DRAIN,
                job_id=job.id,
                status=enums.EVAL_STATUS_PENDING,
                create_time=time.time(),
            ))
        index = self.server.store.update_alloc_desired_transitions(
            {aid: transition for aid in alloc_ids}, evals)
        for ev in evals:
            ev.modify_index = index
        self.server.broker.enqueue_all(evals)
