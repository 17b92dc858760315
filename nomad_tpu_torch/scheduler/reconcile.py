"""Service/batch reconciler (reference ``nomad_tpu/scheduler/reconcile.py``,
itself Nomad's scheduler/reconcile.go).

Computes the desired-vs-actual diff of one job: which allocations to
place, stop, migrate, update in place or destructively, reschedule now
or later, mark unknown on a disconnected node or take back on a
reconnected one; canaries hold the old version until the group's
deployment is promoted. The nodes are chosen downstream by the placer;
the reconciler only decides what must change. A group missing at least
``BULK_PLACE_MIN`` allocations with nothing else pending and no volumes
gets ONE columnar request (a volume claim is written for each alloc, so a group
with volumes places alloc by alloc).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..structs import Allocation, Job, Node, TaskGroup, alloc_name, enums
from ..structs.evaluation import Evaluation
from ..structs.job import ReschedulePolicy
from ..utils.ids import generate_uuid
from .util import AllocNameIndex, tasks_updated


@dataclass
class PlacementRequest:
    """One allocation that must be placed: fresh, a replacement
    (``previous_alloc``; ``reschedule`` for a failed one, whose node
    ``ignore_node`` is penalised) or a canary."""

    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    canary: bool = False
    ignore_node: str = ""  # node of the failed previous alloc (penalty)


@dataclass
class BulkPlacementRequest:
    """K identical fresh placements carried as one request;
    ``name_indices[i]`` is the alloc name index of placement i."""

    task_group: TaskGroup
    name_indices: object = None  # (K,) int array
    job_id: str = ""

    @property
    def count(self) -> int:
        return len(self.name_indices)

    def expand(self) -> List[PlacementRequest]:
        """The per-alloc requests of this batch, for groups whose
        features rule out the count-based bulk solve."""
        tg = self.task_group
        return [PlacementRequest(
            name=alloc_name(self.job_id, tg.name, int(i)), task_group=tg)
            for i in self.name_indices]


@dataclass
class GroupResult:
    place: List[PlacementRequest] = field(default_factory=list)
    # columnar fresh-placement batch, set instead of K ``place`` entries
    bulk_place: Optional[BulkPlacementRequest] = None
    # (alloc, desired description, client status)
    stop: List[Tuple[Allocation, str, str]] = field(default_factory=list)
    destructive_update: List[Allocation] = field(default_factory=list)
    inplace_update: List[Allocation] = field(default_factory=list)
    migrate: List[Allocation] = field(default_factory=list)
    lost: List[Allocation] = field(default_factory=list)
    # allocs on a freshly disconnected node inside their group's
    # max_client_disconnect window: the plan marks them client=unknown
    # and a follow-up eval fires when the window ends
    disconnecting: List[Allocation] = field(default_factory=list)
    # unknown allocs whose node is back: kept or replaced
    reconnecting: List[Allocation] = field(default_factory=list)
    ignore: int = 0
    # failed allocs whose reschedule policy is exhausted or off: they
    # keep their slot
    failed_no_reschedule: int = 0
    followup_evals: List[Evaluation] = field(default_factory=list)
    # rescheduled-later alloc id -> its follow-up eval id
    delayed_reschedule: Dict[str, str] = field(default_factory=dict)
    # disconnecting alloc id -> its max-disconnect-timeout eval id
    disconnect_updates: Dict[str, str] = field(default_factory=dict)


@dataclass
class ReconcileResults:
    groups: Dict[str, GroupResult] = field(default_factory=dict)
    desired_tg_updates: Dict[str, Dict[str, int]] = field(
        default_factory=dict)

    def total_places(self) -> int:
        return sum(len(g.place) + len(g.destructive_update)
                   + (g.bulk_place.count if g.bulk_place is not None else 0)
                   for g in self.groups.values())


# --- reschedule policy (reference reconcile.go:1336, RescheduleTracker) ---


def _fib_delay(base: float, attempt: int, max_delay: float) -> float:
    a, b = base, base
    for _ in range(max(0, attempt - 1)):
        a, b = b, min(a + b, max_delay)
    return min(b if attempt > 0 else base, max_delay)


def reschedule_delay(policy: ReschedulePolicy, attempt: int) -> float:
    if policy.delay_function == "exponential":
        return min(policy.delay_s * (2 ** attempt), policy.max_delay_s)
    if policy.delay_function == "fibonacci":
        return min(_fib_delay(policy.delay_s, attempt, policy.max_delay_s),
                   policy.max_delay_s)
    return policy.delay_s


def should_reschedule(alloc: Allocation, policy: Optional[ReschedulePolicy],
                      now: float, is_batch: bool) -> Tuple[str, float]:
    """-> ("now"|"later"|"no", eligible_time). Mirrors reference
    Allocation.NextRescheduleTime / RescheduleEligible."""
    if policy is None:
        policy = ReschedulePolicy() if not is_batch else ReschedulePolicy(
            attempts=1, interval_s=24 * 3600, unlimited=False)
    if not policy.unlimited and policy.attempts <= 0:
        return "no", 0.0
    events = (alloc.reschedule_tracker.events if alloc.reschedule_tracker
              else [])
    if not policy.unlimited:
        window_start = now - policy.interval_s
        attempts_in_window = sum(1 for e in events
                                 if e.reschedule_time >= window_start)
        if attempts_in_window >= policy.attempts:
            return "no", 0.0
    attempt = len(events)
    delay = reschedule_delay(policy, attempt)
    fail_time = alloc.task_finished_at or alloc.modify_time or now
    eligible = fail_time + delay
    if eligible <= now:
        return "now", eligible
    return "later", eligible


# --- the reconciler ---


BULK_PLACE_MIN = 256  # below this, per-request objects are cheap enough


class AllocReconciler:
    """The reconciler of one job (reference ``reconcile.py:157-536``).
    ``tainted`` maps node id to node for the draining, down and
    disconnected nodes of the job's allocs; ``now`` pins the clock."""

    def __init__(self, job: Optional[Job], job_id: str,
                 existing: List[Allocation], tainted: Dict[str, Node], *,
                 batch: bool = False, now: Optional[float] = None,
                 deployment=None):
        self.job = job
        self.job_id = job_id
        self.existing = existing
        self.tainted = tainted
        self.batch = batch
        self.now = now if now is not None else _time.time()
        # the active deployment for this job version, if any — canary
        # accounting reads desired_canaries/promoted from it
        self.deployment = deployment
        if (deployment is not None and self.job is not None
                and deployment.job_version != self.job.version):
            self.deployment = None

    def compute(self) -> ReconcileResults:
        results = ReconcileResults()
        stopped = self.job is None or self.job.stopped()

        # bucket allocs by task group (reference allocMatrix)
        matrix: Dict[str, List[Allocation]] = {}
        for a in self.existing:
            matrix.setdefault(a.task_group, []).append(a)

        groups = {tg.name: tg
                  for tg in (self.job.task_groups if self.job else [])}

        # groups that no longer exist in the job: stop everything
        for tg_name, allocs in matrix.items():
            if stopped or tg_name not in groups:
                g = results.groups.setdefault(tg_name, GroupResult())
                for a in allocs:
                    if not a.terminal_status():
                        g.stop.append(
                            (a, "alloc not needed due to job update", ""))

        if stopped:
            return results

        for tg_name, tg in groups.items():
            g = self._compute_group(tg, matrix.get(tg_name, []))
            results.groups[tg_name] = g
            results.desired_tg_updates[tg_name] = {
                "place": len(g.place) + (g.bulk_place.count
                                         if g.bulk_place is not None else 0),
                "stop": len(g.stop),
                "destructive_update": len(g.destructive_update),
                "in_place_update": len(g.inplace_update),
                "migrate": len(g.migrate),
                "ignore": g.ignore,
            }
        return results

    def _compute_group(self, tg: TaskGroup,
                       allocs: List[Allocation]) -> GroupResult:
        g = GroupResult()
        desired = tg.count

        # partition current allocs (reference reconcile_util.go
        # filterByTainted)
        live: List[Allocation] = []          # running/pending on healthy nodes
        batch_done = 0              # completed batch allocs: work is done
        expired_unknown: List[Allocation] = []  # unknown past the window
        for a in allocs:
            if a.server_terminal():
                continue  # already being stopped
            node = self.tainted.get(a.node_id)
            if node is not None:
                if node.status == enums.NODE_STATUS_DISCONNECTED:
                    self._handle_disconnected(tg, a, node, g, expired_unknown)
                    continue
                if node.status == enums.NODE_STATUS_DOWN:
                    if not a.client_terminal():
                        g.lost.append(a)
                    continue
                if node.drain:
                    # the drainer paces migrations by setting the migrate
                    # transition on max_parallel allocs at a time
                    # (reference reconcile_util filterByTainted checks
                    # DesiredTransition.ShouldMigrate); unmarked allocs
                    # keep running (and keep counting toward desired)
                    # until their turn
                    if a.client_terminal():
                        continue
                    if (a.desired_transition.migrate
                            or a.desired_transition.reschedule
                            or a.desired_transition.force_reschedule):
                        # drainer pacing marked it — or the user asked
                        # for a stop, which must not wait its drain turn
                        g.migrate.append(a)
                        continue
                    live.append(a)
                    continue
            if a.client_status == enums.ALLOC_CLIENT_UNKNOWN:
                # node is healthy again: the client reconnected while this
                # alloc was written off (reference reconcileReconnecting)
                g.reconnecting.append(a)
                continue
            if ((a.desired_transition.reschedule
                    or a.desired_transition.force_reschedule)
                    and not a.client_terminal()):
                # user-initiated `alloc stop`: stop here, replace
                # elsewhere (reference Alloc.Stop sets the transition and
                # the reconciler treats it like a migration). A
                # client-terminal alloc falls through to the normal
                # complete/failed accounting instead.
                g.migrate.append(a)
                continue
            if a.client_status == enums.ALLOC_CLIENT_FAILED:
                self._handle_failed(tg, a, g)
                continue
            if a.client_status == enums.ALLOC_CLIENT_COMPLETE:
                if self.batch:
                    # batch allocs that completed are done: they count
                    # toward desired and are never replaced
                    g.ignore += 1
                    batch_done += 1
                # service: a complete alloc no longer counts toward desired;
                # replacement is placed below by the count math
                continue
            live.append(a)

        # expired unknowns become lost; their replacement was placed when
        # they disconnected, so no new placement request here
        for a in expired_unknown:
            g.stop.append((a, "alloc lost: client disconnection exceeded "
                           "max_client_disconnect", enums.ALLOC_CLIENT_LOST))

        # reconnect reconciliation: keep the reconnected alloc and stop its
        # replacement when the job version still matches; a reconnected
        # alloc of an old version loses to its replacement
        # (reference scheduler/reconnecting_picker: original-first default)
        live = self._reconcile_reconnecting(tg, g, live)

        # canary gate (reference reconcile.go:434 computeGroup): while an
        # unpromoted deployment wants canaries, old-version allocs hold
        # steady and only canary placements happen
        canary_target = tg.update.canary if tg.update is not None else 0
        dstate = (self.deployment.task_groups.get(tg.name)
                  if self.deployment is not None else None)
        promoted = bool(dstate.promoted) if dstate is not None else False
        canaries = []
        if self.job is not None and canary_target:
            canaries = [a for a in live
                        if a.canary and a.job_version == self.job.version]
        updated_old = ([a for a in live if a.job_version != self.job.version]
                       if self.job is not None else [])

        dep_halted = (self.deployment is not None
                      and not self.deployment.active()
                      and self.deployment.status
                      != enums.DEPLOYMENT_STATUS_SUCCESSFUL)

        # the hold must key off the deployment state, not just live
        # old-version allocs: if every old alloc vanished mid-canary (node
        # death + GC) the unpromoted deployment still caps placements at
        # canary_target (reference reconcile.go deploymentPlaceReady)
        wants_canaries = (canary_target > 0 and dstate is not None
                          and dstate.desired_canaries > 0 and not promoted)
        if canary_target and (updated_old or wants_canaries) \
                and (not promoted or dep_halted):
            # canaries are surplus: they never enter the count math
            canary_ids = {c.id for c in canaries}
            live = [a for a in live if a.id not in canary_ids]
            g.ignore += len(canaries) + len(updated_old)
            if not dep_halted:
                # a failed/cancelled deployment stops the rollout cold
                # (reference: deploymentFailed gates placements); only a
                # live unpromoted one keeps asking for canaries
                name_index = AllocNameIndex(
                    self.job_id, tg.name, desired,
                    in_use=[a for a in allocs if not a.terminal_status()])
                for name in name_index.next_batch(
                        max(0, canary_target - len(canaries))):
                    g.place.append(PlacementRequest(
                        name=name, task_group=tg, canary=True))
            # migrations/lost still need replacements even mid-canary
            for a in g.migrate:
                g.stop.append((a, "alloc is being migrated", ""))
                g.place.append(PlacementRequest(
                    name=a.name, task_group=tg, previous_alloc=a))
            for a in g.lost:
                g.place.append(PlacementRequest(
                    name=a.name, task_group=tg, previous_alloc=a))
            return g

        # scale down FIRST (reference computeGroup runs computeStop before
        # computeUpdates): updating before stopping lets a destructive
        # replacement re-place an alloc the count math was about to
        # retire, growing the group past `desired` with no eval left to
        # shrink it (seen post-canary-promotion: old alloc + promoted
        # canary = surplus). Old-version allocs stop first — they are
        # doomed anyway — then highest name-index.
        if len(live) + len(g.migrate) > desired:
            excess = len(live) + len(g.migrate) - desired

            def stop_key(a: Allocation):
                current = (self.job is not None
                           and a.job_version == self.job.version)
                return (0 if not current else 1, -a.index())

            by_pref = sorted(live, key=stop_key)
            stop_live = by_pref[:excess]
            for a in stop_live:
                g.stop.append((a, "alloc not needed due to job update", ""))
            live = by_pref[len(stop_live):]
            excess -= len(stop_live)
            # still over: cancel migrations (stop without replacement)
            while excess > 0 and g.migrate:
                a = g.migrate.pop()
                g.stop.append((a, "alloc not needed due to job update", ""))
                excess -= 1

        # updates: job version changed. Spec-diff decides in-place vs
        # destructive (reference scheduler/util.go tasksUpdated consumed
        # at reconcile.go computeUpdates): a change the client can apply
        # to the running alloc — meta, count, policies — updates in
        # place; changes to what runs or what it holds destroy+replace.
        inplace_ids: set = set()
        if self.job is not None:
            updated = [a for a in live if a.job_version != self.job.version]
            if updated:
                destructive = []
                for a in updated:
                    old_tg = (a.job.lookup_task_group(tg.name)
                              if a.job is not None else None)
                    if tasks_updated(old_tg, tg):
                        destructive.append(a)
                    else:
                        g.inplace_update.append(a)
                        inplace_ids.add(a.id)
                # honor update.max_parallel per pass for the destructive
                # side only; in-place updates are non-disruptive and land
                # all at once. destructive[mp:] stay live (and are counted
                # with `keep` below) until their turn in a later eval.
                mp = (max(1, tg.update.max_parallel) if tg.update
                      else len(destructive))
                g.destructive_update.extend(destructive[:mp])
                replaced = {x.id for x in g.destructive_update}
                live = [a for a in live if a.id not in replaced]

        keep = live
        # in-place updated allocs are annotated as updates, not ignores
        g.ignore += sum(1 for a in keep if a.id not in inplace_ids)

        # placements: migrations and lost get replacements with chains
        name_index = AllocNameIndex(
            self.job_id, tg.name, desired,
            in_use=[a for a in allocs if not a.terminal_status()])

        for a in g.migrate:
            g.stop.append((a, "alloc is being migrated", ""))
            g.place.append(PlacementRequest(
                name=a.name, task_group=tg, previous_alloc=a))
        for a in g.lost:
            # the scheduler marks these lost in the plan; place replacements
            g.place.append(PlacementRequest(
                name=a.name, task_group=tg, previous_alloc=a))

        # net new placements to reach desired count (disconnecting allocs
        # already queued their replacements in _handle_disconnected)
        have = (len(keep) + len(g.migrate) + len(g.lost)
                + len(g.destructive_update) + batch_done
                + g.failed_no_reschedule + len(g.disconnecting))
        missing = max(0, desired - have - self._pending_reschedules(g))
        if (missing >= BULK_PLACE_MIN and not g.place
                and not g.destructive_update and not tg.volumes):
            # columnar fast path: K identical fresh placements ride as
            # ONE request; names/ids materialize lazily downstream. Only
            # when nothing else is pending for the group (replacements
            # carry per-alloc context the bulk shape can't) and the
            # group claims no volumes (claim recording is per-alloc).
            g.bulk_place = BulkPlacementRequest(
                task_group=tg, job_id=self.job_id,
                name_indices=name_index.next_batch_indices(missing))
            return g
        for name in name_index.next_batch(missing):
            g.place.append(PlacementRequest(name=name, task_group=tg))
        return g

    def _handle_disconnected(self, tg: TaskGroup, a: Allocation, node: Node,
                             g: GroupResult,
                             expired_unknown: List[Allocation]) -> None:
        """An alloc on a disconnected node: within max_client_disconnect it
        goes unknown (with a replacement and an expiry follow-up eval);
        without the stanza, or past the window, it is lost
        (reference reconcile.go computeGroup disconnecting/lost split)."""
        if a.client_terminal():
            return
        window = tg.max_client_disconnect_s
        disconnect_time = node.status_updated_at or self.now
        expired = window is None or self.now >= disconnect_time + window
        if a.client_status == enums.ALLOC_CLIENT_UNKNOWN:
            if expired:
                expired_unknown.append(a)
            # else: already unknown, follow-up eval pending; nothing to do
            return
        if expired:
            # lost: replacement + count via g.lost, but the lost marking
            # must ride g.stop — update_non_terminal_allocs_to_lost only
            # covers DOWN nodes, not DISCONNECTED ones
            g.lost.append(a)
            g.stop.append((a, "alloc lost: client disconnection exceeded "
                           "max_client_disconnect", enums.ALLOC_CLIENT_LOST))
            return
        g.disconnecting.append(a)
        ev = Evaluation(
            id=generate_uuid(),
            namespace=a.namespace,
            priority=self.job.priority if self.job else 50,
            type=self.job.type if self.job else enums.JOB_TYPE_SERVICE,
            triggered_by=enums.TRIGGER_MAX_DISCONNECT_TIMEOUT,
            job_id=self.job_id,
            status=enums.EVAL_STATUS_PENDING,
            wait_until=disconnect_time + window,
        )
        g.followup_evals.append(ev)
        g.disconnect_updates[a.id] = ev.id
        # replacement keeps the workload running while the client is gone
        g.place.append(PlacementRequest(
            name=a.name, task_group=tg, previous_alloc=a,
            ignore_node=a.node_id))

    def _reconcile_reconnecting(self, tg: TaskGroup, g: GroupResult,
                                live: List[Allocation]) -> List[Allocation]:
        """Pick keep-or-replace for each reconnected (unknown on a healthy
        node) alloc; winners join `live`. Original wins when its job
        version is current; its replacement (same name, younger) stops.
        (reference reconcile.go:1157 + reconnecting_picker)"""
        if not g.reconnecting:
            return live
        out = list(live)
        for a in g.reconnecting:
            current = (self.job is not None
                       and a.job_version == self.job.version)
            if not current:
                g.stop.append((a, "reconnecting alloc is outdated", ""))
                continue
            replacements = [x for x in out
                            if x.name == a.name and x.id != a.id]
            for r in replacements:
                g.stop.append(
                    (r, "replacement no longer needed: alloc reconnected", ""))
            stopped = {r.id for r in replacements}
            out = [x for x in out if x.id not in stopped]
            out.append(a)
        return out

    def _pending_reschedules(self, g: GroupResult) -> int:
        """Replacements already queued via the failed-alloc path."""
        return (sum(1 for p in g.place if p.reschedule)
                + len(g.delayed_reschedule))

    def _handle_failed(self, tg: TaskGroup, alloc: Allocation,
                       g: GroupResult) -> None:
        """Failed alloc: reschedule now, later (follow-up eval), or leave
        (reference reconcile.go:1277-1398)."""
        # an alloc that already has a replacement is ignored
        if alloc.next_allocation:
            g.ignore += 1
            return
        decision, eligible = should_reschedule(
            alloc, tg.reschedule_policy, self.now, self.batch)
        if decision == "now":
            g.place.append(PlacementRequest(
                name=alloc.name, task_group=tg, previous_alloc=alloc,
                reschedule=True, ignore_node=alloc.node_id))
        elif decision == "later":
            ev = Evaluation(
                id=generate_uuid(),
                namespace=alloc.namespace,
                priority=self.job.priority if self.job else 50,
                type=self.job.type if self.job else enums.JOB_TYPE_SERVICE,
                triggered_by=enums.TRIGGER_RETRY_FAILED_ALLOC,
                job_id=self.job_id,
                status=enums.EVAL_STATUS_PENDING,
                wait_until=eligible,
            )
            g.followup_evals.append(ev)
            g.delayed_reschedule[alloc.id] = ev.id
        else:
            # "no": reschedule policy exhausted/disabled — the alloc stays
            # failed and keeps its slot; placing a fresh alloc here would
            # bypass the policy and crash-loop forever
            g.failed_no_reschedule += 1
            g.ignore += 1
