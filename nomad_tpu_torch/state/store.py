"""The state store, trimmed to the placement paths and the allocation
lifecycle (reference ``nomad_tpu/state/store.py``): nodes, node pools,
namespaces, jobs with their versions and scaling events, evals,
deployments, registered volumes with their claims, service
registrations, alloc blocks (the bulk path's placements) and single
allocations (the per-eval path's) in MVCC tables, one serialized writer
and any number of concurrent snapshot readers. ``watches`` (state/watch.py)
parks the blocking queries of the HTTP API until a commit passes their
index.

For the Server (``core/``): commit listeners called with each published
generation and its events, each write emitting the reference's kinds
and payloads (``node-upsert``, ``node-status``, ``node-eligibility``,
``node-drain``, ``node-pool-upsert``, ``node-pool-delete``,
``namespace-upsert``, ``namespace-delete``, ``scaling-event``,
``job-upsert``, ``job-delete``,
``eval-upsert``, ``deployment-upsert``, ``alloc-upsert``,
``alloc-stop``, ``alloc-preempt``, ``alloc-client-update``,
``alloc-transition``, ``alloc-block-upsert``, ``node-delete``,
``job-status``, ``eval-delete``, ``deployment-delete``, ``alloc-gc``,
``volume-upsert``, ``volume-delete``, ``volume-claim``,
``volume-claim-release``, ``service-register``,
``service-deregister``, ``scheduler-config``, ``restore``), which the
Server's unblock rules, the event broker and the incremental feed read.
Core GC's writes: ``delete_node``, ``delete_evals``, ``delete_job``,
``update_job_status``, ``delete_deployment``, ``reap_volume_claims``,
``gc_terminal_allocs`` (a GC'd block position is marked dropped in a new
block version, with no event of its own) and ``compact``. A client
update, a transition or a plan's rewrite of an AllocBlock position (id
``"<block>.<p>"``) promotes it: the written row shadows the block's
virtual row in every read, once. Also ``snapshot_min_index`` (the
worker's and the applier's wait, reference ``worker.py:281``); eval
rows; and ``upsert_plan_results_batch``, many plans' results and their
eval updates in one generation (the applier's commit round, reference
``plan_apply.py:653-851``).

For the replicated control plane (``raft/``): every mutator the FSM
replays takes the proposer's ``ts`` (``raft/fsm.py`` ``TIMESTAMPED``)
and reads ``_clock`` only without one, which the FSM replaces by a
guard; ``restore_dump`` replaces the contents from a dump
(``state/persist.py``) and emits ``restore``; the ``scheduler_config``
table (``set_scheduler_configuration``) carries the operator's algorithm
across a failover; a plan payload may arrive normalized (its allocs'
and blocks' jobs stripped, the plan's job once: ``_rehydrate_jobs``);
and a fresh placement superseding a live alloc of the same slot stops
it (``_supersede_slot_duplicates``: two plans of one eval can both
commit across a failover).

Write protocol: ``_begin()`` allocates the next generation privately,
mutations land in version chains at that generation, ``_commit()``
publishes it. Readers never see a half-applied generation, and taking a
snapshot is atomic with the writer's prune floor (both go through the
tracker's lock).
"""

from __future__ import annotations

import copy
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..structs import enums
from ..structs.alloc import BLOCK_SEP, AllocBlock, Allocation
from ..structs.deployment import Deployment
from ..structs.evaluation import Evaluation
from ..structs.job import Job
from ..structs.node import Node
from ..structs.resources import RESOURCE_DIMS
from .mvcc import (SnapshotTracker, VersionedTable, cons, cons_from_iter,
                   cons_iter)


# the desired description of an alloc stopped by a fresh placement of
# its slot (``_supersede_slot_duplicates``)
SUPERSEDED = "alloc superseded by a newer placement for the same slot"


def _block_alloc(alloc_id: str, lookup) -> Optional[Allocation]:
    """The virtual row of a block position id ``"<block id>.<p>"`` through
    ``lookup(block_id)``, or None (reference ``_block_alloc_fallback``,
    store.py:43-60)."""
    sep = alloc_id.rfind(BLOCK_SEP)
    if sep < 0:
        return None
    block = lookup(alloc_id[:sep])
    if block is None:
        return None
    try:
        p = int(alloc_id[sep + 1:])
    except ValueError:
        return None
    if not 0 <= p < block.size or not block.visible(p):
        return None
    return block.alloc_at(p)


def _block_slot_ids(block: AllocBlock, names: set) -> List[str]:
    """The alloc ids of the visible positions of ``block`` whose name is
    one of ``names`` ((namespace, job, name) triples), in position
    order: the supersede walk's lookup, one numpy pass over the name
    indices, no row built."""
    prefix = f"{block.job_id}.{block.task_group}["
    wanted = []
    for ns, job, name in names:
        if (ns != block.namespace or job != block.job_id
                or not name.startswith(prefix) or not name.endswith("]")):
            continue
        digits = name[len(prefix):-1]
        if digits.isdigit() and str(int(digits)) == digits:
            wanted.append(int(digits))
    if not wanted:
        return []
    hits = np.flatnonzero(np.isin(block.name_indices, wanted))
    return [f"{block.id}{BLOCK_SEP}{p}" for p in hits.tolist()
            if block.visible(p)]


class BlockRef:
    """Secondary-index entry pointing into an AllocBlock: ``row`` is a
    node row of the block, or -1 for all rows (job index). The other
    entries of the alloc indexes are tuples of single-alloc ids."""

    __slots__ = ("block_id", "row")

    def __init__(self, block_id: str, row: int = -1):
        self.block_id = block_id
        self.row = row


class CanonicalNodeList(list):
    """A ready-node list in CANONICAL (registration) order, tagged with
    the node-set version it was computed at. The tensor layer keys its
    shared per-node arrays to it. Shared between callers: never mutate."""

    canonical_version = None
    canonical_key = None


class StateSnapshot:
    """A point-in-time read-only view: a generation number."""

    def __init__(self, store: "StateStore", gen: int):
        self._store = store
        self.index = gen
        self._finalizer = weakref.finalize(self, store._tracker.release, gen)

    def close(self) -> None:
        self._finalizer()

    # --- nodes ---

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._store._nodes.get(node_id, self.index)

    def nodes(self) -> Iterator[Node]:
        return (n for _, n in self._store._nodes.iterate(self.index))

    def ready_nodes_in_pool(self, datacenters: Iterable[str],
                            node_pool: str) -> List[Node]:
        """Ready nodes of the datacenters and pool, in the CANONICAL
        node order (registration order) that the jitter and every
        tie-break are keyed to. Cached per (node-set version, dcs, pool)
        when this snapshot's node view is the latest one; the returned
        list is shared."""
        dcs = list(datacenters)
        store = self._store
        key = (tuple(sorted(dcs)), node_pool)
        if self.index >= store.node_set_index:
            hit = store._ready_nodes_cache.get(key)
            if hit is not None and hit[0] == store.node_set_version:
                return hit[1]
            version = store.node_set_version
            out = CanonicalNodeList(
                n for n in self.nodes()
                if n.ready() and n.in_pool(dcs, node_pool))
            # tag (and publish) only if no node write raced the scan
            if (store.node_set_version == version
                    and self.index >= store.node_set_index):
                out.canonical_version = version
                out.canonical_key = key
                store._ready_nodes_cache[key] = (version, out)
            return out
        return [n for n in self.nodes()
                if n.ready() and n.in_pool(dcs, node_pool)]

    def node_pool(self, name: str):
        pool = self._store._node_pools.get(name, self.index)
        if pool is not None:
            return pool
        from ..structs.operator import BUILTIN_NODE_POOLS, NodePool

        if name in BUILTIN_NODE_POOLS:
            return NodePool(name=name, description="built-in")
        return None

    def node_pools(self):
        """The registered pools, then the built-in ones not overridden."""
        from ..structs.operator import BUILTIN_NODE_POOLS, NodePool

        seen = set()
        for name, p in self._store._node_pools.iterate(self.index):
            seen.add(name)
            yield p
        for name in BUILTIN_NODE_POOLS:
            if name not in seen:
                yield NodePool(name=name, description="built-in")

    # --- namespaces ---

    def namespace(self, name: str):
        ns = self._store._namespaces.get(name, self.index)
        if ns is not None:
            return ns
        from ..structs.operator import DEFAULT_NAMESPACE, Namespace

        if name == DEFAULT_NAMESPACE:
            return Namespace(name=name, description="built-in")
        return None

    def namespaces(self):
        from ..structs.operator import DEFAULT_NAMESPACE, Namespace

        seen = set()
        for name, ns in self._store._namespaces.iterate(self.index):
            seen.add(name)
            yield ns
        if DEFAULT_NAMESPACE not in seen:
            yield Namespace(name=DEFAULT_NAMESPACE, description="built-in")

    def node_usage(self, node_id: str):
        """Summed allocated_vec of the node's non-terminal allocs, or
        None."""
        return self._store._node_usage.get(node_id, self.index)

    def node_dev_usage(self, node_id: str) -> Optional[dict]:
        """{device group id: instances used, "cores": n} or None
        (reference ``store.py:330``)."""
        return self._store._node_dev_usage.get(node_id, self.index)

    def scheduler_configuration(self):
        """The replicated scheduler config, or None when no operator set
        one (the Server's boot-time config applies)."""
        return self._store._scheduler_config.get("config", self.index)

    # --- jobs / evals ---

    def job_by_id(self, job_id: str,
                  namespace: str = "default") -> Optional[Job]:
        return self._store._jobs.get((namespace, job_id), self.index)

    def jobs(self) -> Iterator[Job]:
        return (j for _, j in self._store._jobs.iterate(self.index))

    def job_version(self, job_id: str, version: int,
                    namespace: str = "default") -> Optional[Job]:
        return self._store._job_versions.get((namespace, job_id, version),
                                             self.index)

    def job_versions(self, job_id: str,
                     namespace: str = "default") -> List[Job]:
        """Every retained version, newest first (keyed lookups from the
        current version down)."""
        current = self.job_by_id(job_id, namespace)
        if current is None:
            return []
        out = []
        for v in range(current.version, -1, -1):
            row = self.job_version(job_id, v, namespace)
            if row is not None:
                out.append(row)
        return out

    def scaling_events(self, job_id: str, namespace: str = "default"):
        return list(self._store._scaling_events.get(
            (namespace, job_id), self.index) or ())

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._store._evals.get(eval_id, self.index)

    def evals_by_job(self, job_id: str,
                     namespace: str = "default") -> List[Evaluation]:
        out = []
        for eid in cons_iter(self._store._evals_by_job.get(
                (namespace, job_id), self.index)):
            ev = self.eval_by_id(eid)
            if ev is not None:
                out.append(ev)
        return out

    def evals(self) -> Iterator[Evaluation]:
        return (e for _, e in self._store._evals.iterate(self.index))

    # --- volumes ---

    def volume_by_id(self, vol_id: str, namespace: str = "default"):
        return self._store._volumes.get((namespace, vol_id), self.index)

    def volumes(self, namespace: Optional[str] = None):
        for (ns, _vid), v in self._store._volumes.iterate(self.index):
            if namespace is None or ns == namespace:
                yield v

    # --- service registrations ---

    def service_registrations(self, namespace: Optional[str] = None):
        """Every live registration (reference ``store.py:391-395``)."""
        for _, reg in self._store._services.iterate(self.index):
            if namespace is None or reg.namespace == namespace:
                yield reg

    def service_by_name(self, name: str, namespace: str = "default"):
        out = []
        for rid in dict.fromkeys(cons_iter(self._store._services_by_name.get(
                (namespace, name), self.index))):
            reg = self._store._services.get(rid, self.index)
            if reg is not None:
                out.append(reg)
        return out

    # --- deployments ---

    def deployments(self) -> Iterator[Deployment]:
        return (d for _, d in self._store._deployments.iterate(self.index))

    def deployment_by_id(self, dep_id: str) -> Optional[Deployment]:
        return self._store._deployments.get(dep_id, self.index)

    def deployments_by_job(self, job_id: str,
                           namespace: str = "default") -> List[Deployment]:
        out = []
        for dep_id in cons_iter(self._store._deployments_by_job.get(
                (namespace, job_id), self.index)):
            dep = self._store._deployments.get(dep_id, self.index)
            if dep is not None:
                out.append(dep)
        return out

    def latest_deployment_by_job(self, job_id: str, namespace: str = "default"
                                 ) -> Optional[Deployment]:
        best = None
        for dep in self.deployments_by_job(job_id, namespace):
            if best is None or dep.create_index > best.create_index:
                best = dep
        return best

    # --- allocs ---

    def alloc_blocks(self) -> Iterator[AllocBlock]:
        return (b for _, b in self._store._alloc_blocks.iterate(self.index))

    def alloc_block_by_id(self, block_id: str) -> Optional[AllocBlock]:
        return self._store._alloc_blocks.get(block_id, self.index)

    def allocs(self) -> Iterator[Allocation]:
        store = self._store
        for block in self.alloc_blocks():
            if not store._promoted.get(block.id, self.index):
                yield from block.iter_allocs()
                continue
            for a in block.iter_allocs():
                # a promoted position comes out of the allocs table below
                if store._allocs.get(a.id, self.index) is None:
                    yield a
        for _, a in store._allocs.iterate(self.index):
            yield a

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        a = self._store._allocs.get(alloc_id, self.index)
        if a is not None:
            return a
        return _block_alloc(alloc_id, lambda bid: self._store._alloc_blocks.get(
            bid, self.index))

    def _allocs_from_index(self, table: VersionedTable,
                           key) -> List[Allocation]:
        out: List[Allocation] = []
        store = self._store
        for ref in cons_iter(table.get(key, self.index)):
            if isinstance(ref, tuple):
                for aid in ref:
                    a = store._allocs.get(aid, self.index)
                    if a is not None:
                        out.append(a)
                continue
            block = store._alloc_blocks.get(ref.block_id, self.index)
            if block is None:
                continue
            rows = block.live_rows() if ref.row < 0 else (ref.row,)
            shadowed = store._promoted.get(block.id, self.index)
            for m in rows:
                if not shadowed:
                    out.extend(block.allocs_for_row(m))
                    continue
                for a in block.allocs_for_row(m):
                    # a written block position shadows the virtual row
                    promoted = store._allocs.get(a.id, self.index)
                    out.append(promoted if promoted is not None else a)
        return out

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        return self._allocs_from_index(self._store._allocs_by_node, node_id)

    def allocs_by_node_terminal(self, node_id: str,
                                terminal: bool) -> List[Allocation]:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, job_id: str,
                      namespace: str = "default") -> List[Allocation]:
        return self._allocs_from_index(self._store._allocs_by_job,
                                       (namespace, job_id))

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        return self._allocs_from_index(self._store._allocs_by_eval, eval_id)


class StateStore:
    """MVCC tables + a serialized write path. Safe for concurrent
    ``Harness.process`` callers: writes serialize on one lock, reads go
    through generation-bounded snapshots."""

    def __init__(self):
        self._write_lock = threading.RLock()
        # notified on every publish: snapshot_min_index waits on it
        self._cond = threading.Condition()
        self._listeners: List[Callable[[int, list], None]] = []
        self._index = 0
        self._next_gen = 0
        self._tracker = SnapshotTracker()

        self._nodes = VersionedTable("nodes")
        self._node_pools = VersionedTable("node_pools")
        self._namespaces = VersionedTable("namespaces")
        self._jobs = VersionedTable("jobs")
        # key (ns, job id): the job's last scaling events
        self._scaling_events = VersionedTable("scaling_events")
        # key (ns, job id, version): auto-revert reads the prior version
        self._job_versions = VersionedTable("job_versions")
        self._evals = VersionedTable("evals")
        self._evals_by_job = VersionedTable("evals_by_job")
        self._volumes = VersionedTable("volumes")       # key (ns, id)
        self._alloc_blocks = VersionedTable("alloc_blocks")
        self._allocs = VersionedTable("allocs")
        # per block id, how many of its positions a real row shadows; a
        # block with none is read without a lookup per position
        self._promoted = VersionedTable("promoted")
        self._deployments = VersionedTable("deployments")
        self._deployments_by_job = VersionedTable("deployments_by_job")
        self._allocs_by_node = VersionedTable("allocs_by_node")
        self._allocs_by_job = VersionedTable("allocs_by_job")
        self._allocs_by_eval = VersionedTable("allocs_by_eval")
        # per-node summed allocated_vec of non-terminal allocs
        self._node_usage = VersionedTable("node_usage")
        # per-node device-instance and reserved-core counts of the
        # non-terminal allocs that hold any ({group id: n, "cores": n}),
        # the usage of the device and core columns the tensor layer adds
        self._node_dev_usage = VersionedTable("node_dev_usage")
        # the replicated singleton "config" -> SchedulerConfiguration
        self._scheduler_config = VersionedTable("scheduler_config")
        # the builtin service catalog: registrations by id, with
        # (namespace, service name) and alloc id indexes
        self._services = VersionedTable("services")
        self._services_by_name = VersionedTable("services_by_name")
        self._services_by_alloc = VersionedTable("services_by_alloc")

        # the time source of the mutators' ``ts`` fallbacks
        self._clock = time.time
        # bumped on every node-table write; the tensor layer's canonical
        # node-set caches key on it
        self.node_set_version = 0
        self.node_set_index = 0
        # allocs stopped by a fresh placement of their slot
        # (``_supersede_slot_duplicates``), since the store was made
        self.superseded = 0
        self._ready_nodes_cache: Dict[tuple, tuple] = {}
        # dense LATEST-state usage matrix, one row per node, kept in
        # lockstep with _node_usage: the placer reads it with one gather
        self._usage_rows: Dict[str, int] = {}
        self._usage_mat = np.zeros((256, RESOURCE_DIMS))
        self._all_tables = [
            self._nodes, self._node_pools, self._jobs, self._job_versions,
            self._evals, self._evals_by_job, self._volumes,
            self._alloc_blocks, self._allocs, self._promoted,
            self._deployments, self._deployments_by_job,
            self._allocs_by_node, self._allocs_by_job, self._allocs_by_eval,
            self._node_usage, self._node_dev_usage, self._scheduler_config,
            self._namespaces, self._scaling_events, self._services,
            self._services_by_name, self._services_by_alloc]
        # parked blocking queries, woken by this store's commits (every
        # replica wakes its own as replication applies)
        from .watch import WatchTable

        self.watches = WatchTable(self)

    # --- infrastructure ---

    @property
    def latest_index(self) -> int:
        return self._index

    def snapshot(self) -> StateSnapshot:
        gen = self._tracker.acquire_atomic(lambda: self._index)
        return StateSnapshot(self, gen)

    def snapshot_min_index(self, index: int,
                           timeout: float = 5.0) -> StateSnapshot:
        """Wait until the store has published ``index``, then snapshot
        (reference ``state/store.py:555``)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._index < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"state store did not reach index {index} "
                        f"(at {self._index})")
                self._cond.wait(remaining)
        return self.snapshot()

    def add_commit_listener(self, fn: Callable[[int, list], None]) -> None:
        """``fn(index, events)`` after each publish, on the writer's
        thread and under its lock: a listener must only hand off."""
        self._listeners.append(fn)

    def _begin(self) -> Tuple[int, int]:
        """Allocate the next (unpublished) generation and the prune
        floor. Must hold _write_lock."""
        self._next_gen += 1
        return self._next_gen, self._tracker.min_live(self._index)

    def _commit(self, gen: int, events: list = ()) -> None:
        with self._cond:
            self._index = gen
            self._cond.notify_all()
        for fn in self._listeners:
            fn(gen, events)

    def compact(self) -> int:
        """Prune version chains and drop the tombstones no live snapshot
        can see, across every table (core GC's last pass, reference
        ``store.py:594``). Returns the rows dropped."""
        with self._write_lock:
            floor = self._tracker.min_live(self._index)
            return sum(t.sweep(floor) for t in self._all_tables)

    def dump(self) -> dict:
        """The whole state as a dump (``state/persist.py``)."""
        from .persist import dump_store

        return dump_store(self)

    def restore_dump(self, data: dict) -> int:
        """Replace the contents from a dump (``state/persist.py``; a
        snapshot install, or an operator's restore replicated as a
        command); emits ``restore``. Returns the index."""
        from .persist import restore_store

        restore_store(self, data)
        return self._index

    def set_scheduler_configuration(self, cfg) -> int:
        """The operator's scheduler config as replicated state
        (reference ``store.py:1724``): a failover keeps it."""
        with self._write_lock:
            gen, live = self._begin()
            self._scheduler_config.put("config", cfg, gen, live)
            self._commit(gen, [("scheduler-config", cfg)])
            return gen

    # --- nodes ---

    def upsert_node(self, node: Node) -> int:
        return self.upsert_nodes([node])

    def upsert_nodes(self, nodes: List[Node]) -> int:
        """Nodes in one generation; a re-registered node keeps its
        create index, usage row and drain."""
        with self._write_lock:
            gen, live = self._begin()
            for node in nodes:
                prev = self._nodes.get_latest(node.id)
                node.create_index = (prev.create_index if prev is not None
                                     else gen)
                if (prev is not None and node.drain_strategy is None
                        and prev.drain_strategy is not None):
                    # a re-registration does not own the drain
                    node.drain_strategy = prev.drain_strategy
                    node.scheduling_eligibility = prev.scheduling_eligibility
                node.modify_index = gen
                node._avail_vec = None  # the caller may have mutated it
                if not node.computed_class:
                    node.compute_class()
                self._nodes.put(node.id, node, gen, live)
                self._usage_row(node.id)
            self._bump_node_set(gen)
            self._commit(gen, [("node-upsert", n) for n in nodes])
            return gen

    def _bump_node_set(self, gen: int) -> None:
        self.node_set_version += 1
        self.node_set_index = gen
        self._ready_nodes_cache.clear()

    def _update_node(self, node_id: str, event: str, mutate) -> int:
        """A node row's next version, ``mutate`` applied to a copy."""
        with self._write_lock:
            prev = self._nodes.get_latest(node_id)
            if prev is None:
                raise KeyError(f"node {node_id} not found")
            gen, live = self._begin()
            node = copy.copy(prev)
            mutate(node)
            node.modify_index = gen
            self._nodes.put(node_id, node, gen, live)
            self._bump_node_set(gen)
            self._commit(gen, [(event, node)])
            return gen

    def update_node_status(self, node_id: str, status: str,
                           ts: float = None) -> int:
        ts = ts if ts is not None else self._clock()

        def mut(n):
            n.status = status
            n.status_updated_at = ts
        return self._update_node(node_id, "node-status", mut)

    def update_nodes_status(self, node_ids: List[str], status: str,
                            ts: float = None) -> int:
        """Many status flips in one generation (an expiry batch);
        unknown ids are skipped (reference ``store.py:666``)."""
        ts = ts if ts is not None else self._clock()
        with self._write_lock:
            gen, live = self._begin()
            events = []
            for node_id in node_ids:
                node = self._nodes.get_latest(node_id)
                if node is None:
                    continue
                node = copy.copy(node)
                node.status = status
                node.status_updated_at = ts
                node.modify_index = gen
                self._nodes.put(node_id, node, gen, live)
                events.append(("node-status", node))
            self._bump_node_set(gen)
            self._commit(gen, events)
            return gen

    def update_node_drain(self, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> int:
        """Set or clear a node's drain; a drained node turns ineligible
        (reference ``store.py:717``)."""
        def mut(n):
            n.drain_strategy = drain_strategy
            if drain_strategy is not None:
                n.scheduling_eligibility = enums.NODE_SCHED_INELIGIBLE
            elif mark_eligible:
                n.scheduling_eligibility = enums.NODE_SCHED_ELIGIBLE
        return self._update_node(node_id, "node-drain", mut)

    def update_node_eligibility(self, node_id: str, eligibility: str) -> int:
        def mut(n):
            n.scheduling_eligibility = eligibility
        return self._update_node(node_id, "node-eligibility", mut)

    def delete_node(self, node_id: str) -> int:
        """Node GC and deregistration (reference ``store.py:726-737``):
        the row goes, its usage rows are zeroed, and ``node-delete``
        tells the feed that the node set changed."""
        with self._write_lock:
            gen, live = self._begin()
            node = self._nodes.get_latest(node_id)
            self._nodes.delete(node_id, gen, live)
            self._node_usage.delete(node_id, gen, live)
            self._node_dev_usage.delete(node_id, gen, live)
            row = self._usage_rows.get(node_id)
            if row is not None:
                self._usage_mat[row] = 0.0
            self._bump_node_set(gen)
            self._commit(gen, [("node-delete", node)])
            return gen

    def upsert_node_pool(self, pool) -> int:
        """A pool's row; the built-in pools are refused at the Server's
        endpoint (the reference refuses them here too), so a caller of
        the store may override one."""
        with self._write_lock:
            gen, live = self._begin()
            prev = self._node_pools.get_latest(pool.name)
            pool.create_index = prev.create_index if prev is not None else gen
            pool.modify_index = gen
            self._node_pools.put(pool.name, pool, gen, live)
            self._commit(gen, [("node-pool-upsert", pool)])
            return gen

    def delete_node_pool(self, name: str) -> int:
        from ..structs.operator import BUILTIN_NODE_POOLS

        if name in BUILTIN_NODE_POOLS:
            raise ValueError(f"cannot delete built-in node pool {name!r}")
        with self._write_lock:
            # a pool with member nodes or live jobs must not vanish
            for _, n in self._nodes.iterate(self._index):
                if n.node_pool == name:
                    raise ValueError(f"node pool {name!r} has nodes")
            for _, j in self._jobs.iterate(self._index):
                if j.node_pool == name and not j.stopped():
                    raise ValueError(f"node pool {name!r} has jobs")
            gen, live = self._begin()
            pool = self._node_pools.get_latest(name)
            self._node_pools.delete(name, gen, live)
            self._commit(gen, [("node-pool-delete", pool)])
            return gen

    # --- namespaces ---

    def _require_namespace(self, name: str) -> None:
        """A registration into an unregistered namespace is refused
        (under the write lock: no race with ``delete_namespace``)."""
        from ..structs.operator import DEFAULT_NAMESPACE

        if name == DEFAULT_NAMESPACE:
            return
        if self._namespaces.get_latest(name) is None:
            raise ValueError(f"namespace {name!r} does not exist")

    def upsert_namespace(self, ns) -> int:
        with self._write_lock:
            gen, live = self._begin()
            prev = self._namespaces.get_latest(ns.name)
            ns.create_index = prev.create_index if prev is not None else gen
            ns.modify_index = gen
            self._namespaces.put(ns.name, ns, gen, live)
            self._commit(gen, [("namespace-upsert", ns)])
            return gen

    def delete_namespace(self, name: str) -> int:
        from ..structs.operator import DEFAULT_NAMESPACE

        if name == DEFAULT_NAMESPACE:
            raise ValueError("cannot delete the default namespace")
        with self._write_lock:
            if self._namespaces.get_latest(name) is None:
                raise KeyError(f"namespace {name!r} does not exist")
            # a namespace must not vanish under its live jobs or volumes
            for (jns, _), j in self._jobs.iterate(self._index):
                if jns == name and not j.stopped():
                    raise ValueError(f"namespace {name!r} has jobs")
            for (vns, _), _v in self._volumes.iterate(self._index):
                if vns == name:
                    raise ValueError(f"namespace {name!r} has volumes")
            gen, live = self._begin()
            ns = self._namespaces.get_latest(name)
            self._namespaces.delete(name, gen, live)
            self._commit(gen, [("namespace-delete", ns)])
            return gen

    # --- jobs / evals ---

    def upsert_job(self, job: Job) -> int:
        with self._write_lock:
            self._require_namespace(job.namespace)
            gen, live = self._begin()
            key = (job.namespace, job.id)
            prev = self._jobs.get_latest(key)
            if prev is not None:
                job.create_index = prev.create_index
                job.version = prev.version + 1
            else:
                job.create_index = gen
                job.version = 0
                if job.status != enums.JOB_STATUS_DEAD:
                    job.status = enums.JOB_STATUS_PENDING
            job.modify_index = gen
            job.job_modify_index = gen
            # a snapshot row, so a re-upserted caller object can't
            # rewrite history in place
            row = copy.copy(job)
            self._jobs.put(key, row, gen, live)
            self._job_versions.put((job.namespace, job.id, job.version), row,
                                   gen, live)
            self._commit(gen, [("job-upsert", row)])
            return gen

    def delete_job(self, job_id: str, namespace: str = "default",
                   purge: bool = True) -> int:
        """Purge the job row, or with ``purge=False`` keep it marked
        stopped; its allocations stay as they are until an eval stops
        them (reference ``delete_job``, store.py:766)."""
        with self._write_lock:
            gen, live = self._begin()
            key = (namespace, job_id)
            job = self._jobs.get_latest(key)
            if purge:
                self._jobs.delete(key, gen, live)
                # a later job of the same id starts a scaling history of
                # its own
                self._scaling_events.delete(key, gen, live)
            elif job is not None:
                job = copy.copy(job)
                job.stop = True
                job.modify_index = gen
                self._jobs.put(key, job, gen, live)
            self._commit(gen, [("job-delete", job)])
            return gen

    def append_scaling_event(self, job_id: str, namespace: str,
                             event: dict, keep: int = 20) -> int:
        """A scale's event on the job's ring of its last ``keep``
        (``/v1/job/<id>/scale`` serves them)."""
        with self._write_lock:
            gen, live = self._begin()
            key = (namespace, job_id)
            events = list(self._scaling_events.get_latest(key) or ())
            events.append(dict(event))
            self._scaling_events.put(key, tuple(events[-keep:]), gen, live)
            self._commit(gen, [("scaling-event", event)])
            return gen

    def update_job_status(self, job_id: str, status: str,
                          namespace: str = "default") -> int:
        with self._write_lock:
            key = (namespace, job_id)
            job = self._jobs.get_latest(key)
            if job is None:
                raise KeyError(f"job {job_id} not found")
            gen, live = self._begin()
            job = copy.copy(job)
            job.status = status
            job.modify_index = gen
            self._jobs.put(key, job, gen, live)
            self._commit(gen, [("job-status", job)])
            return gen

    def upsert_evals(self, evals: List[Evaluation], ts: float = None) -> int:
        with self._write_lock:
            gen, live = self._begin()
            for ev in evals:
                self._put_eval(ev, gen, live, ts)
            self._commit(gen, [("eval-upsert", ev) for ev in evals])
            return gen

    def _put_eval(self, ev: Evaluation, gen: int, live: int,
                  ts: float = None) -> None:
        prev = self._evals.get_latest(ev.id)
        ev.create_index = prev.create_index if prev is not None else gen
        ev.modify_index = gen
        ev.modify_time = ts if ts is not None else self._clock()
        if not ev.create_time:
            ev.create_time = ev.modify_time
        self._evals.put(ev.id, ev, gen, live)
        if prev is None:
            key = (ev.namespace, ev.job_id)
            cell = self._evals_by_job.get_latest(key)
            self._evals_by_job.put(key, cons(ev.id, cell), gen, live)

    def delete_evals(self, eval_ids: List[str]) -> int:
        """Drop evals and their ids from the job index (reference
        ``store.py:827``)."""
        with self._write_lock:
            gen, live = self._begin()
            dead = set(eval_ids)
            jobs_touched = set()
            for eid in eval_ids:
                ev = self._evals.get_latest(eid)
                if ev is not None:
                    jobs_touched.add((ev.namespace, ev.job_id))
                self._evals.delete(eid, gen, live)
            for key in sorted(jobs_touched):
                cell = self._evals_by_job.get_latest(key)
                ids = [i for i in cons_iter(cell) if i not in dead]
                if cell is not None and len(ids) != cell.length:
                    self._evals_by_job.put(
                        key, cons_from_iter(reversed(ids)), gen, live)
            self._commit(gen, [("eval-delete", list(eval_ids))])
            return gen

    # --- usage rows ---

    def _usage_row(self, node_id: str) -> int:
        """Must hold _write_lock when the row may need creating."""
        row = self._usage_rows.get(node_id)
        if row is None:
            row = len(self._usage_rows)
            self._usage_rows[node_id] = row
            if row >= self._usage_mat.shape[0]:
                grown = np.zeros((self._usage_mat.shape[0] * 2,
                                  RESOURCE_DIMS))
                grown[: self._usage_mat.shape[0]] = self._usage_mat
                self._usage_mat = grown
        return row

    def usage_rows_for(self, node_ids: List[str]) -> np.ndarray:
        """Matrix row index per node id (the tensor layer's one-gather
        usage read)."""
        rows = self._usage_rows
        try:
            return np.fromiter((rows[n] for n in node_ids), dtype=np.int64,
                               count=len(node_ids))
        except KeyError:
            with self._write_lock:
                return np.fromiter((self._usage_row(n) for n in node_ids),
                                   dtype=np.int64, count=len(node_ids))

    def _rebuild_usage_matrix(self) -> None:
        """Re-derive the dense matrix from the latest usage rows (the
        restore path). Must hold _write_lock. Existing row numbers stay:
        the tensor layer may hold them."""
        self._usage_mat[:] = 0.0
        for node_id, _ in self._nodes.iterate(self._next_gen):
            self._usage_row(node_id)
        for node_id, vec in self._node_usage.iterate(self._next_gen):
            if vec is not None:
                self._usage_mat[self._usage_row(node_id)] = vec

    def _usage_add(self, node_id: str, delta, gen: int, live: int) -> None:
        cur = self._node_usage.get_latest(node_id)
        self._node_usage.put(node_id, delta if cur is None else cur + delta,
                             gen, live)
        self._usage_mat[self._usage_row(node_id)] += delta

    def _usage_apply(self, prev: Optional[Allocation], new: Allocation,
                     gen: int, live: int) -> None:
        """Fold one alloc's rewrite into its node's usage rows: only a
        non-terminal alloc counts, and a rewrite that keeps it counting
        on the same node with the same vector moves nothing (reference
        ``store.py:909-930``)."""
        pc = prev is not None and not prev.terminal_status()
        nc = not new.terminal_status()
        if (pc and nc and prev.node_id == new.node_id
                and np.array_equal(prev.allocated_vec, new.allocated_vec)):
            return
        if pc:
            self._usage_add(prev.node_id, -prev.allocated_vec, gen, live)
            self._dev_usage_add(prev, -1, gen, live)
        if nc:
            self._usage_add(new.node_id, new.allocated_vec, gen, live)
            self._dev_usage_add(new, +1, gen, live)

    def _latest_alloc(self, alloc_id: str) -> Tuple[Optional[Allocation],
                                                    bool]:
        """The latest row of an alloc id and whether it is a block
        position's virtual row (reference ``store.py:944-951``)."""
        a = self._allocs.get_latest(alloc_id)
        if a is not None:
            return a, False
        a = _block_alloc(alloc_id, self._alloc_blocks.get_latest)
        return a, a is not None

    def _count_promoted(self, promoted: Dict[str, int], gen: int,
                        live: int) -> None:
        for bid, c in promoted.items():
            self._promoted.put(bid, (self._promoted.get_latest(bid) or 0) + c,
                               gen, live)

    def update_allocs_from_client(self, updates: List[Allocation],
                                  ts: float = None) -> int:
        """Client status sync (reference ``store.py:978-1004``): each
        update's client status, description, task states, finish time and
        deployment health merge into a copy of the latest row; an alloc
        that turns client-terminal leaves its node's usage. A block
        position is promoted to a row of its own. Unknown ids are
        skipped."""
        with self._write_lock:
            gen, live = self._begin()
            ts = ts if ts is not None else self._clock()
            events = []
            promoted: Dict[str, int] = {}
            for upd in updates:
                existing, virtual = self._latest_alloc(upd.id)
                if existing is None:
                    continue
                merged = copy.copy(existing)
                merged.client_status = upd.client_status
                merged.client_description = upd.client_description
                merged.task_states = upd.task_states or merged.task_states
                merged.task_finished_at = (upd.task_finished_at
                                           or merged.task_finished_at)
                merged.deployment_status = (upd.deployment_status
                                            or merged.deployment_status)
                merged.modify_index = gen
                merged.modify_time = ts
                self._allocs.put(merged.id, merged, gen, live)
                if virtual:
                    bid = merged.id[:merged.id.rfind(BLOCK_SEP)]
                    promoted[bid] = promoted.get(bid, 0) + 1
                self._usage_apply(existing, merged, gen, live)
                events.append(("alloc-client-update", merged))
                if merged.client_terminal():
                    self._reap_services_for_terminal(merged, gen, live,
                                                     events)
            self._count_promoted(promoted, gen, live)
            self._commit(gen, events)
            return gen

    def update_alloc_desired_transitions(
            self, transitions: Dict[str, object],
            evals: List[Evaluation] = (), ts: float = None) -> int:
        """Set desired transitions (the drainer's migrate marks, an alloc
        stop's reschedule) and upsert ``evals`` in the same generation
        (reference ``store.py:1006-1029``). A transition moves no usage."""
        with self._write_lock:
            gen, live = self._begin()
            events = []
            promoted: Dict[str, int] = {}
            for alloc_id, transition in transitions.items():
                existing, virtual = self._latest_alloc(alloc_id)
                if existing is None:
                    continue
                merged = copy.copy(existing)
                merged.desired_transition = transition
                merged.modify_index = gen
                self._allocs.put(alloc_id, merged, gen, live)
                if virtual:
                    bid = alloc_id[:alloc_id.rfind(BLOCK_SEP)]
                    promoted[bid] = promoted.get(bid, 0) + 1
                events.append(("alloc-transition", merged))
            self._count_promoted(promoted, gen, live)
            for ev in evals:
                self._put_eval(ev, gen, live, ts)
                events.append(("eval-upsert", ev))
            self._commit(gen, events)
            return gen

    # --- deployments ---

    def _dev_usage_add(self, alloc: Allocation, sign: int, gen: int,
                       live: int) -> None:
        """Fold one alloc's device instances and cores into its node's
        row (reference ``store.py:932-940``)."""
        if not alloc.allocated_devices and not alloc.allocated_cores:
            return
        from ..scheduler.devices import accumulate_dev_usage

        cur = self._node_dev_usage.get_latest(alloc.node_id)
        row = dict(cur) if cur else {}
        accumulate_dev_usage(row, alloc, sign)
        self._node_dev_usage.put(alloc.node_id, row, gen, live)

    def _put_deployment(self, dep: Deployment, gen: int, live: int) -> None:
        prev = self._deployments.get_latest(dep.id)
        dep.create_index = prev.create_index if prev is not None else gen
        dep.modify_index = gen
        self._deployments.put(dep.id, dep, gen, live)
        if prev is None:
            key = (dep.namespace, dep.job_id)
            cell = self._deployments_by_job.get_latest(key)
            self._deployments_by_job.put(key, cons(dep.id, cell), gen, live)

    def upsert_deployment(self, dep: Deployment) -> int:
        with self._write_lock:
            gen, live = self._begin()
            self._put_deployment(dep, gen, live)
            self._commit(gen, [("deployment-upsert", dep)])
            return gen

    def delete_deployment(self, dep_id: str) -> int:
        """GC of a terminal deployment (reference ``store.py:1327``)."""
        with self._write_lock:
            gen, live = self._begin()
            dep = self._deployments.get_latest(dep_id)
            self._deployments.delete(dep_id, gen, live)
            self._commit(gen, [("deployment-delete", dep)])
            return gen

    # --- volumes (reference ``store.py:1351-1383, 1457-1510``) ---

    def upsert_volume(self, vol) -> int:
        with self._write_lock:
            self._require_namespace(vol.namespace)
            gen, live = self._begin()
            key = (vol.namespace, vol.id)
            prev = self._volumes.get_latest(key)
            if prev is not None:
                vol.create_index = prev.create_index
                # claims are the store's: a re-register keeps live ones
                if not vol.claims and prev.claims:
                    vol.claims = dict(prev.claims)
            else:
                vol.create_index = gen
            vol.modify_index = gen
            self._volumes.put(key, vol, gen, live)
            self._commit(gen, [("volume-upsert", vol)])
            return gen

    def delete_volume(self, vol_id: str, namespace: str = "default",
                      force: bool = False) -> int:
        with self._write_lock:
            key = (namespace, vol_id)
            vol = self._volumes.get_latest(key)
            if vol is not None and vol.claims and not force:
                raise ValueError(
                    f"volume {vol_id} has {len(vol.claims)} live claims")
            gen, live = self._begin()
            self._volumes.delete(key, gen, live)
            self._commit(gen, [("volume-delete", vol)])
            return gen

    # --- service registrations (reference ``store.py:1385-1455``) ---

    def upsert_service_registrations(self, regs) -> int:
        with self._write_lock:
            gen, live = self._begin()
            events = []
            for reg in regs:
                prev = self._services.get_latest(reg.id)
                reg.create_index = (prev.create_index if prev is not None
                                    else gen)
                reg.modify_index = gen
                self._services.put(reg.id, reg, gen, live)
                if prev is None:
                    key = (reg.namespace, reg.service_name)
                    self._services_by_name.put(key, cons(
                        reg.id, self._services_by_name.get_latest(key)),
                        gen, live)
                    self._services_by_alloc.put(reg.alloc_id, cons(
                        reg.id,
                        self._services_by_alloc.get_latest(reg.alloc_id)),
                        gen, live)
                events.append(("service-register", reg))
            self._commit(gen, events)
            return gen

    def _delete_service_regs(self, ids, gen: int, live: int,
                             events: list) -> None:
        for rid in ids:
            reg = self._services.get_latest(rid)
            if reg is None:
                continue
            self._services.delete(rid, gen, live)
            key = (reg.namespace, reg.service_name)
            left = [i for i in cons_iter(self._services_by_name.get_latest(
                key)) if i != rid]
            self._services_by_name.put(
                key, cons_from_iter(reversed(left)), gen, live)
            aleft = [i for i in cons_iter(self._services_by_alloc.get_latest(
                reg.alloc_id)) if i != rid]
            self._services_by_alloc.put(
                reg.alloc_id,
                cons_from_iter(reversed(aleft)) if aleft else None,
                gen, live)
            events.append(("service-deregister", reg))

    def _reap_services_for_terminal(self, alloc, gen: int, live: int,
                                    events: list) -> None:
        """A terminal alloc's registrations go with it: a crashed or lost
        node's client never deregisters them."""
        cell = self._services_by_alloc.get_latest(alloc.id)
        if cell is not None:
            self._delete_service_regs(list(cons_iter(cell)), gen, live,
                                      events)

    def delete_service_registrations(self, ids) -> int:
        with self._write_lock:
            gen, live = self._begin()
            events = []
            self._delete_service_regs(list(ids), gen, live, events)
            self._commit(gen, events)
            return gen

    def delete_services_by_alloc(self, alloc_id: str) -> int:
        with self._write_lock:
            gen, live = self._begin()
            cell = self._services_by_alloc.get_latest(alloc_id)
            events = []
            if cell is not None:
                self._delete_service_regs(list(cons_iter(cell)), gen, live,
                                          events)
            self._commit(gen, events)
            return gen

    def _claim_volumes_for(self, alloc: Allocation, gen: int, live: int,
                           events: list) -> None:
        """Record a first-inserted placement's csi claims inside the
        plan's commit (the applier re-checked them). Readers claim too."""
        from ..structs.volumes import VolumeClaim

        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None or not tg.volumes:
            return
        for req in tg.volumes.values():
            if req.type != "csi":
                continue
            key = (alloc.namespace, req.source)
            vol = self._volumes.get_latest(key)
            if vol is None:
                continue
            vol = copy.copy(vol)
            vol.claims = dict(vol.claims)
            vol.claims[alloc.id] = VolumeClaim(
                alloc_id=alloc.id, node_id=alloc.node_id,
                read_only=req.read_only)
            vol.modify_index = gen
            self._volumes.put(key, vol, gen, live)
            events.append(("volume-claim", vol))

    def reap_volume_claims(self) -> int:
        """Release the claims whose allocs are terminal or gone (the
        volume watcher's pass). Returns the claims released; an idle pass
        writes no generation."""
        with self._write_lock:
            changes = []
            for key, vol in list(self._volumes.iterate(self._index)):
                dead = [aid for aid in vol.claims
                        if (a := self._latest_alloc(aid)[0]) is None
                        or a.terminal_status()]
                if dead:
                    changes.append((key, vol, dead))
            if not changes:
                return 0
            gen, live = self._begin()
            events = []
            released = 0
            for key, vol, dead in changes:
                vol = copy.copy(vol)
                vol.claims = {k: v for k, v in vol.claims.items()
                              if k not in dead}
                vol.modify_index = gen
                self._volumes.put(key, vol, gen, live)
                events.append(("volume-claim-release", vol))
                released += len(dead)
            self._commit(gen, events)
            return released

    # --- the plan-apply mutation ---

    def upsert_allocs(self, allocs: List[Allocation],
                      ts: float = None) -> int:
        """Insert or replace single allocations in one generation."""
        with self._write_lock:
            gen, live = self._begin()
            self._put_allocs(allocs, gen, live,
                             ts if ts is not None else self._clock())
            self._commit(gen, [("alloc-upsert", a) for a in allocs])
            return gen

    def upsert_plan_results(self, result_allocs: List[Allocation] = (),
                            stopped_allocs: List[Allocation] = (),
                            preempted_allocs: List[Allocation] = (),
                            deployment: Optional[Deployment] = None,
                            evals: List[Evaluation] = (),
                            alloc_blocks: List[AllocBlock] = (),
                            job: Optional[Job] = None,
                            ts: float = None) -> int:
        """Commit a plan in one generation, in the reference's order
        (store.py:1173-1190): its stops, its evictions, its single
        allocations, its columnar placements (per block one block row,
        one BlockRef per touched node, one vectorized usage add per
        node), the deployment it opens and its eval updates."""
        return self.upsert_plan_results_batch([dict(
            result_allocs=result_allocs, stopped_allocs=stopped_allocs,
            preempted_allocs=preempted_allocs, deployment=deployment,
            evals=evals, alloc_blocks=alloc_blocks, job=job)], ts=ts)

    def upsert_plan_results_batch(self, payloads: List[dict],
                                  ts: float = None) -> int:
        """Many plans' results in ONE generation (the applier's commit
        round; reference store.py:1055): each payload holds the keyword
        arguments of ``upsert_plan_results`` (without ``ts``), applied in
        order."""
        with self._write_lock:
            gen, live = self._begin()
            ts = ts if ts is not None else self._clock()
            events: list = []
            for p in payloads:
                job = p.get("job")
                stops = p.get("stopped_allocs", ())
                evictions = p.get("preempted_allocs", ())
                results = p.get("result_allocs", ())
                blocks = p.get("alloc_blocks", ())
                self._rehydrate_jobs(stops, job)
                self._rehydrate_jobs(evictions, job)
                self._rehydrate_jobs(results, job)
                self._rehydrate_jobs(blocks, job)
                for a in stops:
                    self._reap_services_for_terminal(a, gen, live, events)
                self._put_allocs(stops, gen, live, ts)
                events.extend(("alloc-stop", a) for a in stops)
                self._put_allocs(evictions, gen, live, ts)
                events.extend(("alloc-preempt", a) for a in evictions)
                # the reference's order (store.py:1193-1206): rewrites of
                # existing rows, then the fresh placements' supersede
                # (it sees the rewrites: an alloc the plan marks unknown
                # or stops is not superseded), then the first inserts
                first = [self._latest_alloc(a.id)[0] is None
                         for a in results]
                rewrites = [a for a, f in zip(results, first) if not f]
                new = [a for a, f in zip(results, first) if f]
                self._put_allocs(rewrites, gen, live, ts)
                events.extend(("alloc-upsert", a) for a in rewrites)
                if new:
                    self._supersede_slot_duplicates(new, gen, live, ts,
                                                    events)
                    self._put_allocs(new, gen, live, ts)
                    for a in new:
                        if a.job is not None:
                            self._claim_volumes_for(a, gen, live, events)
                    events.extend(("alloc-upsert", a) for a in new)
                for block in blocks:
                    if self._put_alloc_block(block, gen, live, ts):
                        events.append(("alloc-block-upsert", block))
                dep = p.get("deployment")
                if dep is not None:
                    self._put_deployment(dep, gen, live)
                    events.append(("deployment-upsert", dep))
                for ev in p.get("evals", ()):
                    self._put_eval(ev, gen, live, ts)
                    events.append(("eval-upsert", ev))
            self._commit(gen, events)
            return gen

    def _rehydrate_jobs(self, rows, job) -> None:
        """The reverse of the plan applier's normalization (reference
        ``_rehydrate_alloc_jobs``, store.py:1048-1065): allocs and blocks
        ride the raft log without their job, the plan's job rides once
        a payload. Re-attach the payload's job to a row of its version
        (a placement, or an in-place update moving an alloc to it), else
        the existing row's (its exact version: a stop may carry an older
        job than the plan's), else the payload's, else the job table.
        Every input is replicated state or the payload, so every replica
        attaches the same job. The reference re-attaches the existing
        row's job first, so an in-place update keeps its old job there
        (ROADMAP §C11)."""
        for a in rows:
            if a.job is not None:
                continue
            if (job is not None and job.id == a.job_id
                    and job.version == a.job_version):
                a.job = job
                continue
            prev = (self._latest_alloc(a.id)[0]
                    if isinstance(a, Allocation) else None)
            if prev is not None and prev.job is not None:
                a.job = prev.job
            elif job is not None and job.id == a.job_id:
                a.job = job
            else:
                a.job = self._jobs.get_latest((a.namespace, a.job_id))

    def _supersede_slot_duplicates(self, new_allocs: List[Allocation],
                                   gen: int, live: int, ts: float,
                                   events: list) -> None:
        """A fresh placement whose slot (namespace, job, name; and node
        for system and sysbatch jobs) already holds a live alloc under
        another id stops the older one in the same transaction
        (reference ``store.py:1101-1166``): across a failover a dying
        leader's round can land unanswered while the eval re-runs through
        the new leader. Canaries are exempt (a canary runs beside the
        stable alloc of its name), and so is an alloc whose client status
        is unknown (a disconnect replacement runs beside its original);
        anything terminal is skipped."""
        def slot(a: Allocation) -> tuple:
            jtype = a.job.type if a.job is not None else ""
            node = (a.node_id if jtype in (enums.JOB_TYPE_SYSTEM,
                                           enums.JOB_TYPE_SYSBATCH)
                    else "")
            return (a.namespace, a.job_id, a.name, node)

        slots = {slot(a) for a in new_allocs if not a.canary}
        if not slots:
            return
        fresh_ids = {a.id for a in new_allocs}
        names = {(ns, job, name) for ns, job, name, _ in slots}
        seen = set()
        stops = []
        # sorted: every replica walks the jobs in one order
        for jkey in sorted({(a.namespace, a.job_id)
                            for a in new_allocs if not a.canary}):
            wanted = {name for ns, job, name in names if (ns, job) == jkey}
            for ref in cons_iter(self._allocs_by_job.get_latest(jkey)):
                if isinstance(ref, tuple):
                    # rows of their own (a promoted block position has
                    # no entry here): the name first, one lookup each
                    ids = [a.id for a in map(self._allocs.get_latest, ref)
                           if a is not None and a.name in wanted]
                else:
                    block = self._alloc_blocks.get_latest(ref.block_id)
                    if block is None:
                        continue
                    ids = _block_slot_ids(block, names)
                for aid in ids:
                    if aid in fresh_ids or aid in seen:
                        continue
                    seen.add(aid)
                    # a block position may be shadowed by a promoted row
                    cur = self._latest_alloc(aid)[0]
                    if (cur is None or cur.canary or cur.terminal_status()
                            or cur.client_status
                            == enums.ALLOC_CLIENT_UNKNOWN
                            or slot(cur) not in slots):
                        continue
                    stopped = cur.copy_for_update()
                    stopped.desired_status = enums.ALLOC_DESIRED_STOP
                    stopped.desired_description = SUPERSEDED
                    stops.append(stopped)
        if stops:
            for a in stops:
                self._reap_services_for_terminal(a, gen, live, events)
            self._put_allocs(stops, gen, live, ts)
            events.extend(("alloc-stop", a) for a in stops)
            self.superseded += len(stops)

    def _put_allocs(self, allocs: List[Allocation], gen: int, live: int,
                    ts: float) -> List[bool]:
        """Single allocations: a new id gets one index entry per node and
        job key (one chunk cell per key per generation); a replaced row
        moves the node's usage by the difference. A write to a block
        position promotes it: the real row shadows the block's virtual
        row in every index (no entry of its own) and replaces its usage.
        Usage, and the device and core rows, count the allocs that are
        not terminal, as the scheduler's proposed view does (reference
        ``_usage_apply``). A server-side rewrite keeps the client's status
        unless it sets one (reference ``_put_alloc``, store.py:953-976).
        Returns, per alloc, whether it was a first insert (no row and no
        block position before)."""
        by_node: Dict[str, list] = {}
        by_job: Dict[tuple, list] = {}
        by_eval: Dict[str, list] = {}
        # per (node, vec identity) counts: placements of one group share
        # one allocated_vec, so the adds collapse to one multiply a node
        usage: Dict[tuple, list] = {}

        def count(node_id, vec, sign):
            e = usage.setdefault((node_id, id(vec), sign), [vec, 0])
            e[1] += 1

        promoted: Dict[str, int] = {}
        fresh: List[bool] = []
        for a in allocs:
            prev, virtual = self._latest_alloc(a.id)
            if virtual:
                bid = a.id[:a.id.rfind(BLOCK_SEP)]
                promoted[bid] = promoted.get(bid, 0) + 1
            a.modify_time = ts
            if (prev is not None and prev.client_status
                    and a.client_status == enums.ALLOC_CLIENT_PENDING):
                a.client_status = prev.client_status
            a.create_index = prev.create_index if prev is not None else gen
            a.modify_index = gen
            self._allocs.put(a.id, a, gen, live)
            fresh.append(prev is None)
            if prev is None:
                by_node.setdefault(a.node_id, []).append(a.id)
                by_job.setdefault((a.namespace, a.job_id), []).append(a.id)
                by_eval.setdefault(a.eval_id, []).append(a.id)
            elif not prev.terminal_status():
                count(prev.node_id, prev.allocated_vec, -1.0)
                self._dev_usage_add(prev, -1, gen, live)
            if not a.terminal_status():
                count(a.node_id, a.allocated_vec, 1.0)
                self._dev_usage_add(a, +1, gen, live)
        for (node_id, _, sign), (vec, n) in usage.items():
            self._usage_add(node_id, vec * (sign * n) if n != 1 or sign < 0
                            else vec, gen, live)
        self._count_promoted(promoted, gen, live)
        for table, groups in ((self._allocs_by_node, by_node),
                              (self._allocs_by_job, by_job),
                              (self._allocs_by_eval, by_eval)):
            for key, ids in groups.items():
                table.put(key, cons(tuple(ids), table.get_latest(key)),
                          gen, live)
        return fresh

    def _put_alloc_block(self, block: AllocBlock, gen: int, live: int,
                         ts: float) -> bool:
        """Insert one block: its row, a BlockRef per node row and on
        its job and eval, one usage add per node. A block id already
        present is skipped and False returned (a port-only guard, ROADMAP
        §C7): a commit round the applier re-applied after its raft wait
        timed out may still land, and the reference's insert would add
        the block's usage and references a second time."""
        if self._alloc_blocks.get_latest(block.id) is not None:
            return False
        block.modify_time = ts
        block.create_index = gen
        block.modify_index = gen
        self._alloc_blocks.put(block.id, block, gen, live)
        vec = block.allocated_vec
        for m in block.live_rows():
            nid = block.node_ids[m]
            c = int(block.counts[m])
            cell = self._allocs_by_node.get_latest(nid)
            self._allocs_by_node.put(nid, cons(BlockRef(block.id, m), cell),
                                     gen, live)
            self._usage_add(nid, vec * c if c != 1 else vec, gen, live)
        jkey = (block.namespace, block.job_id)
        self._allocs_by_job.put(
            jkey, cons(BlockRef(block.id), self._allocs_by_job.get_latest(jkey)),
            gen, live)
        self._allocs_by_eval.put(
            block.eval_id, cons(BlockRef(block.id),
                                self._allocs_by_eval.get_latest(block.eval_id)),
            gen, live)
        return True

    # --- GC (reference ``store.py:1829-1880``) ---

    def gc_terminal_allocs(self, before_index: int,
                           before_time: float = float("inf")) -> int:
        """Drop the allocs with no purpose left: those of purged jobs once
        terminal, and those both server- and client-terminal. A failed
        alloc the server still wants running is kept (its reschedule
        lineage), and so is a completed batch alloc of a live job. A GC'd
        block position is marked dropped in a new block version (no
        event: the feed's ``gc_dropped`` mirrors it); a block with no
        position left goes. Returns the allocs dropped."""
        with self._write_lock:
            gen, live = self._begin()

            def gcable(a) -> bool:
                if a.modify_index >= before_index:
                    return False
                if (a.modify_time or 0) > before_time:
                    return False
                if self._jobs.get_latest((a.namespace, a.job_id)) is None:
                    return a.terminal_status() or a.server_terminal()
                return a.server_terminal() and a.client_terminal()

            dead_allocs = [a for _, a in self._allocs.iterate(gen)
                           if gcable(a)]
            dead = [a.id for a in dead_allocs]
            dead_set = set(dead)
            # every gcable alloc is terminal: no usage row moves
            block_drops: Dict[str, list] = {}
            for a in dead_allocs:
                self._allocs.delete(a.id, gen, live)
                sep = a.id.rfind(BLOCK_SEP)
                if sep > 0 and self._alloc_blocks.get_latest(a.id[:sep]):
                    block_drops.setdefault(a.id[:sep], []).append(
                        int(a.id[sep + 1:]))
            dead_blocks = set()
            for bid, positions in block_drops.items():
                block = self._alloc_blocks.get_latest(bid).with_dropped(
                    positions)
                # a dropped position's row is gone: it shadows no more
                left = (self._promoted.get_latest(bid) or 0) - len(positions)
                self._promoted.put(bid, max(0, left), gen, live)
                if block.live_size() <= 0:
                    self._alloc_blocks.delete(bid, gen, live)
                    dead_blocks.add(bid)
                else:
                    self._alloc_blocks.put(bid, block, gen, live)
            if dead_set or dead_blocks:
                for table in (self._allocs_by_node, self._allocs_by_job,
                              self._allocs_by_eval):
                    for key, cell in list(table.iterate(gen)):
                        self._drop_index_ids(table, key, cell, dead_set,
                                             dead_blocks, gen, live)
            self._commit(gen, [("alloc-gc", dead)])
            return len(dead)

    @staticmethod
    def _drop_index_ids(table: VersionedTable, key, cell, dead_ids: set,
                        dead_blocks: set, gen: int, live: int) -> None:
        """Rewrite one alloc-index chain without the dead ids and blocks,
        keeping its chunks (a tuple of ids a write, or a BlockRef)."""
        heads = []
        changed = False
        for head in cons_iter(cell):
            if isinstance(head, tuple):
                kept = tuple(i for i in head if i not in dead_ids)
                if len(kept) != len(head):
                    changed = True
                if kept:
                    heads.append(kept)
            elif head.block_id in dead_blocks:
                changed = True
            else:
                heads.append(head)
        if changed:
            table.put(key, cons_from_iter(reversed(heads)), gen, live)
