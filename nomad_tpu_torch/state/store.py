"""The state store, trimmed to the placement paths (reference
``nomad_tpu/state/store.py``): nodes, node pools, jobs, evals,
deployments, alloc blocks (the bulk path's placements) and single
allocations (the per-eval path's) in MVCC tables, one serialized writer
and any number of concurrent snapshot readers.

Write protocol: ``_begin()`` allocates the next generation privately,
mutations land in version chains at that generation, ``_commit()``
publishes it. Readers never see a half-applied generation, and taking a
snapshot is atomic with the writer's prune floor (both go through the
tracker's lock).
"""

from __future__ import annotations

import copy
import threading
import weakref
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..structs import enums
from ..structs.alloc import AllocBlock, Allocation
from ..structs.deployment import Deployment
from ..structs.evaluation import Evaluation
from ..structs.job import Job
from ..structs.node import Node
from ..structs.resources import RESOURCE_DIMS
from .mvcc import SnapshotTracker, VersionedTable, cons, cons_iter


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

    def node_usage(self, node_id: str):
        """Summed allocated_vec of the node's non-terminal allocs, or
        None."""
        return self._store._node_usage.get(node_id, self.index)

    # --- jobs / evals ---

    def job_by_id(self, job_id: str,
                  namespace: str = "default") -> Optional[Job]:
        return self._store._jobs.get((namespace, job_id), self.index)

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._store._evals.get(eval_id, self.index)

    # --- deployments ---

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

    def allocs(self) -> Iterator[Allocation]:
        for block in self.alloc_blocks():
            yield from block.iter_allocs()
        for _, a in self._store._allocs.iterate(self.index):
            yield a

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._store._allocs.get(alloc_id, self.index)

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
            for m in rows:
                out.extend(block.allocs_for_row(m))
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


class StateStore:
    """MVCC tables + a serialized write path. Safe for concurrent
    ``Harness.process`` callers: writes serialize on one lock, reads go
    through generation-bounded snapshots."""

    def __init__(self):
        self._write_lock = threading.RLock()
        self._index = 0
        self._next_gen = 0
        self._tracker = SnapshotTracker()

        self._nodes = VersionedTable("nodes")
        self._node_pools = VersionedTable("node_pools")
        self._jobs = VersionedTable("jobs")
        self._evals = VersionedTable("evals")
        self._alloc_blocks = VersionedTable("alloc_blocks")
        self._allocs = VersionedTable("allocs")
        self._deployments = VersionedTable("deployments")
        self._deployments_by_job = VersionedTable("deployments_by_job")
        self._allocs_by_node = VersionedTable("allocs_by_node")
        self._allocs_by_job = VersionedTable("allocs_by_job")
        # per-node summed allocated_vec of non-terminal allocs
        self._node_usage = VersionedTable("node_usage")

        # bumped on every node-table write; the tensor layer's canonical
        # node-set caches key on it
        self.node_set_version = 0
        self.node_set_index = 0
        self._ready_nodes_cache: Dict[tuple, tuple] = {}
        # dense LATEST-state usage matrix, one row per node, kept in
        # lockstep with _node_usage: the placer reads it with one gather
        self._usage_rows: Dict[str, int] = {}
        self._usage_mat = np.zeros((256, RESOURCE_DIMS))

    # --- infrastructure ---

    @property
    def latest_index(self) -> int:
        return self._index

    def snapshot(self) -> StateSnapshot:
        gen = self._tracker.acquire_atomic(lambda: self._index)
        return StateSnapshot(self, gen)

    def _begin(self) -> Tuple[int, int]:
        """Allocate the next (unpublished) generation and the prune
        floor. Must hold _write_lock."""
        self._next_gen += 1
        return self._next_gen, self._tracker.min_live(self._index)

    def _commit(self, gen: int) -> None:
        self._index = gen

    # --- nodes ---

    def upsert_node(self, node: Node) -> int:
        with self._write_lock:
            gen, live = self._begin()
            prev = self._nodes.get_latest(node.id)
            node.create_index = prev.create_index if prev is not None else gen
            node.modify_index = gen
            node._avail_vec = None  # the caller may have mutated resources
            if not node.computed_class:
                node.compute_class()
            self._nodes.put(node.id, node, gen, live)
            self._usage_row(node.id)
            self.node_set_version += 1
            self.node_set_index = gen
            self._ready_nodes_cache.clear()
            self._commit(gen)
            return gen

    def upsert_node_pool(self, pool) -> int:
        with self._write_lock:
            gen, live = self._begin()
            pool.modify_index = gen
            self._node_pools.put(pool.name, pool, gen, live)
            self._commit(gen)
            return gen

    # --- jobs / evals ---

    def upsert_job(self, job: Job) -> int:
        with self._write_lock:
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
            self._jobs.put(key, copy.copy(job), gen, live)
            self._commit(gen)
            return gen

    def upsert_evals(self, evals: List[Evaluation]) -> int:
        with self._write_lock:
            gen, live = self._begin()
            for ev in evals:
                self._put_eval(ev, gen, live)
            self._commit(gen)
            return gen

    def _put_eval(self, ev: Evaluation, gen: int, live: int) -> None:
        prev = self._evals.get_latest(ev.id)
        ev.create_index = prev.create_index if prev is not None else gen
        ev.modify_index = gen
        self._evals.put(ev.id, ev, gen, live)

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

    def _usage_add(self, node_id: str, delta, gen: int, live: int) -> None:
        cur = self._node_usage.get_latest(node_id)
        self._node_usage.put(node_id, delta if cur is None else cur + delta,
                             gen, live)
        self._usage_mat[self._usage_row(node_id)] += delta

    # --- deployments ---

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
            self._commit(gen)
            return gen

    # --- the plan-apply mutation ---

    def upsert_allocs(self, allocs: List[Allocation]) -> int:
        """Insert or replace single allocations in one generation."""
        with self._write_lock:
            gen, live = self._begin()
            self._put_allocs(allocs, gen, live)
            self._commit(gen)
            return gen

    def upsert_plan_results(self, allocs: List[Allocation] = (),
                            alloc_blocks: List[AllocBlock] = (),
                            deployment: Optional[Deployment] = None,
                            evals: List[Evaluation] = ()) -> int:
        """Commit a plan in one generation: its single allocations, its
        columnar placements (per block one block row, one BlockRef per
        touched node, one vectorized usage add per node), the deployment
        it opens and its eval updates."""
        with self._write_lock:
            gen, live = self._begin()
            self._put_allocs(allocs, gen, live)
            for block in alloc_blocks:
                self._put_alloc_block(block, gen, live)
            if deployment is not None:
                self._put_deployment(deployment, gen, live)
            for ev in evals:
                self._put_eval(ev, gen, live)
            self._commit(gen)
            return gen

    def _put_allocs(self, allocs: List[Allocation], gen: int,
                    live: int) -> None:
        """Single allocations: a new id gets one index entry per node and
        job key (one chunk cell per key per generation); a replaced row
        moves the node's usage by the difference."""
        by_node: Dict[str, list] = {}
        by_job: Dict[tuple, list] = {}
        # per (node, vec identity) counts: placements of one group share
        # one allocated_vec, so the adds collapse to one multiply a node
        usage: Dict[tuple, list] = {}

        def count(node_id, vec, sign):
            e = usage.setdefault((node_id, id(vec), sign), [vec, 0])
            e[1] += 1

        for a in allocs:
            prev = self._allocs.get_latest(a.id)
            a.create_index = prev.create_index if prev is not None else gen
            a.modify_index = gen
            self._allocs.put(a.id, a, gen, live)
            if prev is None:
                by_node.setdefault(a.node_id, []).append(a.id)
                by_job.setdefault((a.namespace, a.job_id), []).append(a.id)
            elif prev.should_count_for_usage():
                count(prev.node_id, prev.allocated_vec, -1.0)
            if a.should_count_for_usage():
                count(a.node_id, a.allocated_vec, 1.0)
        for (node_id, _, sign), (vec, n) in usage.items():
            self._usage_add(node_id, vec * (sign * n) if n != 1 or sign < 0
                            else vec, gen, live)
        for table, groups in ((self._allocs_by_node, by_node),
                              (self._allocs_by_job, by_job)):
            for key, ids in groups.items():
                table.put(key, cons(tuple(ids), table.get_latest(key)),
                          gen, live)

    def _put_alloc_block(self, block: AllocBlock, gen: int, live: int) -> None:
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
