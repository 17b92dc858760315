"""Snapshots of the state store: a store to a JSON-safe dump and back (a
trimmed copy of ``nomad_tpu/state/persist.py:65-470``, written against
the port's store internals).

The dump is the latest committed value of every primary table; the
secondary indexes (allocs by node, job and eval as chunks of ids and
``BlockRef`` entries, evals and deployments by job, the promoted-row
counts, per-node usage and device usage, the dense usage matrix) are
derived and rebuilt on restore, so they never ride the wire or the disk.

FORMAT 2 (written): AllocBlocks ride natively (already columnar); real
alloc rows are parallel scalar columns, one packed resource-vector
matrix, a deduplicated job table and a sparse ``extras`` list of the
rare fat fields. FORMAT 1 (read, and written on request): every alloc
its own row, blocks de-columnarized into per-position rows.

The layout is the reference's: a reference dump restores into the
port's store and a port dump into the reference's. The tables the port
does not model (ACLs, variables, regions, one-time tokens) are not
written and are ignored on read; the ``alloc_modify_index`` column, a
field the port's allocations lack, is written as 0.

Snapshotting is split into capture (pin an MVCC generation: O(1), safe
under the raft node lock) and serialize (walk the pinned generation,
done off the lock by the snapshot thread).
"""

from __future__ import annotations

import numpy as np

from ..structs.alloc import BLOCK_SEP, Allocation, DesiredTransition
from ..structs.wire import wire_decode, wire_encode
from .mvcc import cons
from .store import BlockRef

FORMAT = 2

# scalar per-alloc fields that become parallel columns in FORMAT=2
_COL_FIELDS = (
    "id", "eval_id", "name", "namespace", "node_id", "node_name",
    "job_id", "job_version", "task_group", "desired_status",
    "desired_description", "client_status", "client_description",
    "deployment_id", "canary", "previous_allocation", "next_allocation",
    "follow_up_eval_id", "preempted_by_allocation", "allocated_at",
    "task_finished_at", "modify_time", "create_index", "modify_index",
    "alloc_modify_index",
)
# the columns the port's Allocation has (it has no alloc_modify_index)
_PORT_COLS = tuple(f for f in _COL_FIELDS if f != "alloc_modify_index")

# fat or rare fields: written per row only when not the default
_EXTRA_FIELDS = (
    "allocated_ports", "allocated_devices", "allocated_cores",
    "desired_transition", "task_states", "deployment_status",
    "reschedule_tracker", "metrics",
)

_DEFAULT_TRANSITION = DesiredTransition()


def _extra_is_default(field: str, value) -> bool:
    if field == "desired_transition":
        return value is None or value == _DEFAULT_TRANSITION
    if field in ("deployment_status", "reschedule_tracker", "metrics"):
        return value is None
    return not value


def capture_store(store):
    """Pin an MVCC snapshot handle: O(1). ``serialize_capture`` later
    (off the lock) sees exactly the state at capture time."""
    return store.snapshot()


def serialize_capture(store, snap, fmt: int = FORMAT) -> dict:
    """Serialize the pinned generation ``snap`` (does NOT release it)."""
    job_versions = [row for _, row in store._job_versions.iterate(snap.index)]
    cfg = snap.scheduler_configuration()
    out = {
        "format": fmt,
        "index": snap.index,
        "nodes": [wire_encode(n) for n in snap.nodes()],
        "jobs": [wire_encode(j) for j in snap.jobs()],
        "job_versions": [wire_encode(j) for j in job_versions],
        "evals": [wire_encode(e) for e in snap.evals()],
        "deployments": [wire_encode(d) for d in snap.deployments()],
        "volumes": [wire_encode(v)
                    for _, v in store._volumes.iterate(snap.index)],
        "node_pools": [wire_encode(p)
                       for _, p in store._node_pools.iterate(snap.index)],
        "namespaces": [wire_encode(x)
                       for _, x in store._namespaces.iterate(snap.index)],
        "services": [wire_encode(r)
                     for _, r in store._services.iterate(snap.index)],
        "scheduler_config": wire_encode(cfg) if cfg is not None else None,
        "scaling_events": [
            {"key": list(k), "events": list(v)}
            for k, v in store._scaling_events.iterate(snap.index)],
    }
    if fmt == 1:
        # legacy writer: blocks de-columnarized into per-position rows
        out["allocs"] = [wire_encode(a) for a in snap.allocs()]
    elif fmt == FORMAT:
        out["alloc_blocks"] = [wire_encode(b) for b in snap.alloc_blocks()]
        out["allocs_columnar"] = _dump_alloc_columns(store, snap)
    else:
        raise ValueError(f"cannot write snapshot format {fmt}")
    return out


def dump_store(store, fmt: int = FORMAT) -> dict:
    """Serialize the latest committed state. Takes its own snapshot."""
    snap = store.snapshot()
    try:
        return serialize_capture(store, snap, fmt=fmt)
    finally:
        snap.close()


def _dump_alloc_columns(store, snap) -> dict:
    """Real ``_allocs`` rows (standalone and promoted) as parallel
    columns; block positions ride in ``alloc_blocks``."""
    cols = {f: [] for f in _COL_FIELDS}
    vecs = []
    vec_missing = []
    jobs = []
    job_slot_by_id = {}    # id(job) -> slot (identity fast path)
    job_slot_by_key = {}   # (ns, job_id, version) -> slot
    job_idx = []
    extras = []
    k = 0
    for _, a in store._allocs.iterate(snap.index):
        for f in _COL_FIELDS:
            cols[f].append(getattr(a, f, 0))
        v = a.allocated_vec
        if v is None:
            vec_missing.append(k)
        else:
            vecs.append(np.asarray(v, dtype=np.float64))
        j = a.job
        if j is None:
            job_idx.append(-1)
        else:
            slot = job_slot_by_id.get(id(j))
            if slot is None:
                key = (a.namespace, a.job_id, a.job_version)
                slot = job_slot_by_key.get(key)
                if slot is None:
                    slot = len(jobs)
                    jobs.append(wire_encode(j))
                    job_slot_by_key[key] = slot
                job_slot_by_id[id(j)] = slot
            job_idx.append(slot)
        extra = None
        for f in _EXTRA_FIELDS:
            v = getattr(a, f)
            if not _extra_is_default(f, v):
                if extra is None:
                    extra = {}
                extra[f] = wire_encode(v)
        extras.append(extra)
        k += 1
    return {
        "n": k,
        "cols": cols,
        "vecs": wire_encode(np.stack(vecs)) if vecs else None,
        "vec_missing": vec_missing,
        "jobs": jobs,
        "job_idx": job_idx,
        "extras": extras,
    }


def _decode_alloc_columns(sec) -> list:
    if not sec:
        return []
    n = int(sec["n"])
    cols = sec["cols"]
    jobs = [wire_decode(j) for j in sec["jobs"]]
    job_idx = sec["job_idx"]
    mat = wire_decode(sec["vecs"]) if sec.get("vecs") is not None else None
    missing = set(sec.get("vec_missing", ()))
    extras = sec["extras"]
    col_lists = [cols[f] for f in _PORT_COLS]
    known_extra = set(_EXTRA_FIELDS)
    out = []
    vrow = 0
    for i in range(n):
        a = Allocation(**{f: col[i] for f, col in zip(_PORT_COLS, col_lists)})
        if i in missing:
            a.allocated_vec = None
        else:
            a.allocated_vec = mat[vrow]
            vrow += 1
        ji = job_idx[i]
        if ji >= 0:
            a.job = jobs[ji]
        extra = extras[i]
        if extra:
            for f, v in extra.items():
                if f in known_extra:
                    setattr(a, f, wire_decode(v))
        out.append(a)
    return out


def _promoted_positions(blocks, allocs) -> dict:
    """Real alloc ids that shadow a visible block position, as
    ``{block_id: [position, ...]}``: reached through the block's
    ``BlockRef`` entries, so they get no index entry of their own, and
    the block's usage excludes them (their row carries its own)."""
    block_by_id = {b.id: b for b in blocks}
    promoted = {}
    for a in allocs:
        i = a.id.rfind(BLOCK_SEP)
        if i <= 0:
            continue
        b = block_by_id.get(a.id[:i])
        if b is None:
            continue
        try:
            p = int(a.id[i + 1:])
        except ValueError:
            continue
        if 0 <= p < b.size and b.visible(p):
            promoted.setdefault(b.id, []).append(p)
    return promoted


def _block_usage_into(blocks, promoted, usage) -> None:
    """Fold the blocks' placement usage into the per-node ``usage``
    dict, one numpy scatter-add a block: a row contributes
    ``allocated_vec * counts[m]``, minus one vec per dropped or promoted
    position in it; rejected rows contribute nothing."""
    node_pos = {}
    node_list = []
    acc = None
    for b in blocks:
        n_rows = len(b.node_ids)
        if n_rows == 0:
            continue
        eff = np.asarray(b.counts, dtype=np.float64).copy()
        shadow = list(b.dropped) + promoted.get(b.id, [])
        if shadow:
            rows = np.searchsorted(
                b.offsets(), np.asarray(shadow, dtype=np.int64),
                side="right") - 1
            np.subtract.at(eff, rows, 1.0)
        if b.rejected_rows:
            eff[np.fromiter(b.rejected_rows, dtype=np.int64,
                            count=len(b.rejected_rows))] = 0.0
        vec = np.asarray(b.allocated_vec, dtype=np.float64)
        idx = np.empty(n_rows, dtype=np.int64)
        for m, nid in enumerate(b.node_ids):
            pos = node_pos.get(nid)
            if pos is None:
                pos = node_pos[nid] = len(node_list)
                node_list.append(nid)
            idx[m] = pos
        if acc is None:
            acc = np.zeros((max(len(node_list), 64), vec.shape[0]))
        elif len(node_list) > acc.shape[0]:
            grow = np.zeros((max(len(node_list), acc.shape[0] * 2),
                             acc.shape[1]))
            grow[:acc.shape[0]] = acc
            acc = grow
        np.add.at(acc, idx, eff[:, None] * vec[None, :])
    if acc is None:
        return
    for i, nid in enumerate(node_list):
        row = acc[i]
        if not row.any():
            continue
        prev = usage.get(nid)
        usage[nid] = row if prev is None else prev + row


def restore_store(store, data: dict) -> None:
    """Replace the store's contents with a dump (restart from a snapshot,
    a follower's snapshot install, an operator's restore). Publishes at
    the dump's index with one ``restore`` event. Accepts FORMAT 2 and
    FORMAT 1."""
    fmt = data.get("format")
    if fmt not in (1, FORMAT):
        raise ValueError(f"unsupported snapshot format {data.get('format')}")
    index = int(data["index"])
    nodes = [wire_decode(x) for x in data.get("nodes", [])]
    jobs = [wire_decode(x) for x in data.get("jobs", [])]
    job_versions = [wire_decode(x) for x in data.get("job_versions", [])]
    evals = [wire_decode(x) for x in data.get("evals", [])]
    if fmt == 1:
        allocs = [wire_decode(x) for x in data.get("allocs", [])]
        blocks = []
    else:
        allocs = _decode_alloc_columns(data.get("allocs_columnar"))
        blocks = [wire_decode(x) for x in data.get("alloc_blocks", [])]
    deployments = [wire_decode(x) for x in data.get("deployments", [])]
    volumes = [wire_decode(x) for x in data.get("volumes", [])]
    node_pools = [wire_decode(x) for x in data.get("node_pools", [])]
    namespaces = [wire_decode(x) for x in data.get("namespaces", [])]
    services = [wire_decode(x) for x in data.get("services", [])]
    scaling_events = data.get("scaling_events", [])
    sched_cfg = (wire_decode(data["scheduler_config"])
                 if data.get("scheduler_config") is not None else None)

    with store._write_lock:
        # the store behind the dump (an install, a restart): land at the
        # dump's index, so replay stays deterministic; the store ahead
        # (an operator's restore of an older dump): the next generation
        gen = index if store._index < index else store._index + 1
        live = store._tracker.min_live(store._index)
        promoted = _promoted_positions(blocks, allocs) if blocks else {}
        promoted_ids = {f"{bid}{BLOCK_SEP}{p}"
                        for bid, ps in promoted.items() for p in ps}
        # live snapshots still read the old versions: keys absent from
        # the dump get tombstones at the new generation, and every
        # derived table is rewritten whole
        new_keys = {
            id(store._nodes): {n.id for n in nodes},
            id(store._jobs): {(j.namespace, j.id) for j in jobs},
            id(store._job_versions): {(j.namespace, j.id, j.version)
                                      for j in job_versions},
            id(store._evals): {e.id for e in evals},
            id(store._allocs): {a.id for a in allocs},
            id(store._alloc_blocks): {b.id for b in blocks},
            id(store._deployments): {d.id for d in deployments},
            id(store._volumes): {(v.namespace, v.id) for v in volumes},
            id(store._node_pools): {p.name for p in node_pools},
            id(store._namespaces): {x.name for x in namespaces},
            id(store._services): {r.id for r in services},
            id(store._scaling_events): {tuple(e["key"])
                                        for e in scaling_events},
            id(store._scheduler_config): ({"config"} if sched_cfg is not None
                                          else set()),
        }
        for t in store._all_tables:
            keep = new_keys.get(id(t), set())
            for key in list(t._rows):
                if key not in keep:
                    t.delete(key, gen, live)
        for n in nodes:
            store._nodes.put(n.id, n, gen, live)
        for j in jobs:
            store._jobs.put((j.namespace, j.id), j, gen, live)
        for j in job_versions:
            store._job_versions.put((j.namespace, j.id, j.version), j,
                                    gen, live)
        for e in evals:
            store._evals.put(e.id, e, gen, live)
            _prepend(store._evals_by_job, (e.namespace, e.job_id), e.id,
                     gen, live)
        usage = {}
        dev_usage = {}
        by_node, by_job, by_eval = {}, {}, {}
        for a in allocs:
            store._allocs.put(a.id, a, gen, live)
            if a.id not in promoted_ids:
                by_node.setdefault(a.node_id, []).append(a.id)
                by_job.setdefault((a.namespace, a.job_id), []).append(a.id)
                by_eval.setdefault(a.eval_id, []).append(a.id)
            if not a.terminal_status():
                prev = usage.get(a.node_id)
                usage[a.node_id] = (a.allocated_vec if prev is None
                                    else prev + a.allocated_vec)
                if a.allocated_devices or a.allocated_cores:
                    from ..scheduler.devices import accumulate_dev_usage

                    accumulate_dev_usage(dev_usage.setdefault(a.node_id, {}),
                                         a)
        # one chunk of ids a key, as one write of the live store
        for table, groups in ((store._allocs_by_node, by_node),
                              (store._allocs_by_job, by_job),
                              (store._allocs_by_eval, by_eval)):
            for key, ids in groups.items():
                _prepend(table, key, tuple(ids), gen, live)
        if blocks:
            _block_usage_into(blocks, promoted, usage)
            for b in blocks:
                store._alloc_blocks.put(b.id, b, gen, live)
                for m in b.live_rows():
                    _prepend(store._allocs_by_node, b.node_ids[m],
                             BlockRef(b.id, m), gen, live)
                _prepend(store._allocs_by_job, (b.namespace, b.job_id),
                         BlockRef(b.id), gen, live)
                _prepend(store._allocs_by_eval, b.eval_id, BlockRef(b.id),
                         gen, live)
            for bid, ps in promoted.items():
                store._promoted.put(bid, len(ps), gen, live)
        for node_id, vec in usage.items():
            store._node_usage.put(node_id, vec, gen, live)
        for node_id, row in dev_usage.items():
            store._node_dev_usage.put(node_id, row, gen, live)
        for d in deployments:
            store._deployments.put(d.id, d, gen, live)
            _prepend(store._deployments_by_job, (d.namespace, d.job_id),
                     d.id, gen, live)
        for v in volumes:
            store._volumes.put((v.namespace, v.id), v, gen, live)
        for p in node_pools:
            store._node_pools.put(p.name, p, gen, live)
        for x in namespaces:
            store._namespaces.put(x.name, x, gen, live)
        for r in services:
            store._services.put(r.id, r, gen, live)
            _prepend(store._services_by_name, (r.namespace, r.service_name),
                     r.id, gen, live)
            _prepend(store._services_by_alloc, r.alloc_id, r.id, gen, live)
        for e in scaling_events:
            store._scaling_events.put(tuple(e["key"]), tuple(e["events"]),
                                      gen, live)
        if sched_cfg is not None:
            store._scheduler_config.put("config", sched_cfg, gen, live)
        store._next_gen = gen
        store._bump_node_set(gen)
        store._rebuild_usage_matrix()
        store._commit(gen, [("restore", None)])


def _prepend(table, key, value, gen: int, live: int) -> None:
    table.put(key, cons(value, table.get_latest(key)), gen, live)
