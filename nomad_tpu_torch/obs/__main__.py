"""Trace tooling CLI (a trimmed copy of ``nomad_tpu/obs/__main__.py``).

    python -m nomad_tpu_torch.obs --export out.json [--addr URL] [--device cpu]
    python -m nomad_tpu_torch.obs --trace-smoke [--device cpu]

``--export`` writes a Chrome ``trace_event`` JSON file (load it in
chrome://tracing or https://ui.perfetto.dev). With ``--addr`` it scrapes
a running agent's ``/v1/traces`` through ``ApiClient``; without, it
boots a small in-process three-server cluster, runs a workload and
exports that trace.

``--trace-smoke``: on a live three-server cluster with tracing on, every
committed eval must show a complete enqueue -> schedule -> plan-submit
-> verify -> commit span chain and the raft fsync and apply spans must
be there for gap attribution; then the same workload with the tracer
and the recorder off must record nothing. Exit 0 ok, 2 failed.

The cluster's Servers run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import tempfile
import time

from . import RECORDER, TRACER
from .export import (EVAL_CHAIN, chain_report, phase_breakdown,
                     render_chain, write_chrome_trace)
from .trace import R_NAME


def _run_workload(leader, jobs_n: int):
    """Register ``jobs_n`` one-alloc jobs, enqueue their evals and drain.
    Returns the evals (each its own trace root)."""
    from .. import mock

    jobs = []
    for _ in range(jobs_n):
        j = mock.job()
        j.task_groups[0].count = 1
        j.task_groups[0].tasks[0].resources.cpu = 100
        j.task_groups[0].tasks[0].resources.memory_mb = 64
        jobs.append(j)
        leader.store.upsert_job(j)
    evals = [mock.eval_for(j, create_time=time.time()) for j in jobs]
    leader.store.upsert_evals(evals)
    for ev in evals:
        leader.server.broker.enqueue(ev)
    deadline = time.time() + 120
    while True:
        if leader.server.wait_for_idle(timeout=10.0, include_delayed=False) \
                and leader.server.blocked.blocked_count() == 0:
            snap = leader.local_store.snapshot()
            try:
                placed = sum(1 for a in snap.allocs()
                             if not a.terminal_status())
            finally:
                snap.close()
            if placed >= jobs_n:
                return evals
        if time.time() > deadline:
            raise RuntimeError("workload did not drain")
        time.sleep(0.05)


def _demo_cluster(tmp: str, device, jobs_n: int = 60, nodes_n: int = 20,
                  workers: int = 2):
    """A live three-server cluster with a drained workload: returns
    (cluster, leader, evals); the caller stops the cluster."""
    from .. import mock
    from ..core.server import ServerConfig
    from ..raft.cluster import RaftCluster

    def config_fn(_i: int) -> ServerConfig:
        return ServerConfig(
            num_workers=workers, eval_batch_size=4, device=device,
            heartbeat_ttl=3600.0, gc_interval=3600.0, nack_timeout=900.0,
            failed_eval_followup_delay=3600.0,
            failed_eval_unblock_interval=0.5)

    cluster = RaftCluster(3, config_fn=config_fn, data_dir=tmp)
    cluster.start()
    leader = cluster.wait_for_leader(timeout=15.0)
    if leader is None:
        cluster.stop()
        raise RuntimeError("no leader elected")
    for _ in range(nodes_n):
        leader.register_node(mock.node())
    evals = _run_workload(leader, jobs_n)
    return cluster, leader, evals


def export_trace(path: str, addr: str = "", device=None) -> int:
    if addr:
        from ..api.client import ApiClient

        body = ApiClient(addr, timeout=10.0).traces(limit=0)
        doc = body.get("trace", {"traceEvents": []})
        doc["otherData"] = {"phases": body.get("phases", {})}
        with open(path, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} span(s) from {addr} "
              f"-> {path}")
        return 0
    TRACER.enabled = True
    TRACER.clear()
    tmp = tempfile.mkdtemp(prefix="nomad-obs-export-")
    try:
        cluster, _leader, _evals = _demo_cluster(tmp, device)
        try:
            spans = TRACER.spans()
        finally:
            cluster.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    write_chrome_trace(path, spans)
    print(f"wrote {len(spans)} span(s) from an in-process demo cluster "
          f"-> {path}")
    for name, row in phase_breakdown(spans).items():
        print(f"  {name:<22} n={row['count']:<5} p50={row['p50_ms']:8.3f}ms"
              f" p99={row['p99_ms']:8.3f}ms")
    return 0


def trace_smoke(jobs_n: int = 60, device=None) -> int:
    t0 = time.monotonic()
    TRACER.enabled = RECORDER.enabled = True
    TRACER.clear()
    RECORDER.clear()
    tmp = tempfile.mkdtemp(prefix="nomad-obs-smoke-")
    try:
        cluster, leader, evals = _demo_cluster(tmp, device, jobs_n=jobs_n)
        try:
            spans = TRACER.spans()
            incomplete = [rep for rep in (
                chain_report(spans, ev.trace(), required=EVAL_CHAIN)
                for ev in evals) if not rep["complete"]]
            if incomplete:
                print("TRACE SMOKE: FAIL - incomplete span chain for "
                      f"{len(incomplete)}/{len(evals)} eval(s):")
                for rep in incomplete[:3]:
                    print(render_chain(rep))
                return 2
            names = {rec[R_NAME] for rec in spans}
            for must in ("raft.fsync", "raft.apply", "eval.persist"):
                if must not in names:
                    print(f"TRACE SMOKE: FAIL - no {must} span recorded")
                    return 2
            if not RECORDER.events("broker") or not RECORDER.events("raft"):
                print("TRACE SMOKE: FAIL - the flight recorder missed a "
                      "subsystem (broker/raft)")
                return 2
            print(render_chain(chain_report(spans, evals[0].trace(),
                                            required=EVAL_CHAIN)))
            # the switch: the same workload, tracer and recorder off
            TRACER.enabled = RECORDER.enabled = False
            TRACER.clear()
            RECORDER.clear()
            _run_workload(cluster.leader() or leader, 20)
            if TRACER.spans() or RECORDER.events():
                print("TRACE SMOKE: FAIL - spans or recorder events with "
                      "tracing off")
                return 2
        finally:
            cluster.stop()
            TRACER.enabled = RECORDER.enabled = True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"TRACE SMOKE: ok - {len(evals)} eval(s) with complete "
          f"enqueue->commit span chains ({len(spans)} spans), nothing "
          f"recorded with tracing off, {time.monotonic() - t0:.1f}s")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nomad_tpu_torch.obs")
    parser.add_argument("--export", metavar="PATH",
                        help="write a Chrome trace_event JSON file")
    parser.add_argument("--addr", default="",
                        help="scrape a running agent (http://host:port) "
                             "instead of the in-process demo")
    parser.add_argument("--trace-smoke", action="store_true",
                        help="live-cluster span-chain and switch-off gate")
    parser.add_argument("--device", default=None,
                        help="where the demo cluster's placers run (the "
                             "card unless 'cpu')")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.trace_smoke:
        return trace_smoke(device=args.device)
    if args.export:
        return export_trace(args.export, addr=args.addr, device=args.device)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
