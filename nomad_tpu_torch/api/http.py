"""The /v1 HTTP agent over the port's Server (a trimmed copy of
``nomad_tpu/api/http.py``; reference command/agent/http.go:382-528).

``HTTPAgent(server, host, port, writer=...)`` serves the routes below
from a ``ThreadingHTTPServer``. Reads go to the local store's snapshot;
writes go to ``writer``: the Server itself, or in a replicated
deployment its ``ReplicatedServer``, which forwards a write to the raft
leader while reads stay on the local replica behind the read-index
round (``_setup_read``: ``?stale=true`` skips it, ``?consistent=true``
asks the leader for a full heartbeat round), with the follower-read
headers ``X-Nomad-KnownLeader`` and ``X-Nomad-LastContact``.

The reference's rules hold on every route:

- blocking queries: ``?index=N&wait=W`` (plain seconds or a Go duration,
  at most 30 s) parks in the store's waiter table until a commit passes
  N (``state/watch.py``);
- ``X-Nomad-Index`` is the index of the snapshot the reply was read
  from, not ``latest_index``;
- a body over ``MAX_BODY_BYTES`` gets 413 and malformed JSON 400, before
  any store access; an unknown route gets 404;
- a request whose ``X-Nomad-Deadline`` (an absolute epoch time) has
  passed gets 504. The port has no admission layer, so it never answers
  429, as the reference's agent without ``loadctl`` never does.

Routes: jobs (list, read, versions, allocations, evaluations,
deployments, register, parse, plan, evaluate, scale, revert,
deregister), nodes (list, read, allocations, drain, eligibility),
allocations (list, read, stop), evaluations, deployments (list, read,
promote, fail), ``/v1/search``, namespaces, node pools, scaling
policies, ``/v1/volumes`` and ``/v1/volume/csi/<id>``, the service
catalog (``/v1/services``, ``/v1/service/<name>``), the routes of the
agent's own clients (``clients``: ``/v1/client/stats``,
``/v1/client/fs/(ls|cat|stat)/<alloc>``, ``/v1/client/fs/logs/<alloc>``),
``/v1/system/gc``,
``/v1/operator/scheduler/configuration``, ``/v1/operator/snapshot``,
``/v1/operator/raft/configuration`` and ``/v1/operator/raft/peer``,
``/v1/status/leader``, ``/v1/agent/self``, ``/v1/agent/monitor``,
``/v1/agent/pprof/*``, ``/v1/metrics`` (JSON and ``?format=prometheus``;
with each kernel's launch count as ``nomad.kernel.launches.<name>``),
``/v1/traces`` and ``/v1/event/stream``.

Left for later (ROADMAP A10), and answered 404 as an unknown route is:
ACLs and variables (A10.4), the client's exec sessions (A10.3b),
dispatch (A10.5), regions, ``?region=``
forwarding, agent join and members (A10.2), the dashboard (``ui.py``,
A10.1) and the admission layer's 429 (A10.7).

``stop`` leaves no thread behind: it closes the open event streams and
monitors, wakes the parked blocking queries, shuts the open connections
and joins every handler thread.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import re
import socket
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from .. import _ext
from ..obs import REGISTRY, TRACER
from ..obs.metrics import prometheus_text
from ..structs import enums
from ..structs.job import Job
from ..structs.node import DrainStrategy
from .codec import from_dict, to_dict
from .jobspec import _validate

log = logging.getLogger("nomad_tpu_torch.api")

MAX_BLOCK_S = 30.0
# oversized bodies (413) and malformed JSON (400) are refused before any
# store snapshot or endpoint work
MAX_BODY_BYTES = 8 << 20


class BodyTooLarge(Exception):
    pass


class MalformedBody(Exception):
    pass


_WAIT_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def _parse_wait(raw: str) -> Optional[float]:
    """Blocking-query ``wait`` values: plain seconds or a Go duration
    ("10s", "250ms", "1m"). None for empty or garbage; the caller picks
    the policy (a long-poll falls back to its default, the event stream
    answers 400 before committing its chunked response)."""
    raw = (raw or "").strip()
    for unit in ("ms", "s", "m", "h"):
        if raw.endswith(unit):
            try:
                return float(raw[:-len(unit)]) * _WAIT_UNITS[unit]
            except ValueError:
                return None
    try:
        return float(raw) if raw else None
    except ValueError:
        return None


def _deadline_passed(raw: str) -> bool:
    """``X-Nomad-Deadline``: an absolute epoch time the client stamped
    from its timeout; a garbled value is ignored."""
    if not raw:
        return False
    try:
        return time.time() >= float(raw)
    except ValueError:
        return False


# /v1/agent/monitor may lower the framework logger's level while streams
# are attached; overlapping streams refcount the original level so the
# last one restores it
_monitor_lock = threading.Lock()
_monitor_state: Dict[int, list] = {}  # id(logger) -> [count, orig_level]


def _monitor_level_push(logger, level: int) -> None:
    with _monitor_lock:
        st = _monitor_state.get(id(logger))
        if st is None:
            st = _monitor_state[id(logger)] = [0, logger.level]
        st[0] += 1
        # only ever lower the effective level
        if logger.getEffectiveLevel() > level:
            logger.setLevel(level)


def _monitor_level_pop(logger) -> None:
    with _monitor_lock:
        st = _monitor_state.get(id(logger))
        if st is None:
            return
        st[0] -= 1
        if st[0] <= 0:
            logger.setLevel(st[1])
            del _monitor_state[id(logger)]


class HTTPAgent:
    """The agent's HTTP server. ``port=0`` binds an ephemeral port;
    ``address`` names it."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 4646,
                 writer=None):
        self.server = server
        # mutating verbs go through the writer (a ReplicatedServer
        # forwards them to the leader); reads stay on the local store
        self.writer = writer if writer is not None else server
        # the agent's local clients (client/client.py): /v1/client/*
        # serves their allocs' files, logs and host stats
        self.clients: list = []
        self._closing = threading.Event()
        self._conn_lock = threading.Lock()
        self._conns: set = set()
        self._streams: set = set()
        agent = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                log.debug("http: " + fmt, *args)

            def setup(self):
                super().setup()
                with agent._conn_lock:
                    agent._conns.add(self.connection)

            def finish(self):
                with agent._conn_lock:
                    agent._conns.discard(self.connection)
                super().finish()

            # per-request read state (reset at the top of each verb:
            # a handler serves every request of a keep-alive connection)
            _read_index: Optional[int] = None
            _known_leader: Optional[bool] = None
            _last_contact_ms: Optional[int] = None

            def _reset(self):
                self._read_index = None
                self._known_leader = None
                self._last_contact_ms = None

            def _reply(self, code: int, payload,
                       index: Optional[int] = None):
                body = json.dumps(to_dict(payload)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if index is None:
                    # the index of the snapshot the payload was read
                    # from; latest_index can run ahead of the data and
                    # make a watcher skip a change
                    index = self._read_index
                self.send_header("X-Nomad-Index",
                                 str(index if index is not None
                                     else agent.server.store.latest_index))
                if self._known_leader is not None:
                    self.send_header("X-Nomad-KnownLeader",
                                     "true" if self._known_leader
                                     else "false")
                if self._last_contact_ms is not None:
                    self.send_header("X-Nomad-LastContact",
                                     str(self._last_contact_ms))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, msg: str):
                self._reply(code, {"error": msg})

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                if length > MAX_BODY_BYTES:
                    # refused before reading: the bytes never enter the
                    # process (and the connection closes, since the
                    # unread body would corrupt the next request)
                    raise BodyTooLarge(f"{length} bytes > {MAX_BODY_BYTES}")
                raw = self.rfile.read(length)
                try:
                    return json.loads(raw)
                except ValueError as e:
                    raise MalformedBody(str(e)) from None

            def _expired(self) -> bool:
                return _deadline_passed(
                    self.headers.get("X-Nomad-Deadline", ""))

            def _block(self, q: dict) -> None:
                """A blocking query parks until the store moves past
                ``index`` (woken on the exact commit)."""
                want = int(q.get("index", ["0"])[0] or 0)
                if want <= 0:
                    return
                parsed = _parse_wait(q.get("wait", [""])[0])
                wait = min(parsed if parsed is not None else 5.0,
                           MAX_BLOCK_S)
                with TRACER.span("read.index_wait", want=want):
                    agent.server.store.watches.wait_min_index(
                        want + 1, wait)

            def do_GET(self):
                try:
                    self._reset()
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    if self._expired():
                        return self._error(504, "request deadline passed")
                    if url.path == "/v1/event/stream":
                        return agent._route_event_stream(self, q)
                    if url.path == "/v1/agent/monitor":
                        return agent._route_monitor(self, q)
                    if agent._setup_read(self, q):
                        return  # no leader, or the read index timed out
                    self._block(q)
                    agent._route_get(self, url.path, q)
                except Exception as e:  # noqa: BLE001 - a 500 for the client
                    log.debug("GET %s -> 500", self.path, exc_info=True)
                    self._error(500, str(e))

            def do_POST(self):
                try:
                    self._reset()
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    # the body-size and JSON checks run before any store
                    # snapshot or endpoint work
                    body = self._body()
                    if self._expired():
                        return self._error(504, "request deadline passed")
                    agent._route_post(self, url.path, q, body)
                except BodyTooLarge as e:
                    self.close_connection = True
                    self._error(413, f"request body too large: {e}")
                except MalformedBody as e:
                    self._error(400, f"malformed JSON body: {e}")
                except PermissionError as e:
                    self._error(403, str(e))
                except Exception as e:  # noqa: BLE001
                    log.debug("POST %s -> 500", self.path, exc_info=True)
                    self._error(500, str(e))

            do_PUT = do_POST

            def do_DELETE(self):
                try:
                    self._reset()
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    if self._expired():
                        return self._error(504, "request deadline passed")
                    agent._route_delete(self, url.path, q)
                except Exception as e:  # noqa: BLE001
                    log.debug("DELETE %s -> 500", self.path, exc_info=True)
                    self._error(500, str(e))

        class _Server(ThreadingHTTPServer):
            # handler threads are joined on close (stop shuts their
            # connections first)
            daemon_threads = False
            block_on_close = True

        self._httpd = _Server((host, port), Handler)
        self.address = f"http://{host}:{self._httpd.server_port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> "HTTPAgent":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-agent")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._closing.set()
        self._httpd.shutdown()
        with self._conn_lock:
            streams = list(self._streams)
            conns = list(self._conns)
        for sub in streams:
            sub.close()
        self.server.store.watches.teardown()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its client
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- reads --

    def _setup_read(self, h, q: dict) -> bool:
        """Read consistency on a replicated server (reference api/api.go
        QueryOptions); this server answers every read itself:

        - ``?stale=true``: at once from the local replica, its staleness
          bounded by ``X-Nomad-LastContact``;
        - default: the read-index protocol: the leader names a read
          index (its lease confirms leadership) and the read waits until
          the local store applied through it;
        - ``?consistent=true``: the same, the leader confirming with a
          full heartbeat round.

        True when the request was answered here (503 no leader, 500 the
        wait timed out)."""
        raft = getattr(self.writer, "raft", None)
        if raft is None:
            return False  # a standalone server: its store is the truth
        from ..raft.node import NotLeaderError

        h._known_leader = self.writer.known_leader()
        lc = self.writer.last_contact()
        h._last_contact_ms = int(min(lc, 10 ** 6) * 1000)
        REGISTRY.incr("nomad.reads.leader" if raft.is_leader()
                      else "nomad.reads.follower")
        if q.get("stale", [""])[0] == "true":
            REGISTRY.incr("nomad.reads.stale")
            return False
        consistent = q.get("consistent", [""])[0] == "true"
        try:
            with TRACER.span("read.index_wait", mode="read_index"):
                idx = self.writer.read_index(consistent=consistent,
                                             timeout=2.0)
                self.writer.wait_applied(idx, timeout=5.0)
        except NotLeaderError:
            REGISTRY.incr("nomad.reads.no_leader")
            h._known_leader = self.writer.known_leader()
            h._reply(503, {"error": "no cluster leader"})
            return True
        except TimeoutError as e:
            h._reply(500, {"error": f"read index wait: {e}"})
            return True
        return False

    def _route_get(self, h, path: str, q: dict) -> None:
        snap = self.server.store.snapshot()
        try:
            # X-Nomad-Index is this snapshot's index
            h._read_index = snap.index
            self._get(h, snap, path, q)
        finally:
            snap.close()

    def _get(self, h, snap, path: str, q: dict) -> None:
        ns = q.get("namespace", ["default"])[0]
        prefix = q.get("prefix", [""])[0]

        if path == "/v1/namespaces":
            return h._reply(200, list(snap.namespaces()))
        if m := re.fullmatch(r"/v1/namespace/([^/]+)", path):
            nsp = snap.namespace(m.group(1))
            if nsp is None:
                return h._error(404, "namespace not found")
            return h._reply(200, nsp)
        if path == "/v1/node/pools":
            return h._reply(200, list(snap.node_pools()))
        if m := re.fullmatch(r"/v1/node/pool/([^/]+)", path):
            pool = snap.node_pool(m.group(1))
            if pool is None:
                return h._error(404, "node pool not found")
            return h._reply(200, pool)
        if path == "/v1/scaling/policies":
            return h._reply(200, self.server.scaling_policies(ns))
        if m := re.fullmatch(r"/v1/scaling/policy/(.+)", path):
            for pol in self.server.scaling_policies(None):
                if pol["id"] == m.group(1):
                    return h._reply(200, pol)
            return h._error(404, "scaling policy not found")
        if m := re.fullmatch(r"/v1/job/(.+)/scale", path):
            job = snap.job_by_id(m.group(1), ns)
            if job is None:
                return h._error(404, "job not found")
            return h._reply(200, {
                "job_id": job.id,
                "task_groups": {tg.name: {
                    "desired": tg.count,
                    "scaling": ({"min": tg.scaling.min,
                                 "max": tg.scaling.max,
                                 "enabled": tg.scaling.enabled}
                                if tg.scaling else None)}
                    for tg in job.task_groups},
                "events": snap.scaling_events(job.id, ns)})
        if path == "/v1/services":
            # the catalog's summary (reference ``http.py:673-690``)
            by_name = {}
            for reg in snap.service_registrations(ns):
                e = by_name.setdefault(reg.service_name,
                                       {"service_name": reg.service_name,
                                        "namespace": reg.namespace,
                                        "tags": set(), "instances": 0})
                e["instances"] += 1
                e["tags"].update(reg.tags)
            return h._reply(200, [
                {**e, "tags": sorted(e["tags"])}
                for e in sorted(by_name.values(),
                                key=lambda x: x["service_name"])])
        if m := re.fullmatch(r"/v1/service/([^/]+)", path):
            regs = snap.service_by_name(m.group(1), ns)
            if not regs:
                return h._error(404, "service not found")
            return h._reply(200, regs)
        if path == "/v1/client/stats":
            return h._reply(200, [c.hoststats.latest() for c in self.clients])
        if m := re.fullmatch(r"/v1/client/fs/(ls|cat|stat)/([^/]+)", path):
            return self._route_fs(h, m.group(1), m.group(2), q)
        if m := re.fullmatch(r"/v1/client/fs/logs/([^/]+)", path):
            return self._route_logs(h, m.group(1), q, snap)
        if path == "/v1/volumes":
            return h._reply(200, [
                {"id": v.id, "namespace": v.namespace, "name": v.name,
                 "access_mode": v.access_mode, "claims": len(v.claims)}
                for v in snap.volumes(ns)])
        if m := re.fullmatch(r"/v1/volume/csi/([^/]+)", path):
            vol = snap.volume_by_id(m.group(1), ns)
            if vol is None:
                return h._error(404, "volume not found")
            return h._reply(200, vol)

        if path == "/v1/jobs":
            return h._reply(200, [self._job_stub(j, snap)
                                  for j in snap.jobs()
                                  if j.id.startswith(prefix)])
        # suffixed job routes first, then the plain one takes the rest
        if m := re.fullmatch(r"/v1/job/(.+)/versions", path):
            if snap.job_by_id(m.group(1), ns) is None:
                return h._error(404, "job not found")
            return h._reply(200, [
                {"version": j.version, "stable": j.stable,
                 "submit_time": j.submit_time,
                 "job_modify_index": j.job_modify_index}
                for j in snap.job_versions(m.group(1), ns)])
        if m := re.fullmatch(r"/v1/job/(.+)/allocations", path):
            return h._reply(200, [self._alloc_stub(a) for a in
                                  snap.allocs_by_job(m.group(1), ns)])
        if m := re.fullmatch(r"/v1/job/(.+)/evaluations", path):
            return h._reply(200, snap.evals_by_job(m.group(1), ns))
        if m := re.fullmatch(r"/v1/job/(.+)/deployments", path):
            return h._reply(200, snap.deployments_by_job(m.group(1), ns))
        if m := re.fullmatch(r"/v1/job/(.+)", path):
            job = snap.job_by_id(m.group(1), ns)
            if job is None:
                return h._error(404, "job not found")
            return h._reply(200, job)

        if path == "/v1/deployments":
            return h._reply(200, list(snap.deployments()))
        if m := re.fullmatch(r"/v1/deployment/([^/]+)", path):
            dep = snap.deployment_by_id(m.group(1))
            if dep is None:
                return h._error(404, "deployment not found")
            return h._reply(200, dep)

        if path == "/v1/operator/snapshot":
            return h._reply(200, self.server.store.dump())

        if path == "/v1/nodes":
            return h._reply(200, [self._node_stub(n, snap)
                                  for n in snap.nodes()])
        if m := re.fullmatch(r"/v1/node/([^/]+)", path):
            node = snap.node_by_id(m.group(1))
            if node is None:
                return h._error(404, "node not found")
            return h._reply(200, node)
        if m := re.fullmatch(r"/v1/node/([^/]+)/allocations", path):
            return h._reply(200, [self._alloc_stub(a) for a in
                                  snap.allocs_by_node(m.group(1))])

        if path == "/v1/allocations":
            return h._reply(200, [self._alloc_stub(a) for a in snap.allocs()
                                  if a.id.startswith(prefix)])
        if m := re.fullmatch(r"/v1/allocation/([^/]+)", path):
            alloc = snap.alloc_by_id(m.group(1))
            if alloc is None:
                return h._error(404, "alloc not found")
            return h._reply(200, alloc)

        if path == "/v1/evaluations":
            return h._reply(200, list(snap.evals()))
        if m := re.fullmatch(r"/v1/evaluation/([^/]+)", path):
            ev = snap.eval_by_id(m.group(1))
            if ev is None:
                return h._error(404, "eval not found")
            return h._reply(200, ev)

        if path == "/v1/search":
            return self._search(h, snap, q, ns, prefix)
        if path == "/v1/status/leader":
            raft = getattr(self.writer, "raft", None)
            if raft is not None:
                return h._reply(200, {
                    "leader": raft.leader_id or "",
                    "is_leader": self.writer.is_leader()})
            return h._reply(200, "local")
        if path == "/v1/agent/self":
            return h._reply(200, {
                "stats": {
                    "broker": self.server.broker.stats,
                    "plan_applier": self.server.plan_applier.stats,
                    "blocked_evals": self.server.blocked.blocked_count(),
                },
                "version": "0.1.0",
            })
        if path == "/v1/agent/pprof/threads":
            # the goroutine-dump analog: every thread's stack
            names = {t.ident: t.name for t in threading.enumerate()}
            dump = [f"thread {names.get(tid, '?')} ({tid}):\n"
                    + "".join(traceback.format_stack(frame))
                    for tid, frame in sys._current_frames().items()]
            return h._reply(200, {"threads": len(dump),
                                  "dump": "\n".join(dump)})
        if path == "/v1/agent/pprof/profile":
            return self._profile(h, q)
        if path == "/v1/operator/raft/configuration":
            return h._reply(200, self._raft_configuration())
        if path == "/v1/operator/scheduler/configuration":
            return h._reply(200, self.server.sched_config)
        if path == "/v1/metrics":
            return self._metrics(h, q)
        if path == "/v1/traces":
            from ..obs.export import chrome_trace, phase_breakdown

            spans = TRACER.spans()
            limit = int(q.get("limit", ["500"])[0])
            return h._reply(200, {
                "enabled": TRACER.enabled,
                "total_spans": len(spans),
                "phases": phase_breakdown(spans),
                # newest spans last, Chrome trace_event format
                "trace": chrome_trace(spans[-limit:] if limit else spans),
            })
        h._error(404, f"no such route {path}")

    def _find_runner(self, alloc_id: str):
        for client in self.clients:
            runner = client.runners.get(alloc_id)
            if runner is not None:
                return runner
        return None

    def _route_fs(self, h, op: str, alloc_id: str, q: dict) -> None:
        """An alloc's files on this agent's clients (reference
        ``http.py:1092-1129``)."""
        from ..client import allocdir

        runner = self._find_runner(alloc_id)
        if runner is None:
            return h._error(404, "alloc not on this agent")
        root = runner.allocdir.root
        rel = q.get("path", ["/"])[0]
        try:
            if op == "ls":
                return h._reply(200, allocdir.fs_list(root, rel))
            if op == "stat":
                return h._reply(200, allocdir.fs_stat(root, rel))
            offset = max(int(q.get("offset", ["0"])[0] or 0), 0)
            limit = max(min(int(q.get("limit", ["65536"])[0] or 65536),
                            1 << 20), 0)
            data = allocdir.fs_read(root, rel, offset, limit)
            return h._reply(200, {
                "data": base64.b64encode(data).decode("ascii"),
                "offset": offset + len(data)})
        except PermissionError as e:
            return h._error(403, str(e))
        except FileNotFoundError:
            return h._error(404, f"no such path {rel!r}")
        except (IsADirectoryError, NotADirectoryError, OSError) as e:
            return h._error(400, str(e))

    def _route_logs(self, h, alloc_id: str, q: dict, snap) -> None:
        """A task's log across its rotated files (reference
        ``http.py:1131-1160``)."""
        from ..client.allocdir import AllocDir
        from ..client.logmon import read_log

        alloc = snap.alloc_by_id(alloc_id)
        if alloc is None:
            return h._error(404, "alloc not found")
        task = q.get("task", [""])[0]
        if not task and alloc.job is not None:
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg is not None and tg.tasks:
                task = tg.tasks[0].name
        kind = q.get("type", ["stdout"])[0]
        offset = int(q.get("offset", ["0"])[0] or 0)
        limit = min(int(q.get("limit", ["65536"])[0] or 65536), 1 << 20)
        for client in self.clients:
            runner = client.runners.get(alloc_id)
            log_dir = (runner.allocdir.logs if runner is not None
                       else AllocDir(client.config.data_dir, alloc_id).logs)
            if runner is None and not os.path.isdir(log_dir):
                continue
            out = read_log(log_dir, task, kind, offset=offset, limit=limit)
            return h._reply(200, {
                "task": task, "type": kind, "offset": out["offset"],
                "size": out["size"],
                "data": base64.b64encode(out["data"]).decode("ascii")})
        return h._error(404, "alloc logs not on this agent")

    def _search(self, h, snap, q: dict, ns: str, prefix: str) -> None:
        """Prefix search across object types in the request's namespace
        (reference nomad/search_endpoint.go), truncated at 20 a
        context."""
        context = q.get("context", ["all"])[0]
        contexts = ("all", "jobs", "nodes", "allocs", "evals", "deployments")
        if context not in contexts:
            return h._error(400, f"invalid context {context!r}; "
                                 f"one of {contexts}")
        limit = 20

        def take(it):
            out, truncated = [], False
            for x in it:
                if len(out) >= limit:
                    truncated = True
                    break
                out.append(x)
            return out, truncated

        results: Dict[str, list] = {}
        trunc: Dict[str, bool] = {}
        if context in ("all", "jobs"):
            results["jobs"], trunc["jobs"] = take(
                j.id for j in snap.jobs()
                if j.id.startswith(prefix) and j.namespace == ns)
        if context in ("all", "nodes"):
            results["nodes"], trunc["nodes"] = take(
                n.id for n in snap.nodes()
                if n.id.startswith(prefix) or n.name.startswith(prefix))
        if context in ("all", "allocs"):
            results["allocs"], trunc["allocs"] = take(
                a.id for a in snap.allocs()
                if a.id.startswith(prefix) and a.namespace == ns)
        if context in ("all", "evals"):
            results["evals"], trunc["evals"] = take(
                e.id for e in snap.evals()
                if e.id.startswith(prefix) and e.namespace == ns)
        if context in ("all", "deployments"):
            results["deployments"], trunc["deployments"] = take(
                d.id for d in snap.deployments()
                if d.id.startswith(prefix) and d.namespace == ns)
        return h._reply(200, {"matches": results, "truncations": trunc})

    def _profile(self, h, q: dict) -> None:
        """A statistical CPU profile: every thread's stack sampled for
        ``?seconds=S`` at ``?hz=``, as collapsed stacks with counts."""
        try:
            seconds = min(float(q.get("seconds", ["5"])[0] or 5), 30.0)
            hz = min(max(float(q.get("hz", ["100"])[0] or 100), 1.0), 500.0)
        except ValueError:
            return h._error(400, "bad seconds/hz")
        counts: Dict[str, int] = {}
        me = threading.get_ident()
        deadline = time.time() + seconds
        samples = 0
        while time.time() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue  # not the profiler itself
                stack = ";".join(
                    f"{f.name}@{os.path.basename(f.filename)}:{f.lineno}"
                    for f in traceback.extract_stack(frame))
                counts[stack] = counts.get(stack, 0) + 1
            samples += 1
            time.sleep(1.0 / hz)
        top = sorted(counts.items(), key=lambda kv: -kv[1])
        return h._reply(200, {
            "seconds": seconds, "samples": samples,
            "collapsed": [f"{stack} {n}" for stack, n in top[:500]]})

    def _raft_configuration(self) -> dict:
        """The peer set and leadership (reference operator_endpoint.go
        RaftGetConfiguration)."""
        raft = getattr(self.writer, "raft", None)
        if raft is None:
            return {"servers": [], "leader": "", "term": 0,
                    "commit_index": 0, "last_applied": 0, "mode": "single"}
        addrs = {k: v for k, v in raft.servers.items() if v}
        servers = [{"id": raft.id, "address": addrs.get(raft.id, "local"),
                    "leader": raft.is_leader(), "self": True}]
        for p in raft.peers:
            servers.append({"id": p, "address": addrs.get(p, "local"),
                            "leader": p == raft.leader_id, "self": False})
        return {"servers": servers, "leader": raft.leader_id or "",
                "term": raft.current_term,
                "commit_index": raft.commit_index,
                "last_applied": raft.last_applied, "mode": "raft"}

    def _metrics(self, h, q: dict) -> None:
        srv = self.server
        metrics = {
            "broker": srv.broker.stats,
            "plan": srv.plan_applier.stats,
            "plan_bad_nodes": srv.plan_applier.bad_nodes.stats,
            "heartbeats_active": srv.heartbeats.active(),
            # live gauges under the reference's metric names
            "nomad.broker.total_unacked": srv.broker.inflight(),
            "nomad.blocked_evals.total_blocked": srv.blocked.blocked_count(),
            "nomad.reads.parked": srv.store.watches.parked(),
            "nomad.reads.event_waiters": srv.events.waiter_count(),
            "nomad.state.live_snapshots": srv.store._tracker.live_count(),
            **REGISTRY.dump(),
        }
        # each hand-written kernel's launches in this process (_ext.COUNTS)
        for name, n in _ext.COUNTS.snapshot()["launches"].items():
            metrics[f"nomad.kernel.launches.{name}"] = n
        if q.get("format", [""])[0] == "prometheus":
            body = prometheus_text(metrics).encode()
            h.send_response(200)
            h.send_header("Content-Type", "text/plain; version=0.0.4")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
            return
        return h._reply(200, metrics)

    # -- writes --

    def _route_post(self, h, path: str, q: dict, body: dict) -> None:
        ns = q.get("namespace", ["default"])[0]
        if m := re.fullmatch(r"/v1/namespace/([^/]+)", path):
            from ..structs.operator import Namespace

            nsp = from_dict(Namespace, body.get("namespace") or body)
            nsp.name = m.group(1)
            try:
                self.writer.upsert_namespace(nsp)
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"ok": True})
        if m := re.fullmatch(r"/v1/node/pool/([^/]+)", path):
            from ..structs.operator import NodePool

            pool = from_dict(NodePool, body.get("node_pool") or body)
            pool.name = m.group(1)
            try:
                self.writer.upsert_node_pool(pool)
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"ok": True})
        if m := re.fullmatch(r"/v1/volume/csi/([^/]+)", path):
            from ..structs.volumes import Volume

            vol = from_dict(Volume, body.get("volume") or body)
            vol.id = m.group(1)
            vol.namespace = ns
            vol.claims = {}  # the store's; never taken from a client
            try:
                self.writer.register_volume(vol)
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"ok": True})
        if path == "/v1/jobs/parse":
            # HCL-like or JSON in, the canonical job out; registers
            # nothing
            from .jobspec import parse_hcl_like, parse_json

            spec = (body or {}).get("job_hcl", "")
            if not spec:
                return h._error(400, "job_hcl is required")
            try:
                if spec.lstrip().startswith("{"):
                    job = parse_json(spec)
                else:
                    job = parse_hcl_like(
                        spec, variables=(body or {}).get("variables"))
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, job)
        if path == "/v1/jobs":
            data = body.get("job") or body.get("Job") or body
            job = from_dict(Job, data)
            _validate(job)
            try:
                eval_id = self.writer.register_job(job)
            except ValueError as e:  # an unknown namespace
                return h._error(400, str(e))
            return h._reply(200, {"eval_id": eval_id, "job_id": job.id})
        if m := re.fullmatch(r"/v1/allocation/([^/]+)/stop", path):
            try:
                eval_id = self.writer.stop_alloc(m.group(1))
            except KeyError:
                return h._error(404, "alloc not found")
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/job/(.+)/scale", path):
            try:
                eval_id = self.writer.scale_job(
                    m.group(1), body.get("task_group", ""),
                    int(body.get("count")
                        if body.get("count") is not None else -1),
                    namespace=ns)
            except KeyError:
                return h._error(404, "job not found")
            except (ValueError, TypeError) as e:
                return h._error(400, str(e))
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/job/(.+)/revert", path):
            try:
                eval_id = self.writer.revert_job(
                    m.group(1), int(body.get("job_version", -1)
                                    if body.get("job_version") is not None
                                    else -1), namespace=ns)
            except KeyError as e:
                return h._error(404, str(e))
            except (ValueError, TypeError) as e:
                return h._error(400, str(e))
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/job/(.+)/plan", path):
            data = body.get("job") or body.get("Job") or body
            job = from_dict(Job, data)
            job.id = m.group(1)
            job.namespace = ns
            _validate(job)
            # a dry run reads local state: any replica answers it
            return h._reply(200, self.server.plan_job(job))
        if m := re.fullmatch(r"/v1/job/(.+)/evaluate", path):
            snap = self.server.store.snapshot()
            try:
                job = snap.job_by_id(m.group(1), ns)
            finally:
                snap.close()
            if job is None:
                return h._error(404, "job not found")
            eval_id = self.writer.create_job_eval(
                job, enums.TRIGGER_JOB_REGISTER)
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/node/([^/]+)/drain", path):
            spec = body.get("drain_spec")
            strategy = None
            if spec is not None:
                strategy = from_dict(DrainStrategy, spec)
            self.writer.update_node_drain(m.group(1), strategy,
                                          bool(body.get("mark_eligible")))
            return h._reply(200, {"ok": True})
        if m := re.fullmatch(r"/v1/node/([^/]+)/eligibility", path):
            self.writer.update_node_eligibility(m.group(1),
                                                body.get("eligibility", ""))
            return h._reply(200, {"ok": True})
        if path == "/v1/system/gc":
            # GC writes state: a follower forwards it
            return h._reply(200, self.writer.force_gc())
        if path == "/v1/operator/scheduler/configuration":
            from ..structs.operator import SchedulerConfiguration

            cfg = from_dict(SchedulerConfiguration, body)
            self.writer.set_scheduler_config(cfg)
            return h._reply(200, {"updated": True})
        if path == "/v1/operator/snapshot":
            # a whole-state restore: a replicated command under raft
            self.server.store.restore_dump(body)
            return h._reply(200, {"restored": True,
                                  "index": self.server.store.latest_index})
        if m := re.fullmatch(r"/v1/deployment/promote/([^/]+)", path):
            try:
                eval_id = self.writer.promote_deployment(
                    m.group(1), groups=body.get("groups"))
            except KeyError as e:
                return h._error(404, str(e))
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/deployment/fail/([^/]+)", path):
            try:
                self.writer.fail_deployment(m.group(1))
            except KeyError as e:
                return h._error(404, str(e))
            except ValueError as e:
                return h._error(400, str(e))
            return h._reply(200, {"ok": True})
        h._error(404, f"no such route {path}")

    def _route_delete(self, h, path: str, q: dict) -> None:
        ns = q.get("namespace", ["default"])[0]
        if path == "/v1/operator/raft/peer":
            sid = q.get("id", [""])[0]
            remove = getattr(self.writer, "remove_peer", None)
            if remove is None:
                return h._error(400, "not a raft server")
            if not sid:
                return h._error(400, "missing id")
            try:
                remove(sid)
            except ValueError as e:
                return h._error(400, str(e))
            except KeyError as e:
                return h._error(404, str(e))
            return h._reply(200, {"removed": sid})
        if m := re.fullmatch(r"/v1/job/(.+)", path):
            purge = q.get("purge", ["false"])[0] in ("true", "1")
            eval_id = self.writer.deregister_job(m.group(1), ns, purge=purge)
            return h._reply(200, {"eval_id": eval_id})
        if m := re.fullmatch(r"/v1/node/pool/([^/]+)", path):
            try:
                self.writer.delete_node_pool(m.group(1))
            except ValueError as e:
                return h._error(409, str(e))
            return h._reply(200, {"ok": True})
        if m := re.fullmatch(r"/v1/namespace/([^/]+)", path):
            try:
                self.writer.delete_namespace(m.group(1))
            except KeyError as e:
                return h._error(404, str(e))
            except ValueError as e:
                return h._error(409, str(e))
            return h._reply(200, {"ok": True})
        if m := re.fullmatch(r"/v1/volume/csi/([^/]+)", path):
            force = q.get("force", ["false"])[0] in ("true", "1")
            try:
                self.writer.deregister_volume(m.group(1), ns, force=force)
            except ValueError as e:
                return h._error(409, str(e))
            return h._reply(200, {"ok": True})
        h._error(404, f"no such route {path}")

    # -- streams (reference /v1/event/stream, nomad/stream/; monitor) --

    @staticmethod
    def _start_chunked(h, q: dict):
        """Parse the stream's ``wait`` before committing the response (a
        bad one is a clean 400), then send the chunked headers. Returns
        (write_chunk, deadline), or (None, None) after a 400."""
        raw = q.get("wait", [""])[0]
        wait = _parse_wait(raw)
        if wait is None:
            if raw:
                h._error(400, "invalid wait")
                return None, None
            wait = 60.0
        wait = min(wait, 600.0)
        deadline = time.time() + wait
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()

        def write_chunk(payload: bytes) -> None:
            h.wfile.write(f"{len(payload):x}\r\n".encode()
                          + payload + b"\r\n")
            h.wfile.flush()

        return write_chunk, deadline

    def _route_monitor(self, h, q: dict) -> None:
        """Live agent logs as ndjson (reference ``nomad monitor``): a
        handler on the framework logger until the wait expires."""
        import queue as _queue

        level = getattr(logging, q.get("log_level", ["info"])[0].upper(),
                        logging.INFO)
        buf: "_queue.Queue" = _queue.Queue(maxsize=1024)

        class _H(logging.Handler):
            def emit(self, record):
                try:
                    buf.put_nowait({"ts": record.created,
                                    "level": record.levelname,
                                    "name": record.name,
                                    "message": record.getMessage()})
                except _queue.Full:
                    pass  # a slow consumer drops lines, never blocks

        # attached before the headers go out: the client takes the 200
        # as subscribed
        handler = _H(level=level)
        logger = logging.getLogger("nomad_tpu_torch")
        _monitor_level_push(logger, level)
        logger.addHandler(handler)
        write_chunk, deadline = self._start_chunked(h, q)
        if write_chunk is None:
            logger.removeHandler(handler)
            _monitor_level_pop(logger)
            return
        try:
            while time.time() < deadline and not self._closing.is_set():
                try:
                    rec = buf.get(timeout=0.25)
                except _queue.Empty:
                    continue
                write_chunk(json.dumps(rec).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            logger.removeHandler(handler)
            _monitor_level_pop(logger)
            try:
                write_chunk(b"")
            except OSError:
                pass

    def _route_event_stream(self, h, q: dict) -> None:
        """ndjson events with topic filters, ``?topic=Node&topic=Job:<id>``
        (reference event_endpoint.go)."""
        topics: Dict[str, list] = {}
        for t in q.get("topic", []):
            if ":" in t:
                topic, key = t.split(":", 1)
            else:
                topic, key = t, "*"
            topics.setdefault(topic, []).append(key)
        # subscribe before the headers commit: an event published in
        # between must not be lost
        sub = self.server.events.subscribe(topics or None)
        with self._conn_lock:
            self._streams.add(sub)
        write_chunk, deadline = self._start_chunked(h, q)
        try:
            if write_chunk is None:
                return
            while time.time() < deadline and not sub.closed:
                events = sub.next_events(
                    timeout=min(0.5, max(0.0, deadline - time.time())))
                if sub.truncated:
                    # the ring lapped this stream: an in-band marker
                    # tells the client to re-list from a fresh snapshot
                    sub.truncated = False
                    write_chunk(json.dumps(
                        {"Topic": "Truncation", "Type": "resync-required",
                         "Key": "", "Index": 0,
                         "Payload": None}).encode() + b"\n")
                for e in events:
                    write_chunk(json.dumps({
                        "Topic": e.topic, "Type": e.type, "Key": e.key,
                        "Index": e.index,
                        "Payload": to_dict(e.payload),
                    }).encode() + b"\n")
            write_chunk(b"")  # the terminating chunk
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            sub.close()
            with self._conn_lock:
                self._streams.discard(sub)

    # -- stubs (list routes return trimmed rows) --

    def _job_stub(self, job, snap) -> dict:
        summary: Dict[str, int] = {}
        for a in snap.allocs_by_job(job.id, job.namespace):
            if not a.terminal_status():
                summary[a.client_status] = summary.get(a.client_status, 0) + 1
        return {
            "id": job.id, "name": job.name, "type": job.type,
            "priority": job.priority, "status": job.status,
            "namespace": job.namespace, "stop": job.stop,
            "alloc_summary": summary,
        }

    def _node_stub(self, node, snap=None) -> dict:
        out = {
            "id": node.id, "name": node.name, "datacenter": node.datacenter,
            "node_class": node.node_class, "node_pool": node.node_pool,
            "status": node.status,
            "scheduling_eligibility": node.scheduling_eligibility,
            "drain": node.drain,
        }
        if snap is not None:
            u = snap.node_usage(node.id)
            cap = float(node.resources.cpu) or 1.0
            out["cpu_frac"] = round(float(u[0]) / cap, 4) \
                if u is not None else 0.0
        return out

    def _alloc_stub(self, a) -> dict:
        return {
            "id": a.id, "name": a.name, "job_id": a.job_id,
            "task_group": a.task_group, "node_id": a.node_id,
            "desired_status": a.desired_status,
            "client_status": a.client_status,
            "create_index": a.create_index, "modify_index": a.modify_index,
        }
