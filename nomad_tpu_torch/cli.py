"""The command line (a trimmed copy of ``nomad_tpu/cli.py``; reference
command/).

  python -m nomad_tpu_torch agent [--clients N] [--port P] [--workers W]
                                  [--algorithm A] [--data-dir D]
                                  [--device cuda|cpu] [-config FILE]
  python -m nomad_tpu_torch job run|plan|validate|status|stop|scale|
                                revert|history ...
  python -m nomad_tpu_torch node status|drain|eligibility ...
  python -m nomad_tpu_torch alloc status|stop|logs|fs ...
  python -m nomad_tpu_torch eval status <eval_id>
  python -m nomad_tpu_torch deployment list|status|promote|fail ...
  python -m nomad_tpu_torch service list|info ...
  python -m nomad_tpu_torch namespace|node-pool list|apply|delete ...
  python -m nomad_tpu_torch volume list|register|deregister ...
  python -m nomad_tpu_torch system gc
  python -m nomad_tpu_torch operator scheduler|raft|snapshot ...
  python -m nomad_tpu_torch monitor

``agent`` runs one Server on the card (``--device cpu`` asks for the
CPU; without a card and without it the agent raises, as
``device.resolve`` does), the HTTP agent, and ``--clients`` client
agents that fingerprint the host (its CUDA cards as ``nvidia/gpu``
device groups), run their allocations under the task drivers and sync
their status back in batches. ``build_agent`` is that build, for callers
that host an agent in-process. The other commands talk HTTP to an agent
(``--address``, or NOMAD_ADDR).

Not ported yet, and refused with a message naming the item: multi-server
mode (``--peers``, ``--join``, ``--gossip``, ``--retry-join``,
``--server-id``; ROADMAP A10.2), external plugins (``--plugin-dir``,
A10.10) and federation (``--region``, ``--authoritative-region``; set
aside). No command is registered whose route the port's agent answers
404: ACLs and variables (A10.4), ``job dispatch`` (A10.5), ``alloc
exec`` (A10.3b), regions and ``server join`` (A10.2), ``operator
debug``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


def _client(args):
    from .api.client import ApiClient

    return ApiClient(address=args.address, namespace=args.namespace)


def _p(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))


# -- agent -------------------------------------------------------------------


AGENT_FLAG_KEYS = ("data_dir", "port", "workers", "algorithm",
                   "server_id", "peers", "clients", "region",
                   "authoritative_region", "plugin_dir")

# flags of parts not ported yet: (attribute, default, what refuses it)
_NOT_PORTED = (
    ("peers", "", "multi-server mode waits for ROADMAP A10.2"),
    ("join", "", "join by address waits for ROADMAP A10.2"),
    ("gossip", "", "gossip waits for ROADMAP A10.2"),
    ("retry_join", "", "gossip join waits for ROADMAP A10.2"),
    ("server_id", "server-0", "multi-server mode waits for ROADMAP A10.2"),
    ("plugin_dir", "", "external plugins wait for ROADMAP A10.10"),
    ("region", "global", "federation is not ported"),
    ("authoritative_region", "", "federation is not ported"),
)


@dataclass
class Agent:
    """A running agent: the Server, its HTTP agent and its clients."""

    server: object
    http: object
    clients: List[object] = field(default_factory=list)

    def stop(self) -> None:
        """HTTP first (no request outlives the server), then the clients
        (their tasks and executors), then the Server."""
        self.http.stop()
        for c in self.clients:
            c.signal_stop()
        for c in self.clients:
            c.stop()
        self.server.stop()


def build_agent(*, workers: int = 2, algorithm: str = "binpack",
                clients: int = 1, port: int = 4646, data_dir: str = "",
                device=None, nodes: Optional[list] = None,
                client_config: Optional[Callable[[int], object]] = None,
                **server_kw) -> Agent:
    """Start a Server on ``device`` (the card when None), the HTTP agent
    on ``port`` (0: an ephemeral one) and ``clients`` client agents,
    as ``cmd_agent`` does (reference ``cli.py:48-118``). Client i keeps
    its state under ``<data_dir>/client<i>`` (a temporary directory
    without ``data_dir``), runs as ``nodes[i]`` when ``nodes`` is given
    (else it fingerprints the host), and takes ``client_config(i)`` for
    its ClientConfig when given. ``server_kw`` are further ServerConfig
    fields."""
    from .api.http import HTTPAgent
    from .client import Client, ClientConfig
    from .core import Server, ServerConfig
    from .structs.operator import SchedulerConfiguration

    server = Server(ServerConfig(
        num_workers=workers, device=device,
        sched_config=SchedulerConfiguration(scheduler_algorithm=algorithm),
        **server_kw))
    server.start()
    http = None
    agent = None
    try:
        # HTTP first: the agent is observable while the clients register
        http = HTTPAgent(server, port=port).start()
        agent = Agent(server, http)
        for i in range(clients):
            cfg = (client_config(i) if client_config is not None
                   else ClientConfig())
            if data_dir:
                cfg.data_dir = os.path.join(data_dir, f"client{i}")
            c = Client(server, cfg,
                       node=nodes[i] if nodes is not None else None)
            c.start()
            agent.clients.append(c)
        http.clients = agent.clients  # serve /v1/client/* for them
    except BaseException:
        if agent is not None:
            agent.stop()
        else:
            if http is not None:
                http.stop()
            server.stop()
        raise
    return agent


def cmd_agent(args) -> int:
    if args.config:
        from .agent_config import apply_to_args, load_agent_config

        file_cfg = load_agent_config(args.config)
        # defaults from the parser itself (a bare `agent`), so the merge
        # cannot drift from the declared flag defaults
        defaults_ns = build_parser().parse_args(["agent"])
        defaults = {k: getattr(defaults_ns, k) for k in AGENT_FLAG_KEYS}
        apply_to_args(file_cfg, args, defaults)
    for attr, default, why in _NOT_PORTED:
        if getattr(args, attr, default) != default:
            flag = "--" + attr.replace("_", "-")
            print(f"{flag}: {why}", file=sys.stderr)
            return 1

    agent = build_agent(workers=args.workers, algorithm=args.algorithm,
                        clients=args.clients, port=args.port,
                        data_dir=args.data_dir, device=args.device)
    server = agent.server
    print(f"agent started: {agent.http.address} "
          f"(workers={args.workers} clients={args.clients} "
          f"algorithm={args.algorithm} device={server.device})", flush=True)
    stop = []
    reload_req = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    if args.config and hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, lambda *a: reload_req.append(1))
    try:
        while not stop:
            if reload_req:
                reload_req.clear()
                # live reload (reference agent.go:1360): the scheduler
                # algorithm is the hot-swappable subset
                try:
                    import copy as _copy

                    from .agent_config import load_agent_config

                    fc = load_agent_config(args.config)
                    if fc.algorithm:
                        # only the algorithm, on a copy of the current
                        # config: operator-set fields stay
                        new_cfg = _copy.deepcopy(server.sched_config)
                        new_cfg.scheduler_algorithm = fc.algorithm
                        server.set_scheduler_config(new_cfg)
                        print(f"config reloaded: algorithm={fc.algorithm}",
                              flush=True)
                except Exception as e:
                    print(f"config reload failed: {e}", flush=True)
            time.sleep(0.2)
    finally:
        agent.stop()
    print("agent stopped", flush=True)
    return 0


# -- job ---------------------------------------------------------------------


def cmd_job_validate(args) -> int:
    """Parse and validate a jobspec locally (reference
    command/job_validate.go)."""
    from .api.codec import to_dict
    from .api.jobspec import parse_file

    try:
        job = parse_file(args.spec, variables=_spec_vars(args))
    except (OSError, ValueError) as e:
        print(f"Job validation failed: {e}", file=sys.stderr)
        return 1
    if getattr(args, "as_json", False):
        _p(to_dict(job))
    else:
        groups = ", ".join(f"{tg.name}[{tg.count}]"
                           for tg in job.task_groups)
        print(f"Job validation successful: {job.id!r} "
              f"({job.type}; groups: {groups})")
    return 0


def cmd_job_plan(args) -> int:
    """Dry-run the update and print each group's desired changes
    (reference command/job_plan.go)."""
    from .api.jobspec import parse_file

    job = parse_file(args.spec, variables=_spec_vars(args))
    out = _client(args).plan_job(job)
    diff = out.get("diff", {})
    print(f"Job: {out.get('job_id')!r} (version {out.get('job_version')}, "
          f"{diff.get('type', '?')})")
    for f in diff.get("fields", [])[:40]:
        print(f"  ~ {f}")
    print("\nScheduler dry-run:")
    for tg, ann in sorted((out.get("annotations") or {}).items()):
        parts = [f"{k}: {v}" for k, v in sorted(ann.items()) if v]
        print(f"  group {tg!r}: " + (", ".join(parts) if parts
                                     else "no changes"))
    failed = out.get("failed_tg_allocs") or {}
    for tg, m in failed.items():
        print(f"  group {tg!r}: {m.get('coalesced_failures', 0) + 1} "
              f"WOULD FAIL to place (filtered {m.get('nodes_filtered')}, "
              f"exhausted {m.get('nodes_exhausted')})")
    return 1 if failed else 0


def _spec_vars(args) -> dict:
    out = {}
    for kv in getattr(args, "var", None) or []:
        if "=" not in kv:
            print(f"invalid -var {kv!r}: expected key=value", file=sys.stderr)
            raise SystemExit(2)
        k, v = kv.split("=", 1)
        out[k] = v
    return out


def cmd_job_run(args) -> int:
    from .api.jobspec import parse_file

    job = parse_file(args.spec, variables=_spec_vars(args))
    eval_id = _client(args).register_job(job)
    print(f"job {job.id!r} registered, evaluation {eval_id}")
    if args.detach:
        return 0
    return _monitor_eval(args, eval_id)


def _monitor_eval(args, eval_id: str) -> int:
    api = _client(args)
    deadline = time.time() + 30
    while time.time() < deadline:
        ev = api.evaluation(eval_id)
        if ev["status"] in ("complete", "failed", "canceled"):
            print(f"evaluation {eval_id} -> {ev['status']} "
                  f"{ev.get('status_description', '')}".strip())
            if ev.get("blocked_eval"):
                print(f"  blocked eval created: {ev['blocked_eval']}")
            for tg, m in (ev.get("failed_tg_allocs") or {}).items():
                print(f"  group {tg!r}: {m.get('coalesced_failures', 0) + 1} "
                      f"unplaced (filtered {m.get('nodes_filtered')}, "
                      f"exhausted {m.get('nodes_exhausted')})")
            return 0 if ev["status"] == "complete" else 1
        time.sleep(0.2)
    print(f"evaluation {eval_id} still in progress")
    return 1


def cmd_job_scale(args) -> int:
    eval_id = _client(args).scale_job(args.job_id, args.group, args.count)
    print(f"job {args.job_id!r} group {args.group!r} scaled to "
          f"{args.count}, evaluation {eval_id}")
    return _monitor_eval(args, eval_id) if not args.detach else 0


def cmd_job_revert(args) -> int:
    eval_id = _client(args).revert_job(args.job_id, args.version)
    print(f"job {args.job_id!r} reverted to version {args.version}, "
          f"evaluation {eval_id}")
    return _monitor_eval(args, eval_id) if not args.detach else 0


def cmd_job_history(args) -> int:
    for v in _client(args).job_versions(args.job_id):
        print(f"version {v['version']:4d}  stable={v['stable']}  "
              f"index={v['job_modify_index']}")
    return 0


def cmd_job_status(args) -> int:
    api = _client(args)
    if not args.job_id:
        _p(api.list_jobs())
        return 0
    job = api.job(args.job_id)
    allocs = api.job_allocations(args.job_id)
    print(f"ID       = {job['id']}\nType     = {job['type']}\n"
          f"Priority = {job['priority']}\nStatus   = {job['status']}")
    print("\nAllocations")
    for a in allocs:
        print(f"{a['id'][:8]}  {a['task_group']:12} {a['node_id'][:8]}  "
              f"{a['desired_status']:6} {a['client_status']}")
    return 0


def cmd_job_stop(args) -> int:
    eval_id = _client(args).deregister_job(args.job_id, purge=args.purge)
    print(f"job {args.job_id!r} stopped, evaluation {eval_id}")
    return 0


# -- node --------------------------------------------------------------------


def cmd_node_status(args) -> int:
    api = _client(args)
    if not args.node_id:
        _p(api.list_nodes())
        return 0
    _p(api.node(args.node_id))
    return 0


def cmd_node_drain(args) -> int:
    api = _client(args)
    if args.enable:
        api.drain_node(args.node_id, drain_spec={"deadline_s": args.deadline})
        print(f"node {args.node_id} draining")
    else:
        api.drain_node(args.node_id, drain_spec=None, mark_eligible=True)
        print(f"node {args.node_id} drain disabled")
    return 0


def cmd_node_eligibility(args) -> int:
    _client(args).set_node_eligibility(args.node_id, args.enable)
    print(f"node {args.node_id} "
          f"{'eligible' if args.enable else 'ineligible'}")
    return 0


# -- alloc / eval / operator -------------------------------------------------


def cmd_alloc_status(args) -> int:
    _p(_client(args).allocation(args.alloc_id))
    return 0


def cmd_alloc_stop(args) -> int:
    """Stop and reschedule one allocation (reference command/alloc_stop.go)."""
    eval_id = _client(args).stop_alloc(args.alloc_id)
    print(f"alloc {args.alloc_id} stopping, evaluation {eval_id}")
    return _monitor_eval(args, eval_id) if not args.detach else 0


def cmd_alloc_logs(args) -> int:
    """Print a task's captured output (reference command/alloc_logs.go)."""
    out = _client(args).alloc_logs(
        args.alloc_id, task=args.task,
        log_type="stderr" if args.stderr else "stdout",
        offset=args.offset)
    sys.stdout.write(out["data"].decode(errors="replace"))
    return 0


def cmd_alloc_fs(args) -> int:
    """Browse or read an allocation's files (reference
    command/alloc_fs.go)."""
    api = _client(args)
    st = api.alloc_fs_stat(args.alloc_id, args.path or "/")
    if st["is_dir"]:
        for e in api.alloc_fs_ls(args.alloc_id, args.path or "/"):
            kind = "d" if e["is_dir"] else "-"
            print(f"{kind} {e['size']:>10}  {e['name']}")
        return 0
    offset = 0
    while True:
        data = api.alloc_fs_cat(args.alloc_id, args.path, offset=offset)
        if not data:
            break
        sys.stdout.buffer.write(data)
        offset += len(data)
    sys.stdout.buffer.flush()
    return 0


def cmd_eval_status(args) -> int:
    _p(_client(args).evaluation(args.eval_id))
    return 0


def cmd_operator_snapshot(args) -> int:
    api = _client(args)
    if args.op == "save":
        data = api.snapshot_save()
        with open(args.file, "w") as f:
            json.dump(data, f)
        print(f"snapshot saved to {args.file} (index {data.get('index')})")
        return 0
    with open(args.file) as f:
        data = json.load(f)
    index = api.snapshot_restore(data)
    print(f"snapshot restored at index {index}")
    return 0


def cmd_operator_scheduler(args) -> int:
    api = _client(args)
    if args.op == "get-config":
        _p(api.scheduler_configuration())
        return 0
    cfg = dict(api.scheduler_configuration())
    if args.scheduler_algorithm:
        cfg["scheduler_algorithm"] = args.scheduler_algorithm
    api.set_scheduler_configuration(cfg)
    print("scheduler configuration updated")
    return 0


def cmd_service(args) -> int:
    """The service catalog (reference command/service_list.go and
    service_info.go)."""
    api = _client(args)
    if args.op == "list":
        for s in api.list_services():
            print(f"{s['service_name']}\t{s['instances']} instance(s)\t"
                  f"tags={','.join(s['tags']) or '-'}")
        return 0
    if not args.name:
        print("service info requires a name", file=sys.stderr)
        return 2
    for reg in api.service(args.name):
        print(f"{reg['id']}\t{reg['address']}:{reg['port']}\t"
              f"node={reg['node_id'][:8]}\talloc={reg['alloc_id'][:8]}")
    return 0


def cmd_monitor(args) -> int:
    """Stream the agent's log (reference command/monitor.go)."""
    import urllib.error
    import urllib.request

    url = (f"{args.address}/v1/agent/monitor?wait={args.wait}"
           f"&log_level={args.log_level}")
    try:
        with urllib.request.urlopen(url, timeout=args.wait + 30) as resp:
            while True:
                line = resp.readline()
                if not line:
                    return 0
                try:
                    rec = json.loads(line)
                    ts = time.strftime("%H:%M:%S",
                                       time.localtime(rec["ts"]))
                    print(f"{ts} [{rec['level']}] {rec['name']}: "
                          f"{rec['message']}", flush=True)
                except (ValueError, KeyError):
                    continue
    except KeyboardInterrupt:
        return 0
    except urllib.error.URLError as e:
        print(f"monitor failed: {e}", file=sys.stderr)
        return 1


def cmd_operator_raft(args) -> int:
    """Raft membership (reference command/operator_raft_*.go)."""
    api = _client(args)
    if args.op == "list-peers":
        cfg = api.raft_configuration()
        for s in cfg.get("servers", []):
            mark = " (leader)" if s.get("leader") else ""
            print(f"{s['id']}\t{s['address']}{mark}")
        return 0
    if not args.peer_id:
        print("remove-peer requires -peer-id", file=sys.stderr)
        return 2
    api.raft_remove_peer(args.peer_id)
    print(f"peer {args.peer_id} removed")
    return 0


def cmd_deployment(args) -> int:
    """Deployments (reference command/deployment_*.go)."""
    api = _client(args)
    if args.op != "list" and not args.dep_id:
        print(f"deployment {args.op} requires a deployment id",
              file=sys.stderr)
        return 2
    if args.op == "list":
        for d in api.list_deployments():
            print(f"{d['id'][:8]}  {d['job_id']:24} v{d['job_version']}  "
                  f"{d['status']}")
        return 0
    if args.op == "status":
        _p(api.deployment(args.dep_id))
        return 0
    if args.op == "promote":
        eval_id = api.promote_deployment(args.dep_id)
        print(f"deployment {args.dep_id} promoted, evaluation {eval_id}")
        return 0
    api.fail_deployment(args.dep_id)
    print(f"deployment {args.dep_id} failed")
    return 0


# -- namespaces / pools / volumes / system -----------------------------------


def cmd_namespace(args) -> int:
    api = _client(args)
    if args.op == "list":
        for n in api.list_namespaces():
            print(f"{n['name']:20} {n.get('description', '')}")
    elif args.op == "apply":
        api.apply_namespace(args.name, args.description)
        print(f"namespace {args.name!r} applied")
    else:
        api.delete_namespace(args.name)
        print(f"namespace {args.name!r} deleted")
    return 0


def cmd_node_pool(args) -> int:
    api = _client(args)
    if args.op == "list":
        for p in api.list_node_pools():
            sc = p.get("scheduler_configuration") or {}
            alg = sc.get("scheduler_algorithm")
            print(f"{p['name']:20} {p.get('description', '')} "
                  f"{('alg=' + alg) if alg else ''}")
    elif args.op == "apply":
        body = {"description": args.description}
        if args.scheduler_algorithm:
            body["scheduler_configuration"] = {
                "scheduler_algorithm": args.scheduler_algorithm}
        api.apply_node_pool(args.name, body)
        print(f"node pool {args.name!r} applied")
    else:
        api.delete_node_pool(args.name)
        print(f"node pool {args.name!r} deleted")
    return 0


def cmd_volume(args) -> int:
    api = _client(args)
    if args.op == "list":
        for v in api.list_volumes():
            print(f"{v['id']:24} {v['access_mode']:24} claims={v['claims']}")
    elif args.op == "register":
        body = {"name": args.vol_id, "access_mode": args.access_mode}
        api.register_volume(args.vol_id, body)
        print(f"volume {args.vol_id!r} registered")
    else:
        api.deregister_volume(args.vol_id, force=args.force)
        print(f"volume {args.vol_id!r} deregistered")
    return 0


def cmd_system_gc(args) -> int:
    _p(_client(args).system_gc())
    return 0


# -- parser ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad_tpu_torch")
    p.add_argument("--address", default=os.environ.get("NOMAD_ADDR",
                                                       "http://127.0.0.1:4646"))
    p.add_argument("--namespace", default=os.environ.get("NOMAD_NAMESPACE",
                                                         "default"))
    sub = p.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent", help="run an agent (server+clients+http)")
    ag.add_argument("-dev", action="store_true", dest="dev")
    ag.add_argument("-config", "--config", default="",
                    help="agent config file (HCL-shaped or .json); "
                         "flags override file values; SIGHUP reloads")
    ag.add_argument("--clients", type=int, default=1)
    ag.add_argument("--workers", type=int, default=2)
    ag.add_argument("--port", type=int, default=4646)
    ag.add_argument("--algorithm", default="binpack")
    ag.add_argument("--data-dir", default="")
    ag.add_argument("--device", default="cuda",
                    help="where the scheduler's kernels run: cuda (the "
                         "default; raises without a card) or cpu")
    ag.add_argument("--region", default="global",
                    help="federation is not ported: only the default")
    ag.add_argument("--authoritative-region", dest="authoritative_region",
                    default="", help="federation is not ported")
    ag.add_argument("--plugin-dir", default="",
                    help="external plugins wait for ROADMAP A10.10")
    ag.add_argument("--server-id", default="server-0",
                    help="multi-server mode waits for ROADMAP A10.2")
    ag.add_argument("--peers", default="",
                    help="multi-server mode waits for ROADMAP A10.2")
    ag.add_argument("--join", default="",
                    help="join by address waits for ROADMAP A10.2")
    ag.add_argument("--gossip", default="",
                    help="gossip waits for ROADMAP A10.2")
    ag.add_argument("--retry-join", dest="retry_join", default="",
                    help="gossip join waits for ROADMAP A10.2")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job").add_subparsers(dest="job_cmd", required=True)
    jr = job.add_parser("run")
    jr.add_argument("spec")
    jr.add_argument("-detach", action="store_true")
    jr.add_argument("-var", action="append", dest="var",
                    help="key=value jobspec variable (repeatable)")
    jr.set_defaults(fn=cmd_job_run)
    jp = job.add_parser("plan")
    jp.add_argument("spec")
    jp.add_argument("-var", action="append", dest="var")
    jp.set_defaults(fn=cmd_job_plan)
    jv = job.add_parser("validate", help="parse and validate a jobspec "
                        "without submitting it")
    jv.add_argument("spec")
    jv.add_argument("-var", action="append", dest="var")
    jv.add_argument("-json", action="store_true", dest="as_json",
                    help="print the canonical parsed job as JSON")
    jv.set_defaults(fn=cmd_job_validate)
    jsc = job.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.add_argument("-detach", action="store_true")
    jsc.set_defaults(fn=cmd_job_scale)
    jrv = job.add_parser("revert")
    jrv.add_argument("job_id")
    jrv.add_argument("version", type=int)
    jrv.add_argument("-detach", action="store_true")
    jrv.set_defaults(fn=cmd_job_revert)
    jh = job.add_parser("history")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    js = job.add_parser("status")
    js.add_argument("job_id", nargs="?", default="")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)

    node = sub.add_parser("node").add_subparsers(dest="node_cmd", required=True)
    ns = node.add_parser("status")
    ns.add_argument("node_id", nargs="?", default="")
    ns.set_defaults(fn=cmd_node_status)
    nd = node.add_parser("drain")
    nd.add_argument("node_id")
    g = nd.add_mutually_exclusive_group(required=True)
    g.add_argument("-enable", action="store_true", dest="enable")
    g.add_argument("-disable", action="store_false", dest="enable")
    nd.add_argument("--deadline", type=float, default=3600.0)
    nd.set_defaults(fn=cmd_node_drain)
    ne = node.add_parser("eligibility")
    ne.add_argument("node_id")
    g2 = ne.add_mutually_exclusive_group(required=True)
    g2.add_argument("-enable", action="store_true", dest="enable")
    g2.add_argument("-disable", action="store_false", dest="enable")
    ne.set_defaults(fn=cmd_node_eligibility)

    al = sub.add_parser("alloc").add_subparsers(dest="alloc_cmd", required=True)
    als = al.add_parser("status")
    als.add_argument("alloc_id")
    als.set_defaults(fn=cmd_alloc_status)
    alstop = al.add_parser("stop")
    alstop.add_argument("alloc_id")
    alstop.add_argument("-detach", action="store_true")
    alstop.set_defaults(fn=cmd_alloc_stop)
    allog = al.add_parser("logs")
    allog.add_argument("alloc_id")
    allog.add_argument("task", nargs="?", default="")
    allog.add_argument("-stderr", action="store_true")
    allog.add_argument("--offset", type=int, default=0)
    allog.set_defaults(fn=cmd_alloc_logs)
    alfs = al.add_parser("fs")
    alfs.add_argument("alloc_id")
    alfs.add_argument("path", nargs="?", default="/")
    alfs.set_defaults(fn=cmd_alloc_fs)

    ev = sub.add_parser("eval").add_subparsers(dest="eval_cmd", required=True)
    evs = ev.add_parser("status")
    evs.add_argument("eval_id")
    evs.set_defaults(fn=cmd_eval_status)

    dep = sub.add_parser("deployment")
    dep.add_argument("op", choices=["list", "status", "promote", "fail"])
    dep.add_argument("dep_id", nargs="?", default="")
    dep.set_defaults(fn=cmd_deployment)

    nsp = sub.add_parser("namespace")
    nsp.add_argument("op", choices=["list", "apply", "delete"])
    nsp.add_argument("name", nargs="?", default="")
    nsp.add_argument("-description", default="")
    nsp.set_defaults(fn=cmd_namespace)

    npool = sub.add_parser("node-pool")
    npool.add_argument("op", choices=["list", "apply", "delete"])
    npool.add_argument("name", nargs="?", default="")
    npool.add_argument("-description", default="")
    npool.add_argument("-scheduler-algorithm", dest="scheduler_algorithm",
                       default="")
    npool.set_defaults(fn=cmd_node_pool)

    vol = sub.add_parser("volume")
    vol.add_argument("op", choices=["list", "register", "deregister"])
    vol.add_argument("vol_id", nargs="?", default="")
    vol.add_argument("-access-mode", dest="access_mode",
                     default="single-node-writer")
    vol.add_argument("-force", action="store_true")
    vol.set_defaults(fn=cmd_volume)

    system = sub.add_parser("system").add_subparsers(dest="system_cmd",
                                                     required=True)
    sgc = system.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)

    op = sub.add_parser("operator").add_subparsers(dest="op_cmd", required=True)
    osched = op.add_parser("scheduler")
    osched.add_argument("op", choices=["get-config", "set-config"])
    osched.add_argument("-scheduler-algorithm", dest="scheduler_algorithm",
                        default="")
    osched.set_defaults(fn=cmd_operator_scheduler)
    osnap = op.add_parser("snapshot")
    osnap.add_argument("op", choices=["save", "restore"])
    osnap.add_argument("file")
    osnap.set_defaults(fn=cmd_operator_snapshot)
    oraft = op.add_parser("raft")
    oraft.add_argument("op", choices=["list-peers", "remove-peer"])
    oraft.add_argument("-peer-id", dest="peer_id", default="")
    oraft.set_defaults(fn=cmd_operator_raft)

    mon = sub.add_parser("monitor")
    mon.add_argument("-log-level", dest="log_level", default="info")
    mon.add_argument("-wait", type=int, default=600)
    mon.set_defaults(fn=cmd_monitor)

    svc = sub.add_parser("service")
    svc.add_argument("op", choices=["list", "info"])
    svc.add_argument("name", nargs="?", default="")
    svc.set_defaults(fn=cmd_service)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
