"""Job specification parsing (a copy of ``nomad_tpu/api/jobspec.py``;
reference jobspec2/parse.go:21).

The reference parses HCL2 job files into api.Job. The native format here
is JSON with snake_case keys mirroring the dataclass fields:

    {
      "job": {
        "id": "web", "type": "service", "datacenters": ["dc1"],
        "task_groups": [{
          "name": "web", "count": 3,
          "tasks": [{"name": "srv", "driver": "raw_exec",
                     "config": {"command": "/bin/sleep", "args": ["60"]},
                     "resources": {"cpu": 500, "memory_mb": 256}}],
          "constraints": [{"ltarget": "${attr.kernel.name}",
                           "rtarget": "linux", "operand": "="}]
        }]
      }
    }

A top-level "job" wrapper is optional. parse_hcl_like() additionally
accepts a minimal HCL-shaped surface (block syntax with = assignments)
so hand-written specs stay ergonomic without an HCL dependency.
"""

from __future__ import annotations

import json
import re
from typing import Optional

from ..structs.job import Job
from .codec import from_dict


def parse_json(text: str) -> Job:
    data = json.loads(text)
    if "job" in data:
        data = data["job"]
    elif "Job" in data:
        data = data["Job"]
    job = from_dict(Job, data)
    _validate(job)
    return job


def parse_file(path: str, variables: Optional[dict] = None) -> Job:
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return parse_json(text)
    return parse_hcl_like(text, variables=variables)


def _validate(job: Job) -> None:
    if not job.id:
        raise ValueError("job id is required")
    if not job.task_groups:
        raise ValueError(f"job {job.id} has no task groups")
    names = set()
    for tg in job.task_groups:
        if tg.name in names:
            raise ValueError(f"duplicate task group {tg.name!r}")
        names.add(tg.name)
        if not tg.tasks:
            raise ValueError(f"task group {tg.name!r} has no tasks")
        if tg.count < 0:
            raise ValueError(f"task group {tg.name!r} has negative count")
        if tg.scaling is not None and tg.scaling.enabled:
            sc = tg.scaling
            if sc.max and sc.min > sc.max:
                raise ValueError(
                    f"group {tg.name!r}: scaling min {sc.min} > max {sc.max}")
            if tg.count < sc.min or (sc.max and tg.count > sc.max):
                raise ValueError(
                    f"group {tg.name!r}: count {tg.count} outside scaling "
                    f"bounds [{sc.min}, {sc.max or 'unbounded'}]")
        for vname, req in tg.volumes.items():
            if req.per_alloc:
                # indexed per-alloc sources aren't implemented yet; a
                # silent shared-volume fallback would be data loss bait
                raise ValueError(
                    f"volume {vname!r} in group {tg.name!r}: "
                    "per_alloc volumes are not supported yet")
            if req.type not in ("host", "csi"):
                raise ValueError(
                    f"volume {vname!r} in group {tg.name!r}: "
                    f"unknown type {req.type!r}")
        for t in tg.tasks:
            for vm in t.volume_mounts:
                if vm.volume not in tg.volumes:
                    raise ValueError(
                        f"task {t.name!r} mounts undeclared volume "
                        f"{vm.volume!r}")
            if t.plugin:  # {} / None = no stanza (codec may inflate {})
                ptype = t.plugin.get("type", "")
                if ptype not in ("volume", "device"):
                    raise ValueError(
                        f"task {t.name!r}: unknown plugin type "
                        f"{ptype!r} (volume | device)")
                if not t.plugin.get("id"):
                    raise ValueError(
                        f"task {t.name!r}: plugin stanza requires an id")


# ---------------------------------------------------------------------------
# minimal HCL-shaped parser
# ---------------------------------------------------------------------------
#
# Supports the common jobspec shape:
#   job "web" {
#     datacenters = ["dc1"]
#     group "api" {
#       count = 3
#       task "server" {
#         driver = "raw_exec"
#         config { command = "/bin/sleep" \n args = ["60"] }
#         resources { cpu = 500 \n memory = 256 }
#       }
#       constraint { attribute = "${attr.kernel.name}" \n value = "linux" }
#     }
#   }

_TOKEN = re.compile(r"""
    (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<lbrace>\{) | (?P<rbrace>\})
  | (?P<lbrack>\[) | (?P<rbrack>\])
  | (?P<eq>=) | (?P<comma>,)
  | (?P<string>"(?:[^"\\$]|\\.|\$(?!\{)|\$\{[^{}]*\})*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<bool>\btrue\b|\bfalse\b)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.-]*)
  | (?P<ws>\s+)
""", re.VERBOSE)


def _unquote(raw: str) -> str:
    """Unescape a tokenized string literal. Not json.loads: interpolation
    segments (${format("x", ...)}) legally carry raw inner quotes."""
    body = raw[1:-1]
    out = []
    i = 0
    esc = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt == "u" and i + 5 < len(body):
                try:
                    out.append(chr(int(body[i + 2:i + 6], 16)))
                    i += 6
                    continue
                except ValueError:
                    pass
            out.append(esc.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _tokenize(text: str):
    out = []
    i = 0
    while i < len(text):
        m = _TOKEN.match(text, i)
        if m is None:
            raise ValueError(f"jobspec parse error at offset {i}: {text[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind):
        k, v = self.next()
        if k != kind:
            raise ValueError(f"expected {kind}, got {k} {v!r}")
        return v

    def parse_body(self) -> dict:
        """Parse until rbrace/EOF: assignments and nested blocks.
        Repeated blocks accumulate into lists."""
        body: dict = {}
        while True:
            k, v = self.peek()
            if k is None or k == "rbrace":
                return body
            if k != "ident":
                raise ValueError(f"unexpected {k} {v!r}")
            self.next()
            name = v
            k2, v2 = self.peek()
            if k2 == "eq":
                self.next()
                body[name] = self.parse_value()
            else:
                # block: optional string label(s), then { body }
                labels = []
                while self.peek()[0] == "string":
                    labels.append(_unquote(self.next()[1]))
                self.expect("lbrace")
                inner = self.parse_body()
                self.expect("rbrace")
                entry = {"__label__": labels[0]} if labels else {}
                entry.update(inner)
                body.setdefault(name, []).append(entry)

    def parse_value(self):
        k, v = self.next()
        if k == "string":
            return _unquote(v)
        if k == "number":
            return float(v) if "." in v else int(v)
        if k == "bool":
            return v == "true"
        if k == "ident" and v.startswith(("var.", "local.")):
            # bare HCL2 reference (count = var.replicas): normalize to
            # the interpolation form and resolve later
            return "${" + v + "}"
        if k == "lbrack":
            items = []
            while True:
                if self.peek()[0] == "rbrack":
                    self.next()
                    return items
                items.append(self.parse_value())
                if self.peek()[0] == "comma":
                    self.next()
        raise ValueError(f"unexpected value token {k} {v!r}")


def _constraint_dict(block: dict) -> dict:
    # HCL constraint {attribute, operator, value} -> struct fields
    out = {
        "ltarget": block.get("attribute", block.get("ltarget", "")),
        "operand": block.get("operator", block.get("operand", "=")),
        "rtarget": str(block.get("value", block.get("rtarget", ""))),
    }
    return out


def _task_dict(block: dict) -> dict:
    out = {"name": block.get("__label__", block.get("name", "task"))}
    for key in ("driver", "user", "leader", "kill_timeout_s"):
        if key in block:
            out[key] = block[key]
    if "env" in block and isinstance(block["env"], list):
        env = {}
        for e in block["env"]:
            env.update({k: str(v) for k, v in e.items() if k != "__label__"})
        out["env"] = env
    if "meta" in block and isinstance(block["meta"], list):
        meta = {}
        for m in block["meta"]:
            meta.update({k: str(v) for k, v in m.items() if k != "__label__"})
        out["meta"] = meta
    if "config" in block:
        cfg = block["config"][0] if isinstance(block["config"], list) else block["config"]
        out["config"] = {k: v for k, v in cfg.items() if k != "__label__"}
    if "resources" in block:
        res = block["resources"][0]
        r = {}
        if "cpu" in res:
            r["cpu"] = float(res["cpu"])
        if "memory" in res:
            r["memory_mb"] = float(res["memory"])
        if "memory_mb" in res:
            r["memory_mb"] = float(res["memory_mb"])
        if "disk" in res:
            r["disk_mb"] = float(res["disk"])
        if "cores" in res:
            r["cores"] = int(res["cores"])
        out["resources"] = r
    if "plugin" in block:
        # plugins-as-tasks stanza (client/dynamicplugins.py; reference
        # task csi_plugin): plugin { type = "volume" id = "x" }
        pl = (block["plugin"][0] if isinstance(block["plugin"], list)
              else block["plugin"])
        if not isinstance(pl, dict):
            raise ValueError(
                "plugin must be a block: plugin { type = ... id = ... }")
        out["plugin"] = {k: str(v) for k, v in pl.items()
                         if k != "__label__"}
    out["constraints"] = [_constraint_dict(c) for c in block.get("constraint", [])]
    mounts = []
    for vm in block.get("volume_mount", []):
        mounts.append({
            "volume": vm.get("volume", vm.get("__label__", "")),
            "destination": vm.get("destination", ""),
            "read_only": bool(vm.get("read_only", False)),
        })
    if mounts:
        out["volume_mounts"] = mounts
    return out


def _group_dict(block: dict) -> dict:
    out = {"name": block.get("__label__", block.get("name", "group"))}
    if "count" in block:
        out["count"] = int(block["count"])
    out["tasks"] = [_task_dict(t) for t in block.get("task", [])]
    out["constraints"] = [_constraint_dict(c) for c in block.get("constraint", [])]
    spreads = []
    for sp in block.get("spread", []):
        spreads.append({
            "attribute": sp.get("attribute", ""),
            "weight": int(sp.get("weight", 50)),
            "targets": [
                {"value": t.get("__label__", t.get("value", "")),
                 "percent": int(t.get("percent", 0))}
                for t in sp.get("target", [])],
        })
    out["spreads"] = spreads
    networks = []
    for nb in block.get("network", []):
        net = {"mode": nb.get("mode", "host"),
               "reserved_ports": [], "dynamic_ports": []}
        for pb in nb.get("port", []):
            label = pb.get("__label__", pb.get("label", ""))
            if "static" in pb:
                net["reserved_ports"].append([label, int(pb["static"])])
            else:
                net["dynamic_ports"].append(label)
        networks.append(net)
    if networks:
        out["networks"] = networks
    if "restart" in block:
        rp = block["restart"][0]
        out["restart_policy"] = {
            "attempts": int(rp.get("attempts", 2)),
            "interval_s": float(rp.get("interval", 1800)),
            "delay_s": float(rp.get("delay", 15)),
            "mode": rp.get("mode", "fail"),
        }
    if block.get("ephemeral_disk"):
        # the group's scratch disk (a stanza the reference's parser
        # skips; Nomad's jobspec has it)
        ed = block["ephemeral_disk"][0]
        out["ephemeral_disk"] = {
            "size_mb": int(ed.get("size", 300)),
            "sticky": bool(ed.get("sticky", False)),
            "migrate": bool(ed.get("migrate", False)),
        }
    volumes = {}
    for vb in block.get("volume", []):
        name = vb.get("__label__", vb.get("name", ""))
        volumes[name] = {
            "name": name,
            "type": vb.get("type", "host"),
            "source": vb.get("source", ""),
            "read_only": bool(vb.get("read_only", False)),
            "access_mode": vb.get("access_mode", "single-node-writer"),
            "per_alloc": bool(vb.get("per_alloc", False)),
        }
    if volumes:
        out["volumes"] = volumes
    if block.get("scaling"):
        sc = block["scaling"][0]
        out["scaling"] = {
            "min": int(sc.get("min", 0)),
            "max": int(sc.get("max", 0)),
            "enabled": bool(sc.get("enabled", True)),
            "policy": sc.get("policy", [{}])[0]
            if isinstance(sc.get("policy"), list) else sc.get("policy", {}),
        }
    services = []
    for sb in block.get("service", []):
        services.append({
            "name": sb.get("__label__", sb.get("name", "")),
            "port_label": sb.get("port", sb.get("port_label", "")),
            "tags": list(sb.get("tags", [])),
            "checks": [{
                "name": cb.get("__label__", cb.get("name", "")),
                "type": cb.get("type", "tcp"),
                "path": cb.get("path", "/"),
                "method": cb.get("method", "GET"),
                "interval_s": float(cb.get("interval", 10)),
                "timeout_s": float(cb.get("timeout", 3)),
                "port_label": cb.get("port", ""),
            } for cb in sb.get("check", [])],
        })
    if services:
        out["services"] = services
    return out


# ---------------------------------------------------------------------------
# HCL2-style variables / locals / functions (reference jobspec2:
# variable blocks, locals, go-cty stdlib functions, NOMAD_VAR_* env and
# -var flag overrides)
# ---------------------------------------------------------------------------

_INTERP = re.compile(r"\$\{([^{}]+)\}")

# the function subset jobs actually lean on (reference jobspec2 exposes
# the cty stdlib; these cover the common spec-shaping cases)
_FUNCTIONS = {
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "trimspace": lambda s: str(s).strip(),
    "join": lambda sep, items: str(sep).join(str(i) for i in items),
    "split": lambda sep, s: str(s).split(str(sep)),
    "replace": lambda s, old, new: str(s).replace(str(old), str(new)),
    "format": lambda fmt, *a: _go_format(str(fmt), a),
    "coalesce": lambda *a: next((x for x in a if x not in (None, "")), ""),
    "length": lambda x: len(x),
    "min": lambda *a: min(a),
    "max": lambda *a: max(a),
}


def _go_format(fmt: str, args) -> str:
    """Tiny %v-style formatter (the jobspec2 format() surface): each
    argument binds to the leftmost remaining verb; substituted text is
    never rescanned, so argument values containing %v/%s/%d are safe."""
    out = fmt
    pos = 0
    for a in args:
        hits = [i for i in (out.find(s, pos) for s in ("%v", "%s", "%d"))
                if i >= 0]
        if not hits:
            break
        idx = min(hits)
        rep = str(a)
        out = out[:idx] + rep + out[idx + 2:]
        pos = idx + len(rep)
    return out


def _collect_variables(body: dict, overrides: Optional[dict]) -> dict:
    """Resolve variable bindings: -var overrides > NOMAD_VAR_<name> env
    > block default (reference jobspec2 ParseWithConfig)."""
    import os

    out: dict = {}
    for vb in body.get("variable", []):
        name = vb.get("__label__", "")
        if not name:
            continue
        out[name] = vb.get("default")
    for key, val in os.environ.items():
        if key.startswith("NOMAD_VAR_"):
            out[key[len("NOMAD_VAR_"):]] = val
    for key, val in (overrides or {}).items():
        out[key] = val
    missing = [k for k, v in out.items() if v is None]
    if missing:
        raise ValueError(f"variables without a value: {missing}")
    return out


def _eval_expr(expr: str, variables: dict, local_vals: dict):
    """Evaluate one ${...} expression: var./local. refs, literals, and
    one-level function calls. Unknown forms return None so runtime
    interpolations (${attr.*}, ${NOMAD_*}) pass through untouched."""
    expr = expr.strip()
    if expr.startswith("var."):
        name = expr[4:]
        if name not in variables:
            raise ValueError(f"undefined variable {name!r}")
        return variables[name]
    if expr.startswith("local."):
        name = expr[6:]
        if name not in local_vals:
            raise ValueError(f"undefined local {name!r}")
        return local_vals[name]
    m = re.fullmatch(r"([a-z_]+)\((.*)\)", expr, re.DOTALL)
    if m and m.group(1) in _FUNCTIONS:
        args = []
        for raw in _split_args(m.group(2)):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith('"') and raw.endswith('"'):
                args.append(json.loads(raw))
            elif re.fullmatch(r"-?\d+", raw):
                args.append(int(raw))
            elif re.fullmatch(r"-?\d+\.\d+", raw):
                args.append(float(raw))
            else:
                val = _eval_expr(raw, variables, local_vals)
                if val is None:
                    raise ValueError(f"cannot evaluate argument {raw!r}")
                args.append(val)
        return _FUNCTIONS[m.group(1)](*args)
    return None  # runtime interpolation: not ours to resolve


def _split_args(s: str):
    """Split a call's arguments on top-level commas (quotes and nested
    parens respected)."""
    out, depth, in_str, cur = [], 0, False, []
    i = 0
    while i < len(s):
        ch = s[i]
        if in_str:
            cur.append(ch)
            if ch == "\\":
                i += 1
                if i < len(s):
                    cur.append(s[i])
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    if cur:
        out.append("".join(cur))
    return out


def _resolve_strings(value, variables: dict, local_vals: dict):
    """Walk the parsed body resolving spec-time interpolations in place;
    a string that is exactly one interpolation keeps the expression's
    native type (count = "${var.n}" stays an int)."""
    if isinstance(value, str):
        whole = _INTERP.fullmatch(value)
        if whole:
            out = _eval_expr(whole.group(1), variables, local_vals)
            return value if out is None else out

        def sub(m):
            out = _eval_expr(m.group(1), variables, local_vals)
            return m.group(0) if out is None else str(out)

        return _INTERP.sub(sub, value)
    if isinstance(value, list):
        return [_resolve_strings(v, variables, local_vals) for v in value]
    if isinstance(value, dict):
        return {k: _resolve_strings(v, variables, local_vals)
                for k, v in value.items()}
    return value


def parse_hcl_like(text: str, variables: Optional[dict] = None) -> Job:
    """Parse the minimal HCL-shaped jobspec surface into a Job, with
    jobspec2-style variable/locals/function resolution."""
    body = _Parser(_tokenize(text)).parse_body()
    bindings = _collect_variables(body, variables)
    local_vals: dict = {}
    for lb in body.get("locals", []):
        for k, v in lb.items():
            if k != "__label__":
                local_vals[k] = _resolve_strings(v, bindings, local_vals)
    body = _resolve_strings(body, bindings, local_vals)
    jobs = body.get("job")
    if not jobs:
        raise ValueError("no job block found")
    jb = jobs[0]
    data = {
        "id": jb.get("__label__", jb.get("id", "")),
        "name": jb.get("name", jb.get("__label__", "")),
        "type": jb.get("type", "service"),
        "priority": int(jb.get("priority", 50)),
        "datacenters": jb.get("datacenters", ["dc1"]),
        "namespace": jb.get("namespace", "default"),
        "node_pool": jb.get("node_pool", "default"),
        "all_at_once": bool(jb.get("all_at_once", False)),
        "constraints": [_constraint_dict(c) for c in jb.get("constraint", [])],
        "task_groups": [_group_dict(g) for g in jb.get("group", [])],
        "meta": {},
    }
    for m in jb.get("meta", []):
        data["meta"].update({k: str(v) for k, v in m.items() if k != "__label__"})
    if "parameterized" in jb:
        pb = jb["parameterized"][0]
        data["parameterized"] = {
            "payload": pb.get("payload", "optional"),
            "meta_required": pb.get("meta_required", []),
            "meta_optional": pb.get("meta_optional", []),
        }
    job = from_dict(Job, data)
    _validate(job)
    return job
