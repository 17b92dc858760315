"""Agent configuration files (a copy of ``nomad_tpu/agent_config.py``;
reference command/agent/config.go and config_parse.go, with the live
Reload of agent.go:1360).

The file is the HCL-shaped surface the jobspec parser reads (or JSON
with the same keys):

    data_dir  = "/var/lib/nomad-tpu"
    http_port = 4646

    server {
      enabled   = true
      workers   = 4
      algorithm = "tpu-binpack"
    }

    client {
      enabled = true
      count   = 1
    }

CLI flags override file values. A SIGHUP re-reads the file and applies
the live-reloadable subset, the scheduler algorithm, without restarting
the agent. The keys of the parts not ported yet (``server_id`` and
``peers``: ROADMAP A10.2; ``region`` and ``authoritative_region``:
federation, set aside; ``plugin_dir``: A10.10) are parsed as the
reference parses them, and the agent refuses to start with them set.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class AgentFileConfig:
    data_dir: str = ""
    http_port: Optional[int] = None
    server_enabled: bool = True
    workers: Optional[int] = None
    algorithm: str = ""
    server_id: str = ""
    peers: str = ""
    client_enabled: bool = True
    client_count: Optional[int] = None
    region: str = ""
    authoritative_region: str = ""
    plugin_dir: str = ""
    raw: Dict = field(default_factory=dict)


def parse_agent_config(text: str, path: str = "<config>") -> AgentFileConfig:
    if path.endswith(".json"):
        body = json.loads(text)
        # JSON form uses nested objects; normalize to the block-list
        # shape the HCL parser produces
        for key in ("server", "client"):
            if isinstance(body.get(key), dict):
                body[key] = [body[key]]
    else:
        from .api.jobspec import _Parser, _tokenize

        body = _Parser(_tokenize(text)).parse_body()
    cfg = AgentFileConfig(raw=body)
    cfg.data_dir = str(body.get("data_dir", "") or "")
    if body.get("http_port") is not None:
        cfg.http_port = int(body["http_port"])
    server = (body.get("server") or [{}])[0]
    cfg.server_enabled = bool(server.get("enabled", True))
    if server.get("workers") is not None:
        cfg.workers = int(server["workers"])
    cfg.algorithm = str(server.get("algorithm", "") or "")
    cfg.server_id = str(server.get("server_id", "") or "")
    cfg.peers = str(server.get("peers", "") or "")
    cfg.region = str(server.get("region", "") or "")
    cfg.authoritative_region = str(
        server.get("authoritative_region", "") or "")
    client = (body.get("client") or [{}])[0]
    cfg.client_enabled = bool(client.get("enabled", True))
    if client.get("count") is not None:
        cfg.client_count = int(client["count"])
    cfg.plugin_dir = str(client.get("plugin_dir", "") or "")
    return cfg


def load_agent_config(path: str) -> AgentFileConfig:
    with open(path) as f:
        return parse_agent_config(f.read(), path)


def apply_to_args(cfg: AgentFileConfig, args, parser_defaults: Dict) -> None:
    """File values fill in wherever the CLI flag was left at its default
    (flags win, files beat built-ins — the reference merge order)."""
    def maybe(attr: str, value) -> None:
        if value is None or value == "":
            return
        if getattr(args, attr, None) == parser_defaults.get(attr):
            setattr(args, attr, value)

    maybe("data_dir", cfg.data_dir)
    maybe("port", cfg.http_port)
    maybe("workers", cfg.workers)
    maybe("algorithm", cfg.algorithm)
    maybe("server_id", cfg.server_id)
    maybe("peers", cfg.peers)
    maybe("region", cfg.region)
    maybe("authoritative_region", cfg.authoritative_region)
    maybe("plugin_dir", cfg.plugin_dir)
    if not cfg.client_enabled:
        # still subject to "flags win": an explicit --clients N beats it
        maybe("clients", 0)
    elif cfg.client_count is not None:
        maybe("clients", cfg.client_count)
    if not cfg.server_enabled:
        # a client-only agent needs a remote-server transport the client
        # doesn't speak yet; fail loudly instead of ignoring the stanza
        raise ValueError(
            "server { enabled = false } is not supported yet: every agent "
            "runs an embedded server (client-only agents need the RPC "
            "client transport)")
