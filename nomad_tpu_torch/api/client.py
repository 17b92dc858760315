"""Python client of the /v1 HTTP agent (a trimmed copy of
``nomad_tpu/api/client.py``; reference api/ package).

Blocking queries pass ``(index, wait)`` as the reference QueryOptions
do, and every request carries an ``X-Nomad-Deadline`` header (now plus
the client's timeout) that the agent answers with 504 once passed. The
reference's 429 retry budget is not ported: the port's agent has no
admission layer and never answers 429 (ROADMAP A10.7). The routes of
ACLs, variables, dispatch, the client's exec sessions and agent join
are left with the agent's (ROADMAP A10).
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlencode

from ..structs.job import Job
from .codec import to_dict


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class ApiClient:
    def __init__(self, address: str = "http://127.0.0.1:4646",
                 namespace: str = "default", timeout: float = 35.0):
        self.address = address.rstrip("/")
        self.namespace = namespace
        self.timeout = timeout

    # -- transport --

    def _request(self, method: str, path: str, body: Any = None,
                 params: Optional[Dict[str, str]] = None,
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[Any, int]:
        out, index, _ = self.request(method, path, body, params, headers)
        return out, index

    def request(self, method: str, path: str, body: Any = None,
                params: Optional[Dict[str, str]] = None,
                headers: Optional[Dict[str, str]] = None):
        """One call: returns (payload, X-Nomad-Index, response headers);
        raises ``ApiError`` on a status >= 400."""
        url = f"{self.address}{path}"
        params = dict(params or {})
        params.setdefault("namespace", self.namespace)
        url += "?" + urlencode({k: str(v) for k, v in params.items()})
        data = None
        if body is not None:
            data = json.dumps(to_dict(body)).encode()
        deadline = time.time() + self.timeout
        hdrs = {"Content-Type": "application/json",
                "X-Nomad-Deadline": f"{deadline:.6f}"}
        hdrs.update(headers or {})
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read() or b"null")
                index = int(resp.headers.get("X-Nomad-Index") or 0)
                return payload, index, dict(resp.headers)
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001 - a body that is not JSON
                msg = str(e)
            raise ApiError(e.code, msg) from e

    def get(self, path: str, **params):
        return self._request("GET", path, params=params)

    # -- jobs (reference api/jobs.go) --

    def register_job(self, job) -> str:
        payload = {"job": to_dict(job) if isinstance(job, Job) else job}
        out, _ = self._request("POST", "/v1/jobs", payload)
        return out["eval_id"]

    def parse_job(self, spec: str, variables: Optional[dict] = None) -> dict:
        """Server-side parsing of an HCL-like or JSON jobspec."""
        body = {"job_hcl": spec}
        if variables:
            body["variables"] = variables
        out, _ = self._request("POST", "/v1/jobs/parse", body)
        return out

    def plan_job(self, job) -> dict:
        """Dry-run an update (reference api/jobs.go Plan)."""
        payload = {"job": to_dict(job) if isinstance(job, Job) else job}
        job_id = payload["job"]["id"]
        out, _ = self._request("POST", f"/v1/job/{job_id}/plan", payload)
        return out

    def list_jobs(self, prefix: str = "") -> List[dict]:
        out, _ = self.get("/v1/jobs", prefix=prefix)
        return out

    def job(self, job_id: str) -> dict:
        out, _ = self.get(f"/v1/job/{job_id}")
        return out

    def job_versions(self, job_id: str) -> List[dict]:
        out, _ = self.get(f"/v1/job/{job_id}/versions")
        return out

    def job_allocations(self, job_id: str) -> List[dict]:
        out, _ = self.get(f"/v1/job/{job_id}/allocations")
        return out

    def job_evaluations(self, job_id: str) -> List[dict]:
        out, _ = self.get(f"/v1/job/{job_id}/evaluations")
        return out

    def job_deployments(self, job_id: str) -> List[dict]:
        out, _ = self.get(f"/v1/job/{job_id}/deployments")
        return out

    def deregister_job(self, job_id: str, purge: bool = False) -> str:
        out, _ = self._request("DELETE", f"/v1/job/{job_id}",
                               params={"purge": str(purge).lower()})
        return out.get("eval_id", "")

    def evaluate_job(self, job_id: str) -> str:
        out, _ = self._request("POST", f"/v1/job/{job_id}/evaluate")
        return out["eval_id"]

    def scale_job(self, job_id: str, task_group: str, count: int) -> str:
        out, _ = self._request("POST", f"/v1/job/{job_id}/scale",
                               {"task_group": task_group, "count": count})
        return out["eval_id"]

    def job_scale_status(self, job_id: str) -> dict:
        out, _ = self.get(f"/v1/job/{job_id}/scale")
        return out

    def revert_job(self, job_id: str, job_version: int) -> str:
        out, _ = self._request("POST", f"/v1/job/{job_id}/revert",
                               {"job_version": job_version})
        return out["eval_id"]

    def scaling_policies(self) -> List[dict]:
        out, _ = self.get("/v1/scaling/policies")
        return out

    # -- deployments (reference api/deployments.go) --

    def list_deployments(self) -> List[dict]:
        out, _ = self.get("/v1/deployments")
        return out

    def deployment(self, dep_id: str) -> dict:
        out, _ = self.get(f"/v1/deployment/{dep_id}")
        return out

    def promote_deployment(self, dep_id: str,
                           groups: Optional[List[str]] = None) -> str:
        body = {"groups": groups} if groups is not None else {}
        out, _ = self._request("POST", f"/v1/deployment/promote/{dep_id}",
                               body)
        return out.get("eval_id", "")

    def fail_deployment(self, dep_id: str) -> None:
        self._request("POST", f"/v1/deployment/fail/{dep_id}", {})

    # -- nodes (reference api/nodes.go) --

    def list_nodes(self) -> List[dict]:
        out, _ = self.get("/v1/nodes")
        return out

    def node(self, node_id: str) -> dict:
        out, _ = self.get(f"/v1/node/{node_id}")
        return out

    def node_allocations(self, node_id: str) -> List[dict]:
        out, _ = self.get(f"/v1/node/{node_id}/allocations")
        return out

    def drain_node(self, node_id: str, drain_spec: Optional[dict] = None,
                   mark_eligible: bool = False) -> None:
        self._request("POST", f"/v1/node/{node_id}/drain",
                      {"drain_spec": drain_spec,
                       "mark_eligible": mark_eligible})

    def set_node_eligibility(self, node_id: str, eligible: bool) -> None:
        self._request("POST", f"/v1/node/{node_id}/eligibility",
                      {"eligibility": "eligible" if eligible
                       else "ineligible"})

    # -- allocations / evaluations --

    def list_allocations(self, prefix: str = "") -> List[dict]:
        out, _ = self.get("/v1/allocations", prefix=prefix)
        return out

    def allocation(self, alloc_id: str) -> dict:
        out, _ = self.get(f"/v1/allocation/{alloc_id}")
        return out

    def stop_alloc(self, alloc_id: str) -> str:
        """Stop and reschedule one allocation; returns the eval id."""
        out, _ = self._request("POST", f"/v1/allocation/{alloc_id}/stop", {})
        return out["eval_id"]

    def alloc_logs(self, alloc_id: str, task: str = "",
                   log_type: str = "stdout", offset: int = 0,
                   limit: int = 65536) -> dict:
        """A task's captured log (reference api/fs.go Logs)."""
        out, _ = self.get(f"/v1/client/fs/logs/{alloc_id}", task=task,
                          type=log_type, offset=offset, limit=limit)
        out["data"] = base64.b64decode(out.get("data", "") or "")
        return out

    def alloc_fs_ls(self, alloc_id: str, path: str = "/") -> list:
        out, _ = self._request("GET", f"/v1/client/fs/ls/{alloc_id}",
                               params={"path": path})
        return out

    def alloc_fs_stat(self, alloc_id: str, path: str) -> dict:
        out, _ = self._request("GET", f"/v1/client/fs/stat/{alloc_id}",
                               params={"path": path})
        return out

    def alloc_fs_cat(self, alloc_id: str, path: str, offset: int = 0,
                     limit: int = 65536) -> bytes:
        out, _ = self._request("GET", f"/v1/client/fs/cat/{alloc_id}",
                               params={"path": path, "offset": offset,
                                       "limit": limit})
        return base64.b64decode(out.get("data", "") or "")

    def list_services(self) -> list:
        out, _ = self.get("/v1/services")
        return out

    def service(self, name: str) -> list:
        out, _ = self.get(f"/v1/service/{name}")
        return out

    def list_evaluations(self) -> List[dict]:
        out, _ = self.get("/v1/evaluations")
        return out

    def evaluation(self, eval_id: str) -> dict:
        out, _ = self.get(f"/v1/evaluation/{eval_id}")
        return out

    def search(self, prefix: str, context: str = "all") -> dict:
        out, _ = self.get("/v1/search", prefix=prefix, context=context)
        return out

    # -- namespaces / node pools / volumes / system --

    def list_namespaces(self) -> List[dict]:
        out, _ = self.get("/v1/namespaces")
        return out

    def apply_namespace(self, name: str, description: str = "") -> None:
        self._request("POST", f"/v1/namespace/{name}",
                      {"description": description})

    def delete_namespace(self, name: str) -> None:
        self._request("DELETE", f"/v1/namespace/{name}")

    def list_node_pools(self) -> List[dict]:
        out, _ = self.get("/v1/node/pools")
        return out

    def apply_node_pool(self, name: str, body: dict) -> None:
        self._request("POST", f"/v1/node/pool/{name}", body)

    def delete_node_pool(self, name: str) -> None:
        self._request("DELETE", f"/v1/node/pool/{name}")

    def list_volumes(self) -> List[dict]:
        out, _ = self.get("/v1/volumes")
        return out

    def register_volume(self, vol_id: str, body: dict) -> None:
        self._request("POST", f"/v1/volume/csi/{vol_id}", body)

    def deregister_volume(self, vol_id: str, force: bool = False) -> None:
        self._request("DELETE", f"/v1/volume/csi/{vol_id}",
                      params={"force": str(force).lower()})

    def system_gc(self) -> dict:
        out, _ = self._request("PUT", "/v1/system/gc", {})
        return out

    # -- operator and agent --

    def scheduler_configuration(self) -> dict:
        out, _ = self.get("/v1/operator/scheduler/configuration")
        return out

    def set_scheduler_configuration(self, cfg) -> None:
        self._request("PUT", "/v1/operator/scheduler/configuration", cfg)

    def raft_configuration(self) -> dict:
        out, _ = self.get("/v1/operator/raft/configuration")
        return out

    def raft_remove_peer(self, server_id: str) -> None:
        self._request("DELETE", "/v1/operator/raft/peer",
                      params={"id": server_id})

    def snapshot_save(self) -> dict:
        """The whole state as a dump (operator snapshot save)."""
        out, _ = self.get("/v1/operator/snapshot")
        return out

    def snapshot_restore(self, data: dict) -> int:
        out, _ = self._request("POST", "/v1/operator/snapshot", data)
        return out.get("index", 0)

    def leader(self) -> Any:
        out, _ = self.get("/v1/status/leader")
        return out

    def agent_self(self) -> dict:
        out, _ = self.get("/v1/agent/self")
        return out

    def metrics(self) -> dict:
        out, _ = self.get("/v1/metrics")
        return out

    def metrics_prometheus(self) -> str:
        url = (f"{self.address}/v1/metrics?"
               + urlencode({"format": "prometheus",
                            "namespace": self.namespace}))
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read().decode()

    def traces(self, limit: int = 500) -> dict:
        out, _ = self.get("/v1/traces", limit=limit)
        return out

    # -- event stream (reference api/event.go) --

    def stream_events(self, topics: Optional[List[str]] = None,
                      wait_s: float = 2.0):
        """Yield event dicts from /v1/event/stream until the server's
        wait window closes."""
        params = [("wait", str(wait_s))] + [("topic", t)
                                            for t in topics or []]
        params.append(("namespace", self.namespace))
        url = f"{self.address}/v1/event/stream?{urlencode(params)}"
        with urllib.request.urlopen(url, timeout=wait_s + 10) as resp:
            for line in resp:
                line = line.strip()
                if line:
                    yield json.loads(line)

    # -- blocking query helper (reference QueryOptions WaitIndex) --

    def blocking(self, path: str, index: int, wait_s: float = 5.0):
        """A GET that parks server-side until the store passes
        ``index``: returns (payload, X-Nomad-Index)."""
        return self._request("GET", path,
                             params={"index": str(index),
                                     "wait": str(wait_s)})
