"""Client-side service health checks (a copy of
``nomad_tpu/client/checks.py``; reference the nomad provider's
checks_hook and client/serviceregistration/checks/): HTTP and TCP checks
run on the client at their interval, and their results fold into the
alloc's deployment health (client/allochealth/tracker.go)."""

from __future__ import annotations

import socket
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..structs.services import ServiceCheck


def service_address(alloc, node, port_label: str) -> Tuple[str, int]:
    """Resolve a service/check address: the node's fingerprinted ip (or
    loopback) + the alloc's assigned port for the label. A numeric
    'label' is taken as a literal port."""
    addr = "127.0.0.1"
    if node is not None:
        addr = node.attributes.get("unique.network.ip-address", addr) or addr
    if port_label and str(port_label).isdigit():
        return addr, int(port_label)
    for p in (alloc.allocated_ports or []):
        if p.label == port_label:
            return addr, p.value
    return addr, 0


def run_check(check: ServiceCheck, address: str, port: int) -> Tuple[bool, str]:
    """One check execution -> (healthy, detail)."""
    if port <= 0:
        return False, f"no port for label {check.port_label!r}"
    if check.type == "tcp":
        try:
            with socket.create_connection((address, port),
                                          timeout=check.timeout_s):
                return True, "tcp connect ok"
        except OSError as e:
            return False, f"tcp connect failed: {e}"
    if check.type == "http":
        url = f"http://{address}:{port}{check.path}"
        try:
            req = urllib.request.Request(url, method=check.method)
            with urllib.request.urlopen(req, timeout=check.timeout_s) as resp:
                if 200 <= resp.status < 300:
                    return True, f"http {resp.status}"
                return False, f"http {resp.status}"
        except Exception as e:
            return False, f"http failed: {e}"
    return False, f"unknown check type {check.type!r}"


class CheckRunner:
    """Runs every check of one allocation's services on its interval.
    Thread-safe status map consumed by the alloc health tracker."""

    def __init__(self, alloc, tg, node,
                 on_change: Optional[Callable] = None):
        self.alloc = alloc
        self.node = node
        self.on_change = on_change
        self._checks: List[tuple] = []  # (key, ServiceCheck, addr, port)
        self._status: Dict[str, tuple] = {}  # key -> (ok, detail, ts)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from ..structs.services import collect_services

        seq = 0
        for task_name, svc in collect_services(tg):
            for i, raw in enumerate(svc.checks or []):
                check = ServiceCheck.from_obj(raw)
                label = check.port_label or svc.port_label
                addr, port = service_address(alloc, node, label)
                # the sequence number keeps keys unique even when two
                # tasks declare same-named services/checks
                key = f"{seq}.{task_name or '_group'}.{svc.name}.{check.name or i}"
                seq += 1
                self._checks.append((key, check, addr, port))

    def has_checks(self) -> bool:
        return bool(self._checks)

    def start(self) -> None:
        if not self._checks or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"checks-{self.alloc.id[:8]}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        next_due = {key: 0.0 for key, *_ in self._checks}
        while not self._stop.wait(0.2):
            now = time.time()
            changed = False
            for key, check, addr, port in self._checks:
                if now < next_due[key]:
                    continue
                next_due[key] = now + max(check.interval_s, 0.5)
                ok, detail = run_check(check, addr, port)
                with self._lock:
                    prev = self._status.get(key)
                    self._status[key] = (ok, detail, now)
                if prev is None or prev[0] != ok:
                    changed = True
            if changed and self.on_change is not None:
                self.on_change()

    def all_passing(self) -> bool:
        """True once every check has run at least once and passes."""
        with self._lock:
            if len(self._status) < len(self._checks):
                return False
            return all(ok for ok, _, _ in self._status.values())
