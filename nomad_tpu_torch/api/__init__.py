"""The HTTP API (reference ``nomad_tpu/api/``): the /v1 agent over the
port's Server and its Python client.

- codec.py   -- struct <-> JSON-safe dict conversion
- jobspec.py -- job specification parsing (JSON and the HCL-like surface)
- http.py    -- ``HTTPAgent``, the /v1 routes over a Server or a raft
  cluster's ``ReplicatedServer``
- client.py  -- ``ApiClient``, the Python client of those routes

The dashboard (``ui.py``) is not ported (ROADMAP A10.1).
"""

from .client import ApiClient, ApiError
from .http import HTTPAgent

__all__ = ["ApiClient", "ApiError", "HTTPAgent"]
