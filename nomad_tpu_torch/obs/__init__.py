"""Eval-lifecycle tracing, the flight recorder and the metrics registry
(reference ``nomad_tpu/obs/__init__.py`` and ``nomad_tpu/core/metrics.py``):
the process-global singletons the Server path reports to. Each is a leaf:
the tensor layer and the core import them and nothing else of ``obs``.

- ``TRACER``: named spans in per-thread bounded rings (obs/trace.py);
  every closed span also lands in the ``nomad.eval.phase.<name>``
  histogram of ``REGISTRY``.
- ``RECORDER``: per-subsystem bounded event rings (obs/recorder.py).
- ``REGISTRY``: counters, gauges, timings, histograms (obs/metrics.py;
  the reference keeps it in ``core/metrics.py``).

The exporters are ``obs/export.py`` (Chrome trace, phase breakdown,
span-chain reports; ``/v1/traces`` serves them) and ``python -m
nomad_tpu_torch.obs`` (``--export``, ``--trace-smoke``). The reference's
``NOMAD_TPU_TRACE=0`` kill switch and its ring-size variables are not
ported: the port's rings are fixed (``RING_CAP``, ``RING_EVENTS``), and
a tracer or recorder whose ``enabled`` is false records nothing.
"""

from .metrics import REGISTRY, Registry
from .recorder import RECORDER, FlightRecorder
from .trace import NULL_SPAN, TRACER, Tracer

__all__ = ["TRACER", "Tracer", "RECORDER", "FlightRecorder", "REGISTRY",
           "Registry", "NULL_SPAN"]
