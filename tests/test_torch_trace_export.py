"""The trace export on both packages: ``chrome_trace``,
``phase_breakdown``, ``chain_report`` and ``render_chain`` over the same
span list give the same result, on a seeded synthetic list (nested
spans, gaps filled by trace-less raft work, batch spans listing several
traces, instants) and on the spans a port Server recorded on the CPU;
``write_chrome_trace`` writes the same file."""

from __future__ import annotations

import json

import numpy as np
import pytest

from nomad_tpu.obs import export as ref_export
from nomad_tpu_torch import mock
from nomad_tpu_torch.core.server import Server, ServerConfig
from nomad_tpu_torch.obs import TRACER
from nomad_tpu_torch.obs import export as port_export

EXPORTS = ("chrome_trace", "phase_breakdown")


def synthetic_spans(seed: int, n_traces: int = 12):
    """Span records ``(name, trace, parent, id, t0, t1, thread, args)``
    for ``n_traces`` evals walking the eval chain, with a raft span in
    some gaps, a batch span listing several traces and an instant."""
    rng = np.random.default_rng(seed)
    spans, sid = [], 0
    t = 1000.0
    traces = [f"ev-{i:03d}" for i in range(n_traces)]
    for tr in traces:
        t0 = t + float(rng.uniform(0, 0.01))
        for name in ref_export.EVAL_CHAIN:
            if rng.random() < 0.1 and name != "eval.queued":
                continue  # a chain with a hole
            d = float(rng.uniform(1e-4, 5e-3))
            sid += 1
            spans.append((name, tr, 0, sid, t0, t0 + d, "worker-0",
                          {"i": sid}))
            if name == "worker.schedule":
                sid += 1
                spans.append(("worker.tensor_build", tr, sid - 1, sid,
                              t0 + d / 4, t0 + d / 2, "worker-0", {}))
            gap = float(rng.uniform(0, 2e-3))
            if gap > 1e-3:
                sid += 1
                spans.append(("raft.fsync", None, 0, sid, t0 + d,
                              t0 + d + gap, "raft", {"n": 3}))
            t0 += d + gap
        t = t0
    sid += 1
    spans.append(("plan.commit", None, 0, sid, t, t + 0.002, "applier",
                  {"traces": traces[:4]}))
    sid += 1
    spans.append(("eval.ack", traces[0], 0, sid, t, t, "worker-1", {}))
    spans.sort(key=lambda r: r[4])
    return spans, traces


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_export_equals_reference_on_synthetic_spans(seed):
    spans, traces = synthetic_spans(seed)
    for fn in EXPORTS:
        assert getattr(port_export, fn)(spans) == \
            getattr(ref_export, fn)(spans), fn
    for tr in traces:
        want = ref_export.chain_report(spans, tr)
        got = port_export.chain_report(spans, tr)
        assert got == want, tr
        assert port_export.render_chain(got) == ref_export.render_chain(want)
        assert port_export.spans_for_trace(spans, tr) == \
            ref_export.spans_for_trace(spans, tr)
    assert port_export.chain_report(spans, "none") == \
        ref_export.chain_report(spans, "none")
    assert port_export.chrome_trace([]) == ref_export.chrome_trace([])


def test_written_file_equals_reference(tmp_path):
    spans, _ = synthetic_spans(3)
    for pkg, name in ((ref_export, "ref.json"), (port_export, "port.json")):
        pkg.write_chrome_trace(str(tmp_path / name), spans)
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == ref
    assert port["otherData"]["phases"] == port_export.phase_breakdown(spans)


def test_export_equals_reference_on_a_server_run():
    """The spans a port Server records for a few jobs (CPU): both
    exports agree, and every committed eval's chain is complete."""
    TRACER.clear()
    with Server(ServerConfig(num_workers=2, device="cpu",
                             heartbeat_ttl=3600, gc_interval=3600)) as srv:
        mock.build_nodes(srv.store, 16)
        jobs = [mock.service_job(3, cpu=50, mem=32) for _ in range(4)]
        for j in jobs:
            srv.register_job(j)
        assert srv.wait_for_idle(10.0)
        evals = [e for j in jobs
                 for e in srv.store.snapshot().evals_by_job(j.id)]
    spans = TRACER.spans()
    assert spans
    for fn in EXPORTS:
        assert getattr(port_export, fn)(spans) == \
            getattr(ref_export, fn)(spans), fn
    for ev in evals:
        rep = port_export.chain_report(spans, ev.trace())
        assert rep == ref_export.chain_report(spans, ev.trace())
        assert rep["complete"], port_export.render_chain(rep)
