"""The port's tracer, flight recorder and metrics registry
(nomad_tpu_torch/obs: trace.py, recorder.py, metrics.py) against the JAX
package's: the same sequence of calls through both gives the same span
names, nesting, traces and args, the same bounded rings and the same
counts."""

import threading

import pytest

from nomad_tpu.core import metrics as ref_metrics
from nomad_tpu.obs import recorder as ref_recorder
from nomad_tpu.obs import trace as ref_trace
from nomad_tpu_torch.obs import metrics as port_metrics
from nomad_tpu_torch.obs import recorder as port_recorder
from nomad_tpu_torch.obs import trace as port_trace

PACKAGES = ((ref_trace, ref_recorder, ref_metrics),
            (port_trace, port_recorder, port_metrics))


def drive(trace_mod, ring_cap=64):
    """One call sequence: nested spans under a bind, a span naming its
    own trace, args set mid-span, an instant, a retroactive span, and a
    second thread's spans. Returns the tracer."""
    tr = trace_mod.Tracer(enabled=True, ring_cap=ring_cap)
    with tr.bind("ev-1"):
        with tr.span("worker.schedule", type="batch"):
            with tr.span("worker.tensor_build", n=256) as sp:
                sp.set(changed=3)
            with tr.span("plan.submit"):
                tr.event("eval.enqueued", job="j1")
        with tr.span("plan.verify", trace="ev-2"):
            with tr.span("plan.commit_round", n=2, traces=["ev-1", "ev-2"]):
                pass
    tr.add_span("eval.queued", 10.0, 10.5, trace="ev-3", deliveries=1)

    def other():
        with tr.span("solver.wait", k=300, joint=False):
            pass

    t = threading.Thread(target=other, name="worker-7")
    t.start()
    t.join()
    return tr


def shape(trace_mod, tr):
    """The records without clocks and ids: (name, trace, parent's name,
    thread, args), in record order per thread."""
    recs = []
    for ring in tr._rings.values():
        recs.extend(ring.snapshot())
    by_id = {r[trace_mod.R_ID]: r for r in recs}
    out = []
    for r in recs:
        parent = by_id.get(r[trace_mod.R_PARENT])
        out.append((r[trace_mod.R_NAME], r[trace_mod.R_TRACE],
                    parent[trace_mod.R_NAME] if parent else None,
                    r[trace_mod.R_THREAD] if r[trace_mod.R_THREAD]
                    == "worker-7" else "main", dict(r[trace_mod.R_ARGS])))
    return sorted(out, key=repr)


def test_same_spans_nesting_and_traces():
    got = [shape(mods[0], drive(mods[0])) for mods in PACKAGES]
    assert got[0] == got[1]
    names = [r[0] for r in got[1]]
    assert sorted(names) == sorted([
        "worker.tensor_build", "eval.enqueued", "plan.submit",
        "worker.schedule", "plan.commit_round", "plan.verify",
        "eval.queued", "solver.wait"])
    nested = {r[0]: (r[1], r[2]) for r in got[1]}
    assert nested["worker.tensor_build"] == ("ev-1", "worker.schedule")
    assert nested["plan.commit_round"] == ("ev-2", "plan.verify")
    assert nested["solver.wait"] == (None, None)
    # record layout constants agree
    for name in ("R_NAME", "R_TRACE", "R_PARENT", "R_ID", "R_T0", "R_T1",
                 "R_THREAD", "R_ARGS"):
        assert getattr(ref_trace, name) == getattr(port_trace, name)


@pytest.mark.parametrize("cap", [1, 3, 5])
def test_rings_are_bounded_alike(cap):
    got = []
    for trace_mod, _, _ in PACKAGES:
        tr = trace_mod.Tracer(enabled=True, ring_cap=cap)
        for i in range(7):
            with tr.span(f"s{i}"):
                pass
        got.append([r[trace_mod.R_NAME] for r in tr.spans()])
    assert got[0] == got[1] == [f"s{i}" for i in range(7 - cap, 7)]


def test_disabled_and_cleared_tracers_record_nothing():
    for trace_mod, _, _ in PACKAGES:
        off = trace_mod.Tracer(enabled=False)
        assert off.span("x") is trace_mod.NULL_SPAN
        assert off.bind("t") is trace_mod.NULL_SPAN
        with off.span("x"):
            off.event("y")
            off.add_span("z", 0.0, 1.0)
        assert off.spans() == []
        on = drive(trace_mod)
        assert len(on.spans()) == 8
        on.clear()
        assert on.spans() == []
        with on.span("after"):
            pass
        assert [r[trace_mod.R_NAME] for r in on.spans()] == ["after"]


def test_recorder_rings_alike():
    got = []
    for _, rec_mod, _ in PACKAGES:
        rec = rec_mod.FlightRecorder(enabled=True, ring_events=3)
        for i in range(5):
            rec.record("broker", "enqueue", eval=f"e{i}")
        rec.record("plan", "partial_reject", n=2)
        got.append(([(s, ev, f) for _, s, _, ev, f in rec.events()],
                    [(s, ev, f) for _, s, _, ev, f in rec.events("plan")],
                    len(rec.dump_text().splitlines())))
        rec.clear()
        assert rec.events() == []
        off = rec_mod.FlightRecorder(enabled=False)
        off.record("broker", "enqueue")
        assert off.events() == []
    assert got[0] == got[1]
    assert [f["eval"] for s, _, f in got[1][0] if s == "broker"] == [
        "e2", "e3", "e4"]


def test_registry_counts_alike():
    got = []
    for trace_mod, _, met_mod in PACKAGES:
        reg = met_mod.Registry()
        reg.incr("nomad.plan.submit")
        reg.incr("nomad.plan.node_rejected", 3)
        reg.set_gauge("nomad.plan.queue_depth", 4)
        reg.set_gauge("nomad.plan.queue_depth", 2)
        with reg.time("nomad.plan.evaluate"):
            pass
        for v in (0.001, 0.002, 0.003, 0.004):
            reg.observe("nomad.eval.enqueue_to_commit", v)
        dump = reg.dump()
        got.append((
            sorted(dump),
            {k: v for k, v in dump.items() if not isinstance(v, dict)},
            {k: v["count"] for k, v in dump.items() if isinstance(v, dict)},
            reg.percentile("nomad.eval.enqueue_to_commit", 0.5),
            reg.get("nomad.plan.node_rejected"),
            reg.get("nomad.plan.queue_depth")))
        reg.reset("nomad.plan.submit")
        assert "nomad.plan.submit" not in reg.dump()
        reg.reset()
        assert reg.dump() == {}
    assert got[0] == got[1]
    assert got[1][4] == 3.0 and got[1][5] == 2.0


def test_spans_feed_the_phase_histograms():
    """A closed span observes nomad.eval.phase.<name> in its package's
    global Registry, as the reference's does."""
    for trace_mod, _, met_mod in PACKAGES:
        name = "test.obs_phase"
        key = "nomad.eval.phase." + name
        met_mod.REGISTRY.reset(key)
        tr = trace_mod.Tracer(enabled=True)
        for _ in range(3):
            with tr.span(name):
                pass
        tr.add_span(name, 1.0, 2.0)
        assert met_mod.REGISTRY.dump()[key]["count"] == 4
        met_mod.REGISTRY.reset(key)
