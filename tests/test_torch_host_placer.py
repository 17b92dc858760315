"""The host placer behind "binpack" and "spread"
(nomad_tpu_torch/scheduler/placer.py HostPlacer, reference
nomad_tpu/scheduler/placer.py:23-76): the same pinned jobs through the
JAX package's Harness and the port's Harness(device="cpu"), and through
both packages' Servers (one worker, pinned ids), give the same per-job
fingerprint under each algorithm. The default ServerConfig places. An
injected placer turns the per-node-pool algorithm override off (the
reference's _placer_injected hazard)."""

import numpy as np
import pytest

import bench
from nomad_tpu import mock as ref_mock
from nomad_tpu.core import server as ref_server
from nomad_tpu.scheduler import placer as ref_placer
from nomad_tpu.structs import Spread as RefSpread
from nomad_tpu.structs.operator import SchedulerConfiguration
from nomad_tpu.testing import Harness
from nomad_tpu_torch import convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.core import server as port_server
from nomad_tpu_torch.scheduler import placer as port_placer
from nomad_tpu_torch.scheduler.generic_sched import GenericScheduler
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor.placer import TorchPlacer
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_bulk_scan import over_capacity
from test_torch_pipeline import fingerprint, node_record, port_service  # noqa: F401
from test_torch_server import _pin_ids, _register_all, _server
from test_torch_spread_pipeline import job_record

ALGS = ("binpack", "spread")
N_NODES = 48


def _ref_jobs(tag):
    """A batch group (expanded to per-alloc requests), a service group
    (the log2 limit) and a rack-spread group (the widened limit)."""
    jobs = [bench.service_job(60, cpu=500, mem=256, batch=True),
            bench.service_job(12, cpu=900, mem=512),
            bench.service_job(20, cpu=300, mem=128, spreads=[
                RefSpread(attribute="${attr.rack}", weight=50)])]
    for i, j in enumerate(jobs):
        j.id = j.name = f"host-{tag}-{i}"
    return jobs


def _same(got, want):
    assert set(got) == set(want)
    for jid in want:
        assert got[jid][:2] == want[jid][:2], jid
        assert np.allclose(got[jid][2], want[jid][2], rtol=0,
                           atol=1e-12), jid


@pytest.mark.parametrize("alg", ALGS)
def test_harness_fingerprint_equals_reference(alg, port_service):
    ref = Harness()
    bench.build_nodes(ref.store, N_NODES)
    jobs = _ref_jobs(alg)
    records = [job_record(j) for j in jobs]
    cfg = SchedulerConfiguration(scheduler_algorithm=alg)
    for i, j in enumerate(jobs):
        ref.store.upsert_job(j)
        ref.process(ref_mock.eval_for(j, id=f"host-ev-{alg}-{i}"),
                    sched_config=cfg)
    want = fingerprint(ref.store, jobs)
    assert sum(fp[0] for fp in want.values()) == 92

    h = PortHarness(device="cpu")
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        h.store.upsert_node(n)
    pcfg = port_operator.SchedulerConfiguration(scheduler_algorithm=alg)
    pjobs = [convert.job_from_record(r) for r in records]
    for i, j in enumerate(pjobs):
        h.store.upsert_job(j)
        h.process(port_mock.eval_for(j, id=f"host-ev-{alg}-{i}"),
                  sched_config=pcfg)
    _same(fingerprint(h.store, pjobs), want)
    assert over_capacity(h.store) == []
    assert port_service.stats["launches"] == 0   # no device code


@pytest.mark.parametrize("alg", ALGS)
def test_server_fingerprint_equals_reference(alg, monkeypatch, port_service):
    _pin_ids(monkeypatch)
    ref = ref_server.Server(ref_server.ServerConfig(
        num_workers=1, eval_batch_size=1, heartbeat_ttl=3600,
        gc_interval=3600, nack_timeout=900.0,
        sched_config=SchedulerConfiguration(scheduler_algorithm=alg)))
    bench.build_nodes(ref.store, N_NODES)
    jobs = _ref_jobs(f"srv-{alg}")
    records = [job_record(j) for j in jobs]
    ref_stats = _register_all(ref, jobs)
    want = fingerprint(ref.store, jobs)
    assert sum(fp[0] for fp in want.values()) == 92

    srv = _server(alg, num_workers=1, eval_batch_size=1, nack_timeout=900.0)
    for n in convert.nodes_from_records(
            [node_record(n) for n in ref.store.snapshot().nodes()]):
        srv.store.upsert_node(n)
    pjobs = [convert.job_from_record(r) for r in records]
    stats = _register_all(srv, pjobs)
    _same(fingerprint(srv.store, pjobs), want)
    for key in ("applied", "nodes_rejected", "partial_commits"):
        assert stats[key] == ref_stats[key], key
    assert over_capacity(srv.store) == []
    assert port_service.stats["launches"] == 0


def test_default_server_config_places(port_service):
    cfg = port_server.ServerConfig(num_workers=2, device="cpu")
    assert cfg.sched_config.scheduler_algorithm == "binpack"
    with port_server.Server(cfg) as srv:
        port_mock.build_nodes(srv.store, 16)
        job = port_mock.service_job(40, cpu=200, mem=128)
        srv.register_job(job)
        assert srv.wait_for_idle(30.0)
        live = [a for a in srv.store.snapshot().allocs_by_job(job.id)
                if not a.terminal_status()]
        assert len(live) == 40
    assert over_capacity(srv.store) == []
    assert port_service.stats["launches"] == 0


@pytest.mark.parametrize("alg", ALGS + ("some-future-algorithm",))
def test_factory_maps_every_host_algorithm(alg):
    for pkg in (ref_placer, port_placer):
        p = pkg.placer_for_algorithm(alg)
        assert type(p).__name__ == "HostPlacer" and p.algorithm == alg
    # the device argument is the TorchPlacer's; the host placer ignores it
    assert port_placer.placer_for_algorithm(alg, device="cpu").algorithm == alg
    assert isinstance(port_placer.placer_for_algorithm(
        "tpu-binpack", device="cpu"), TorchPlacer)


def test_injected_placer_turns_pool_override_off(monkeypatch,
                                                port_service):
    """The reference's hazard, kept: with a placer passed in,
    ``_placer_injected`` is set and a node pool's algorithm override no
    longer swaps the placer; without one the override's host placer
    places."""
    from nomad_tpu_torch.scheduler import generic_sched

    h = PortHarness(device="cpu")
    port_mock.build_nodes(h.store, 32)
    h.store.upsert_node_pool(port_operator.NodePool(
        name="default",
        scheduler_configuration=port_operator.NodePoolSchedulerConfiguration(
            scheduler_algorithm="spread")))
    cfg = port_operator.SchedulerConfiguration(scheduler_algorithm="binpack")
    ran = []

    class Recording(port_placer.HostPlacer):
        def place(self, *args, **kw):
            ran.append(self.algorithm)
            return super().place(*args, **kw)

    monkeypatch.setattr(generic_sched, "placer_for_algorithm",
                        lambda alg, device=None: Recording(alg))
    assert not GenericScheduler(h.store.snapshot(), h, sched_config=cfg,
                                device="cpu")._placer_injected
    assert GenericScheduler(h.store.snapshot(), h, sched_config=cfg,
                            placer=Recording("binpack"),
                            device="cpu")._placer_injected
    jobs = [port_mock.service_job(8, cpu=100, mem=64) for _ in range(2)]
    for j in jobs:
        h.store.upsert_job(j)
    h.process(port_mock.eval_for(jobs[0]), sched_config=cfg)
    h.process(port_mock.eval_for(jobs[1]), sched_config=cfg,
              placer=Recording("binpack"))
    # the pool's override swapped the placer for "spread"; the injected
    # one kept "binpack"
    assert ran == ["spread", "binpack"]
    snap = h.store.snapshot()
    assert [len(snap.allocs_by_job(j.id)) for j in jobs] == [8, 8]
    assert port_service.stats["launches"] == 0
