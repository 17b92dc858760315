"""The port's node-sharded solve (nomad_tpu_torch/tensor/sharding.py)
against the JAX reference's sharded programs on the CPU.

The JAX side runs nomad_tpu/tensor/sharding.py on conftest's 8 virtual
CPU devices (``node_mesh(jax.devices()[:S])``); the port side runs its
plain versions on a NodeMesh of S CPU devices. B13 (the sharded greedy
fill) and B15 (the sharded scatter) must agree exactly: counts, carry and
the per-eval all-gather rounds. B14 (the sharded joint solve) must agree
exactly on counts, carry, the info row's placed totals, rounds and pick,
and the gather count; its two packing scores to a relative 1e-6 (torch's
and XLA's f32 powf differ by an ulp on a few inputs). The service runs
the pinned 256-node workload of tests/test_c2m_sharded.py on a 4-shard
CPU mesh and must give the JAX package's fingerprint and gather count.
The CUDA kernels run only on the card, where chip_smoke.py holds each
against these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import bench
from nomad_tpu import mock
from nomad_tpu.structs.operator import SchedulerConfiguration
from nomad_tpu.tensor import sharding as ref
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor import prng
from nomad_tpu_torch.tensor import sharding as sh
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.tensor.batch_solver import solve_batch
from nomad_tpu_torch.tensor.kernels import TIE_JITTER, solve_bulk_multi
from nomad_tpu_torch.testing import Harness as PortHarness
from test_torch_pipeline import JOBS, fingerprint, job_record, node_record

SCORE_RTOL = 1e-6


def _mesh(s):
    """S CPU shards."""
    return sh.NodeMesh(["cpu"] * s)


def _bulk_inputs(n=256, g=4, d=4, seed=0):
    """tests/test_sharding.py::TestShardedBulkEngine._bulk_inputs."""
    rng = np.random.RandomState(seed)
    f = np.float32
    avail = np.stack([
        rng.choice([2000, 4000, 8000], n),
        rng.choice([4096, 8192], n),
        np.full(n, 100 * 1024),
        np.full(n, 12001),
    ], axis=1).astype(f)
    used0 = np.zeros((n, d), f)
    used0[:, 0] = rng.randint(0, 1000, n)
    used0[:, 1] = rng.randint(0, 2048, n)
    feas = rng.rand(g, n) > 0.2
    aff = np.zeros((g, n), f)
    aff[0] = np.where(rng.rand(n) > 0.7, 0.5, 0.0)
    ask = np.tile(np.array([500.0, 256.0, 0.0, 0.0], f), (g, 1))
    k = np.full(g, 64, np.int32)
    seeds = np.arange(g).astype(np.uint32)
    cidx = np.zeros(8, np.int32)
    cdelta = np.zeros((8, d), f)
    return avail, used0, feas, aff, ask, k, seeds, cidx, cdelta


def _multi_round_inputs():
    """tests/test_sharding.py::test_parity_multi_round_fill: ~1 alloc a
    node, so top_r=8 pools take many rounds."""
    rng = np.random.RandomState(11)
    n, d, g = 512, 4, 2
    f = np.float32
    avail = np.zeros((n, d), f)
    avail[:, 0] = rng.choice([600, 700], n)
    avail[:, 1] = 4096
    used0 = np.zeros((n, d), f)
    feas = rng.rand(g, n) > 0.1
    aff = np.zeros((g, n), f)
    ask = np.tile(np.array([500.0, 16.0, 0.0, 0.0], f), (g, 1))
    k = np.full(g, 200, np.int32)
    seeds = np.arange(g).astype(np.uint32)
    cidx = np.zeros(8, np.int32)
    cdelta = np.zeros((8, d), f)
    return avail, used0, feas, aff, ask, k, seeds, cidx, cdelta


def _last_shard_correction():
    """tests/test_sharding.py::test_corrections_fold_into_sharded_carry:
    a negative correction on a row of the last shard, nothing to place."""
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = _bulk_inputs(
        seed=5)
    used0[250] = [1000.0, 1024.0, 0.0, 0.0]
    cidx[0] = 250
    cdelta[0] = [-1000.0, -1024.0, 0.0, 0.0]
    return (avail, used0, feas, aff, np.zeros_like(ask), np.zeros_like(k),
            seeds, cidx, cdelta)


def _jax_bulk(s, inputs, top_r=64):
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = inputs
    mesh = ref.node_mesh(jax.devices()[:s])
    us, av = ref.shard_bulk_state(mesh, used0, avail)
    solve = ref.make_solve_bulk_multi_sharded(mesh, top_r=top_r)
    out = solve(us, av, feas, aff, ask, k, seeds, cidx, cdelta,
                g=len(k))
    return [np.asarray(x) for x in out]


def _port_bulk(s, inputs, top_r=64):
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = inputs
    mesh = _mesh(s)
    t = torch.from_numpy
    used, av = sh.shard_bulk_state(mesh, used0.copy(), avail)
    used, counts, rounds = sh.solve_bulk_multi_sharded(
        mesh, used, av, sh.shard_cols(mesh, t(feas)),
        sh.shard_cols(mesh, t(aff)), t(ask), t(k),
        t(seeds.astype(np.int64)), t(cidx), t(cdelta), g=len(k),
        top_r=top_r)
    return (sh.gather_rows(used).numpy(),
            sh.gather_rows(counts, dim=1).numpy(), rounds.numpy())


BULK_CASES = {
    "main": (_bulk_inputs, 64),
    "multi_round": (_multi_round_inputs, 8),
    "last_shard_correction": (_last_shard_correction, 64),
}


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_bulk_sharded_equals_reference(case, s):
    """B13's plain version against make_solve_bulk_multi_sharded: counts,
    carry and rounds exactly equal at every mesh size."""
    make, top_r = BULK_CASES[case]
    inputs = make()
    u_w, c_w, r_w = _jax_bulk(s, inputs, top_r)
    u_g, c_g, r_g = _port_bulk(s, inputs, top_r)
    assert c_g.dtype == np.int16 and r_g.dtype == np.int32
    np.testing.assert_array_equal(c_g, c_w)
    np.testing.assert_array_equal(u_g, u_w)
    np.testing.assert_array_equal(r_g, r_w)
    if case == "multi_round":
        assert int(r_g[0]) > 3 and int(c_g[0].sum()) == 200
    if case == "last_shard_correction":
        assert (u_g[250] == 0.0).all()


@pytest.mark.parametrize("case", ["main", "multi_round"])
def test_bulk_sharded_counts_equal_single_device(case):
    """Counts do not depend on the layout: the sharded fill at S = 4
    places exactly as the port's single-device solve_bulk_multi."""
    make, top_r = BULK_CASES[case]
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = make()
    t = torch.from_numpy
    u1, c1 = solve_bulk_multi(
        t(used0.copy()), t(avail), t(feas), t(aff), t(ask), t(k),
        torch.ones(len(k)), t(seeds.astype(np.int64)), t(cidx), t(cdelta),
        g=len(k))
    u4, c4, _ = _port_bulk(4, make(), top_r)
    np.testing.assert_array_equal(c4, c1.numpy())
    np.testing.assert_array_equal(u4, u1.numpy())


@pytest.mark.parametrize("s", [2, 4, 8])
def test_state_scatter_sharded_equals_reference(s):
    """B15 at S = 2, 4, 8 with duplicate rows and (0, 0) padding
    slots."""
    rng = np.random.default_rng(3)
    n, b = 256, 96
    used0 = rng.integers(0, 5000, (n, 4)).astype(np.float32)
    idx = rng.integers(0, n, b).astype(np.int32)
    idx[10:20] = idx[0]                    # duplicates accumulate
    idx[-16:] = 0                          # padding slots
    delta = rng.integers(-300, 300, (b, 4)).astype(np.float32)
    delta[-16:] = 0.0
    mesh_j = ref.node_mesh(jax.devices()[:s])
    fn = ref.make_state_scatter_sharded(mesh_j, donate=False)
    want = np.asarray(fn(jax.device_put(
        used0, NamedSharding(mesh_j, P("nodes", None))), idx, delta))
    mesh = _mesh(s)
    parts = sh.shard_rows(mesh, torch.from_numpy(used0.copy()))
    got = sh.state_scatter_sharded(mesh, parts, torch.from_numpy(idx),
                                   torch.from_numpy(delta))
    np.testing.assert_array_equal(sh.gather_rows(got).numpy(), want)
    single = used0.copy()
    np.add.at(single, idx, delta)
    np.testing.assert_array_equal(sh.gather_rows(got).numpy(), single)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_state_scatter_sharded_twin_flush_equals_reference(s):
    """B15 at a twin flush's size: 4,096 delta rows, every node touched
    about four times, duplicates and padding, exact at S = 1, 2, 4, 8."""
    rng = np.random.default_rng(11)
    n, b = 1024, 4096
    used0 = rng.integers(0, 50_000, (n, 4)).astype(np.float32)
    idx = rng.integers(0, n, b).astype(np.int32)
    idx[:64] = n - 1                       # a hot row on the last shard
    idx[-128:] = 0                         # padding slots
    delta = rng.integers(-500, 500, (b, 4)).astype(np.float32)
    delta[-128:] = 0.0
    mesh_j = ref.node_mesh(jax.devices()[:s])
    fn = ref.make_state_scatter_sharded(mesh_j, donate=False)
    want = np.asarray(fn(jax.device_put(
        used0, NamedSharding(mesh_j, P("nodes", None))), idx, delta))
    mesh = _mesh(s)
    got = sh.state_scatter_sharded(
        mesh, sh.shard_rows(mesh, torch.from_numpy(used0.copy())),
        torch.from_numpy(idx), torch.from_numpy(delta))
    np.testing.assert_array_equal(sh.gather_rows(got).numpy(), want)


def _joint_problem(evict):
    """tests/test_batch_solver.py::test_solve_batch_sharded_parity's
    problem, or with victim budgets tests/test_preempt_solve.py::
    test_sharded_twin_parity_with_victim_columns's."""
    rng_p = np.random.default_rng(7 if not evict else 13)
    n, g, d = 64, 8, 4
    avail = np.zeros((n, d), np.float32)
    avail[:, 0] = rng_p.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng_p.choice([8192, 16384, 32768], n)
    avail[:, 2] = 100_000
    avail[:, 3] = 1000
    used0 = np.zeros((n, d), np.float32)
    used0[:, 0] = rng_p.integers(0, 2000, n)
    used0[:, 1] = rng_p.integers(0, 4000, n)
    feas = rng_p.random((g, n)) > 0.25
    aff = np.where(rng_p.random((g, n)) > 0.7, 0.3, 0.0).astype(np.float32)
    ask = np.zeros((g, d), np.float32)
    ask[:, 0] = rng_p.integers(50, 400, g)
    ask[:, 1] = rng_p.integers(32, 512, g)
    k = rng_p.integers(10, 150 if not evict else 100, g).astype(np.int32)
    seeds = rng_p.integers(0, 2**31, g).astype(np.uint32)
    cidx = np.array([0, 5], np.int32)
    cdelta = np.zeros((2, d), np.float32)
    cdelta[0, 0] = 300.0
    ev = npr = None
    if evict:
        rng = np.random.default_rng(13)
        used0[:, 0] = avail[:, 0] - 100.0
        used0[:, 1] = avail[:, 1] - 128.0
        ev = np.zeros((n, d), np.float32)
        ev[:, 0] = rng.choice([0, 2000, 4000], n)
        ev[:, 1] = rng.choice([0, 2048], n)
        npr = rng.uniform(10.0, 60.0, n).astype(np.float32)
    return avail, used0, feas, aff, ask, k, seeds, cidx, cdelta, ev, npr


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("evict", [False, True])
def test_joint_sharded_equals_reference(evict, s):
    """B14's plain version against make_solve_batch_sharded: counts,
    carry, info[2:] and gathers exact, the packing scores to 1e-6; the
    counts also equal the port's single-device solve_batch."""
    (avail, used0, feas, aff, ask, k, seeds, cidx, cdelta, ev,
     npr) = _joint_problem(evict)
    g = len(k)
    mesh_j = ref.node_mesh(jax.devices()[:s])
    rows = NamedSharding(mesh_j, P("nodes", None))
    extra = ()
    if evict:
        extra = (jax.device_put(ev, rows),
                 jax.device_put(npr, NamedSharding(mesh_j, P("nodes"))))
    solve = ref.make_solve_batch_sharded(mesh_j)
    want = [np.asarray(x) for x in solve(
        jax.device_put(used0, rows), jax.device_put(avail, rows),
        jnp.asarray(feas), jnp.asarray(aff), jnp.asarray(ask),
        jnp.asarray(k), jnp.asarray(seeds), jnp.asarray(cidx),
        jnp.asarray(cdelta), *extra, g=g)]
    mesh = _mesh(s)
    t = torch.from_numpy
    used, av = sh.shard_bulk_state(mesh, used0.copy(), avail)
    kw = {}
    if evict:
        kw = dict(evict=sh.shard_rows(mesh, t(ev)),
                  net_prio=sh.shard_rows(mesh, t(npr)))
    u, c, info, gathers = sh.solve_batch_sharded(
        mesh, used, av, sh.shard_cols(mesh, t(feas)),
        sh.shard_cols(mesh, t(aff)), t(ask), t(k),
        t(seeds.astype(np.int64)), t(cidx), t(cdelta), g=g, **kw)
    u = sh.gather_rows(u).numpy()
    c = sh.gather_rows(c, dim=1).numpy()
    info = info.numpy()
    np.testing.assert_array_equal(c, want[1])
    np.testing.assert_array_equal(u, want[0])
    np.testing.assert_array_equal(info[2:], want[2][2:])
    np.testing.assert_allclose(info[:2], want[2][:2], rtol=SCORE_RTOL, atol=0)
    assert int(gathers) == int(want[3]) > 0
    single = solve_batch(
        t(used0.copy()), t(avail), t(feas), t(aff), t(ask), t(k),
        t(k.astype(np.float32)), t(seeds.astype(np.int64)), t(cidx),
        t(cdelta), None if ev is None else t(ev),
        None if npr is None else t(npr), g=g)
    np.testing.assert_array_equal(c, single[1].numpy())


@pytest.mark.parametrize("fold", [False, True])
def test_jitter_slice_equals_full_draw(fold):
    """A shard's jitter slice is the full draw's columns, bit for bit."""
    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 12345], dtype=torch.int64)
    n, lo, m = 1024, 384, 256
    if fold:
        his = (TIE_JITTER, TIE_JITTER * 8.0)
        full = prng.jitter_fold(seeds, n, his)
        part = prng.jitter_fold(seeds, m, his, offset=lo)
        want = full[..., lo:lo + m]
    else:
        full = prng.jitter(seeds, n, TIE_JITTER)
        part = prng.jitter(seeds, m, TIE_JITTER, offset=lo)
        want = full[:, lo:lo + m]
    assert torch.equal(part.view(torch.int32), want.view(torch.int32))


def test_mesh_parts_and_gather():
    """Every shard has its own parts, its rows or columns, even where
    the device repeats; the gather fills every shard's buffer."""
    mesh = sh.NodeMesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.cards == 1
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh.indices == (-1,) * 4 and list(mesh.ordinals) == [-1] * 4
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    parts = sh.shard_rows(mesh, x)
    assert len(parts) == 4 and torch.equal(parts[2], x[4:6])
    assert torch.equal(sh.gather_rows(parts), x)
    cols = sh.shard_cols(mesh, x.t().contiguous())
    assert torch.equal(cols[3], x.t()[:, 6:8])
    assert torch.equal(sh.gather_rows(cols, dim=1), x.t())
    bufs = [torch.zeros(4) for _ in range(4)]
    for i, b in enumerate(bufs):
        b[i] = i + 1
    sh.all_gather(mesh, bufs)
    assert all(b.tolist() == [1, 2, 3, 4] for b in bufs)
    with pytest.raises(ValueError):
        mesh.n_loc(10)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    mesh = _mesh(2)
    inputs = _bulk_inputs(n=32, g=2)
    _ext.COUNTS.reset()
    _port_bulk(2, inputs)
    snap = _ext.COUNTS.snapshot()
    assert not any(snap["launches"].values())
    assert not any(snap["plain_on_cuda"].values())
    with pytest.raises(ValueError):
        sh.NodeMesh(["meta", "meta"])
    del mesh


def _reference_pipeline(monkeypatch, alg, mesh_devices):
    """tests/test_c2m_sharded.py::_run_pipeline through the JAX package
    at NOMAD_TPU_MESH_DEVICES=mesh_devices."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", str(mesh_devices))
    svc = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", svc)
    try:
        h = Harness()
        bench.build_nodes(h.store, 256)
        cfg = SchedulerConfiguration(scheduler_algorithm=alg)
        jobs = []
        for i, (count, cpu, mem) in enumerate(JOBS):
            j = bench.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = f"parity-{alg}-{i}"
            jobs.append(j)
        records = [job_record(j) for j in jobs]
        for i, j in enumerate(jobs):
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"parity-ev-{alg}-{i}"),
                      sched_config=cfg)
        return fingerprint(h.store, jobs), h, records, dict(svc.stats)
    finally:
        svc.stop()


@pytest.mark.parametrize("alg", ["tpu-binpack", "tpu-solve"])
def test_sharded_service_fingerprint_equals_reference(monkeypatch, alg):
    """The port's service on a 4-shard CPU mesh, through
    Harness(device="cpu"), gives the JAX package's fingerprint on the
    pinned 256-node workload and counts the reference's all-gathers at
    NOMAD_TPU_MESH_DEVICES=4."""
    want, ref_h, records, ref_stats = _reference_pipeline(monkeypatch, alg, 4)
    assert ref_stats["sharded"] >= 3 and ref_stats["mesh_devices"] == 4
    svc = port_solver.BulkSolverService(device="cpu", mesh=_mesh(4))
    monkeypatch.setitem(port_solver._services, "cpu", svc)
    try:
        h = PortHarness(device="cpu")
        for n in convert.nodes_from_records(
                [node_record(n) for n in ref_h.store.snapshot().nodes()]):
            h.store.upsert_node(n)
        cfg = port_operator.SchedulerConfiguration(scheduler_algorithm=alg)
        jobs = [convert.job_from_record(r) for r in records]
        for i, j in enumerate(jobs):
            h.store.upsert_job(j)
            h.process(port_mock.eval_for(j, id=f"parity-ev-{alg}-{i}"),
                      sched_config=cfg)
        got = fingerprint(h.store, jobs)
    finally:
        svc.stop()
    assert set(got) == set(want)
    for jid in want:
        n_w, nodes_w, scores_w = want[jid]
        n_g, nodes_g, scores_g = got[jid]
        assert n_g == n_w and nodes_g == nodes_w, jid
        assert np.allclose(scores_g, scores_w, rtol=0, atol=1e-12), jid
    stats = svc.stats
    assert stats["sharded"] == stats["launches"] >= 3, stats
    assert stats["mesh_devices"] == 4
    assert stats["allgathers"] == ref_stats["allgathers"] > 0, (
        stats["allgathers"], ref_stats["allgathers"])


def test_one_card_resolves_to_no_mesh(monkeypatch):
    """Without an explicit mesh a service resolves to none below two
    CUDA devices, and a CPU service never shards on its own."""
    svc = port_solver.BulkSolverService(device="cpu")
    assert svc._resolve_mesh(256) is None
    assert svc.stats["mesh_devices"] == 0
    svc = port_solver.BulkSolverService(device="cpu", mesh=_mesh(8))
    assert svc._resolve_mesh(256).size == 8
    assert svc._resolve_mesh(12) is None      # 8 does not divide 12
