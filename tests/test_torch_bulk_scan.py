"""The bulk fallbacks in the port against the JAX package, on the CPU.

- B11' ``prng.permutation_ref`` against ``jax.random.permutation`` bit
  for bit (1 round up to n = 1,625, 2 from 1,626; seeds over the whole
  uint32 range), and the split and 32-bit draw under it.
- B11 ``solve_bulk_ref`` against JAX's ``solve_bulk`` and
  ``solve_bulk_fused_ref`` against ``solve_bulk_fused``, in exact counts,
  on pinned fixtures. Every input is f32 on both sides (the reference's
  tests run JAX with x64 on, so an f64 input would move its scores to
  f64).
- The placer's three bulk routes through both packages' Harness: the
  reference's ``TestBulkSolve`` cases (columnar and per request), a
  group above the service's ``MAX_K`` (the fused scan), the generic scan
  with the shared mask taken away, the bulk-preemption scenario, and the
  order in which the fused scan and the service's carry miss each
  other's placements. Nodes and jobs are carried across from the
  reference's as plain records, so both packages see the same ids and
  tie-break seeds; placements compare by node registration ordinal.
"""

import dataclasses
import itertools
import random

import jax
import numpy as np
import pytest
import torch

import bench
from nomad_tpu import mock
from nomad_tpu.scheduler import generic_sched as ref_generic
from nomad_tpu.scheduler import reconcile as ref_reconcile
from nomad_tpu.structs import operator as ref_operator
from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu.tensor import placer as ref_placer
from nomad_tpu.tensor import solver as ref_solver
from nomad_tpu.testing import Harness
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import generic_sched as port_generic
from nomad_tpu_torch.scheduler import reconcile as port_reconcile
from nomad_tpu_torch.structs import enums
from nomad_tpu_torch.structs import operator as port_operator
from nomad_tpu_torch.tensor import kernels
from nomad_tpu_torch.tensor import placer as port_placer
from nomad_tpu_torch.tensor import prng
from nomad_tpu_torch.tensor import solver as port_solver
from nomad_tpu_torch.testing import Harness as PortHarness

from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_pipeline import fingerprint, job_record, node_record
from test_torch_preempt_loop import fake_card  # noqa: F401  (a fixture)

F32 = np.float32
STEP = 256
# the bulk routes' score is the trajectory mean, computed in float64 numpy
# from the same counts in both packages; the per-eval scan's scores are
# the f32 kernel scores, where torch's and XLA's powf may round one ulp
# apart (tests/test_torch_spread_pipeline.py). Counts compare exactly.
SCORE_ATOL = 1e-12
SCAN_SCORE_ATOL = 1e-6


# --------------------------------------------------------------------------
# B11': the permutation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31, 2 ** 32 - 1])
@pytest.mark.parametrize("n", [1, 8, 1625, 1626, 4096, 16384])
def test_permutation_ref_equals_jax(n, seed):
    want = np.asarray(jax.random.permutation(
        jax.random.PRNGKey(np.uint32(seed)), n))
    got = prng.permutation_ref(seed, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_and_keyed_bits_equal_jax():
    """split (partitionable threefry) and the 32-bit draw of a split key,
    which the permutation sorts by; and _shuffle's round count."""
    for seed in (0, 7, 2 ** 32 - 1):
        key = jax.random.PRNGKey(np.uint32(seed))
        want_key, want_sub = jax.random.split(key)
        got_key, got_sub = prng.split_ref(
            prng.seed_keys(torch.tensor([seed])))
        np.testing.assert_array_equal(got_key[0].numpy(),
                                      np.asarray(want_key, np.int64))
        np.testing.assert_array_equal(got_sub[0].numpy(),
                                      np.asarray(want_sub, np.int64))
        want_bits = np.asarray(jax.random.bits(want_sub, (1000,),
                                               np.uint32))
        got_bits = prng.random_bits_keys(got_sub, 1000)[0].numpy()
        np.testing.assert_array_equal(got_bits, want_bits.astype(np.int64))
    assert [prng.permutation_rounds(n) for n in
            (0, 1, 2, 1625, 1626, 2_600_000, 2_700_000)] == [0, 0, 1, 1, 2,
                                                            2, 3]


def test_permutation_wrapper_runs_the_plain_version_on_the_cpu():
    before = _ext.COUNTS.snapshot()
    got = prng.permutation(2 ** 32 - 1, 1626, "cpu")
    assert torch.equal(got, prng.permutation_ref(2 ** 32 - 1, 1626))
    assert sorted(got.tolist()) == list(range(1626))
    assert _ext.COUNTS.snapshot() == before


# --------------------------------------------------------------------------
# B11: the generic scan and the fused scan
# --------------------------------------------------------------------------

def bulk_fixture(name, seed=0, n=64, d=4, s=None, v=4):
    """One generic bulk solve's arguments, as the reference's positional
    list (f32 floats, int32 ids and counts, bool masks), with a hazard.
    ``d`` above 4 adds count columns (device instances, cores: 4-16 a
    node, 0-2 used, an ask of 1 or 2); ``s`` sets the spread count of the
    spread fixtures (2 by default) over ``v`` values."""
    rng = np.random.default_rng(seed)
    spreads = name in ("spread_even", "spread_targets")
    s, v = ((2 if s is None else s), v) if spreads else (0, 1)
    real = n - n // 8
    avail = np.zeros((n, d), F32)
    used = np.zeros((n, d), F32)
    if name == "identical":
        avail[:real, :4] = [4000, 8192, 100_000, 1000]
    else:
        avail[:real, 0] = rng.choice([2000, 4000, 8000], real)
        avail[:real, 1] = rng.choice([4096, 8192], real)
        avail[:real, 2:4] = [100_000, 1000]
        used[:real, 0] = rng.integers(0, 10, real) * 100
        used[:real, 1] = rng.integers(0, 10, real) * 64
    ask = np.zeros(d, F32)
    ask[:4] = [100, 64, 10, 0]
    if d > 4:
        avail[:real, 4:] = rng.choice([4, 8, 16], (real, d - 4))
        used[:real, 4:] = rng.integers(0, 3, (real, d - 4))
        ask[4:] = rng.choice([1.0, 2.0], d - 4)
    if name == "zero_ask":
        ask[:] = 0.0
    feas = np.zeros(n, bool)
    feas[:real] = rng.random(real) < (0.3 if name == "infeasible" else 0.9)
    ptg = np.zeros(n, np.int32)
    if name != "identical":
        ptg[:real] = rng.integers(0, 3, real)
    aff = np.zeros(n, F32)
    if name != "identical":
        aff[:real] = rng.choice([0.0, 0.0, 0.5, -0.25], real)
    svid = rng.integers(0, v, (s, n)).astype(np.int32)
    sok = rng.random((s, n)) < 0.9
    scnt = rng.integers(0, 5, (s, v)).astype(np.int32)
    desired = np.full((s, v), np.nan, F32)
    if name == "spread_targets":
        desired[:] = rng.integers(0, 50, (s, v))
        desired[0, 1] = 0.0                       # a zero target
    has_targets = np.full(s, name == "spread_targets")
    weight = np.full(s, 1.0 / max(s, 1), F32)
    k = {"over_capacity": 20_000, "zero_ask": 3000}.get(name, 600)
    return [avail, used, ask, feas, ptg, ptg.copy(), aff, np.zeros(n, F32),
            svid, sok, scnt, desired, has_targets, weight, k, 10.0,
            name == "dh_job", name == "dh_tg", name == "spread_alg",
            rng.permutation(n).astype(np.int32)]


def n_steps_for(k):
    k_pad = STEP
    while k_pad < k:
        k_pad *= 2
    return k_pad // STEP


def _jax_bulk(args):
    jargs = list(args)
    jargs[14], jargs[15] = np.int32(args[14]), F32(args[15])
    return np.asarray(ref_kernels.solve_bulk(
        *jargs, batch=STEP, n_steps=n_steps_for(args[14])))


def _port_bulk(args):
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    return kernels.solve_bulk_ref(*targs, batch=STEP,
                                  n_steps=n_steps_for(args[14])).numpy()


BULK_FIXTURES = ("binpack_fill", "spread_alg", "dh_job", "dh_tg",
                 "spread_even", "spread_targets", "infeasible", "identical",
                 "over_capacity", "zero_ask")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", BULK_FIXTURES)
def test_solve_bulk_ref_equals_jax(name, seed):
    args = bulk_fixture(name, seed)
    want = _jax_bulk(args)
    got = _port_bulk(args)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() <= args[14]
    if name == "over_capacity":
        assert got.sum() < args[14]      # a remainder is left
    if name in ("spread_alg", "dh_job", "dh_tg"):
        # one per node per step, at most one per node under distinct_hosts
        assert got.max() <= (1 if name != "spread_alg" else
                             n_steps_for(args[14]))


# past the narrow instance's caps (the wide one on the card): d 9 and 12,
# 9 and 16 spreads, and d 10 with 9 spreads of explicit targets
WIDE_BULK = {"d9": ("binpack_fill", dict(d=9)), "d12": ("dh_tg", dict(d=12)),
             "s9": ("spread_even", dict(s=9)),
             "s16": ("spread_targets", dict(s=16, v=6)),
             "d10_s9": ("spread_targets", dict(d=10, s=9))}


@pytest.mark.parametrize("case", sorted(WIDE_BULK))
def test_solve_bulk_ref_equals_jax_past_eight(case):
    name, kw = WIDE_BULK[case]
    args = bulk_fixture(name, 2, **kw)
    want = _jax_bulk(args)
    got = _port_bulk(args)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() <= args[14]
    if "d" in kw:      # the count columns bind: fewer than asked, or capped
        cap = np.floor((args[0][:, 4:] - args[1][:, 4:])
                       / args[2][4:]).min(axis=1)
        assert (got <= np.maximum(cap, 0)).all()


def fused_fixture(n, k, seed, full=False):
    rng = np.random.default_rng(n + k)
    real = n - n // 8
    avail = np.zeros((n, 4), F32)
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2:] = [102_400, 1000]
    feas = np.zeros(n, bool)
    feas[:real] = rng.random(real) < 0.95
    aff = np.zeros(n, F32)
    aff[:real] = rng.choice([0.0, 0.0, 0.0, 0.5], real)
    dyn = np.zeros((n, 6), F32)
    dyn[:real, 0] = rng.integers(0, 20, real) * 50
    dyn[:real, 1] = rng.integers(0, 20, real) * 32
    dyn[:real, 4] = dyn[:real, 5] = rng.integers(0, 2, real)
    if full:
        dyn[:real, :2] = avail[:real, :2] - [25, 16]
    ask = np.array([50, 32, 300, 0], F32)
    return avail, feas, aff, dyn, ask, k, float(k), seed


@pytest.mark.parametrize("n,k,seed,full", [
    (64, 600, 3, False),
    (512, 33_000, 2 ** 32 - 1, False),   # k_pad 65,536: 256 steps in JAX
    (512, 200_000, 0, False),            # more than fits: a remainder
    (64, 600, 7, True),                  # every node too full: nothing
])
def test_solve_bulk_fused_ref_equals_jax(n, k, seed, full):
    avail, feas, aff, dyn, ask, k, tgc, seed = fused_fixture(n, k, seed,
                                                              full)
    want = np.asarray(ref_kernels.solve_bulk_fused(
        avail, feas, aff, dyn, ask, np.int32(k), F32(tgc), np.uint32(seed),
        batch=STEP, n_steps=n_steps_for(k)))
    got = kernels.solve_bulk_fused_ref(
        *(torch.from_numpy(a) for a in (avail, feas, aff, dyn, ask)), k,
        tgc, seed, batch=STEP, n_steps=n_steps_for(k)).numpy()
    np.testing.assert_array_equal(got, want)
    if full:
        assert got.sum() == 0
    elif k == 200_000:
        assert 0 < got.sum() < k
    else:
        assert got.sum() == k


def test_bulk_wrappers_run_the_plain_versions_on_the_cpu():
    args = bulk_fixture("binpack_fill")
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    before = _ext.COUNTS.snapshot()
    got = kernels.solve_bulk(*targs, batch=STEP, n_steps=n_steps_for(600))
    assert np.array_equal(got.numpy(), _port_bulk(args))
    avail, feas, aff, dyn, ask, k, tgc, seed = fused_fixture(64, 600, 3)
    t = [torch.from_numpy(a) for a in (avail, feas, aff, dyn, ask)]
    got = kernels.solve_bulk_fused(*t, k, tgc, seed, batch=STEP,
                                   n_steps=n_steps_for(k))
    assert torch.equal(got, kernels.solve_bulk_fused_ref(
        *t, k, tgc, seed, batch=STEP, n_steps=n_steps_for(k)))
    assert _ext.COUNTS.snapshot() == before
    meta = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        kernels.solve_bulk_fused(meta, meta, meta, meta, meta, 1, 1.0, 0,
                                 batch=STEP, n_steps=1)


def test_bulk_kernel_limits_raise_before_any_launch():
    """A node count above what the one-CTA kernels take raises, naming
    ROADMAP A11d (the scan and the permutation above 65,536), and so does
    a seed outside uint32; nothing is built or launched. 65,536 nodes pass
    the check. (The kernel's entry refuses the other shapes it cannot
    take; chip_smoke.py checks that on the card.)"""
    assert prng.MAX_FILL_NODES == prng.MAX_PERM_NODES == 65536
    big = torch.zeros((65537, 4))
    for what in ("solve_bulk", "solve_bulk_fused"):
        with pytest.raises(NotImplementedError, match="A11d"):
            kernels._bulk_dims(what, big)
    with pytest.raises(NotImplementedError, match="A11d"):
        prng.permutation(0, prng.MAX_PERM_NODES + 1, "cuda")
    with pytest.raises(ValueError):
        prng.permutation(2 ** 32, 8, "cuda")
    for n in (16384, 32768, 65536):
        assert kernels._bulk_dims("solve_bulk", big[:n]) == (n, 4)


@pytest.fixture
def bulk_card(fake_card, monkeypatch):
    """fake_card with a copy to the card the identity (the wrapper moves
    its scalars' head to the ask's device)."""
    to = torch.Tensor.to

    def to_card(x, *a, **kw):
        dev = a[0] if a else kw.get("device")
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return x
        return to(x, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to_card)
    yield fake_card


@pytest.mark.parametrize("case", ["d9", "s9"])
def test_solve_bulk_launches_past_eight(bulk_card, case):
    """d 9 and s 9: one nt_bulk_scan (the library takes the wide
    instance) with the sizes, the budget and a scratch of the library's
    size; nothing is refused."""
    name, kw = WIDE_BULK[case]
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in bulk_fixture(name, 0, **kw)]
    query = _ext.entry("nt_bulk_scan_scratch_words")
    query.code = 71
    before = _ext.COUNTS.snapshot()["launches"]["bulk_scan"]
    out = kernels.solve_bulk(*args, batch=STEP, n_steps=3)
    (call,) = bulk_card["bulk_scan"].fns["nt_bulk_scan"].calls
    n, d = args[0].shape
    s, v = args[10].shape
    assert (d, s) == ((9, 0) if case == "d9" else (4, 9))
    assert call[0] == args[0].data_ptr() and call[11] == out.data_ptr()
    assert call[12:20] == (n, d, s, v, args[14], STEP, 3, 71)
    assert query.calls == [(n, d, s, v)]
    assert _ext.COUNTS.snapshot()["launches"]["bulk_scan"] == before + 1


def test_solve_bulk_refuses_tables_past_shared_memory(bulk_card):
    """8 spread tables of 4,096 values exceed a CTA's shared memory:
    ValueError naming the bytes, before anything launches; 8 of 3,000
    pass the check."""
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in bulk_fixture("spread_even", 0, n=1024, s=8, v=4096)]
    with pytest.raises(ValueError, match="bytes of shared memory"):
        kernels.solve_bulk(*args, batch=STEP, n_steps=3)
    assert not bulk_card["bulk_scan"].fns.get("nt_bulk_scan")
    assert kernels.bulk_scan_smem_bytes(1024, 8, 3000) <= kernels.SMEM_BYTES
    assert kernels.bulk_scan_smem_bytes(1024, 8, 4096) > kernels.SMEM_BYTES


def test_every_cuda_source_is_a_library():
    """Each csrc/*.cu builds into its own library, and every entry point
    names one of them (bulk_scan.cu holds B11 and B11')."""
    sources = sorted(p.stem for p in _ext.CSRC.glob("*.cu"))
    assert list(_ext.LIBRARIES) == sources
    assert _ext._SIGNATURES["nt_bulk_scan"][0] == "bulk_scan"
    assert _ext._SIGNATURES["nt_tie_perm"][0] == "bulk_scan"
    assert {"bulk_scan", "tie_perm"} <= set(_ext.COUNTS.launches)


# --------------------------------------------------------------------------
# the placer's routes through both packages
# --------------------------------------------------------------------------

@pytest.fixture
def services(monkeypatch):
    """A private solver service per package (CPU for the port)."""
    monkeypatch.setenv("NOMAD_TPU_MESH_DEVICES", "1")
    ref = ref_solver.BulkSolverService()
    monkeypatch.setattr(ref_solver, "_service", ref)
    port = port_solver.BulkSolverService(device="cpu")
    monkeypatch.setitem(port_solver._services, "cpu", port)
    yield ref, port
    ref.stop()
    port.stop()


@pytest.fixture
def pinned_ids(monkeypatch):
    """Each package's scheduler mints alloc ids from one counter, so the
    same call sequence gives the same ids (victim columns tie on id)."""
    for mod in (ref_generic, port_generic):
        counter = itertools.count()

        def fake(c=counter):
            return f"{next(c):08x}-0000-0000-0000-000000000000"

        monkeypatch.setattr(mod, "generate_uuid", fake)
    monkeypatch.setattr(ref_generic, "generate_uuids",
                        lambda n: [ref_generic.generate_uuid()
                                   for _ in range(n)])


def per_request(monkeypatch):
    """No columnar requests: a large group arrives as per-request
    placements (the shape the reference places through _place_bulk)."""
    monkeypatch.setattr(ref_reconcile, "BULK_PLACE_MIN", 1 << 30)
    monkeypatch.setattr(port_reconcile, "BULK_PLACE_MIN", 1 << 30)


def _config(alg, module):
    return module.SchedulerConfiguration(scheduler_algorithm=alg)


def run_both(ref_nodes, jobs, alg="tpu-binpack", configs=None):
    """Each job in turn through the reference's Harness and then, on the
    same nodes and job records, through the port's Harness(device="cpu").
    Returns ((ref harness, ref jobs), (port harness, port jobs))."""
    configs = configs or (_config(alg, ref_operator),
                          _config(alg, port_operator))
    h = Harness()
    for n in ref_nodes:
        h.store.upsert_node(n)
    records = [job_record(j) for j in jobs]
    for i, j in enumerate(jobs):
        h.store.upsert_job(j)
        h.process(mock.eval_for(j, id=f"bulk-ev-{i}"),
                  sched_config=configs[0])
    ph = PortHarness(device="cpu")
    for n in convert.nodes_from_records([node_record(n) for n in ref_nodes]):
        ph.store.upsert_node(n)
    port_jobs = [convert.job_from_record(r) for r in records]
    for i, j in enumerate(port_jobs):
        ph.store.upsert_job(j)
        ph.process(port_mock.eval_for(j, id=f"bulk-ev-{i}"),
                   sched_config=configs[1])
    return (h, jobs), (ph, port_jobs)


def assert_same_fingerprint(ref_run, port_run, atol=SCORE_ATOL):
    want = fingerprint(ref_run[0].store, ref_run[1])
    got = fingerprint(port_run[0].store, port_run[1])
    assert set(got) == set(want)
    for jid in want:
        assert got[jid][:2] == want[jid][:2], jid
        assert len(got[jid][2]) == len(want[jid][2]), jid
        np.testing.assert_allclose(got[jid][2], want[jid][2], rtol=0,
                                   atol=atol, err_msg=jid)
    return got


def over_capacity(store):
    snap = store.snapshot()
    nodes = {n.id: n for n in snap.nodes()}
    usage = {nid: 0.0 for nid in nodes}
    for a in snap.allocs():
        if not a.terminal_status():
            usage[a.node_id] = usage[a.node_id] + a.allocated_vec
    ordinal = {n.id: i for i, n in enumerate(snap.nodes())}
    return sorted(ordinal[nid] for nid, u in usage.items()
                  if (np.asarray(u) > nodes[nid].available_vec()).any())


def random_nodes(n_nodes, seed=7):
    """The reference TestBulkSolve cluster: cpu in {2000, 4000, 8000},
    memory in {4096, 8192}, from random.Random(7)."""
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        n = mock.node(id=f"bulk-node-{i:04d}", name=f"bulk-node-{i:04d}")
        n.resources.cpu = rng.choice([2000, 4000, 8000])
        n.resources.memory_mb = rng.choice([4096, 8192])
        n.compute_class()
        out.append(n)
    return out


def sized_batch_job(count, cpu, mem, jid, prio=50):
    j = mock.batch_job(id=jid, name=jid)
    j.priority = prio
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    return j


def _test_bulk_solve(monkeypatch, route, bulk_min, count=600, n_nodes=64,
                     cpu=100, mem=64):
    """The reference's TestBulkSolve._run (tests/test_tensor_placer.py:
    298-320) through both packages."""
    monkeypatch.setattr(ref_placer.TPUPlacer, "BULK_MIN", bulk_min)
    monkeypatch.setattr(port_placer.TorchPlacer, "BULK_MIN", bulk_min)
    if route == "per_request":
        per_request(monkeypatch)
    job = sized_batch_job(count, cpu, mem, "bulk-job")
    ref_run, port_run = run_both(random_nodes(n_nodes), [job])
    # below BULK_MIN the per-request group takes the per-eval scan (B9)
    scan = route == "per_request" and count < bulk_min
    got = assert_same_fingerprint(
        ref_run, port_run, atol=SCAN_SCORE_ATOL if scan else SCORE_ATOL)
    return port_run[0], got["bulk-job"]


ROUTES = ("columnar", "per_request")


@pytest.mark.parametrize("route", ROUTES)
def test_bulk_places_all_and_respects_capacity(route, monkeypatch,
                                               services):
    h, (n_allocs, _, scores) = _test_bulk_solve(monkeypatch, route, 256)
    assert n_allocs == 600
    assert over_capacity(h.store) == []
    assert scores                         # the shared trajectory mean
    assert services[1].stats["solves"] == 1


def mean_alloc_score(store, jid):
    """The mean over a job's allocs of each alloc's normalized score."""
    out = []
    for a in store.snapshot().allocs_by_job(jid):
        out.extend(v for k, v in a.metrics.scores.items()
                   if k.endswith("normalized-score"))
    return float(np.mean(out))


@pytest.mark.parametrize("route", ROUTES)
def test_bulk_score_parity_with_exact_scan(route, monkeypatch, services):
    h_bulk, bulk = _test_bulk_solve(monkeypatch, route, 256)
    h_exact, exact = _test_bulk_solve(monkeypatch, route, 1 << 30)
    assert bulk[0] == exact[0] == 600
    assert (mean_alloc_score(h_bulk.store, "bulk-job")
            >= mean_alloc_score(h_exact.store, "bulk-job") - 5e-3)


@pytest.mark.parametrize("route", ROUTES)
def test_bulk_overflow_blocks(route, monkeypatch, services):
    h, (n_allocs, _, _) = _test_bulk_solve(monkeypatch, route, 256,
                                           n_nodes=4, cpu=500, mem=256)
    assert 0 < n_allocs < 600
    ev = h.evals[-1]
    assert ev.status == enums.EVAL_STATUS_COMPLETE
    assert ev.failed_tg_allocs and ev.blocked_eval


def c2m_nodes(n_nodes):
    """bench.build_nodes' seeded cluster (the C2M path's node shape)."""
    h = Harness()
    bench.build_nodes(h.store, n_nodes, seed=0)
    return list(h.store.snapshot().nodes())


@pytest.mark.parametrize("alg", ["tpu-binpack", "tpu-solve"])
def test_group_above_max_k_equals_reference(alg, services):
    """33,000 allocs in one group, above the service's int16 MAX_K: one
    fused scan (the reference's solve_bulk_fused, k_pad 65,536, 256 steps)
    gives one AllocBlock with the reference's per-node counts, under
    "tpu-solve" too (the joint tier sees only k <= MAX_K)."""
    job = sized_batch_job(33_000, 50, 32, "big-job")
    before = _ext.COUNTS.snapshot()
    ref_run, port_run = run_both(c2m_nodes(512), [job], alg=alg)
    got = assert_same_fingerprint(ref_run, port_run)
    assert got["big-job"][0] == 33_000
    blocks = list(port_run[0].store.snapshot().alloc_blocks())
    assert len(blocks) == 1 and blocks[0].size == 33_000
    assert over_capacity(port_run[0].store) == []
    assert services[1].stats["solves"] == 0   # the service never saw it
    assert _ext.COUNTS.snapshot() == before


@pytest.mark.parametrize("route", ROUTES)
def test_generic_route_without_a_shared_mask(route, monkeypatch, services):
    """With the shared mask taken away (tgt.feas_base = None, in the port
    only reachable today through CSI volumes or reserved ports, both of
    which raise) both packages run the generic scan with the eval's host
    permutation. The reference scores in f64 here (its tests run JAX with
    x64 and the placer passes an f64 zero device-affinity row), the port
    in f32; the integral fixture leaves no near-tie between them."""
    for mod in (ref_placer, port_placer):
        orig = mod.build_task_group_tensors

        def no_base(*a, _orig=orig, **kw):
            return dataclasses.replace(_orig(*a, **kw), feas_base=None)

        monkeypatch.setattr(mod, "build_task_group_tensors", no_base)
    if route == "per_request":
        per_request(monkeypatch)
    jobs = [sized_batch_job(600, 100, 64, "generic-a"),
            sized_batch_job(40_000, 100, 64, "generic-b")]
    ref_run, port_run = run_both(random_nodes(64), jobs)
    got = assert_same_fingerprint(ref_run, port_run)
    assert got["generic-a"][0] == 600
    assert 0 < got["generic-b"][0] < 40_000      # the cluster fills up
    assert over_capacity(port_run[0].store) == []
    assert services[1].stats["solves"] == 0


def _preempt_configs():
    return tuple(m.SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack",
        preemption_config=m.PreemptionConfig(batch_scheduler_enabled=True))
        for m in (ref_operator, port_operator))


@pytest.mark.parametrize("route", ["mirror", "kernel"])
def test_bulk_preempt_scenario_equals_reference(route, monkeypatch,
                                                pinned_ids, services):
    """The reference's _run_preempt_scenario (tests/test_preempt_solve.py:
    290-330) with its BULK_MIN = 16: 16 nodes of (4,000 MHz, 8,192 MB)
    filled by a priority-20 batch job of 32 x (1,900, 3,800), then a
    priority-80 batch job of 32 x (1,000, 2,000). Both groups go through
    _place_bulk (the service, then the remainder to one preemption solve:
    the numpy mirror, or with PREEMPT_DEVICE_MIN = 0 the kernel's plain
    version). Same placements and victims in both packages."""
    for cls in (ref_placer.TPUPlacer, port_placer.TorchPlacer):
        monkeypatch.setattr(cls, "BULK_MIN", 16)
        if route == "kernel":
            monkeypatch.setattr(cls, "PREEMPT_DEVICE_MIN", 0)
    nodes = []
    for i in range(16):
        n = mock.node(id=f"ps-node-{i:02d}", name=f"ps-node-{i:02d}")
        n.resources.cpu = 4000
        n.resources.memory_mb = 8192
        n.compute_class()
        nodes.append(n)
    jobs = [sized_batch_job(32, 1900, 3800, "ps-filler", prio=20),
            sized_batch_job(32, 1000, 2000, "ps-hi", prio=80)]
    r0, p0 = ref_placer.preempt_stats(), port_placer.preempt_stats()
    ref_run, port_run = run_both(nodes, jobs, configs=_preempt_configs())
    r1, p1 = ref_placer.preempt_stats(), port_placer.preempt_stats()
    got = assert_same_fingerprint(ref_run, port_run)
    assert got["ps-filler"][0] == 32 and got["ps-hi"][0] == 32

    def victims(store):
        snap = store.snapshot()
        by_id = {a.id: a for a in snap.allocs()}
        ordinal = {n.id: i for i, n in enumerate(snap.nodes())}
        return sorted((a.id, a.name, ordinal[a.node_id],
                       by_id[a.preempted_by_allocation].name)
                      for a in by_id.values()
                      if a.desired_status == enums.ALLOC_DESIRED_EVICT)

    want = victims(ref_run[0].store)
    assert want and victims(port_run[0].store) == want
    assert len({v[0] for v in want}) == len(want)
    live = [a for a in port_run[0].store.snapshot().allocs_by_job("ps-hi")
            if not a.terminal_status()]
    assert len(live) == 32
    assert over_capacity(port_run[0].store) == []
    delta = {k: p1[k] - p0[k] for k in p1}
    assert delta == {k: r1[k] - r0[k] for k in r1}
    assert delta["kernel_preempted"] >= 1 and delta["host_preempted"] == 0


def test_fused_route_and_service_carry_miss_each_other(services):
    """Kept as the reference has it (ROADMAP C): the fused scan reads the
    store and the in-flight overlay, not the solver service's carry, and
    the carry learns of the fused placements only at its next resync
    (every RESYNC_SOLVES solves). In this order on one cluster: a group
    of 300 through the service (its carry is born), a group of 33,000
    through the fused scan (which fills the first group's nodes, BestFit),
    a second group of 300 through the service, whose stale carry books the
    same nodes again; the harness commits without re-checking fit. Both
    packages put the same allocs on the same nodes, and the same nodes end
    over capacity."""
    jobs = [sized_batch_job(300, 50, 32, "carry-a"),
            sized_batch_job(33_000, 50, 32, "carry-big"),
            sized_batch_job(300, 50, 32, "carry-b")]
    ref_run, port_run = run_both(c2m_nodes(256), jobs)
    assert_same_fingerprint(ref_run, port_run)
    want = over_capacity(ref_run[0].store)
    assert want and over_capacity(port_run[0].store) == want
    assert services[1].stats["solves"] == 2
    assert services[1].stats["resyncs"] == 1


# --------------------------------------------------------------------------
# the redesigned B11's selection (csrc/select.cuh) against the full sort
# --------------------------------------------------------------------------

# levels csrc/select.cuh walks before it bisects (kLevels)
SELECT_LEVELS = 4


def desc_key_ref(score: torch.Tensor) -> torch.Tensor:
    """csrc/sort.cuh ``desc_key`` as int64 values in [0, 2^32): ascending
    key is descending f32 score, -0.0 folded onto +0.0."""
    b = score.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    ordered = torch.where((b & 0x80000000) != 0, ~b & 0xFFFFFFFF,
                          b | 0x80000000)
    return ~ordered & 0xFFFFFFFF


def threshold_takes_ref(key: torch.Tensor, w: torch.Tensor,
                        budget: int) -> torch.Tensor:
    """csrc/select.cuh's fill in plain torch, step for step: the level T
    at which the weight of the keys <= T reaches ``budget`` (the
    distinct levels walked from the best for ``SELECT_LEVELS``, then a
    bisection of the keys up to the worst), every key below T taking its
    whole weight w, the keys at T sharing what is left in position order.
    ``key`` from :func:`desc_key_ref`, ``w`` the caps clipped to the
    budget. Equals :func:`kernels._fill_takes` on the same step. (N,)
    int64."""
    w = w.to(torch.int64)
    live = w > 0
    total = int(w.sum())
    if total <= budget:
        return w.clone()
    level, above = int(key[live].min()), 0
    for it in range(1, SELECT_LEVELS + 1):
        at = int(w[live & (key == level)].sum())
        if above + at >= budget:
            break
        above += at
        if it < SELECT_LEVELS:
            level = int(key[live & (key > level)].min())
    else:
        lo, hi = level + 1, int(key[live].max())
        while lo < hi:
            mid = lo + (hi - lo) // 2
            at = int(w[live & (key <= mid)].sum())
            if at >= budget:
                hi = mid
            else:
                lo, above = mid + 1, at
        level = lo
    bucket = torch.where(key == level, w, 0)
    excl = above + torch.cumsum(bucket, 0) - bucket
    shared = torch.minimum(torch.clamp_min(budget - excl, 0), w)
    return torch.where(key < level, w, torch.where(key == level, shared, 0))


def takes_hook(monkeypatch):
    """Wrap kernels._fill_takes (the reference's full stable sort and
    scan) so that every step of a plain bulk scan also runs the kernel's
    selection (threshold_takes_ref on desc_key_ref) and asserts the same
    takes. Returns the list of (budget, levels above the fill's level)
    of the steps, where levels counts the distinct keys with cap > 0
    before the level the selection stops at."""
    real = kernels._fill_takes
    steps = []

    def hook(score, cap, budget):
        want = real(score, cap, budget)
        key = desc_key_ref(score)
        got = threshold_takes_ref(key, cap, budget)
        assert torch.equal(got.to(torch.int32), want)
        taken = key[want > 0]
        levels = int(torch.unique(key[(cap > 0) & (key < taken.max())])
                     .numel()) if len(taken) else 0
        steps.append((budget, levels))
        return want

    monkeypatch.setattr(kernels, "_fill_takes", hook)
    return steps


@pytest.mark.parametrize("name", BULK_FIXTURES)
def test_selection_equals_the_full_sort_at_every_step(name, monkeypatch):
    """At every step of the generic plain scan, the kernel's selection
    (the weighted level of the budget, whole caps below it, the level's
    positions in order) takes what the full stable sort and scan takes:
    equal scores ("identical"), cap <= 1 ("spread_alg", "dh_job",
    "dh_tg", where 256 of ~800 live nodes make the selection bisect), a
    last step whose budget is below the batch (600 = 256 + 256 + 88),
    infeasible nodes ("infeasible"), and the spread tables (the cached
    identity held at each step too), at 1,024 nodes."""
    from test_torch_task_group import identity_hook

    args = bulk_fixture(name, n=1024)
    steps = takes_hook(monkeypatch)
    identity_hook(monkeypatch)
    got = _port_bulk(args)
    assert steps and got.sum() > 0
    if got.sum() == args[14] and args[14] % STEP:
        assert steps[-1][0] == args[14] % STEP
    if name in ("spread_alg", "dh_tg"):
        # a prefix of many cap-1 positions: the selection bisects
        assert max(lv for _, lv in steps) > SELECT_LEVELS


def _crafted_step(case, seed):
    """One step's (score, cap, budget) with a hazard of the selection."""
    rng = np.random.default_rng(seed)
    n = 512
    score = rng.choice(np.linspace(0.1, 0.9, 40), n).astype(F32)
    cap = rng.integers(0, 6, n).astype(np.int32)
    budget = 256
    if case == "zeros":            # +0.0 and -0.0 tie, in position order
        score[::3] = 0.0
        score[1::3] = -0.0
    elif case == "cap0_interleaved":
        cap[rng.random(n) < 0.4] = 0
        score[:40] = 0.95          # best scores, many of them with cap 0
    elif case == "equal":
        score[:] = 0.5
    elif case == "cap1":
        score = rng.random(n).astype(F32)
        cap = (rng.random(n) < 0.8).astype(np.int32)
    elif case == "short":          # the last step: budget below the batch
        budget = 37
    elif case == "all":            # the caps sum below the budget
        cap[:] = 0
        cap[::50] = 3
    elif case == "neg":            # NEG scores with caps of 0
        score[::2] = kernels.NEG
        cap[::2] = 0
    cap = np.minimum(cap, budget)
    return torch.from_numpy(score), torch.from_numpy(cap), budget


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["zeros", "cap0_interleaved", "equal",
                                  "cap1", "short", "all", "neg"])
def test_selection_hazards_equal_the_full_sort(case, seed):
    score, cap, budget = _crafted_step(case, seed)
    want = kernels._fill_takes(score, cap, budget)
    got = threshold_takes_ref(desc_key_ref(score), cap,
                                      budget)
    assert torch.equal(got.to(torch.int32), want)
    assert int(want.sum()) == min(budget, int(cap.sum()))


@pytest.mark.parametrize("n,k,seed,full", [
    (64, 600, 3, False), (512, 33_000, 2 ** 32 - 1, False),
    (512, 200_000, 0, False)])
def test_fused_selection_equals_the_full_sort(n, k, seed, full,
                                              monkeypatch):
    """The fused form (no spread) at every step of its plain scan."""
    avail, feas, aff, dyn, ask, k, tgc, seed = fused_fixture(n, k, seed,
                                                              full)
    steps = takes_hook(monkeypatch)
    kernels.solve_bulk_fused_ref(
        *(torch.from_numpy(a) for a in (avail, feas, aff, dyn, ask)), k,
        tgc, seed, batch=STEP, n_steps=n_steps_for(k))
    assert steps


# --------------------------------------------------------------------------
# above 16,384 nodes: N_pad 32,768 against JAX, and the wide scan's
# selection (threshold_radix over keys in the scratch)
# --------------------------------------------------------------------------

WIDE = 32768


def test_solve_bulk_ref_equals_jax_at_n_pad_32768():
    """The generic plain scan against JAX's solve_bulk at N_pad 32,768
    (the wide kernel's node count), with spread targets: exact counts."""
    args = bulk_fixture("spread_targets", seed=2, n=WIDE)
    want = _jax_bulk(args)
    got = _port_bulk(args)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == args[14]


def test_solve_bulk_fused_ref_equals_jax_at_n_pad_32768():
    """The fused plain scan (the permutation drawn from the seed, two
    rounds of it) against JAX's solve_bulk_fused at N_pad 32,768: exact
    counts."""
    avail, feas, aff, dyn, ask, k, tgc, seed = fused_fixture(WIDE, 5000,
                                                              2 ** 31)
    want = np.asarray(ref_kernels.solve_bulk_fused(
        avail, feas, aff, dyn, ask, np.int32(k), F32(tgc), np.uint32(seed),
        batch=STEP, n_steps=n_steps_for(k)))
    got = kernels.solve_bulk_fused_ref(
        *(torch.from_numpy(a) for a in (avail, feas, aff, dyn, ask)), k,
        tgc, seed, batch=STEP, n_steps=n_steps_for(k)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == k


def wide_chunk(n: int) -> int:
    """The positions a scan thread holds (bulk_scan.cu: N / 1,024 rounded
    up, its kernel instance 16, 32 or 64 of them)."""
    return -(-n // 1024)


def radix_hook(monkeypatch):
    """Wrap kernels._fill_takes so that every step of a plain scan also
    runs the wide kernel's selection: test_torch_fill_loop's model of
    select.cuh's threshold_radix, threshold_base and take_at on
    desc_key_ref and the caps clipped to the budget, over the positions
    in scan order (thread t's chunk after thread t - 1's), asserting the
    same takes. Returns the routes taken ("all", "first", "radix")."""
    from test_torch_fill_loop import radix_takes_ref

    real = kernels._fill_takes
    routes = []

    def hook(score, cap, budget):
        want = real(score, cap, budget)
        got, route, _ = radix_takes_ref(desc_key_ref(score), cap, budget)
        assert torch.equal(got.to(torch.int32), want)
        routes.append(route)
        return want

    monkeypatch.setattr(kernels, "_fill_takes", hook)
    return routes


@pytest.mark.parametrize("n,k", [(WIDE, 6000), (65536, 1200)])
def test_wide_fused_selection_equals_the_full_sort(n, k, monkeypatch):
    """Above 16,384 nodes a thread holds 32 (N_pad 32,768) or 64 (65,536)
    positions, their keys and caps in the global scratch, and each step's
    level comes from threshold_radix: at every step of the fused plain
    scan its takes equal the full stable sort's, through a deep fill (the
    radix search) as well as the best level alone."""
    assert wide_chunk(n) == n // 1024 and wide_chunk(n) in (32, 64)
    avail, feas, aff, dyn, ask, k, tgc, seed = fused_fixture(n, k, 5)
    routes = radix_hook(monkeypatch)
    got = kernels.solve_bulk_fused_ref(
        *(torch.from_numpy(a) for a in (avail, feas, aff, dyn, ask)), k,
        tgc, seed, batch=STEP, n_steps=n_steps_for(k))
    assert int(got.sum()) == k and len(routes) == -(-k // STEP)
    assert "radix" in routes


@pytest.mark.parametrize("name", ["spread_alg", "spread_targets", "dh_tg"])
def test_wide_generic_selection_equals_jax(name, monkeypatch):
    """The generic scan at N_pad 32,768 with the wide selection at every
    step (cap <= 1 prefixes of many positions, spread tables): its counts
    equal the full sort's and JAX's."""
    args = bulk_fixture(name, seed=3, n=WIDE)
    args[14] = 900
    routes = radix_hook(monkeypatch)
    got = _port_bulk(args)
    np.testing.assert_array_equal(got, _jax_bulk(args))
    assert routes and got.sum() == 900
    if name != "spread_targets":
        assert "radix" in routes
