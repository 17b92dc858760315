"""The port's per-eval program (nomad_tpu_torch/tensor/kernels.py: B8
``score_nodes_ref``, B10 ``score_nodes_once``, B9
``solve_task_group_fused``), its tensor lowering (tensor/cluster.py) and
its host oracle (scheduler/rank.py) against the JAX package on the CPU.

The same cluster is built in both packages with pinned ids; each
package lowers it with its own ``build_task_group_tensors`` and scores
it with its own program. Both programs compute in f32 (the JAX side gets
f32 inputs, as ``pack_solve_args`` gives its fused entry). Tolerances:
the NEG mask, choices and founds are exact; scores agree to 1e-6 x
max(1, max |score|), the size of a few f32 roundings of ``10**x``, which
torch and XLA may round 1 ulp apart. The host oracles are float64 and
run the same numpy formulas: their scores agree to 1e-12.

The CUDA kernels run only on the card, where chip_smoke.py holds each
against these plain versions."""

import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.scheduler.context import EvalContext
from nomad_tpu.scheduler.rank import score_nodes
from nomad_tpu.state import StateStore
from nomad_tpu.structs import Affinity, Constraint, Spread, SpreadTarget, enums
from nomad_tpu.structs.resources import Resources
from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu.tensor.cluster import ClusterTensors, build_task_group_tensors
from nomad_tpu_torch import _ext, convert
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import rank as port_rank
from nomad_tpu_torch.scheduler.context import EvalContext as PortEvalContext
from nomad_tpu_torch.state import StateStore as PortStateStore
from nomad_tpu_torch.tensor import cluster as port_cluster
from nomad_tpu_torch.tensor import kernels
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_pipeline import node_record
from test_torch_preempt_loop import fake_card  # noqa: F401  (a fixture)
from test_torch_spread_pipeline import job_record

F32 = np.float32
NEG = kernels.NEG


def _close(got, want, what=""):
    """Scores: NEG mask exact, the rest within 1e-6 normwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got <= NEG / 2, want <= NEG / 2, what)
    live = want > NEG / 2
    scale = max(1.0, float(np.abs(want[live]).max())) if live.any() else 1.0
    assert np.abs(got[live] - want[live]).max(initial=0.0) <= 1e-6 * scale, what


# ---------------------------------------------------------------------------
# one cluster, built in both packages
# ---------------------------------------------------------------------------


class Mirror:
    """A reference store and a port store holding the same nodes, job and
    allocs (ids pinned), plus the job in both packages."""

    def __init__(self, rng, n_nodes=24, n_allocs=40, dcs=("dc1",),
                 attrs=None):
        self.ref = StateStore()
        self.nodes = []
        for i in range(n_nodes):
            n = mock.node(datacenter=rng.choice(list(dcs)))
            n.id = f"node-{i:03d}"
            n.name = f"n{i}"
            n.resources.cpu = rng.choice([2000, 4000, 8000])
            n.resources.memory_mb = rng.choice([4096, 8192, 16384])
            if attrs is not None:
                n.attributes.update(attrs(i))
            n.compute_class()
            self.ref.upsert_node(n)
            self.nodes.append(n)
        self.filler = mock.job()
        self.filler.id = "filler"
        self.filler.task_groups[0].count = n_allocs
        self.ref.upsert_job(self.filler)
        self.allocs = []
        for i in range(n_allocs):
            a = mock.alloc(self.filler, rng.choice(self.nodes), index=i)
            a.id = f"alloc-{i:03d}"
            a.allocated_vec = Resources(
                cpu=rng.choice([100, 250, 500]),
                memory_mb=rng.choice([64, 128, 512])).vec()
            self.ref.upsert_allocs([a])
            self.allocs.append(a)

    def port(self, job, job_allocs=()):
        """The port's store with the same rows, and the port's job."""
        store = PortStateStore()
        for n in convert.nodes_from_records(
                [node_record(n) for n in self.ref.snapshot().nodes()]):
            store.upsert_node(n)
        pjob = convert.job_from_record(job_record(job))
        pfiller = convert.job_from_record(job_record(self.filler))
        store.upsert_job(pfiller)
        store.upsert_job(pjob)
        owners = {self.filler.id: pfiller, job.id: pjob}
        for a in list(self.allocs) + list(job_allocs):
            pj = owners[a.job_id]
            store.upsert_allocs([port_mock.alloc(
                pj, store.snapshot().node_by_id(a.node_id),
                index=a.index(), id=a.id, allocated_vec=a.allocated_vec.copy(),
                task_group=a.task_group)])
        nodes = [store.snapshot().node_by_id(n.id) for n in self.nodes]
        return store, pjob, nodes


def _ref_tensors(store, job, nodes, algorithm, eval_id):
    ctx = EvalContext(store.snapshot(), eval_id=eval_id)
    cluster = ClusterTensors.build(ctx, nodes)
    tg = job.task_groups[0]
    return cluster, build_task_group_tensors(ctx, job, tg, cluster,
                                             algorithm=algorithm)


def _port_tensors(store, job, nodes, algorithm, eval_id):
    ctx = PortEvalContext(store.snapshot(), eval_id=eval_id)
    cluster = port_cluster.ClusterTensors.build(ctx, nodes)
    tg = job.task_groups[0]
    return cluster, port_cluster.build_task_group_tensors(
        ctx, job, tg, cluster, algorithm=algorithm)


def _jax_scores(cluster, tgt, penalty):
    i32 = np.int32
    out = ref_kernels.score_nodes_once(
        jnp.asarray(cluster.available, F32), jnp.asarray(cluster.used, F32),
        jnp.asarray(tgt.ask, F32), jnp.asarray(tgt.feasible),
        jnp.asarray(tgt.placed_tg, i32), jnp.asarray(tgt.placed_job, i32),
        jnp.asarray(tgt.affinity_boost, F32), jnp.asarray(i32(penalty)),
        jnp.asarray(tgt.spread_val_id, i32), jnp.asarray(tgt.spread_val_ok),
        jnp.asarray(tgt.spread_counts, i32),
        jnp.asarray(tgt.spread_desired, F32),
        jnp.asarray(tgt.spread_has_targets),
        jnp.asarray(tgt.spread_weight, F32), jnp.asarray(F32(-1.0)),
        jnp.asarray(F32(tgt.tg_count)), jnp.asarray(tgt.dh_job),
        jnp.asarray(tgt.dh_tg), jnp.asarray(tgt.spread_alg),
        dev_affinity=jnp.asarray(tgt.dev_affinity, F32),
        dp_val_id=jnp.asarray(tgt.dp_val_id, i32),
        dp_val_ok=jnp.asarray(tgt.dp_val_ok),
        dp_counts=jnp.asarray(tgt.dp_counts, i32),
        dp_limit=jnp.asarray(tgt.dp_limit, F32))
    return np.asarray(out)


def _port_scores(cluster, tgt, penalty):
    return kernels.score_nodes_once(
        cluster.available, cluster.used, tgt.ask, tgt.feasible,
        tgt.placed_tg, tgt.placed_job, tgt.affinity_boost, penalty,
        tgt.spread_val_id, tgt.spread_val_ok, tgt.spread_counts,
        tgt.spread_desired, tgt.spread_has_targets, tgt.spread_weight, -1.0,
        tgt.tg_count, tgt.dh_job, tgt.dh_tg, tgt.spread_alg,
        dev_affinity=tgt.dev_affinity, dp_val_id=tgt.dp_val_id,
        dp_val_ok=tgt.dp_val_ok, dp_counts=tgt.dp_counts,
        dp_limit=tgt.dp_limit, device="cpu").numpy()


def _compare(mirror, job, job_allocs=(), *, algorithm=enums.SCHED_ALG_BINPACK,
             penalty=-1, host=True):
    """Tensors equal; B10 plain vs JAX; each host oracle vs its kernel
    and vs the other package's oracle."""
    eval_id = "score-eval"
    pstore, pjob, pnodes = mirror.port(job, job_allocs)
    rc, rt = _ref_tensors(mirror.ref, job, mirror.nodes, algorithm, eval_id)
    pc, pt = _port_tensors(pstore, pjob, pnodes, algorithm, eval_id)
    np.testing.assert_array_equal(pc.available, rc.available)
    np.testing.assert_array_equal(pc.used, rc.used)
    for name in ("feasible", "affinity_boost", "placed_tg", "placed_job",
                 "spread_val_id", "spread_val_ok", "spread_counts",
                 "spread_desired", "spread_has_targets", "spread_weight",
                 "dp_val_id", "dp_val_ok", "dp_counts", "dp_limit"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(rt, name),
                                      name)
    assert (pt.tg_count, pt.dh_job, pt.dh_tg, pt.spread_alg) == (
        rt.tg_count, rt.dh_job, rt.dh_tg, rt.spread_alg)

    want = _jax_scores(rc, rt, penalty)
    got = _port_scores(pc, pt, penalty)
    _close(got, want, "B10 plain vs JAX")
    n = len(mirror.nodes)
    if host:
        rctx = EvalContext(mirror.ref.snapshot(), eval_id=eval_id)
        pctx = PortEvalContext(pstore.snapshot(), eval_id=eval_id)
        ref_host = {o.node.id: o.final_score for o in score_nodes(
            rctx, job, job.task_groups[0], mirror.nodes, algorithm=algorithm)}
        port_host = {o.node.id: o.final_score for o in port_rank.score_nodes(
            pctx, pjob, pjob.task_groups[0], pnodes, algorithm=algorithm)}
        assert port_host.keys() == ref_host.keys()
        for nid, score in ref_host.items():
            assert port_host[nid] == pytest.approx(score, abs=1e-12), nid
        kern = {pnodes[i].id: float(got[i]) for i in range(n)
                if got[i] > NEG / 2}
        assert kern.keys() == port_host.keys()
        for nid, score in port_host.items():
            assert kern[nid] == pytest.approx(score, abs=1e-6), nid
    return got[:n]


@pytest.mark.parametrize("seed", range(6))
def test_score_once_randomized(seed):
    rng = random.Random(seed)
    mirror = Mirror(rng)
    job = mock.job()
    job.id = "scored"
    job.task_groups[0].tasks[0].resources = Resources(
        cpu=rng.choice([200, 500, 900]), memory_mb=rng.choice([128, 256, 700]))
    _compare(mirror, job)


def test_score_once_affinities_and_constraints():
    rng = random.Random(7)
    mirror = Mirror(rng, n_nodes=16, attrs=lambda i: (
        {"rack": f"r{i % 4}"} if i % 2 == 0 else {}))
    job = mock.job(
        constraints=[Constraint("${attr.kernel.name}", "linux", "="),
                     Constraint("${attr.rack}", "", enums.CONSTRAINT_IS_SET)],
        affinities=[Affinity("${attr.rack}", "r0", "=", weight=50),
                    Affinity("${attr.rack}", "r2", "=", weight=-30)])
    job.id = "scored"
    scores = _compare(mirror, job)
    assert (scores > NEG / 2).sum() == 8


@pytest.mark.parametrize("targets", [
    [],
    [SpreadTarget("d1", 70), SpreadTarget("d2", 30)],
    [SpreadTarget("d1", 50)],
    [SpreadTarget("d1", 0), SpreadTarget("d2", 100)],
])
def test_score_once_spread(targets):
    rng = random.Random(11)
    mirror = Mirror(rng, n_nodes=12, dcs=("d1", "d2", "d3"))
    job = mock.job(datacenters=["d1", "d2", "d3"])
    job.id = "scored"
    job.task_groups[0].spreads = [
        Spread(attribute="${node.datacenter}", weight=60, targets=targets)]
    own = []
    for i in range(5):
        a = mock.alloc(job, rng.choice(mirror.nodes), index=i)
        a.id = f"own-{i}"
        own.append(a)
    mirror.ref.upsert_allocs(own)
    mirror.ref.upsert_job(job)
    _compare(mirror, job, own)


def test_score_once_even_spread_missing_attribute():
    rng = random.Random(5)
    mirror = Mirror(rng, n_nodes=8, n_allocs=0, attrs=lambda i: (
        {"rack": f"r{i % 4}"} if i % 2 == 0 else {}))
    job = mock.job()
    job.id = "scored"
    job.task_groups[0].spreads = [Spread(attribute="${attr.rack}", weight=50)]
    mirror.ref.upsert_job(job)
    scores = _compare(mirror, job)
    racked = [i for i in range(8) if i % 2 == 0]
    rackless = [i for i in range(8) if i % 2]
    assert max(scores[rackless]) < min(scores[racked])


def test_score_once_spread_algorithm():
    rng = random.Random(13)
    mirror = Mirror(rng, n_nodes=10)
    job = mock.job()
    job.id = "scored"
    _compare(mirror, job, algorithm=enums.SCHED_ALG_SPREAD)


def test_score_once_two_spreads_pairwise_tree():
    """Three spreads: the pad-to-4 pairwise tree and weights over S."""
    rng = random.Random(17)
    mirror = Mirror(rng, n_nodes=20, dcs=("d1", "d2"), attrs=lambda i: {
        "rack": f"r{i % 5}", "zone": f"z{i % 3}"})
    job = mock.job(datacenters=["d1", "d2"])
    job.id = "scored"
    job.task_groups[0].spreads = [
        Spread(attribute="${attr.rack}", weight=30),
        Spread(attribute="${attr.zone}", weight=50,
               targets=[SpreadTarget("z0", 60), SpreadTarget("z1", 40)]),
        Spread(attribute="${node.datacenter}", weight=20)]
    own = []
    for i in range(7):
        a = mock.alloc(job, rng.choice(mirror.nodes), index=i)
        a.id = f"own-{i}"
        own.append(a)
    mirror.ref.upsert_allocs(own)
    mirror.ref.upsert_job(job)
    _compare(mirror, job, own)


def test_score_once_distinct_hosts_masks_the_jobs_nodes():
    rng = random.Random(19)
    mirror = Mirror(rng, n_nodes=16)
    job = mock.job(constraints=[Constraint("", "", "distinct_hosts")])
    job.id = "scored"
    own = []
    for i, node in enumerate(mirror.nodes[:5]):
        a = mock.alloc(job, node, index=i)
        a.id = f"own-{i}"
        own.append(a)
    mirror.ref.upsert_allocs(own)
    mirror.ref.upsert_job(job)
    # the host score_nodes leaves distinct_hosts to select_best_node
    scores = _compare(mirror, job, own, host=False)
    assert (scores[:5] <= NEG / 2).all()


def test_score_once_distinct_property_caps_values():
    rng = random.Random(23)
    mirror = Mirror(rng, n_nodes=16, attrs=lambda i: (
        {"rack": f"r{i % 4}"} if i != 15 else {}))
    job = mock.job(constraints=[
        Constraint("${attr.rack}", "2", "distinct_property")])
    job.id = "scored"
    own = []
    for i, node in enumerate([mirror.nodes[0], mirror.nodes[4],
                              mirror.nodes[1]]):
        a = mock.alloc(job, node, index=i)
        a.id = f"own-{i}"
        own.append(a)
    mirror.ref.upsert_allocs(own)
    mirror.ref.upsert_job(job)
    scores = _compare(mirror, job, own, host=False)
    capped = [i for i in range(16) if i % 4 == 0] + [15]
    assert (scores[capped] <= NEG / 2).all()
    assert (scores[[1, 2, 3, 5]] > NEG / 2).all()


def test_score_once_penalty_node():
    rng = random.Random(29)
    mirror = Mirror(rng, n_nodes=12)
    job = mock.job()
    job.id = "scored"
    base = _compare(mirror, job, host=False)
    hit = _compare(mirror, job, penalty=3, host=False)
    assert hit[3] < base[3]
    np.testing.assert_array_equal(np.delete(hit, 3), np.delete(base, 3))


# ---------------------------------------------------------------------------
# B9: the K-step scan, plain torch vs the JAX fused entry
# ---------------------------------------------------------------------------


def _device_columns(rng, n, n_real, extra):
    """``extra`` count columns as tensor/cluster.py appends them for
    device asks and reserved cores (capacity, usage, ask), and a
    device-affinity sub-score with zeros, positives and a negative."""
    cap = np.zeros((n, extra))
    cap[:n_real] = rng.choice([0, 4, 8], (n_real, extra))
    cap[:n_real, -1] = 16                       # the cores column
    used = np.minimum(cap, rng.integers(0, 6, (n, extra)))
    ask = np.array([1.0] * (extra - 1) + [2.0])
    dev = np.zeros(n)
    dev[:n_real] = rng.choice([0.0, 0.0, 0.5, 1.0, -0.25], n_real)
    return cap, used, ask, dev


def _scan_fixture(seed, *, n=512, n_real=480, k=64, k_active=59, s=2, v=8,
                  p=1, vd=4, targets=True, perm=True, dh_tg=False,
                  spread_alg=False, extra=0):
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4))
    avail[:n_real, 0] = rng.choice([8000, 16000, 32000], n_real)
    avail[:n_real, 1] = rng.choice([16384, 32768, 65536], n_real)
    avail[:n_real, 2] = 102400
    avail[:n_real, 3] = 12001
    used = np.zeros((n, 4))
    fill = rng.integers(0, 40, n_real)
    used[:n_real, 0] = fill * 100
    used[:n_real, 1] = fill * 64
    ptg = rng.integers(0, 3, n) * (rng.random(n) < 0.2)
    pjob = ptg + (rng.random(n) < 0.1)
    feas = np.zeros(n, bool)
    feas[:n_real] = rng.random(n_real) < 0.9
    aff = np.zeros(n)
    aff[:n_real] = rng.choice([0.0, 0.0, 0.5, -0.25], n_real)
    pen = np.full(k, -1)
    pen[3] = 5
    pen[10] = int(rng.integers(0, n_real))
    active = np.zeros(k, bool)
    active[:k_active] = True
    svid = rng.integers(0, v - 2, (s, n))
    sok = rng.random((s, n)) < 0.95
    scnt = rng.integers(0, 4, (s, v))
    scnt[:, -2:] = 0
    sdes = np.full((s, v), np.nan)
    has_t = np.zeros(s, bool)
    if targets and s:
        has_t[0] = True
        sdes[0, : v - 2] = rng.choice([0.0, 10.0, 25.5, 40.0], v - 2)
    w = np.full(s, 1.0 / max(s, 1))
    dvid = rng.integers(0, vd, (p, n))
    dok = rng.random((p, n)) < 0.97
    dcnt = rng.integers(0, 2, (p, vd))
    dlim = np.full(p, 30.0)
    tie_perm = rng.permutation(n) if perm else None
    ask = np.array([100.0, 64.0, 300.0, 0.0])
    dev = None
    if extra:
        cap, xused, xask, dev = _device_columns(rng, n, n_real, extra)
        avail = np.concatenate([avail, cap], axis=1)
        used = np.concatenate([used, xused], axis=1)
        ask = np.concatenate([ask, xask])
    return kernels.pack_solve_args(
        avail, used, ptg, pjob, ask, feas,
        aff, pen, active, svid, sok, scnt, sdes, has_t, w, -1.0, 50.0,
        False, dh_tg, spread_alg, dev_affinity=dev, dp_val_id=dvid,
        dp_val_ok=dok, dp_counts0=dcnt, dp_limit=dlim, tie_perm=tie_perm)


def _scan_both(packed):
    want = np.asarray(ref_kernels.solve_task_group_fused(
        *[jnp.asarray(a) for a in packed]))
    got = kernels.solve_task_group_fused(
        *[torch.from_numpy(a) for a in packed]).numpy()
    np.testing.assert_array_equal(got[0], want[0], "choices")
    np.testing.assert_array_equal(got[1], want[1], "founds")
    _close(got[2], want[2], "scores")
    return got


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, targets=False), dict(seed=2, perm=False),
    dict(seed=3, s=0, p=0), dict(seed=4, s=3, v=16, p=2),
    dict(seed=5, spread_alg=True),
    # more steps than feasible nodes: distinct_hosts runs the group dry
    dict(seed=6, n=64, n_real=40, k=64, k_active=60, dh_tg=True),
    # device and core columns with a device-affinity sub-score: d = 6 on
    # the lean shape (one spread, no distinct_property: config 5's) and
    # on the full one, d = 8 (the narrow instance's widest) on the full one
    dict(seed=7, extra=2, s=1, p=0), dict(seed=8, extra=2, s=0, p=0),
    dict(seed=9, extra=2), dict(seed=10, extra=4, s=3, v=16, p=1),
    # past the narrow instance (the wide one on the card): d 9 and 12 from
    # device and core columns, 9 and 16 spreads, 9 distinct_property
    # constraints, and all three at once
    dict(seed=11, extra=5), dict(seed=12, extra=8, s=1, p=0),
    dict(seed=13, s=9, v=16), dict(seed=14, s=16, v=8),
    dict(seed=15, p=9, vd=6), dict(seed=16, extra=6, s=9, v=12, p=9, vd=5),
])
def test_scan_plain_matches_jax(case):
    packed = _scan_fixture(**case)
    if case.get("extra"):
        d = 4 + case["extra"]
        assert packed[0].shape[1] == 2 * d + 6        # the node matrix
        assert np.any(packed[0][:, 2 * d + 4] != 0)   # dev_affinity
    got = _scan_both(packed)
    k_active = case.get("k_active", 59)
    assert not got[1][k_active:].any()         # padded steps find nothing
    if case.get("dh_tg"):
        assert 0 < got[1].sum() < k_active     # ran out of feasible nodes
        placed = got[0][got[1] > 0.5]
        assert len(set(placed.tolist())) == len(placed)


def test_scan_ties_go_to_the_permutation_order():
    """Identical nodes: every step is a tie, broken by tie_perm."""
    n, k = 64, 16
    avail = np.tile([4000.0, 8192.0, 102400.0, 12001.0], (n, 1))
    zeros = np.zeros(n)
    empty = np.zeros((0, n))
    for perm_seed in (0, 1):
        perm = np.random.default_rng(perm_seed).permutation(n)
        packed = kernels.pack_solve_args(
            avail, np.zeros((n, 4)), zeros, zeros,
            np.array([100.0, 64.0, 300.0, 0.0]), np.ones(n, bool), zeros,
            np.full(k, -1), np.ones(k, bool), empty, empty,
            np.zeros((0, 1)), np.zeros((0, 1)), np.zeros(0, bool),
            np.zeros(0), -1.0, float(k), False, True, False, tie_perm=perm)
        got = _scan_both(packed)
        np.testing.assert_array_equal(got[0], perm[:k])


def test_pack_and_pairwise_match_the_reference():
    """The packer gives the reference's arrays, and the fixed tree the
    reference's bits."""
    rng = np.random.default_rng(1)
    raw = (rng.random((16, 4)), rng.random((16, 4)), rng.integers(0, 3, 16),
           rng.integers(0, 3, 16), rng.random(4), rng.random(16) < 0.5,
           rng.random(16), np.full(8, -1), np.ones(8, bool),
           rng.integers(0, 4, (2, 16)), rng.random((2, 16)) < 0.5,
           rng.integers(0, 3, (2, 4)), rng.random((2, 4)),
           np.array([True, False]), np.array([0.25, 0.75]), -1.0, 10.0,
           True, False, False)
    for got, want in zip(kernels.pack_solve_args(*raw),
                         ref_kernels.pack_solve_args(*raw)):
        np.testing.assert_array_equal(got, want)
    for s in (0, 1, 3, 4, 5):
        v = rng.standard_normal((s, 7)).astype(F32)
        want = np.asarray(ref_kernels._pairwise_sum_xp(jnp, jnp.asarray(v)))
        got = kernels.pairwise_sum_ref(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)


def carry_tree_ref(v: torch.Tensor) -> torch.Tensor:
    """csrc/score.cuh ``carry_tree`` (the wide instance's spread tree) in
    plain torch: leaves in order, zero-padded to the next power of two;
    leaf i merges the partial sums its trailing one bits name, each sum
    left + right; the total is the top level's partial sum."""
    s = v.shape[0]
    width, levels = 1, 0
    while width < s:
        width, levels = width * 2, levels + 1
    part = [None] * (levels + 1)
    for i in range(width):
        x = v[i] if i < s else v.new_zeros(v.shape[1:])
        lv = 0
        while (i >> lv) & 1:
            x = part[lv] + x
            lv += 1
        part[lv] = x
    return part[levels]


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


def test_carry_tree_equals_the_pairwise_tree():
    """The wide instance's carry stack gives the reference's halving tree
    bit for bit (``_pairwise_sum_xp``, kernels.py:91-110) at every S from
    0 to 70, on values with -0.0, exact zeros, -1.0 (a node lacking a
    value) and magnitudes far apart (so the add order shows)."""
    rng = np.random.default_rng(5)
    for s in range(71):
        v = rng.standard_normal((s, 9)).astype(F32)
        v *= F32(10.0) ** rng.integers(-6, 7, (s, 9)).astype(F32)
        v[rng.random((s, 9)) < 0.2] = F32(-0.0)
        v[rng.random((s, 9)) < 0.1] = F32(0.0)
        v[rng.random((s, 9)) < 0.1] = F32(-1.0)
        want = np.asarray(ref_kernels._pairwise_sum_xp(jnp, jnp.asarray(v)))
        got = carry_tree_ref(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), f"S {s}")
        np.testing.assert_array_equal(
            _bits(got), _bits(kernels.pairwise_sum_ref(torch.from_numpy(v))),
            f"S {s}")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    packed = [torch.from_numpy(a) for a in _scan_fixture(0, n=64, n_real=60,
                                                         k=16, k_active=16)]
    _ext.COUNTS.reset()
    kernels.solve_task_group_fused(*packed)
    assert _ext.COUNTS.launches["solve_task_group"] == 0
    assert _ext.COUNTS.plain_on_cuda["solve_task_group"] == 0
    meta = [t.to("meta") for t in packed]
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.solve_task_group_fused(*meta)


def test_scan_plain_is_deterministic_and_leaves_inputs_alone():
    packed = _scan_fixture(8)
    before = [a.copy() for a in packed]
    tensors = [torch.from_numpy(a) for a in packed]
    a = kernels.solve_task_group_fused(*tensors).numpy()
    b = kernels.solve_task_group_fused(*copy.deepcopy(tensors)).numpy()
    np.testing.assert_array_equal(a, b)
    for x, y in zip(packed, before):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the cached identity under the redesigned B9 and B11 (csrc/score.cuh)
# ---------------------------------------------------------------------------


def _identity_fixture(variant, seed=0, n=256, real=240, k=32):
    """A cfg3-like scan at a small width: "even" one even spread over 20
    racks; "targets" explicit targets with a zero and a missing target,
    affinities, placed allocs and penalty steps; "worstfit" three spreads
    (the padded tree) under WorstFit on near-full nodes; "distinct"
    distinct_hosts with a distinct_property cap, more steps than nodes
    left; "penalty" the even spread with a penalty node at most steps;
    "devices" the even spread with two device/core count columns (d = 6)
    and a device-affinity sub-score, config 5's lean shape; "devices_wide"
    four such columns (d = 8), three spreads and a distinct_property;
    "wide" the wide instance's shape: eight such columns (d = 12), nine
    spreads (one with targets, one missing on some nodes) and nine
    distinct_property constraints."""
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4))
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2:] = [102400, 12001]
    used = np.zeros((n, 4))
    fill = rng.integers(0, 30, real)
    used[:real, :3] = fill[:, None] * [100, 64, 300]
    ptg, pjob, aff = np.zeros(n), np.zeros(n), np.zeros(n)
    feas = np.arange(n) < real
    pen = np.full(k, -1)
    active = np.arange(k) < k - 2
    s, v = 1, 32
    svid = (np.arange(n) % 20)[None, :].astype(float)
    sok = feas[None, :].copy()
    scnt = np.zeros((s, v))
    sdes = np.full((s, v), np.nan)
    has_t, weight = np.zeros(s, bool), np.ones(s)
    dh_tg = spread_alg = False
    dp = dict(dp_val_id=np.zeros((0, n)), dp_val_ok=np.zeros((0, n), bool),
              dp_counts0=np.zeros((0, 1)), dp_limit=np.zeros(0))
    ask, dev = np.array([100.0, 64.0, 300.0, 0.0]), None
    if variant in ("devices", "devices_wide", "wide"):
        extra = {"devices": 2, "devices_wide": 4, "wide": 8}[variant]
        cap, xused, xask, dev = _device_columns(rng, n, real, extra)
        avail = np.concatenate([avail, cap], axis=1)
        used = np.concatenate([used, xused], axis=1)
        ask = np.concatenate([ask, xask])
    if variant == "devices_wide":   # the full cache: spreads and a property
        s = 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 3]).astype(float)
        sok = np.tile(feas, (s, 1))
        scnt = rng.integers(0, 6, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        has_t, weight = np.zeros(s, bool), np.full(s, 1.0 / s)
        dp = dict(dp_val_id=(np.arange(n) % 7)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 3)[None, :],
                  dp_counts0=rng.integers(0, 3, (1, 8)),
                  dp_limit=np.array([9.0]))
    if variant == "wide":
        mods = (20, 4, 3, 5, 7, 2, 11, 6, 9)
        s = len(mods)
        svid = np.stack([np.arange(n) % m for m in mods]).astype(float)
        sok = np.tile(feas, (s, 1))
        sok[4, ::13] = False                  # a missing attribute
        scnt = rng.integers(0, 4, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        sdes[1, :4] = [20.0, 15.0, 10.0, 0.0]
        has_t = np.zeros(s, bool)
        has_t[1] = True
        weight = np.full(s, 1.0 / s)
        dmods = (7, 5, 3, 4, 6, 8, 2, 7, 5)
        dp = dict(dp_val_id=np.stack([np.arange(n) % m
                                      for m in dmods]).astype(float),
                  dp_val_ok=np.tile(np.arange(n) < real - 3, (len(dmods), 1)),
                  dp_counts0=rng.integers(0, 3, (len(dmods), 8)),
                  dp_limit=np.full(len(dmods), 12.0))
    if variant == "targets":
        has_t[0] = True
        sdes[0, :18] = 4.0
        sdes[0, 3] = 0.0                      # a zero target
        scnt[0, :20] = rng.integers(0, 5, 20)  # values 18, 19: no target
        pen[rng.integers(0, k, 8)] = rng.integers(0, real, 8)
        ptg[:real] = rng.integers(0, 3, real) * (rng.random(real) < 0.2)
        aff[:real] = rng.choice([0.0, 0.0, 0.5, -0.5], real)
    elif variant == "worstfit":
        spread_alg, s = True, 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 3]).astype(float)
        sok = np.tile(feas, (s, 1))
        sok[2, ::11] = False                  # a missing attribute
        scnt = rng.integers(0, 6, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        sdes[1, :4] = [20.0, 15.0, 10.0, 0.0]
        has_t = np.array([False, True, False])
        weight = np.array([0.2, 0.5, 0.3])
        used[:real, 0] = avail[:real, 0] - 100 * rng.integers(0, 5, real)
    elif variant == "distinct":
        dh_tg = True
        feas = feas & (rng.random(n) < 0.1)   # ~24 nodes for 30 steps
        ptg[:real] = rng.random(real) < 0.02
        dp = dict(dp_val_id=(np.arange(n) % 7)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 3)[None, :],
                  dp_counts0=rng.integers(0, 3, (1, 8)),
                  dp_limit=np.array([4.0]))
    elif variant == "penalty":
        pen[::2] = rng.integers(0, real, k // 2)
        pjob[:real] = rng.random(real) < 0.1
    return kernels.pack_solve_args(
        avail, used, ptg, pjob, ask, feas,
        aff, pen, active, svid, sok, scnt, sdes, has_t, weight, -1.0,
        float(k), False, dh_tg, spread_alg, dev_affinity=dev,
        dp_val_id=dp["dp_val_id"], dp_val_ok=dp["dp_val_ok"],
        dp_counts0=dp["dp_counts0"], dp_limit=dp["dp_limit"],
        tie_perm=rng.permutation(n))


# the cached identity of csrc/score.cuh in plain torch: the twins of the
# kernels' internal steps, held here against the full score

def node_terms_ref(*, available, used, ask, feasible, placed_tg, placed_job,
                   affinity_boost, dev_affinity, tg_count, dh_job, dh_tg,
                   spread_alg):
    """The cached part of B8 (csrc/score.cuh ``node_terms``), in plain
    torch: what a node's score owes to its own columns. Returns (head,
    div_base, ok_local): head is :func:`kernels.score_nodes_ref`'s add
    chain up to the spread term with the reschedule term absent (its ``+ 0.0``
    included), div_base its divisor without the spread term, ok_local its
    mask without distinct_property. B9 and B11 keep these per node and
    recompute them only where a step changed the node."""
    f = available.dtype
    new_used = used + ask[None, :]
    ok = feasible & torch.all(new_used <= available, dim=1)
    ok = ok & (~dh_job | (placed_job == 0))
    ok = ok & (~dh_tg | (placed_tg == 0))
    fitness = kernels.fit_scores(available, new_used, spread_alg)
    anti_present = placed_tg > 0
    anti = -(placed_tg.to(f) + 1.0) / torch.clamp_min(tg_count, 1.0)
    aff_present = affinity_boost != 0.0
    dev_present = dev_affinity != 0.0
    head = (fitness + torch.where(anti_present, anti, 0.0)
            + torch.zeros_like(fitness)
            + torch.where(aff_present, affinity_boost, 0.0)
            + torch.where(dev_present, dev_affinity, 0.0))
    div_base = (1.0 + anti_present.to(f) + aff_present.to(f)
                + dev_present.to(f))
    return head, div_base, ok


def value_tables_ref(*, spread_counts, spread_desired, spread_has_targets,
                     spread_weight, dp_counts, dp_limit, lowest_boost):
    """The per-step value tables of the cached score (csrc/score.cuh
    ``value_tables``), in plain torch: boost (S, V), the boost
    :func:`kernels.score_nodes_ref` gives a node holding value t of
    spread k, at these counts; dp_ok (P, Vd), whether value t of
    distinct_property k is below its limit."""
    f = spread_desired.dtype
    cur = spread_counts.to(f)
    des = spread_desired
    explicit = torch.where(
        torch.isnan(des), -1.0,
        torch.where(des == 0.0, lowest_boost,
                    (des - (cur + 1.0))
                    / torch.where(des == 0.0, 1.0, des)
                    * spread_weight[:, None]))
    present_v = spread_counts > 0
    any_present = torch.any(present_v, dim=1)
    minc = torch.where(present_v, spread_counts,
                       kernels._INT32_MAX).amin(dim=1).to(f)
    maxc = torch.where(present_v, spread_counts, 0).amax(dim=1).to(f)
    minc_b = minc[:, None]
    maxc_b = maxc[:, None]
    safe_min = torch.where(minc_b == 0.0, 1.0, minc_b)
    even = torch.where(
        cur != minc_b,
        torch.where(minc_b == 0.0, -1.0, (minc_b - cur) / safe_min),
        torch.where(minc_b == maxc_b, -1.0,
                    torch.where(minc_b == 0.0, 1.0,
                                (maxc_b - minc_b) / safe_min)))
    even = torch.where(any_present[:, None], even, 0.0)
    boost = torch.where(spread_has_targets[:, None], explicit, even)
    return boost, dp_counts < dp_limit[:, None]


def cached_scores_ref(head, div_base, ok_local, boost, dp_ok, *,
                      spread_val_id, spread_val_ok, dp_val_id, dp_val_ok):
    """B8 from the cached terms and the value tables (csrc/score.cuh
    ``cached_score``), in plain torch: each node's table entries (-1
    where it lacks the spread value), the fixed pairwise tree, one add,
    one division, the mask. Equals :func:`kernels.score_nodes_ref` bit
    for bit at every node but the step's penalty node."""
    f = head.dtype
    b = torch.where(spread_val_ok, torch.gather(boost, 1, spread_val_id),
                    -1.0)
    spread_total = kernels.pairwise_sum_ref(b)
    present = spread_total != 0.0
    total = head + torch.where(present, spread_total, 0.0)
    score = total / (div_base + present.to(f))
    ok = ok_local
    if dp_val_id.shape[0]:
        ok = ok & torch.all(dp_val_ok & torch.gather(dp_ok, 1, dp_val_id),
                            dim=0)
    return torch.where(ok, score, kernels.NEG)


def identity_hook(monkeypatch):
    """Wrap kernels.score_nodes_ref so that every call (every step of a
    plain scan, at that step's carry) also computes the cached identity
    (node_terms_ref, value_tables_ref, cached_scores_ref) and asserts it
    equals the full score bit for bit at every node but the step's
    penalty node, which the kernels score in full, and that each node's
    boost-table entry is the boost the full score used. Returns the list
    of the penalty indices seen, one a call."""
    real = kernels.score_nodes_ref
    seen = []

    def hook(**kw):
        score, fitness, boost = real(**kw)
        head, div_base, ok = node_terms_ref(**{
            name: kw[name] for name in (
                "available", "used", "ask", "feasible", "placed_tg",
                "placed_job", "affinity_boost", "dev_affinity", "tg_count",
                "dh_job", "dh_tg", "spread_alg")})
        table, dp_ok = value_tables_ref(
            spread_counts=kw["spread_counts"],
            spread_desired=kw["spread_desired"],
            spread_has_targets=kw["spread_has_targets"],
            spread_weight=kw["spread_weight"], dp_counts=kw["dp_counts"],
            dp_limit=kw["dp_limit"], lowest_boost=kw["lowest_boost"])
        cached = cached_scores_ref(
            head, div_base, ok, table, dp_ok,
            spread_val_id=kw["spread_val_id"],
            spread_val_ok=kw["spread_val_ok"], dp_val_id=kw["dp_val_id"],
            dp_val_ok=kw["dp_val_ok"])
        pen = int(kw["penalty_idx"])
        rest = torch.ones(score.shape[0], dtype=torch.bool)
        if pen >= 0:
            rest[pen] = False
        assert torch.equal(cached[rest].view(torch.int32),
                           score[rest].view(torch.int32))
        per_node = torch.where(kw["spread_val_ok"],
                               torch.gather(table, 1, kw["spread_val_id"]),
                               -1.0)
        assert torch.equal(per_node.view(torch.int32),
                           boost.view(torch.int32))
        # the wide instance's tree over the same entries
        assert torch.equal(
            carry_tree_ref(per_node).view(torch.int32),
            kernels.pairwise_sum_ref(per_node).view(torch.int32))
        seen.append(pen)
        return score, fitness, boost

    monkeypatch.setattr(kernels, "score_nodes_ref", hook)
    return seen


@pytest.mark.parametrize("variant", ["even", "targets", "worstfit",
                                     "distinct", "penalty", "devices",
                                     "devices_wide", "wide"])
def test_cached_identity_equals_the_full_score_at_every_step(variant,
                                                             monkeypatch):
    """B9's and B11's cached terms + value-table lookups + tree + division
    give score_nodes_ref's scores bit for bit at every step of the plain
    scan's carry (csrc/score.cuh states why), on eight cfg3-like
    fixtures at 256 nodes and K 32, three of them with device columns
    (one at the wide instance's shape); the wide instance's carry tree
    gives the same spread totals."""
    packed = [torch.from_numpy(a) for a in _identity_fixture(variant)]
    seen = identity_hook(monkeypatch)
    got = kernels.solve_task_group_fused(*packed)
    k = packed[1].shape[0]
    assert len(seen) == k
    assert got[1].sum() > 0
    if variant in ("targets", "penalty"):
        assert any(p >= 0 for p in seen)
    if variant == "distinct":
        assert 0 < got[1].sum() < k - 2   # the group ran out of nodes


# ---------------------------------------------------------------------------
# B9 and B10 on stub cards past the narrow instance's caps
# ---------------------------------------------------------------------------

# d 9 (five device/core columns on the lean shape), s 9, p 9
STUB_WIDE = {"d9": dict(extra=5, s=1, p=0), "s9": dict(s=9, v=16),
             "p9": dict(p=9, vd=6)}


@pytest.mark.parametrize("shape", sorted(STUB_WIDE))
def test_b9_and_b10_launch_past_eight(fake_card, shape):
    """A shape past 8 columns, spreads or distinct_property constraints
    launches B9 and B10 once each on a stub card (the library takes the
    wide instance), with the packed layout's pointers and sizes and B9's
    scratch of its library's size; nothing is refused."""
    packed = [torch.from_numpy(a) for a in _scan_fixture(
        0, n=64, n_real=60, k=16, k_active=16, **STUB_WIDE[shape])]
    query = _ext.entry("nt_solve_task_group_scratch_words")
    query.code = 55
    before = _ext.COUNTS.snapshot()["launches"]
    out = kernels.solve_task_group_fused(*packed)
    score = kernels.score_nodes_packed(packed[0], *packed[2:], 3)
    after = _ext.COUNTS.snapshot()["launches"]
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"solve_task_group": 1,
                                          "score_nodes": 1}
    n, w = packed[0].shape
    d, s, v = (w - 6) // 2, packed[4].shape[0], packed[3].shape[1]
    p, vd = packed[5].shape[0] // 2, packed[6].shape[1] - 1
    assert max(d, s, p) == 9 and kernels.is_wide(d, s, p)
    lib = fake_card["task_group"].fns
    (call,) = lib["nt_solve_task_group"].calls
    assert call[:8] == tuple(t.data_ptr() for t in packed)
    assert call[9] == out.data_ptr()
    assert call[10:18] == (n, d, 16, s, v, p, vd, 55)   # then the stream
    assert query.calls == [(n, d, s, v, p, vd)]
    (call,) = lib["nt_score_nodes"].calls
    assert call[:7] == tuple(t.data_ptr() for t in packed[:1] + packed[2:])
    assert call[7] == score.data_ptr()
    assert call[8:15] == (3, n, d, s, v, p, vd)


@pytest.mark.parametrize("what", ["spreads", "properties"])
def test_b9_and_b10_refuse_tables_past_shared_memory(fake_card, what):
    """Count tables past a CTA's shared memory (4 spreads of 8,192 values;
    16 distinct_property constraints of 4,096 values) raise ValueError
    naming the bytes before anything is launched; one value fewer a
    table's row than the limit allows passes the check."""
    cfg = (dict(s=4, v=8192) if what == "spreads"
           else dict(p=16, vd=4096))
    packed = [torch.from_numpy(a) for a in _scan_fixture(
        0, n=64, n_real=60, k=16, k_active=16, **cfg)]
    for fn in (lambda: kernels.solve_task_group_fused(*packed),
               lambda: kernels.score_nodes_packed(packed[0], *packed[2:],
                                                  -1)):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            fn()
    assert not fake_card["task_group"].fns.get("nt_solve_task_group")
    assert not fake_card["task_group"].fns.get("nt_score_nodes")
    # the limit is the tables' bytes: 4 x 7,000 values fit, 4 x 8,192 not
    limit = kernels.SCAN_SMEM_BYTES
    assert kernels.scan_smem_bytes(4, 4, 7000, 0, 1) <= limit
    assert kernels.scan_smem_bytes(4, 4, 8192, 0, 1) > limit
    # the wide instance adds the winner's ids (S + P u16), whole 16 bytes
    assert kernels.scan_smem_bytes(12, 4, 7000, 0, 1) == (
        kernels._r16(kernels.table_bytes(4, 7000, 0, 1)) + 16)
