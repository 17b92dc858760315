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
from test_torch_pipeline import node_record
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


def _scan_fixture(seed, *, n=512, n_real=480, k=64, k_active=59, s=2, v=8,
                  p=1, vd=4, targets=True, perm=True, dh_tg=False,
                  spread_alg=False):
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
    return kernels.pack_solve_args(
        avail, used, ptg, pjob, np.array([100.0, 64.0, 300.0, 0.0]), feas,
        aff, pen, active, svid, sok, scnt, sdes, has_t, w, -1.0, 50.0,
        False, dh_tg, spread_alg, dp_val_id=dvid, dp_val_ok=dok,
        dp_counts0=dcnt, dp_limit=dlim, tie_perm=tie_perm)


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
])
def test_scan_plain_matches_jax(case):
    got = _scan_both(_scan_fixture(**case))
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
