"""B16's device-side step loop (nomad_tpu_torch/csrc/task_group_shard.cu
``nt_task_group_shard_solve``) on the CPU: its schedule in plain torch, and
its host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of what one launch does, shard by shard: each shard's
cached node terms (csrc/score.cuh's identity: tests/test_torch_task_group.py
``node_terms_ref`` / ``value_tables_ref`` / ``cached_scores_ref``) over its
live rows, kept in row order, scored each step with the cached score (the
full score at the step's penalty row), the shard's best by (score desc,
tie-break position asc) pushed as a candidate row into every shard's
gather buffer at the step's parity, one barrier, every shard's pick of
the same winner from its own buffer, and the commit: the value counts
and the lowest explicit boost from the candidate's own value ids on
every shard, the usage, placement counts and cached terms of the
winner's row on its owner only (computed ahead, from the candidate,
while the barrier runs). A shard with no live row above NEG pushes (NEG,
its lowest position, that row), so a step that finds nothing reports
position 0 at NEG, as B9 does.

The model must equal ``solve_task_group_sharded_ref`` bit for bit and the
JAX package's ``solve_task_group`` (choices and founds exactly, scores
within 1e-6: torch's and XLA's f32 ``10**x`` may round 1 ulp apart) at S
= 1, 2, 4, 8, on cfg3-like variants at a small width and on
tests/test_torch_graft_entry.py's fixtures (its hazard fixture's last
steps find nothing). At every step the owners' refreshed terms equal a
full recompute of every row's terms, and no buffer row is read before
its step's push or after the next push into its parity."""

import numpy as np
import pytest
import torch

from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import kernels
from nomad_tpu_torch.tensor import sharding as sh
from nomad_tpu_torch.tensor.kernels import NEG, score_nodes_ref
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_graft_entry import FIXTURES as GRAFT_FIXTURES
from test_torch_task_group import (cached_scores_ref, node_terms_ref,
                                   value_tables_ref)

SHARDS = (1, 2, 4, 8)
SCORE_ATOL = 1e-6
NO_VALUE = 0xFFFF     # score.cuh kNoValue: the row lacks the value
F32 = np.float32


def small_cfg3(variant: str, seed: int = 0, n: int = 256, real: int = 240,
               k: int = 32):
    """chip_smoke.py's cfg3 variants at 256 nodes and K 32, as the 26
    positional arguments of solve_task_group: "cfg3" one even rack spread
    over 20 values, two inactive steps, a tie_perm; "targets" explicit
    targets with a zero and a missing target, placed allocs, affinities
    and penalty steps; "distinct" distinct_hosts and a binding
    distinct_property cap, more steps than fitting nodes; "worstfit"
    three spreads (the padded pairwise tree), WorstFit, near-full nodes;
    "infeasible" no node fits; past the narrow instance's caps (the wide
    one on the card): "cols" five device/core count columns (d 9) on the
    lean shape, "wide" eight (d 12) with nine spreads (one with targets)
    and nine distinct_property constraints, one of them binding."""
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4), F32)
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2:] = (102400, 12001)
    used = np.zeros((n, 4), F32)
    used[:real, :3] = rng.integers(0, 30, real)[:, None] * np.array(
        [100, 64, 300], F32)
    ptg, pjob, aff = np.zeros(n, F32), np.zeros(n, F32), np.zeros(n, F32)
    dev_aff = np.zeros(n, F32)
    feas = np.arange(n) < real
    pen = np.full(k, -1, np.int32)
    active = np.arange(k) < k - 2
    s, v = 1, 32
    svid = (np.arange(n) % 20)[None, :].astype(np.int32)
    sok = feas[None, :].copy()
    scnt = np.zeros((s, v), np.int32)
    sdes = np.full((s, v), np.nan, F32)
    has_t, weight = np.zeros(s, bool), np.ones(s, F32)
    dvid, dok = np.zeros((0, n), np.int32), np.zeros((0, n), bool)
    dcnt, dlim = np.zeros((0, 1), np.int32), np.zeros(0, F32)
    dh_tg = spread_alg = False
    ask = np.array([100.0, 64.0, 300.0, 0.0], F32)
    if variant == "targets":
        has_t[0] = True
        sdes[0, :18] = 4.0
        sdes[0, 3] = 0.0
        scnt[0, :20] = rng.integers(0, 5, 20)
        pen[rng.integers(0, k, 8)] = rng.integers(0, real, 8)
        ptg[:real] = rng.integers(0, 3, real) * (rng.random(real) < 0.2)
        aff[:real] = rng.choice([0.0, 0.0, 0.5, -0.5], real)
    elif variant == "distinct":
        dh_tg = True
        feas = feas & (rng.random(n) < 0.1)
        ptg[:real] = rng.random(real) < 0.02
        dvid = (np.arange(n) % 7)[None, :].astype(np.int32)
        dok = (np.arange(n) < real - 3)[None, :]
        dcnt = rng.integers(0, 3, (1, 8)).astype(np.int32)
        dlim = np.array([4.0], F32)
    elif variant == "worstfit":
        spread_alg, s = True, 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 3]).astype(np.int32)
        sok = np.tile(feas, (s, 1))
        sok[2, ::11] = False
        scnt = (rng.integers(0, 6, (s, v)) * (np.arange(v) < 20)).astype(
            np.int32)
        sdes = np.full((s, v), np.nan, F32)
        sdes[1, :4] = [20.0, 15.0, 10.0, 0.0]
        has_t = np.array([False, True, False])
        weight = np.array([0.2, 0.5, 0.3], F32)
        used[:real, 0] = avail[:real, 0] - 100 * rng.integers(0, 5, real)
    elif variant == "infeasible":
        ask = np.array([64000.0, 64.0, 300.0, 0.0], F32)
    elif variant in ("cols", "wide"):
        extra = 5 if variant == "cols" else 8
        cap = np.zeros((n, extra), F32)
        cap[:real] = rng.choice([0, 4, 8], (real, extra))
        cap[:real, -1] = 16                     # the cores column
        avail = np.concatenate([avail, cap], axis=1)
        used = np.concatenate([used, np.minimum(
            cap, rng.integers(0, 6, (n, extra))).astype(F32)], axis=1)
        ask = np.concatenate([ask, [1.0] * (extra - 1) + [2.0]]).astype(F32)
        dev_aff[:real] = rng.choice([0.0, 0.0, 0.5, -0.25], real)
    if variant == "wide":
        mods = (20, 4, 3, 5, 7, 2, 11, 6, 9)
        s = len(mods)
        svid = np.stack([np.arange(n) % m for m in mods]).astype(np.int32)
        sok = np.tile(feas, (s, 1))
        sok[4, ::13] = False
        scnt = (rng.integers(0, 4, (s, v)) * (np.arange(v) < 20)).astype(
            np.int32)
        sdes = np.full((s, v), np.nan, F32)
        sdes[1, :4] = [20.0, 15.0, 10.0, 0.0]
        has_t = np.zeros(s, bool)
        has_t[1] = True
        weight = np.full(s, 1.0 / s, F32)
        dmods = (7, 5, 3, 4, 6, 8, 2, 7, 5)
        dvid = np.stack([np.arange(n) % m for m in dmods]).astype(np.int32)
        dok = np.tile(np.arange(n) < real - 3, (len(dmods), 1))
        dcnt = rng.integers(0, 3, (len(dmods), 8)).astype(np.int32)
        dlim = np.full(len(dmods), 12.0, F32)
        dlim[6] = 9.0                           # 2 values: 18 of 32 steps
    return (avail, used, ptg, pjob, ask, feas, aff, dev_aff, pen, active,
            svid, sok, scnt, sdes, has_t, weight, dvid, dok, dcnt, dlim,
            F32(-1.0), F32(k), False, dh_tg, spread_alg,
            rng.permutation(n).astype(np.int32))


FIXTURES = {f"cfg3_{v}": (lambda v=v: small_cfg3(v))
            for v in ("cfg3", "targets", "distinct", "worstfit",
                      "infeasible", "cols", "wide")}
FIXTURES.update({f"graft_{name}": make
                 for name, make in GRAFT_FIXTURES.items()})


class Shard:
    """One shard's state in the kernel: its rows' columns, their cached
    terms, its live rows (ok_local at the start, in row order) and the
    lowest tie-break position of all its rows."""

    def __init__(self, s, n, cols, pos, sc):
        self.lo = s * n
        rows = slice(self.lo, self.lo + n)
        self.cols = {name: c[rows].clone() for name, c in cols.items()}
        self.pos = pos[rows]
        self.sc = sc
        self.head, self.div, self.okl = self.terms()
        self.live = self.okl.nonzero().flatten()   # row order
        j = int(torch.argmin(self.pos))
        self.minpos, self.minrow = int(self.pos[j]), self.lo + j

    def commit_terms(self, j):
        """Row j's terms after a placement on it, its columns left as
        they are (the kernel's commit_terms)."""
        c = {name: col[j:j + 1].clone() for name, col in self.cols.items()}
        c["used"] += self.sc["ask"]
        c["ptg"] += 1
        c["pjob"] += 1
        return self.terms(cols=c)

    def terms(self, rows=slice(None), cols=None):
        c = self.cols if cols is None else cols
        return node_terms_ref(
            available=c["avail"][rows], used=c["used"][rows],
            ask=self.sc["ask"], feasible=c["feas"][rows],
            placed_tg=c["ptg"][rows], placed_job=c["pjob"][rows],
            affinity_boost=c["aff"][rows], dev_affinity=c["dev"][rows],
            tg_count=self.sc["tg_count"], dh_job=self.sc["dh_job"],
            dh_tg=self.sc["dh_tg"], spread_alg=self.sc["spread_alg"])


def model_b16(s_n: int, args: tuple, audit: dict):
    """One nt_task_group_shard_solve launch over S shards, in plain torch
    -> (choices int32, founds bool, scores f32), each (K,)."""
    a = sh.pad_node_axis(args, s_n)
    (avail, used, ptg, pjob, ask, feas, aff, dev_aff, pen, active, svid,
     sok, scnt, sdes, has_t, weight, dvid, dok, dcnt, dlim, lowest,
     tg_count, dh_job, dh_tg, spread_alg) = a[:25]
    f32, i64 = torch.float32, torch.int64
    n_all = avail.shape[0]
    n = n_all // s_n
    k_steps = pen.shape[0]
    tie = (a[25].to(i64) if len(a) > 25 and a[25] is not None
           else torch.arange(n_all))
    pos = torch.empty(n_all, dtype=i64)
    pos[tie] = torch.arange(n_all)
    svid, dvid = svid.to(i64), dvid.to(i64)
    sok, dok = sok.bool(), dok.bool()
    # the cached value ids: kNoValue where the row lacks the value
    sv = torch.where(sok, svid, NO_VALUE)
    dv = torch.where(dok, dvid, NO_VALUE)
    sc = dict(ask=ask.to(f32), tg_count=torch.as_tensor(tg_count, dtype=f32),
              dh_job=torch.as_tensor(dh_job).bool(),
              dh_tg=torch.as_tensor(dh_tg).bool(),
              spread_alg=torch.as_tensor(spread_alg).bool())
    cols = dict(avail=avail.to(f32), used=used.to(f32),
                ptg=ptg.to(torch.int32), pjob=pjob.to(torch.int32),
                feas=feas.bool(), aff=aff.to(f32), dev=dev_aff.to(f32))
    shards = [Shard(s, n, cols, pos, sc) for s in range(s_n)]
    scnt_c, dcnt_c = scnt.to(torch.int32).clone(), dcnt.to(torch.int32).clone()
    low = torch.as_tensor(lowest, dtype=f32)
    s_sp, p = svid.shape[0], dvid.shape[0]
    # every shard's gather buffer: (parity, shard) -> (candidate, its step)
    bufs = [dict() for _ in range(s_n)]
    pending = [None] * s_n          # the owner's refresh, computed ahead
    choices, founds, scores = [], [], []
    for t in range(k_steps):
        par = t % 2
        boost, dp_ok = value_tables_ref(
            spread_counts=scnt_c, spread_desired=sdes.to(f32),
            spread_has_targets=has_t.bool(), spread_weight=weight.to(f32),
            dp_counts=dcnt_c, dp_limit=dlim.to(f32), lowest_boost=low)
        pen_t = int(pen[t])
        for s, st in enumerate(shards):
            rows = slice(st.lo, st.lo + n)
            cached = cached_scores_ref(
                st.head, st.div, st.okl, boost, dp_ok,
                spread_val_id=svid[:, rows], spread_val_ok=sok[:, rows],
                dp_val_id=dvid[:, rows], dp_val_ok=dok[:, rows])
            if st.lo <= pen_t < st.lo + n:
                # the penalty row is scored in full (score_node)
                full, _, _ = score_nodes_ref(
                    available=st.cols["avail"], used=st.cols["used"],
                    ask=sc["ask"], feasible=st.cols["feas"],
                    placed_tg=st.cols["ptg"], placed_job=st.cols["pjob"],
                    affinity_boost=st.cols["aff"],
                    dev_affinity=st.cols["dev"],
                    penalty_idx=torch.tensor(pen_t - st.lo),
                    spread_val_id=svid[:, rows], spread_val_ok=sok[:, rows],
                    spread_counts=scnt_c, spread_desired=sdes.to(f32),
                    spread_has_targets=has_t.bool(),
                    spread_weight=weight.to(f32), dp_val_id=dvid[:, rows],
                    dp_val_ok=dok[:, rows], dp_counts=dcnt_c,
                    dp_limit=dlim.to(f32), lowest_boost=low,
                    tg_count=sc["tg_count"], dh_job=sc["dh_job"],
                    dh_tg=sc["dh_tg"], spread_alg=sc["spread_alg"])
                cached = cached.clone()
                cached[pen_t - st.lo] = full[pen_t - st.lo]
            live = st.live
            sl = cached[live]
            best = sl.max() if len(live) else torch.tensor(-np.inf)
            if len(live) and bool(best > NEG):
                tie_pos = torch.where(sl == best, st.pos[live], 1 << 40)
                j = int(live[int(torch.argmin(tie_pos))])
                cand = (float(best), int(st.pos[j]), st.lo + j,
                        [int(x) for x in sv[:, st.lo + j]]
                        + [int(x) for x in dv[:, st.lo + j]])
                # ahead of the barrier: the commit's terms if it wins
                st.ahead = (j, st.commit_terms(j))
            else:
                cand = (NEG, st.minpos, st.minrow, [NO_VALUE] * (s_sp + p))
            for q in range(s_n):                  # the push
                bufs[q][par, s] = (cand, t)
        # the barrier; then each shard reads its own buffer
        picks = []
        for q in range(s_n):
            rows_q = [bufs[q][par, s] for s in range(s_n)]
            assert all(step == t for _, step in rows_q)
            picks.append(min((c for c, _ in rows_q),
                             key=lambda c: (-c[0], c[1])))
        assert all(pk == picks[0] for pk in picks)
        best, _, row, ids = picks[0]
        found = bool(active[t]) and best > NEG
        if found:
            for kk in range(s_sp):
                if ids[kk] != NO_VALUE:
                    if bool(has_t[kk]):
                        low = torch.minimum(low, boost[kk, ids[kk]])
                    scnt_c[kk, ids[kk]] += 1
            for kk in range(p):
                if ids[s_sp + kk] != NO_VALUE:
                    dcnt_c[kk, ids[s_sp + kk]] += 1
            st = shards[row // n]
            j = row - st.lo
            st.cols["used"][j] += sc["ask"]
            st.cols["ptg"][j] += 1
            st.cols["pjob"][j] += 1
            fresh = st.terms(slice(j, j + 1))
            aj, ahead = st.ahead
            assert aj == j and all(torch.equal(x.view(torch.int32)
                                               if x.dtype == f32 else x, y
                                               .view(torch.int32)
                                               if y.dtype == f32 else y)
                                   for x, y in zip(fresh, ahead))
            st.head[j], st.div[j], st.okl[j] = (fresh[0][0], fresh[1][0],
                                                fresh[2][0])
            audit["commits"] = audit.get("commits", 0) + 1
        # the owners' refresh holds every row's terms
        for st in shards:
            head, div, okl = st.terms()
            assert torch.equal(head.view(torch.int32),
                               st.head.view(torch.int32))
            assert torch.equal(div, st.div) and torch.equal(okl, st.okl)
        audit["nothing"] = audit.get("nothing", 0) + (best <= NEG)
        choices.append(row)
        founds.append(found)
        scores.append(best)
    return (torch.tensor(choices, dtype=torch.int32),
            torch.tensor(founds, dtype=torch.bool),
            torch.tensor(scores, dtype=f32))


_JAX = {}


def _jax(name):
    if name not in _JAX:
        _JAX[name] = tuple(np.asarray(o) for o in ref_kernels.solve_task_group(
            *FIXTURES[name]()))
    return _JAX[name]


@pytest.mark.parametrize("s_n", SHARDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_step_loop_equals_plain_and_jax(name, s_n):
    """The kernel's schedule, shard by shard: bit-equal to the plain
    version, and to the JAX package's solve_task_group (scores within
    1e-6); founds and commits agree; "infeasible" and the hazard fixture
    have steps that find nothing."""
    args = FIXTURES[name]()
    audit = {}
    got = model_b16(s_n, tuple(torch.as_tensor(x) for x in args), audit)
    mesh = sh.NodeMesh(["cpu"] * s_n)
    want = sh.solve_task_group_sharded_ref(mesh, sh.shard_solve_args(mesh,
                                                                     args))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    wc, wf, ws = _jax(name)
    np.testing.assert_array_equal(got[0].numpy(), wc)
    np.testing.assert_array_equal(got[1].numpy(), wf)
    np.testing.assert_allclose(got[2].numpy(), ws, rtol=0, atol=SCORE_ATOL)
    assert audit.get("commits", 0) == int(got[1].sum())
    if name in ("cfg3_infeasible", "graft_hazard"):
        assert audit["nothing"] > 0
        nothing = got[2] <= NEG
        tie = np.asarray(args[25]) if args[25] is not None else np.arange(
            len(args[0]))
        assert bool((got[0][nothing] == int(tie[0])).all())


def test_the_hazard_fixture_runs_out_within_the_loop():
    """The hazard fixture's last steps find nothing and report position 0
    (the node tie_perm[0]) at NEG on every S."""
    args = FIXTURES["graft_hazard"]()
    for s_n in SHARDS:
        got = model_b16(s_n, tuple(torch.as_tensor(x) for x in args), {})
        assert not bool(got[1][-1]) and float(got[2][-1]) == float(F32(NEG))
        assert int(got[0][-1]) == int(args[25][0])


# ---------------------------------------------------------------------------
# the wrapper on stub cards: one host call a solve
# ---------------------------------------------------------------------------

STUB_MESHES = {"one_card": (0, 0, 0, 0), "two_cards": (0, 1, 0, 1)}


@pytest.fixture
def stub_mesh(monkeypatch, stub_libs, cards):  # noqa: F811
    """A CUDA mesh on stub cards; the packed inputs stay on the CPU (a
    copy to a card is the identity)."""
    to = torch.Tensor.to

    def to_stub_card(x, *a, **kw):
        dev = a[0] if a else kw.get("device")
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return x
        return to(x, *a, **kw)

    def make(ordinals):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.Tensor, "to", to_stub_card)
        _ext.entry("nt_task_group_shard_solve_scratch_words").code = 4096
        return sh.NodeMesh([f"cuda:{i}" for i in ordinals])

    _ext.scratch_words.cache_clear()
    yield make
    _ext.scratch_words.cache_clear()


@pytest.mark.parametrize("variant", ["targets", "distinct"])
@pytest.mark.parametrize("layout", sorted(STUB_MESHES))
def test_solve_is_one_host_call(stub_libs, stub_mesh, layout,  # noqa: F811
                                variant):
    """B16 on a stub mesh: one nt_task_group_shard_solve a solve, counted
    once a card: each shard's pointers into the one pack (its rows of
    node_mat, its columns of spread_node and dp_node, the replicated
    arrays shared), a fresh scratch a shard, the barrier words kept
    between solves; no B9 launch and no host-side gather."""
    mesh = stub_mesh(STUB_MESHES[layout])
    args = small_cfg3(variant, n=64, real=60, k=8)
    before = _ext.COUNTS.snapshot()["launches"]
    for _ in range(2):
        out = sh.solve_task_group_sharded(mesh, args)
    after = _ext.COUNTS.snapshot()["launches"]
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"task_group_shard": 2 * mesh.cards}
    fn = stub_libs["task_group_shard"].fns["nt_task_group_shard_solve"]
    assert len(fn.calls) == 2
    call = fn.calls[-1]
    n_all, s_n = 64, mesh.size
    n, w = n_all // s_n, 2 * 4 + 6
    node_mat = [call[0][i] for i in range(s_n)]
    assert [x - node_mat[0] for x in node_mat] == [4 * s * n * w
                                                  for s in range(s_n)]
    p = 1 if variant == "distinct" else 0
    for i in (2, 5) if p else (2,):    # spread_node, dp_node: its columns
        ptrs = [call[i][q] for q in range(s_n)]
        assert [x - ptrs[0] for x in ptrs] == [4 * s * n
                                              for s in range(s_n)]
    if not p:
        assert all(call[5][q] is None for q in range(s_n))  # no dp rows
    for i in (1, 3, 4, 6, 7):          # replicated
        assert len({call[i][q] for q in range(s_n)}) == 1
    assert len({call[8][q] for q in range(s_n)}) == s_n   # scratch
    assert call[9]                                         # out
    assert fn.calls[0][10] == call[10]                     # barrier words
    assert list(call[11]) == [mesh.distinct.index(d) for d in mesh.devices]
    assert list(call[12]) == [d.index for d in mesh.distinct]
    vd = 8 if p else 1
    assert call[13:23] == (mesh.cards, s_n, 8, n, 4, 1, 32, p, vd, n_all)
    assert list(call[23]) == [1000 + d.index for d in mesh.distinct]


@pytest.mark.parametrize("variant", ["cols", "wide"])
def test_solve_launches_past_eight(stub_libs, stub_mesh,  # noqa: F811
                                   variant):
    """d 9 (lean) and d 12 with 9 spreads and 9 distinct_property
    constraints: one nt_task_group_shard_solve a solve (the library takes
    the wide instance) with the sizes; nothing is refused."""
    mesh = stub_mesh((0, 0))
    args = small_cfg3(variant, n=64, real=60, k=8)
    sh.solve_task_group_sharded(mesh, args)
    fn = stub_libs["task_group_shard"].fns["nt_task_group_shard_solve"]
    (call,) = fn.calls
    d, s_sp, p = args[0].shape[1], args[10].shape[0], args[16].shape[0]
    assert (d, s_sp, p) == ((9, 1, 0) if variant == "cols" else (12, 9, 9))
    vd = 8 if p else 1
    assert call[13:23] == (1, 2, 8, 32, d, s_sp, 32, p, vd, 64)


def test_solve_refuses_tables_past_shared_memory(stub_libs,  # noqa: F811
                                                 stub_mesh):
    """4 spreads of 8,192 values exceed a CTA's shared memory (the count,
    boost and step tables): ValueError naming the bytes, no host call."""
    mesh = stub_mesh((0, 0))
    args = list(small_cfg3("cfg3", n=64, real=60, k=8))
    v = 8192
    args[10] = np.tile(args[10], (4, 1))
    args[11] = np.tile(args[11], (4, 1))
    args[12] = np.zeros((4, v), np.int32)
    args[13] = np.full((4, v), np.nan, F32)
    args[14] = np.zeros(4, bool)
    args[15] = np.full(4, 0.25, F32)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sh.solve_task_group_sharded(mesh, tuple(args))
    fn = stub_libs["task_group_shard"].fns["nt_task_group_shard_solve"]
    assert not fn.calls
    assert sh.task_group_shard_smem_bytes(4, 4, 4096, 0, 1) <= (
        kernels.SCAN_SMEM_BYTES)


def test_empty_solve_launches_nothing(stub_libs, stub_mesh):  # noqa: F811
    """K 0 makes no host call and returns three empty columns."""
    mesh = stub_mesh((0, 0, 0, 0))
    args = small_cfg3("cfg3", n=64, real=60, k=8)
    sh.solve_task_group_sharded(mesh, args)
    fn = stub_libs["task_group_shard"].fns["nt_task_group_shard_solve"]
    empty = list(args)
    empty[8], empty[9] = np.zeros(0, np.int32), np.zeros(0, bool)
    out = sh.solve_task_group_sharded(mesh, tuple(empty))
    assert len(fn.calls) == 1 and all(o.shape == (0,) for o in out)
