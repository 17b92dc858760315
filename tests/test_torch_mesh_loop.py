"""The device-side round loops of B13 and B14 (nomad_tpu_torch/csrc/
sharded.cu ``nt_bulk_shard_solve``, ``nt_joint_shard_solve``) on the
CPU: their schedule in plain torch, and their host calls on stub cards.

The kernels cannot run here (no ``nvcc``, no card), so this module keeps
a plain-torch model of what they do, step for step:

- B13: each shard scores, caps and keys its nodes once per eval and
  sorts its live nodes (cap > 0) once, in top_k's order; a round's pool
  is the next R entries of that order whose cap is still > 0, found from
  a cursor past the dead prefix, then (NEG, 0, -1 - (s R + j)) slots.
  Above 16,384 nodes a shard the kernel sorts nothing: each round's pool
  is select.cuh's threshold_radix fill of R over the shard's nodes in
  node order (key topk_desc of the eval's key, weight 1 while the cap is
  > 0; test_torch_fill_loop's model), the chosen sorted by (key, node).
  Each shard stores its row into every shard's pool buffer, double-
  buffered by round parity; after the barrier every shard merges its own
  buffer, and the replicated results must agree.
- B14: the greedy arm (B13's schedule), the T restarts each with its own
  pools and barrier group (empty bid slots as (NEG, 0, negative id)),
  every (arm, shard) pushing its per-node contributions into every
  shard's buffer, the join, and the same pick on every shard.

The model must equal the plain versions ``solve_bulk_multi_sharded_ref``
and ``solve_batch_sharded_ref`` (which tests/test_torch_sharding.py holds
against the JAX reference) exactly, on that module's fixtures. At every
round of the model the pool's live prefix equals the reference's
``top_k`` of ``where(cap > 0, key, NEG)``, and putting the reference's
ids into the NEG slots changes no output (the ids there differ, and
nothing reads them).

Then the wrappers on stub cards (tests/test_torch_ext.py's ``stub_libs``
and ``cards``): one host call of each entry point per solve, with every
shard's pointers, each card's replicated inputs and stream, and no read
of a device value on the host."""

import ctypes

import numpy as np
import pytest
import torch

from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import sharding as sh
from nomad_tpu_torch.tensor.batch_solver import (MAX_ROUNDS, PORTFOLIO, TOP_R,
                                                 _jitter_his, _price_eps,
                                                 bid_scores, resolve_round,
                                                 topr_ref)
from nomad_tpu_torch.tensor.kernels import (NEG, TIE_JITTER, fill_score_cap,
                                            fit_scores, pairwise_sum_ref,
                                            preempt_score_ref)
from nomad_tpu_torch.tensor.prng import jitter_fold_ref, jitter_ref
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_sharding import BULK_CASES, _joint_problem

F32 = torch.float32


def _mesh(s):
    return sh.NodeMesh(["cpu"] * s)


def _merge_fill(buf, budget):
    """B13's merge of one gathered (S, 3, R) buffer: lexsort's order, the
    threshold of the best-covered shard's worst entry, the takes and the
    eligible entries, by global id. Returns (takes, eligible, gids, budget
    left, go)."""
    r = buf.shape[2]
    vals = buf[:, 0, :].reshape(-1)
    caps = buf[:, 1, :].reshape(-1).to(torch.int32)
    gids = buf[:, 2, :].reshape(-1).to(torch.int64)
    thresh = buf[:, 0, r - 1].max()
    order = sh._lexsort_desc(vals, gids)
    vals_s = vals[order]
    eligible = vals_s > thresh
    eligible[0] = vals_s[0] > NEG
    caps_e = torch.where(eligible, caps[order], 0)
    cum = torch.cumsum(caps_e, 0, dtype=torch.int32)
    take_s = torch.minimum(torch.clamp_min(budget - (cum - caps_e), 0),
                           caps_e)
    consumed = int(take_s.sum())
    take = torch.zeros_like(caps)
    take[order] = take_s
    elig = torch.zeros_like(eligible)
    elig[order] = eligible
    left = budget - consumed
    go = left > 0 and bool(vals_s[0] > NEG) and consumed > 0
    return take, elig, gids, left, go


def topk_desc_ref(v: torch.Tensor) -> torch.Tensor:
    """sharded.cu ``topk_desc`` as int64 values in [0, 2^32): ascending is
    top_k's descending order of f32 values (-0.0 below +0.0)."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where((u & 0x80000000) != 0, ~u & 0xFFFFFFFF,
                          u | 0x80000000)
    return ~ordered & 0xFFFFFFFF


def select_pool(key, cap, r, audit):
    """The wide kernel's pool (pool_select): the threshold_radix fill of
    R over the nodes in node order, each weighing 1 while its cap is > 0,
    the chosen sorted by (topk_desc key, node). Returns their nodes."""
    from test_torch_fill_loop import radix_takes_ref

    k32 = topk_desc_ref(key)
    takes, route, _ = radix_takes_ref(k32, (cap > 0).to(torch.int64), r)
    audit["routes"].append(route)
    chosen = torch.nonzero(takes).reshape(-1)
    return chosen[torch.argsort(k32[chosen] * (1 << 32) + chosen)]


class _Shard:
    """One shard's state of a B13 eval: keys, caps, takes, the sorted
    live order and the cursor (``wide``: no order, a selection a round)."""

    def __init__(self, key, cap, wide=False):
        self.key, self.cap, self.wide = key, cap, wide
        self.take = torch.zeros_like(cap)
        self.cursor = 0
        if wide:
            return
        vals, idx = topr_ref(torch.where(cap > 0, key, NEG), key.shape[0])
        self.order = idx[cap[idx] > 0]        # the live nodes, sorted once
        assert bool((vals[:self.order.shape[0]] > NEG).all())

    def pool(self, s, r, n_loc, neg_ids, audit):
        """The round's pool row (3, R): the next R live entries of the
        order, then the NEG slots (``neg_ids`` "kernel": -1 - (s R + j);
        "reference": top_k's dead ids, index ascending)."""
        if self.wide:
            li = select_pool(self.key, self.cap, r, audit)
        else:
            tail = self.order[self.cursor:]
            alive = self.cap[tail] > 0
            live = tail[alive]
            if live.shape[0]:
                self.cursor += int(torch.nonzero(alive)[0])
            else:
                self.cursor = self.order.shape[0]
            li = live[:r]
        found = li.shape[0]
        vals = torch.full((r,), NEG, dtype=F32)
        caps = torch.zeros(r, dtype=F32)
        if neg_ids == "kernel":
            gids = -1.0 - (s * r + torch.arange(r, dtype=F32))
        else:
            dead = torch.nonzero(self.cap <= 0).reshape(-1)
            gids = torch.zeros(r, dtype=F32)
            gids[found:] = (dead[:r - found] + s * n_loc).to(F32)
        vals[:found] = self.key[li]
        caps[:found] = self.cap[li].to(F32)
        gids[:found] = (li + s * n_loc).to(F32)
        # the live prefix is the reference's top_k of the masked keys
        ref_v, ref_i = topr_ref(torch.where(self.cap > 0, self.key, NEG), r)
        assert torch.equal(ref_v[:found], vals[:found])
        assert torch.equal(ref_i[:found], li)
        assert bool((ref_v[found:] == NEG).all())
        if found < r:
            audit["neg_slots"] += r - found
            audit["ids_differ"] |= not torch.equal(
                gids[found:], (ref_i[found:] + s * n_loc).to(F32))
        return torch.stack([vals, caps, gids])


def model_fill(used, avail, feas, aff, ask, k, seeds, *, g, top_r,
               neg_ids="kernel", audit=None, wide_above=16384):
    """B13's schedule on S CPU shard parts after the fold (``used``
    updated in place); a shard of more than ``wide_above`` nodes selects
    its pools (the kernel's 16,384). Returns (counts parts, rounds)."""
    audit = ({"neg_slots": 0, "ids_differ": False, "routes": []}
             if audit is None else audit)
    audit.setdefault("routes", [])
    s_n = len(used)
    n_loc = used[0].shape[0]
    r = min(top_r, n_loc)
    jits = [jitter_ref(seeds, n_loc, TIE_JITTER, offset=s * n_loc)
            for s in range(s_n)]
    bufs = [torch.zeros((2, s_n, 3, r), dtype=F32) for _ in range(s_n)]
    counts = [torch.zeros((g, n_loc), dtype=torch.int16)
              for _ in range(s_n)]
    rounds = torch.zeros(g, dtype=torch.int32)
    parity = 0
    for e in range(g):
        budget = int(k[e])
        if budget <= 0:
            continue
        shards = []
        for s in range(s_n):
            score, cap = fill_score_cap(used[s], avail[s], feas[s][e],
                                        aff[s][e], ask[e], k[e])
            shards.append(_Shard(score + jits[s][e], cap.to(torch.int32),
                                 wide=n_loc > wide_above))
        go, rnd = True, 0
        while go:
            for s, st in enumerate(shards):
                row = st.pool(s, r, n_loc, neg_ids, audit)
                for buf in bufs:                  # into every shard's buffer
                    buf[parity, s] = row
            # the barrier; then every shard merges its own buffer
            merged = [_merge_fill(buf[parity], budget) for buf in bufs]
            for m in merged[1:]:
                assert all(torch.equal(x, y) for x, y in zip(m[:3],
                                                             merged[0][:3]))
                assert m[3:] == merged[0][3:]
            for s, (st, (take, elig, gids, _, _)) in enumerate(
                    zip(shards, merged)):
                pos = gids - s * n_loc
                mine = (gids >= 0) & (pos >= 0) & (pos < n_loc)
                st.take.index_add_(0, pos[mine], take[mine])
                st.cap[pos[mine & elig]] = 0
            budget, go = merged[0][3], merged[0][4]
            parity ^= 1
            rnd += 1
        for s, st in enumerate(shards):
            used[s] += ask[e][None, :] * st.take[:, None].to(F32)
            counts[s][e] = st.take.to(torch.int16)
        rounds[e] = rnd
    return counts, rounds


def model_restart(used0, avail, avail_cap, feas, aff, ask, k, jits, pscore,
                  *, g, rounds, eps):
    """One restart's schedule (its own barrier group): per round each
    shard bids and pushes its (3, G, rl) row (empty slots (NEG, 0,
    -1 - (s rl + j))) into every shard's buffer of this parity, then
    every shard resolves the round from its own buffer and applies its
    own rows. Returns (used parts, take parts, rounds run)."""
    s_n = len(used0)
    n_loc = used0[0].shape[0]
    n = n_loc * s_n
    rl, rg = min(TOP_R, n_loc), min(TOP_R, n)
    used = [u.clone() for u in used0]
    take = [torch.zeros((g, n_loc), dtype=torch.int32) for _ in used0]
    price = [torch.zeros(n_loc, dtype=F32) for _ in used0]
    rem = [k.to(torch.int32).clone() for _ in used0]   # replicated
    bufs = [torch.zeros((2, s_n, 3, g, rl), dtype=F32) for _ in used0]
    g_idx = torch.arange(g)
    ask_pos = ask > 0
    rnd = 0
    go = bool((k > 0).any()) and rounds > 0
    while go:
        par = rnd & 1
        for s in range(s_n):
            ok, score = bid_scores(used[s], avail[s], avail_cap[s], feas[s],
                                   aff[s], ask, rem[s],
                                   None if pscore is None else pscore[s])
            bid = torch.where(ok, score + jits[s] - price[s][None, :], NEG)
            lvals, lidx = topr_ref(bid, rl)
            free = avail_cap[s][lidx] - used[s][lidx]
            per_dim = torch.where(
                ask_pos[:, None, :],
                torch.floor(free / torch.where(ask_pos, ask, 1.0)[:, None, :]),
                float("inf"))
            lcap = torch.clamp_min(per_dim.amin(dim=2), 0.0)
            empty = ~torch.gather(ok, 1, lidx)
            slot = -1.0 - (s * rl + torch.arange(rl, dtype=F32))
            row = torch.stack([
                torch.where(empty, NEG, lvals), torch.where(empty, 0.0, lcap),
                torch.where(empty, slot[None, :], (lidx + s * n_loc).to(F32))])
            for buf in bufs:
                buf[par, s] = row
        outs = []
        for s in range(s_n):
            p = bufs[s][par]
            vals_m = p[:, 0].permute(1, 0, 2).reshape(g, -1)
            caps_m = p[:, 1].permute(1, 0, 2).reshape(g, -1)
            gids_m = p[:, 2].permute(1, 0, 2).reshape(g, -1).to(torch.int64)
            order = sh._lexsort_desc(vals_m, gids_m)
            vals = torch.gather(vals_m, 1, order)[:, :rg]
            gids = torch.gather(gids_m, 1, order)[:, :rg]
            caps = torch.gather(caps_m, 1, order)[:, :rg]
            # an empty slot's negative id goes to a dummy node n: inactive
            amt, bump = resolve_round(vals, torch.where(gids < 0, n, gids),
                                      caps, rem[s], n + 1)
            outs.append((gids, amt, bump[:n]))
        for o in outs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))
        progressed = False
        for s in range(s_n):
            gids, amt, bump = outs[s]
            pos = gids - s * n_loc
            mine = (gids >= 0) & (pos >= 0) & (pos < n_loc)
            posc = pos.clamp(0, n_loc - 1)
            amt_mine = torch.where(mine, amt, 0)
            used[s].index_add_(0, posc.reshape(-1), (
                ask[:, None, :] * amt_mine[..., None].to(F32)).reshape(-1, 4))
            take[s].index_put_((g_idx[:, None].expand(g, rg), posc), amt_mine,
                               accumulate=True)
            price[s] = price[s] + eps * bump[s * n_loc:(s + 1) * n_loc].to(F32)
            rem[s] = rem[s] - amt.sum(dim=1, dtype=torch.int32)
            progressed = bool((amt > 0).any())
        rnd += 1
        go = rnd < rounds and progressed and bool((rem[0] > 0).any())
    return used, take, rnd


def model_joint(mesh, used, avail, feas, aff, ask, k, seeds, cidx, cdelta,
                evict=None, net_prio=None, *, g, rounds=MAX_ROUNDS,
                top_r=64):
    """B14's schedule: the fold, the greedy arm and the restarts (each
    its own group), every (arm, shard) pushing its contributions into
    every shard's buffer, the join, the same pick on every shard.
    Returns (used parts, counts parts, info (6,), gathers)."""
    s_n = mesh.size
    n_loc = used[0].shape[0]
    n_t = len(PORTFOLIO)
    sh.state_scatter_sharded_ref(mesh, used, cidx, cdelta, clamp=True)
    used_g = [u.clone() for u in used]
    counts_g, rounds_g = model_fill(used_g, avail, feas, aff, ask, k, seeds,
                                    g=g, top_r=top_r)
    avail_cap = avail if evict is None else [a + e for a, e in
                                             zip(avail, evict)]
    pscore = (None if net_prio is None
              else [preempt_score_ref(p) for p in net_prio])
    jits = [jitter_fold_ref(seeds, n_loc, _jitter_his(), offset=s * n_loc)
            for s in range(s_n)]
    arms = [model_restart(used, avail, avail_cap, feas, aff, ask, k,
                          [j[t] for j in jits], pscore, g=g, rounds=rounds,
                          eps=eps)
            for t, eps in enumerate(_price_eps())]
    arms.append((used_g, counts_g, None))
    contrib = [torch.zeros((s_n, n_t + 1, n_loc), dtype=F32)
               for _ in range(s_n)]
    placed = [torch.zeros((s_n, n_t + 1), dtype=torch.int32)
              for _ in range(s_n)]
    for arm, (u_a, take_a, _) in enumerate(arms):
        for s in range(s_n):
            node = take_a[s].to(torch.int32).sum(dim=0, dtype=torch.int32)
            row = node.to(F32) * fit_scores(avail[s], u_a[s])
            for d in range(s_n):          # into every shard's buffer
                contrib[d][s, arm] = row
                placed[d][s, arm] = node.sum()
    # the join; every shard picks from its own buffer
    picks = []
    for s in range(s_n):
        scores = [pairwise_sum_ref(contrib[s][:, arm].reshape(-1))
                  for arm in range(n_t + 1)]
        pl = [int(placed[s][:, arm].sum()) for arm in range(n_t + 1)]
        best = 0
        for t in range(1, n_t):
            if pl[t] > pl[best] or (pl[t] == pl[best]
                                    and bool(scores[t] > scores[best])):
                best = t
        pick_a = pl[best] > pl[n_t] or (pl[best] == pl[n_t]
                                        and bool(scores[best] > scores[n_t]))
        picks.append((best, pick_a, float(scores[best]), float(scores[n_t]),
                      pl[best], pl[n_t]))
    assert all(p == picks[0] for p in picks)
    best, pick_a, score_a, score_g, placed_a, placed_g = picks[0]
    src = arms[best] if pick_a else arms[n_t]
    out_used = [u.clone() for u in src[0]]
    out_counts = [c.to(torch.int16) for c in src[1]]
    rounds_t = [a[2] for a in arms[:n_t]]
    info = torch.tensor([score_a, score_g, float(placed_a), float(placed_g),
                         float(rounds_t[best]), float(pick_a)], dtype=F32)
    gathers = 1 + int(rounds_g.sum()) + sum(rt + 1 for rt in rounds_t)
    return out_used, out_counts, info, torch.tensor(gathers,
                                                    dtype=torch.int32)


def _bulk_parts(mesh, inputs):
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = inputs
    t = torch.from_numpy
    used, av = sh.shard_bulk_state(mesh, used0.copy(), avail)
    return (used, av, sh.shard_cols(mesh, t(feas)), sh.shard_cols(mesh, t(aff)),
            t(ask), t(k), t(seeds.astype(np.int64)), t(cidx), t(cdelta))


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_fill_schedule_equals_plain_version(case, s):
    """The B13 kernel's schedule (sort once, live prefix, pushed
    double-buffered pools, replicated merges) equals
    solve_bulk_multi_sharded_ref: counts, carry and rounds (the gathers)
    exactly."""
    make, top_r = BULK_CASES[case]
    inputs = make()
    mesh = _mesh(s)
    args = _bulk_parts(mesh, inputs)
    g = len(inputs[5])
    want = sh.solve_bulk_multi_sharded_ref(mesh, *args, g=g, top_r=top_r)
    args = _bulk_parts(mesh, inputs)
    used, av, feas, aff, ask, k, seeds, cidx, cdelta = args
    sh.state_scatter_sharded_ref(mesh, used, cidx, cdelta, clamp=True)
    counts, rounds = model_fill(used, av, feas, aff, ask, k, seeds, g=g,
                                top_r=top_r)
    assert torch.equal(sh.gather_rows(counts, dim=1),
                       sh.gather_rows(want[1], dim=1))
    assert torch.equal(sh.gather_rows(used), sh.gather_rows(want[0]))
    assert torch.equal(rounds, want[2])


def _wide_inputs(n, k, seed):
    """n nodes of ~1 alloc each (the multi-round case's shape) and three
    evals, so R = 8 pools take many rounds; equal keys among them (no
    affinity, two capacities)."""
    rng = np.random.RandomState(seed)
    g, f = 3, np.float32
    avail = np.zeros((n, 4), f)
    avail[:, 0] = rng.choice([600, 700], n)
    avail[:, 1] = 4096
    used0 = np.zeros((n, 4), f)
    used0[rng.rand(n) < 0.3, 0] = 100.0
    feas = rng.rand(g, n) > 0.1
    aff = np.zeros((g, n), f)
    ask = np.tile(np.array([500.0, 16.0, 0.0, 0.0], f), (g, 1))
    seeds = np.arange(g).astype(np.uint32)
    return (avail, used0, feas, aff, ask, np.array(k, np.int32), seeds,
            np.zeros(8, np.int32), np.zeros((8, 4), f))


@pytest.mark.parametrize("form", ["select", "sorted"])
@pytest.mark.parametrize("n,k", [(32768, (120, 24, 64)),
                                 (65536, (96, 16, 40))])
def test_wide_fill_schedule_equals_plain_version(n, k, form):
    """B13 at S = 1 with n_loc 32,768 and 65,536, each round's pool
    selected from the scratch (threshold_radix: the kernel above 16,384
    nodes a shard): the pools equal top_k's every round, and counts,
    carry and rounds equal solve_bulk_multi_sharded_ref's. The "sorted"
    form runs the narrow shards' schedule at the same width, for the same
    result."""
    inputs = _wide_inputs(n, k, seed=n // 1024)
    mesh = _mesh(1)
    g = len(k)
    want = sh.solve_bulk_multi_sharded_ref(mesh, *_bulk_parts(mesh, inputs),
                                           g=g, top_r=8)
    used, av, feas, aff, ask, kk, seeds, cidx, cdelta = _bulk_parts(mesh,
                                                                    inputs)
    audit = {"neg_slots": 0, "ids_differ": False, "routes": []}
    counts, rounds = model_fill(
        used, av, feas, aff, ask, kk, seeds, g=g, top_r=8, audit=audit,
        wide_above=16384 if form == "select" else n)
    assert torch.equal(counts[0], want[1][0])
    assert torch.equal(used[0], want[0][0])
    assert torch.equal(rounds, want[2]) and int(rounds.max()) > 10
    if form == "sorted":
        assert not audit["routes"]
    else:
        assert len(audit["routes"]) == int(rounds.sum())
        assert "radix" in audit["routes"]


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("evict", [False, True])
def test_joint_schedule_equals_plain_version(evict, s):
    """The B14 kernel's schedule (arms at once, each restart its own
    group, contributions pushed, one join, the pick on every shard)
    equals solve_batch_sharded_ref: carry, counts, the info row and the
    gather count exactly."""
    (avail, used0, feas, aff, ask, k, seeds, cidx, cdelta, ev,
     npr) = _joint_problem(evict)
    g = len(k)
    mesh = _mesh(s)
    t = torch.from_numpy

    def parts():
        used, av = sh.shard_bulk_state(mesh, used0.copy(), avail)
        kw = {}
        if evict:
            kw = dict(evict=sh.shard_rows(mesh, t(ev)),
                      net_prio=sh.shard_rows(mesh, t(npr)))
        return (used, av, sh.shard_cols(mesh, t(feas)),
                sh.shard_cols(mesh, t(aff)), t(ask), t(k),
                t(seeds.astype(np.int64)), t(cidx), t(cdelta)), kw

    args, kw = parts()
    want = sh.solve_batch_sharded_ref(mesh, *args, g=g, **kw)
    args, kw = parts()
    got = model_joint(mesh, *args, g=g, **kw)
    assert torch.equal(sh.gather_rows(got[0]), sh.gather_rows(want[0]))
    assert torch.equal(sh.gather_rows(got[1], dim=1),
                       sh.gather_rows(want[1], dim=1))
    assert torch.equal(got[2], want[2])
    assert int(got[3]) == int(want[3]) > 0


def _sparse_inputs():
    """Few live nodes a shard: most nodes infeasible or full, so every
    round's pools carry NEG slots."""
    avail, used0, feas, aff, ask, k, seeds, cidx, cdelta = BULK_CASES[
        "main"][0]()
    rng = np.random.RandomState(3)
    feas &= rng.rand(*feas.shape) > 0.85
    used0[::3] = avail[::3]
    return avail, used0, feas, aff, ask, k, seeds, cidx, cdelta


def _exhausting_inputs():
    """tests/test_sharding.py's multi-round fill with a budget that the
    second eval cannot place: its shards run out of live nodes."""
    inputs = list(BULK_CASES["multi_round"][0]())
    inputs[5] = np.full(2, 300, np.int32)
    return tuple(inputs)


@pytest.mark.parametrize("case", ["exhausting", "sparse"])
def test_neg_slot_ids_are_read_by_no_output(case):
    """The kernel puts -1 - (s R + j) in a pool's slots past the live
    entries, where the reference's top_k puts dead nodes' ids. The
    model run both ways: the ids differ on some round, and counts, carry
    and rounds do not."""
    make, top_r = {"exhausting": (_exhausting_inputs, 8),
                   "sparse": (_sparse_inputs, 16)}[case]
    inputs = make()
    g = len(inputs[5])
    outs, audits = [], []
    for neg_ids in ("kernel", "reference"):
        mesh = _mesh(4)
        used, av, feas, aff, ask, k, seeds, cidx, cdelta = _bulk_parts(
            mesh, inputs)
        sh.state_scatter_sharded_ref(mesh, used, cidx, cdelta, clamp=True)
        audit = {"neg_slots": 0, "ids_differ": False}
        counts, rounds = model_fill(used, av, feas, aff, ask, k, seeds, g=g,
                                    top_r=top_r, neg_ids=neg_ids, audit=audit)
        outs.append((sh.gather_rows(used), sh.gather_rows(counts, dim=1),
                     rounds))
        audits.append(audit)
    assert audits[0]["neg_slots"] > 0 and audits[0]["ids_differ"]
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert int(outs[0][1].sum()) > 0


# ---------------------------------------------------------------------------
# the wrappers on stub cards: one host call a solve, no host read
# ---------------------------------------------------------------------------

STUB_MESHES = {"one_card": (0, 0, 0, 0), "two_cards": (0, 1, 0, 1)}


@pytest.fixture
def no_host_read(monkeypatch):
    """Any read of a tensor's value on the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a device value")

    def install():
        for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                     "__float__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
    return install


@pytest.fixture
def stub_mesh(monkeypatch, stub_libs, cards):
    """A CUDA mesh on stub cards (``layout``: the shards' ordinals); its
    parts lie on the CPU, so the wrappers' device checks are skipped and
    B15's fold (tested on its own in test_torch_ext.py) is recorded.
    Returns (mesh, the folds)."""
    def make(ordinals):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for query in ("nt_bulk_shard_solve_scratch_words",
                      "nt_joint_shard_solve_scratch_words"):
            _ext.entry(query).code = 64
        monkeypatch.setattr(sh, "_check_parts", lambda *a: None)
        folds = []
        monkeypatch.setattr(sh, "_scatter_launch",
                            lambda m, u, i, d, clamp: folds.append(clamp))
        return sh.NodeMesh([f"cuda:{i}" for i in ordinals]), folds

    _ext.scratch_words.cache_clear()
    yield make
    _ext.scratch_words.cache_clear()


def _stub_inputs(mesh, g=4, n=64, evict=False):
    """Row and column parts on the CPU, each shard's its own tensor."""
    n_loc = n // mesh.size

    def rows(shape):
        return [torch.rand(shape) for _ in range(mesh.size)]

    kw = {}
    if evict:
        kw = dict(evict=rows((n_loc, 4)), net_prio=rows((n_loc,)))
    return (rows((n_loc, 4)), rows((n_loc, 4)),
            [torch.ones((g, n // mesh.size), dtype=torch.bool)
             for _ in range(mesh.size)],
            [torch.zeros((g, n // mesh.size)) for _ in range(mesh.size)],
            torch.ones((g, 4)), torch.full((g,), 8, dtype=torch.int32),
            torch.arange(g, dtype=torch.int64),
            torch.zeros(8, dtype=torch.int32), torch.zeros((8, 4))), kw


def _ptrs(arr, n):
    return [arr[i] for i in range(n)]


def _check_mesh_args(call, mesh, parts, n_out):
    """The leading pointer arrays hold every shard's part, the output
    arrays one pointer a shard, then each card's replicated inputs."""
    s_n = mesh.size
    for i, p in enumerate(parts):
        assert _ptrs(call[i], s_n) == [x.data_ptr() for x in p]
    for i in range(len(parts), len(parts) + n_out):
        assert len(set(_ptrs(call[i], s_n))) == s_n   # fresh, one a shard
    for i in range(len(parts) + n_out, len(parts) + n_out + 3):
        assert len(_ptrs(call[i], mesh.cards)) == mesh.cards
    assert list(call[-1]) == [1000 + d.index for d in mesh.distinct]


def _launches(name):
    return _ext.COUNTS.snapshot()["launches"][name]


@pytest.mark.parametrize("layout", sorted(STUB_MESHES))
def test_bulk_solve_is_one_host_call(stub_libs, stub_mesh, no_host_read,
                                     layout):
    """B13 on a stub mesh: the fold and one nt_bulk_shard_solve a solve,
    counted once a card, the barrier words kept between solves."""
    mesh, folds = stub_mesh(STUB_MESHES[layout])
    args, _ = _stub_inputs(mesh)
    before = _launches("bulk_shard")
    no_host_read()
    for _ in range(2):
        used, counts, rounds = sh.solve_bulk_multi_sharded(mesh, *args, g=4)
    fn = stub_libs["sharded"].fns["nt_bulk_shard_solve"]
    assert fn.calls and len(fn.calls) == 2 and folds == [True, True]
    call = fn.calls[-1]
    _check_mesh_args(call, mesh, args[:4], 2)
    assert _ptrs(call[4], mesh.size) == [c.data_ptr() for c in counts]
    assert call[9] == rounds.data_ptr()
    assert fn.calls[0][10] == call[10]                 # the barrier words
    assert list(call[11]) == [mesh.distinct.index(d) for d in mesh.devices]
    assert list(call[12]) == [d.index for d in mesh.distinct]
    assert call[13:18] == (mesh.cards, mesh.size, 4, 64 // mesh.size,
                           64 // mesh.size)
    assert call[18] == pytest.approx(TIE_JITTER)
    assert _launches("bulk_shard") == before + 2 * mesh.cards
    assert used is args[0]


@pytest.mark.parametrize("evict", [False, True])
@pytest.mark.parametrize("layout", sorted(STUB_MESHES))
def test_joint_solve_is_one_host_call(stub_libs, stub_mesh, no_host_read,
                                      layout, evict):
    """B14 on a stub mesh: the fold and one nt_joint_shard_solve a solve
    (the greedy arm inside it: no B13 call), counted once a card."""
    mesh, folds = stub_mesh(STUB_MESHES[layout])
    args, kw = _stub_inputs(mesh, evict=evict)
    before = _launches("joint_shard")
    no_host_read()
    used, counts, info, gathers = sh.solve_batch_sharded(mesh, *args, g=4,
                                                         **kw)
    fn = stub_libs["sharded"].fns["nt_joint_shard_solve"]
    assert len(fn.calls) == 1 and folds == [True]
    assert not stub_libs["sharded"].fns["nt_bulk_shard_solve"].calls
    call = fn.calls[0]
    parts = list(args[:4]) + ([kw["evict"], kw["net_prio"]] if evict else [])
    if evict:
        _check_mesh_args(call, mesh, parts, 3)
    else:
        assert call[4] is None and call[5] is None
        _check_mesh_args(call[:4] + call[6:], mesh, parts, 3)
    assert _ptrs(call[6], mesh.size) == [u.data_ptr() for u in used]
    assert _ptrs(call[7], mesh.size) == [c.data_ptr() for c in counts]
    assert (call[12], call[13]) == (info.data_ptr(), gathers.data_ptr())
    n_t = len(PORTFOLIO)
    consts = [call[17][i] for i in range(1 + 2 * n_t)]
    assert consts[0] == pytest.approx(TIE_JITTER)
    assert consts[1 + n_t:] == pytest.approx(list(_price_eps()))
    n_loc = 64 // mesh.size
    assert call[18:27] == (mesh.cards, mesh.size, 4, n_loc, n_loc,
                           min(TOP_R, n_loc), TOP_R, n_t, MAX_ROUNDS)
    assert _launches("joint_shard") == before + mesh.cards


def test_mesh_wrappers_take_up_to_65536_nodes(stub_libs, stub_mesh):
    """B13 takes up to 65,536 nodes a shard and B14's pick 65,536 in all
    (ROADMAP A11d): each is one host call there; one node more raises
    before any launch."""
    fns = stub_libs["sharded"].fns
    mesh, _ = stub_mesh((0,))
    args, _ = _stub_inputs(mesh, g=1, n=65536)
    sh.solve_bulk_multi_sharded(mesh, *args, g=1)
    sh.solve_batch_sharded(mesh, *args, g=1)
    assert fns["nt_bulk_shard_solve"].calls[-1][16] == 65536
    assert fns["nt_joint_shard_solve"].calls[-1][21] == 65536
    big, _ = _stub_inputs(mesh, g=1, n=65537)
    for solve in (sh.solve_bulk_multi_sharded, sh.solve_batch_sharded):
        with pytest.raises(NotImplementedError, match="A11d"):
            solve(mesh, *big, g=1)
    two, _ = stub_mesh((0, 0))
    wide, _ = _stub_inputs(two, g=1, n=2 * 32769)
    sh.solve_bulk_multi_sharded(two, *wide, g=1)   # 32,769 a shard
    with pytest.raises(NotImplementedError, match="A11d"):
        sh.solve_batch_sharded(two, *wide, g=1)     # 65,538 in all
    assert len(fns["nt_bulk_shard_solve"].calls) == 2
    assert len(fns["nt_joint_shard_solve"].calls) == 1


def test_scratch_queries_size_each_shards_buffer(stub_libs):
    """Each solve sizes its shards' scratch with its library's query,
    once a shape."""
    _ext.scratch_words.cache_clear()
    try:
        bulk = _ext.entry("nt_bulk_shard_solve_scratch_words")
        joint = _ext.entry("nt_joint_shard_solve_scratch_words")
        bulk.code, joint.code = 4096, 8192
        assert _ext.scratch_words("nt_bulk_shard_solve_scratch_words",
                                  4, 16, 4, 16) == 4096
        assert _ext.scratch_words("nt_joint_shard_solve_scratch_words",
                                  4, 16, 4, 16, 16, 5) == 8192
        assert bulk.calls == [(4, 16, 4, 16)]
        assert joint.calls == [(4, 16, 4, 16, 16, 5)]
    finally:
        _ext.scratch_words.cache_clear()


def test_mesh_card_arrays():
    """A mesh's C arrays for the solves: each shard's place among the
    distinct cards, and their ordinals."""
    mesh = sh.NodeMesh(["cpu"] * 3)
    assert list(mesh.card_of) == [0, 0, 0]
    assert list(mesh.card_ordinals) == [-1]
    assert isinstance(mesh.card_of, ctypes.Array)
