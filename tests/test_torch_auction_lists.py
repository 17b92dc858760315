"""The candidate lists of B5 (nomad_tpu_torch/csrc/batch_solve.cu
``nt_auction``) on the CPU: their bookkeeping in plain torch, the draw the
kernel makes inside its launch, and the wrapper's host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of its lists beside the full bid matrix of the plain
auction. A row's nodes belong to ``lanes`` home lanes (node i to lane
(i >> 4) mod lanes; the kernel has 64); each (row, lane) keeps the keys of
at most ``depth`` nodes and a floor, with the invariant that every fitting
home node outside the list has a key below the floor and every entry holds
its node's current key. Keys are ``topr_ref``'s unique order (bid in the
float total order, then the lower index).

- A scan of a row is the kernel's: scan thread (lane, i & 15) keeps the 16
  best of its nodes, the lane keeps the ``depth`` best of its threads'
  lists, and the floor goes just above the best key left out (by a thread
  or by the lane). A kernel thread sees at most 16 nodes of a row up to
  16,384 nodes, 32 at N_pad 32,768 and 64 at 65,536 (the kernel's
  ceiling): there, and at the model's narrower lanes, a thread lets keys
  go, and its best one may set its lane's floor.
- After a round, each row with demand drops the nodes the round touched
  (their usage, and so their price, moved) and takes back each one's new
  key if it is at or above its lane's floor; a list past ``depth`` keeps
  its best and the floor goes just above the best key it let go.
- A row's top R is the top R of its lists when its R-th key is at or above
  every floor, else the row is scanned again.

The model's surfaced (vals, idxs) must equal ``topr_ref`` of the full bid
matrix at every round, and its final (used, take, rounds) ``auction_ref``
and the JAX reference's ``_auction``, at depths that never rescan (the
kernel's 64 lanes) and at depths that force evictions and rescans (one or
two lanes of R or R + 1 keys). Torch runs on one thread (several workers
share the cores)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import batch_solver as ref
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import batch_solver as bs
from nomad_tpu_torch.tensor import prng
from nomad_tpu_torch.tensor.kernels import MAX_FILL_NODES, NEG, TIE_JITTER
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)

NONE = torch.iinfo(torch.int64).min   # no key (the kernel's 0)
R = bs.TOP_R
SUB = 16                              # scan threads of a lane
KERNEL = (64, R)                      # (lanes, depth) of the kernel
DEPTHS = [KERNEL, (64, 32), (1, R), (1, R + 1), (2, R)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def pair_keys(bid: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(G, N) bids -> int64 keys in topr_ref's order, NONE where a pair
    may not bid."""
    idx = torch.arange(bid.shape[-1], dtype=torch.int64)
    key = bs._order_key(bid) * (1 << 32) + (0xFFFFFFFF - idx)
    return torch.where(ok, key, NONE)


def keep_best(keys, group, groups: int, depth: int):
    """Per group, the ``depth`` best of ``keys`` (NONE: no candidate).
    Returns (kept (N,) bool, (groups,) the best key left out, or NONE)."""
    n = keys.shape[0]
    o = torch.sort(keys, descending=True, stable=True).indices
    o = o[torch.sort(group[o], stable=True).indices]
    k, g = keys[o], group[o]
    start = torch.searchsorted(g, torch.arange(groups))
    rank = torch.arange(n) - start[g]
    valid = k != NONE
    kept = torch.zeros(n, dtype=torch.bool)
    kept[o] = valid & (rank < depth)
    out = torch.full((groups,), NONE, dtype=torch.int64)
    first_out = valid & (rank == depth)
    out[g[first_out]] = k[first_out]
    return kept, out


def raise_floor(floor, left_out):
    """The floor just above the best key left out, never lower."""
    return torch.where(left_out != NONE,
                       torch.maximum(floor, left_out + 1), floor)


class Lists:
    """One restart's lists over G rows: ``inlist`` (G, N) and ``floor``
    (G, lanes), NONE for no floor."""

    def __init__(self, g: int, n: int, lanes: int, depth: int):
        node = torch.arange(n)
        self.lanes, self.depth = lanes, depth
        self.home = (node >> 4) % lanes
        self.thread = self.home * SUB + (node & (SUB - 1))
        self.inlist = torch.zeros((g, n), dtype=torch.bool)
        self.floor = torch.full((g, lanes), NONE, dtype=torch.int64)
        self.scans = 0
        self.thread_floors = 0   # lanes whose floor a thread's key set

    def scan(self, row, keys):
        """The kernel's scan of ``row``: its threads' 16 best, then the
        lanes' ``depth`` best of those."""
        kept1, lost = keep_best(keys, self.thread, self.lanes * SUB, R)
        kept, rest = keep_best(torch.where(kept1, keys, NONE), self.home,
                               self.lanes, self.depth)
        self.inlist[row] = kept
        lost_lane = lost.view(self.lanes, SUB).amax(dim=1)
        self.floor[row] = raise_floor(
            torch.full((self.lanes,), NONE, dtype=torch.int64),
            torch.maximum(rest, lost_lane))
        self.thread_floors += int((lost_lane > rest).sum())
        self.scans += 1

    def update(self, row, keys, touched):
        """Drop the touched nodes, take back each new key at or above its
        lane's floor; a list past ``depth`` lets its worst go."""
        back = torch.zeros_like(self.inlist[row])
        kt = keys[touched]
        back[touched] = (kt != NONE) & (kt >= self.floor[row][
            self.home[touched]])
        self.inlist[row, touched] = False
        cand = torch.where(self.inlist[row] | back, keys, NONE)
        self.inlist[row], out = keep_best(cand, self.home, self.lanes,
                                          self.depth)
        self.floor[row] = raise_floor(self.floor[row], out)

    def top(self, row, keys):
        """(R,) best list keys of ``row`` (NONE-padded), and whether they
        are its top R: the R-th at or above every floor."""
        best = torch.topk(torch.where(self.inlist[row], keys, NONE),
                          R).values
        return best, not bool(best[-1] < self.floor[row].max())


def auction_lists(used0, available, feas, aff, ask, k, jits, *,
                  price_eps: float, lanes: int, depth: int,
                  rounds: int = bs.MAX_ROUNDS, evict=None, pscore=None,
                  audit: bool = False):
    """One restart of B5 through the lists: the plain auction's rounds
    with each row's top R taken from its lists. Holds the surfaced (vals,
    idxs) against ``topr_ref`` of the full bid matrix every round.
    Returns (used, take, rounds, full row scans), and with ``audit`` the
    Lists last."""
    n, d = available.shape
    g = feas.shape[0]
    f = available.dtype
    avail_cap = available if evict is None else available + evict
    ask_pos = ask > 0
    ask_safe = torch.where(ask_pos, ask, 1.0)
    g_idx = torch.arange(g)
    used = used0.clone()
    remaining = k.to(torch.int32).clone()
    take = torch.zeros((g, n), dtype=torch.int32)
    price = torch.zeros(n, dtype=f)
    lists = Lists(g, n, lanes, depth)
    touched = None
    rnd, progressed = 0, True
    while rnd < rounds and progressed and bool((remaining > 0).any()):
        ok, score = bs.bid_scores(used, available, avail_cap, feas, aff, ask,
                                  remaining, pscore)
        bid = torch.where(ok, score + jits - price[None, :], NEG)
        keys = pair_keys(bid, ok)
        vals = torch.full((g, R), NEG, dtype=f)
        idxs = torch.zeros((g, R), dtype=torch.int64)
        for row in (remaining > 0).nonzero().flatten().tolist():
            if touched is None:
                lists.scan(row, keys[row])
            else:
                lists.update(row, keys[row], touched)
            best, exact = lists.top(row, keys[row])
            if not exact:
                lists.scan(row, keys[row])
                best, exact = lists.top(row, keys[row])
                assert exact, "a scan leaves the row short"
            live = best != NONE
            at = 0xFFFFFFFF - (best[live] & 0xFFFFFFFF)
            idxs[row, live] = at
            vals[row, live] = bid[row, at]
        want_v, want_i = bs.topr_ref(bid, R)
        active = want_v > NEG / 2
        assert torch.equal(active, vals > NEG / 2)
        assert torch.equal(want_i[active], idxs[active])
        assert torch.equal(want_v[active].view(torch.int32),
                           vals[active].view(torch.int32))
        free = avail_cap[idxs] - used[idxs]
        per_dim = torch.where(ask_pos[:, None, :],
                              torch.floor(free / ask_safe[:, None, :]),
                              math.inf)
        cap = torch.clamp_min(per_dim.amin(dim=2), 0.0)
        amt, bump = bs.resolve_round(vals, idxs, cap, remaining, n)
        delta = ask[:, None, :] * amt[..., None].to(f)
        used = used.index_add(0, idxs.reshape(-1), delta.reshape(-1, d))
        take = take.index_put((g_idx[:, None].expand(g, R), idxs), amt,
                              accumulate=True)
        remaining = remaining - amt.sum(dim=1, dtype=torch.int32)
        price = price + available.new_tensor(price_eps) * bump.to(f)
        touched = idxs[amt > 0]
        rnd += 1
        progressed = bool((amt > 0).any())
    if audit:
        return used, take, rnd, lists.scans, lists
    return used, take, rnd, lists.scans


# ---------------------------------------------------------------------------
# fixtures: chip_smoke.py's B5 variants at 256-1,024 nodes
# ---------------------------------------------------------------------------

def problem(variant: str, n: int = 512, g: int = 16, seed: int = 0):
    """(used0, avail, feas, aff, ask, k, seeds, evict, net_prio, rounds,
    his) as numpy: "main" (5% of the nodes hold the free capacity, the
    demand 75% of it), "wide" (a few allocs free on every node, demand
    past the round cap), "evict" (twice the demand, victim budgets),
    "sparse" (k = 0 rows, a row of 5 feasible nodes, an infeasible row,
    rows that run dry mid-run), "ties" (empty nodes of two sizes and no
    jitter: every empty node of a size bids exactly 0.0 and ties go to
    the lower index)."""
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4), np.float32)
    avail[:, 0] = rng.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng.choice([8192, 16384, 32768], n)
    avail[:, 2] = 100_000
    avail[:, 3] = 1000
    ask = np.zeros((g, 4), np.float32)
    ask[:, 0] = rng.choice([60, 100, 140, 200, 240], g)
    ask[:, 1] = rng.choice([48, 96, 128, 192], g)
    k = np.full(g, 60, np.int32)
    his = bs._jitter_his()[:2]
    open_share = {"main": 0.05, "evict": 0.05, "sparse": 0.3}.get(variant,
                                                                  1.0)
    open_nodes = rng.random(n) < open_share
    demand = float((k * ask[:, 0]).sum())
    if variant == "wide":
        demand *= 1.5
    share = min(demand / 0.75 / float(avail[open_nodes, 0].sum()), 1.0)
    fill = np.where(open_nodes, 1.0 - share * rng.uniform(0.5, 1.5, n), 1.0)
    used0 = np.zeros((n, 4), np.float32)
    used0[:, :3] = np.floor(avail[:, :3] * np.clip(fill, 0.0, 1.0)[:, None])
    feas = rng.random((g, n)) < 0.95
    aff = np.zeros((g, n), np.float32)
    aff[5] = rng.choice([0.0, 0.0, 0.5, -0.5], n)
    seeds = rng.integers(0, 2 ** 32, g).astype(np.int64)
    evict = net_prio = None
    rounds = bs.MAX_ROUNDS
    if variant == "evict":
        k[:] *= 2
        evict = np.zeros((n, 4), np.float32)
        victims = rng.random(n) < 0.4
        evict[:, 0] = victims * 2000.0
        evict[:, 1] = victims * 4096.0
        net_prio = rng.uniform(0.0, 4000.0, n).astype(np.float32)
    elif variant == "sparse":
        k[[11, 15]] = 0
        k[[1, 2]] = 3          # rows that run dry after a round or two
        feas[3] = False
        feas[3, rng.choice(n, 5, replace=False)] = True
        feas[8] = False
    elif variant == "ties":
        used0[:] = 0.0
        avail[:, 0] = np.where(np.arange(n) % 2, 8000, 16000)
        avail[:, 1] = np.where(np.arange(n) % 2, 16384, 32768)
        aff[:] = 0.0
        his = (0.0, 0.0)
        rounds = 12
    elif variant == "wide":
        rounds = 24
    return (used0, avail, feas, aff, ask, k, seeds, evict, net_prio, rounds,
            his)


VARIANTS = ("main", "wide", "evict", "sparse", "ties")
SIZES = {"main": 1024, "wide": 512, "evict": 512, "sparse": 256,
         "ties": 256}


def _torch_args(p):
    used0, avail, feas, aff, ask, k, seeds, evict, net_prio, rounds, his = p
    t = torch.from_numpy
    return (t(used0), t(avail), t(feas), t(aff), t(ask), t(k), t(seeds),
            None if evict is None else t(evict),
            None if net_prio is None else t(net_prio), rounds, his)


@pytest.mark.parametrize("lanes,depth", DEPTHS,
                         ids=[f"{a}x{b}" for a, b in DEPTHS])
@pytest.mark.parametrize("variant", VARIANTS)
def test_lists_equal_the_plain_auction(variant, lanes, depth):
    """Every restart of the portfolio through the lists: the surfaced
    bids equal topr_ref's every round, and (used, take, rounds) equal
    auction_ref's."""
    used0, avail, feas, aff, ask, k, seeds, evict, net_prio, rounds, his = (
        _torch_args(problem(variant, SIZES[variant])))
    eps = bs._price_eps()[:len(his)]
    jits = prng.jitter_fold_ref(seeds, avail.shape[0], his)
    pscore = None if net_prio is None else bs.preempt_score_ref(net_prio)
    scans = []
    for t in range(len(his)):
        got = auction_lists(used0, avail, feas, aff, ask, k, jits[t],
                            price_eps=eps[t], lanes=lanes, depth=depth,
                            rounds=rounds, evict=evict, pscore=pscore)
        want = bs.auction_ref(used0, avail, feas, aff, ask, k, jits[t],
                              rounds=rounds, price_eps=eps[t], evict=evict,
                              pscore=pscore)
        assert got[2] == want[2] >= 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        scans.append(got[3])
    live = int((k > 0).sum())
    if (lanes, depth) == KERNEL and variant in ("main", "sparse"):
        assert scans == [live] * len(his)   # the first round's alone
    if lanes == 1 and variant in ("main", "wide", "evict"):
        assert min(scans) > live            # shallow lists rescan


@pytest.mark.parametrize("variant", ["main", "wide", "evict", "sparse"])
def test_lists_equal_jax(variant):
    """The lists at the kernel's depth and at the shallowest against the
    JAX reference's _auction on the same draws."""
    p = problem(variant, SIZES[variant], seed=1)
    used0, avail, feas, aff, ask, k, seeds, evict, net_prio, rounds, his = p
    g = ask.shape[0]
    jits = prng.jitter_fold_ref(torch.from_numpy(seeds), avail.shape[0],
                                his).numpy()
    args = _torch_args(p)
    pscore_t = None if net_prio is None else bs.preempt_score_ref(args[8])
    pscore_j = None if net_prio is None else 1.0 / (
        1.0 + jnp.exp(0.0048 * (jnp.asarray(net_prio) - 2048.0)))
    for t, (jscale, ptemp) in enumerate(bs.PORTFOLIO[:len(his)]):
        want = ref._auction(
            jnp.asarray(used0), jnp.asarray(avail), jnp.asarray(feas),
            jnp.asarray(aff), jnp.asarray(ask), jnp.asarray(k),
            jnp.asarray(jits[t]), g, rounds,
            price_eps=ref.PRICE_EPS * ptemp,
            evict=None if evict is None else jnp.asarray(evict),
            pscore=pscore_j)
        for lanes, depth in (KERNEL, (1, R)):
            got = auction_lists(*args[:6], torch.from_numpy(jits[t]),
                                price_eps=bs.PRICE_EPS * ptemp, lanes=lanes,
                                depth=depth, rounds=rounds, evict=args[7],
                                pscore=pscore_t)
            assert got[2] == int(want[2])
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def wide_problem(n: int, g: int = 4, seed: int = 0):
    """problem()'s shape at N_pad 32,768 or 65,536, where a kernel scan
    thread scores 32 or 64 nodes of a row: every node full but those of
    two scan threads (i mod 1,024 in {5, 600}: all their nodes fit, so
    each turns keys away that beat the rest of its lane) and a few random
    ones; the demand takes several rounds of them."""
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4), np.float32)
    avail[:, 0] = rng.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng.choice([8192, 16384, 32768], n)
    avail[:, 2] = 100_000
    avail[:, 3] = 1000
    node = np.arange(n)
    open_nodes = (np.isin(node % 1024, (5, 600))
                  | (rng.random(n) < 0.001))
    used0 = avail.copy()
    used0[:, 3] = 0.0
    free = rng.integers(2, 6, n) * 200
    used0[open_nodes, 0] = avail[open_nodes, 0] - free[open_nodes]
    used0[open_nodes, 1] = np.floor(avail[open_nodes, 1] * 0.5)
    ask = np.zeros((g, 4), np.float32)
    ask[:, 0] = rng.choice([100, 200], g)
    ask[:, 1] = rng.choice([48, 96], g)
    k = np.full(g, 40, np.int32)
    feas = rng.random((g, n)) < 0.95
    aff = np.zeros((g, n), np.float32)
    seeds = rng.integers(0, 2 ** 32, g).astype(np.int64)
    return (used0, avail, feas, aff, ask, k, seeds, None, None, 24,
            bs._jitter_his()[:2])


@pytest.mark.parametrize("n", [32768, 65536])
def test_wide_rows_lists_equal_the_plain_auction_and_jax(n):
    """At the kernel's lanes and depth with a scan thread over 32 and 64
    nodes of a row: the surfaced bids equal topr_ref's every round,
    (used, take, rounds) equal auction_ref's and the JAX reference's
    _auction; some lane's floor is set by a thread's turned-away key, and
    rows are scanned again when their lists run dry."""
    p = wide_problem(n)
    used0, avail, feas, aff, ask, k, seeds, _, _, rounds, his = p
    args = _torch_args(p)
    g = ask.shape[0]
    jits = prng.jitter_fold_ref(args[6], n, his)
    eps = bs._price_eps()[:len(his)]
    lanes, depth = KERNEL
    for t in range(len(his)):
        lists_out = auction_lists(*args[:6], jits[t], price_eps=eps[t],
                                  lanes=lanes, depth=depth, rounds=rounds,
                                  audit=True)
        got, audit = lists_out[:4], lists_out[4]
        want = bs.auction_ref(*args[:6], jits[t], rounds=rounds,
                              price_eps=eps[t])
        assert got[2] == want[2] > 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert audit.thread_floors > 0 and got[3] > g
        if t == 0:
            jw = ref._auction(
                jnp.asarray(used0), jnp.asarray(avail), jnp.asarray(feas),
                jnp.asarray(aff), jnp.asarray(ask), jnp.asarray(k),
                jnp.asarray(jits[t].numpy()), g, rounds,
                price_eps=ref.PRICE_EPS * bs.PORTFOLIO[t][1])
            assert got[2] == int(jw[2])
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(jw[1]))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(jw[0]))


SPECIAL = np.array([-0.0, 0.0, 0.25, -0.25, 1e-30, -1e-30], np.float32)


@pytest.mark.parametrize("lanes,depth", DEPTHS,
                         ids=[f"{a}x{b}" for a, b in DEPTHS])
def test_lists_hold_ties_and_signed_zeros(lanes, depth):
    """Rows of exactly tied bids, -0.0 and +0.0 among them, and pairs that
    stop fitting: after a scan and after every random round of touched
    nodes taking new values (or none), the lists' top R is topr_ref's
    (-0.0 below +0.0, ties to the lower index)."""
    rng = np.random.default_rng(7)
    g, n = 4, 300
    bid = rng.choice(SPECIAL, (g, n))
    ok = rng.random((g, n)) < 0.9
    lists = Lists(g, n, lanes, depth)
    touched = None
    for step in range(40):
        b = torch.from_numpy(np.where(ok, bid, np.float32(NEG)))
        keys = pair_keys(b, torch.from_numpy(ok))
        for row in range(g):
            if step == 0:
                lists.scan(row, keys[row])
            else:
                lists.update(row, keys[row], touched)
            best, exact = lists.top(row, keys[row])
            if not exact:
                lists.scan(row, keys[row])
                best, exact = lists.top(row, keys[row])
                assert exact
            want_v, want_i = bs.topr_ref(b[row:row + 1], R)
            live = best != NONE
            active = want_v[0] > NEG / 2
            assert torch.equal(live, active)
            assert torch.equal(want_i[0][active],
                               0xFFFFFFFF - (best[live] & 0xFFFFFFFF))
        t = rng.choice(n, 24, replace=False)
        bid[:, t] = rng.choice(SPECIAL, (g, t.size))
        ok[:, t] = rng.random((g, t.size)) < 0.7
        touched = torch.from_numpy(t)
    assert np.signbit(SPECIAL[0]) and not np.signbit(SPECIAL[1])


def test_the_kernels_draw_equals_jitter_fold_ref_and_jax():
    """The kernel folds each (t, row) key once, (k0, k1) = threefry2x32 of
    the counter (0, t) under (seed >> 32, seed & 0xffffffff), then draws
    node i as threefry2x32 of (0, i) under (k0, k1), out0 ^ out1, to
    [1, 2) - 1 times the f32 width, floored at 0: jitter_fold_ref, and
    JAX's uniform(fold_in(PRNGKey(seed), t))."""
    import jax

    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789],
                         dtype=torch.int64)
    n = 300
    his = bs._jitter_his()
    want = prng.jitter_fold_ref(seeds, n, his)
    node = torch.arange(n, dtype=torch.int64)
    mask = prng.MASK32
    for t, hi in enumerate(his):
        zero = torch.zeros_like(seeds)
        k0, k1 = prng.threefry2x32((seeds >> 32) & mask, seeds & mask, zero,
                                   torch.full_like(seeds, t))
        o0, o1 = prng.threefry2x32(k0[:, None], k1[:, None],
                                   torch.zeros_like(node)[None, :],
                                   node[None, :])
        f = ((((o0 ^ o1) >> 9) | 0x3F800000).to(torch.int32)
             .view(torch.float32) - 1.0)
        span = torch.tensor(prng._span(hi), dtype=torch.float32)
        got = torch.clamp_min(f * span + 0.0, 0.0)
        assert torch.equal(got.view(torch.int32), want[t].view(torch.int32))
        jx = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(int(s)), t), (n,),
            jnp.float32, 0.0, TIE_JITTER * bs.PORTFOLIO[t][0]))
            for s in seeds.tolist()])
        assert np.array_equal(jx.view(np.uint32),
                              got.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# the wrapper on stub cards: one launch, the draws inside it
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch, stub_libs, cards):  # noqa: F811
    """CPU tensors taken for a card's (``is_cuda`` true), every library a
    stub: the wrappers take their kernel routes and launch stubs."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    _ext.scratch_words.cache_clear()
    yield stub_libs
    _ext.scratch_words.cache_clear()


def _stub_args(n=64, g=4):
    rng = np.random.default_rng(0)
    return (torch.zeros((n, 4)), torch.full((n, 4), 1000.0),
            torch.ones((g, n), dtype=torch.bool), torch.zeros((g, n)),
            torch.ones((g, 4)), torch.full((g,), 8, dtype=torch.int32),
            torch.from_numpy(rng.integers(0, 2 ** 32, g)))


def _launches():
    return dict(_ext.COUNTS.snapshot()["launches"])


def test_auction_is_one_launch_with_its_draws_inside(fake_card):
    """One nt_auction: the seeds themselves and one (2, T) row of price
    temperatures and jitter widths, the list scratch the library asks
    for, one set of barrier words a stream, no nt_jitter_fold; COUNTS
    move by one auction."""
    used0, avail, feas, aff, ask, k, seeds = _stub_args()
    his, eps = bs._jitter_his(), bs._price_eps()
    fake_card["batch_solve"].nt_auction_scratch_words.code = 4096
    scans = torch.zeros(len(eps), dtype=torch.int32)
    before = _launches()
    used, take, rounds = bs.auction(used0, avail, feas, aff, ask, k, seeds,
                                    his=his, price_eps=eps, rounds=7,
                                    scans=scans)
    (call,) = fake_card["batch_solve"].fns["nt_auction"].calls
    assert call[:7] == (used0.data_ptr(), avail.data_ptr(), feas.data_ptr(),
                        aff.data_ptr(), ask.data_ptr(), k.data_ptr(),
                        seeds.data_ptr())
    params = bs._params_tensor(eps, his, used0.device)
    assert call[7] == params.data_ptr()
    assert params.tolist() == [float(np.float32(e)) for e in eps] + [
        prng._span(hi) for hi in his]
    assert call[8] is None and call[9] is None          # no evict arm
    assert call[10:13] == (used.data_ptr(), take.data_ptr(),
                           rounds.data_ptr())
    assert call[14] is not None and call[15] == scans.data_ptr()
    words = bs._barrier_words(used0.device)
    assert call[16] == words.data_ptr()
    assert words.tolist() == [0] * bs.BARRIER_WORDS
    assert call[17:21] == (len(eps), 4, 64, 7)
    assert fake_card["batch_solve"].nt_auction_scratch_words.calls == [
        (len(eps), 4)]
    assert not fake_card["jitter"].nt_jitter_fold.calls
    after = _launches()
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {"auction": 1}
    bs.auction(used0, avail, feas, aff, ask, k, seeds, his=his,
               price_eps=eps)     # the same stream: the same words
    assert fake_card["batch_solve"].fns["nt_auction"].calls[1][16] == (
        words.data_ptr())


def test_solve_batch_launches_no_jitter_fold(fake_card, monkeypatch):
    """solve_batch on a card: the fold, B1 and B5, one launch each, then
    the pick; B3' is drawn inside B5."""
    used0, avail, feas, aff, ask, k, seeds = _stub_args()
    monkeypatch.setattr(bs, "batch_pick", lambda *a: a)
    before = _launches()
    bs.solve_batch(used0, avail, feas, aff, ask, k, torch.ones(4), seeds,
                   torch.zeros(1, dtype=torch.int32), torch.zeros((1, 4)),
                   g=4)
    (call,) = fake_card["batch_solve"].fns["nt_auction"].calls
    assert call[6] == seeds.data_ptr()
    after = _launches()
    assert not fake_card["jitter"].nt_jitter_fold.calls
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {
        "scatter_add": 1, "bulk_fill": 1, "auction": 1}


def test_auction_refuses_what_the_kernel_does_not_take(fake_card):
    used0, avail, feas, aff, ask, k, seeds = _stub_args()
    kw = dict(his=(TIE_JITTER,), price_eps=(bs.PRICE_EPS,))
    with pytest.raises(ValueError, match="1-64 evals"):
        bs.auction(used0, avail, feas.repeat(17, 1), aff.repeat(17, 1),
                   ask.repeat(17, 1), k.repeat(17), seeds.repeat(17), **kw)
    with pytest.raises(ValueError, match="seeds"):
        bs.auction(used0, avail, feas, aff, ask, k, seeds.to(torch.int32),
                   **kw)
    n = MAX_FILL_NODES + 1
    big = (torch.zeros((n, 4)), torch.zeros((n, 4)),
           torch.ones((1, n), dtype=torch.bool), torch.zeros((1, n)),
           torch.ones((1, 4)), torch.ones(1, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="A11d"):
        bs.auction(*big, **kw)
    assert not fake_card["batch_solve"].fns.get("nt_auction")


def test_auction_takes_up_to_65536_nodes(fake_card):
    """N_pad 32,768 and 65,536 (the ceiling, ROADMAP A11d) are one
    nt_auction each; 65,537 raises before any launch."""
    kw = dict(his=(TIE_JITTER,), price_eps=(bs.PRICE_EPS,))
    assert MAX_FILL_NODES == 65536
    for n in (32768, MAX_FILL_NODES):
        bs.auction(*_stub_args(n=n, g=1), **kw)
    calls = fake_card["batch_solve"].fns["nt_auction"].calls
    assert [c[19] for c in calls] == [32768, MAX_FILL_NODES]
    with pytest.raises(NotImplementedError, match="A11d"):
        bs.auction(*_stub_args(n=MAX_FILL_NODES + 1, g=1), **kw)
    assert len(calls) == 2
