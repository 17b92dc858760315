"""The joint solve behind SchedulerAlgorithm="tpu-solve", in torch
(reference ``nomad_tpu/tensor/batch_solver.py``).

``solve_batch`` places a batch of G fresh-placement evals as one
assignment problem, in one call with the signature of
:func:`kernels.solve_bulk_multi`:

- fold the queued usage corrections into the carry (B4) and clamp it at
  0; both arms start from that state;
- the greedy arm: the exact "tpu-binpack" chain (B1, which draws B3's
  jitter in its launch);
- the auction arm (B5): one auction per ``PORTFOLIO`` entry, each with
  its own ``fold_in(PRNGKey(seed), t)`` jitter (B3', drawn inside B5's
  launch on the card) scaled by the entry's jitter scale and its own
  price temperature. Per round every
  eval with demand left bids for its ``TOP_R`` best nodes, each node
  goes to its best bid (ties to the lowest eval), each winner fills its
  won nodes in score order, and nodes that were contested and drained
  get dearer;
- the pick (B6): the best restart by (placed, packing score), earliest
  on exact ties, then auction against greedy the same way. The packing
  score is sum over nodes of placed x BestFit fitness of the final
  usage, summed by the reference's fixed pairwise tree.

It returns the chosen carry, (G, N) int16 counts and the info row
``[auction_score, greedy_score, placed_auction, placed_greedy,
rounds_run, auction_won]``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/batch_solve.cu`` for the auction and the pick, the port's
earlier kernels for the rest); on a CPU tensor it runs its plain torch
version (``*_ref``), and on nothing else. The auction kernel keeps each
row's candidates in per-lane lists with floors and rescores only the
nodes a round touched (``csrc/batch_solve.cu`` has the invariant); the
pick sums (arm, chunk) items of the reference's pairwise tree on many
SMs and combines each arm's chunk sums by the same halving. The
carry passed in takes the correction fold in place; the returned carry
is a new tensor.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence

import numpy as np
import torch

from .. import _ext
from .kernels import (MAX_FILL_NODES, NEG, TIE_JITTER, _check_cuda,
                      bulk_fill, bulk_fill_ref, fit_scores, fit_scores_np,
                      pairwise_sum_ref, preempt_score_ref)
from .prng import _span, jitter_fold_ref
from .scatter import scatter_add, scatter_add_ref

MAX_ROUNDS = 64      # auction rounds per restart
TOP_R = 16           # nodes each eval bids for per round
PRICE_EPS = TIE_JITTER  # price bump of a contested, drained node
# (jitter scale, price temperature) per restart; entry 0 is the legacy
# basin, the repeated (8.0, 0.25) is a fresh fold_in stream of its basin
PORTFOLIO = (
    (1.0, 1.0),
    (8.0, 0.25),
    (0.25, 0.25),
    (4.0, 0.25),
    (8.0, 0.25),
)
RESTARTS = len(PORTFOLIO)
# the kernel resolves a round's G x TOP_R surfaced bids with one thread each
MAX_EVALS = 1024 // TOP_R
# the words of one barrier group (csrc/mesh.cuh kGroupWords)
BARRIER_WORDS = 32
# the pick kernel: the padded node count it takes, and its arms (the
# restarts and the greedy arm)
MAX_PICK_NODES = MAX_FILL_NODES
MAX_PICK_ARMS = 64


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def packing_score_ref(counts: torch.Tensor, available: torch.Tensor,
                      used_final: torch.Tensor) -> torch.Tensor:
    """Order-independent packing quality of an assignment (reference
    ``_packing_score_xp``): sum_n placed[n] * BestFit fitness of
    ``used_final[n]``, by the fixed pairwise tree in node order. Returns
    a 0-dim tensor of ``available``'s dtype."""
    per_node = fit_scores(available, used_final)
    placed = counts.to(torch.int64).sum(dim=0) if counts.dim() == 2 else counts
    return pairwise_sum_ref(placed.to(per_node.dtype) * per_node)


def packing_score_np(counts, available, used_final) -> float:
    """float64 numpy twin of :func:`packing_score_ref`, for scoring end
    states on the host."""
    counts = np.asarray(counts)
    placed = counts.sum(axis=0) if counts.ndim == 2 else counts
    per_node = fit_scores_np(available, used_final)
    return float(pairwise_sum_ref(torch.from_numpy(
        placed.astype(np.float64) * per_node)))


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in the total order XLA's top_k sorts by (-0.0
    below +0.0)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topr_ref(bid: torch.Tensor, r: int):
    """Each row's ``r`` largest entries in ``jax.lax.top_k`` order: value
    descending in the float total order (-0.0 below +0.0), ties to the
    lower index. Returns (values, int64 indices), each (G, r).
    ``torch.topk`` alone does not promise this order; on the unique key
    (order key, complement of the index) it has no choice to make."""
    n = bid.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=bid.device)
    key = _order_key(bid) * (1 << 32) + (0xFFFFFFFF - idx)
    idxs = torch.topk(key, r, dim=-1).indices
    return torch.gather(bid, -1, idxs), idxs


def bid_scores(used, available, avail_cap, feas, aff, ask, remaining,
               pscore=None):
    """Each (eval, node) pair's auction score and whether it may bid:
    feasible, fitting within ``avail_cap`` (capacity plus victim
    budgets) and with demand left (reference ``_auction``,
    batch_solver.py:172-196). With ``pscore`` (the victims' logistic
    preemption scores) fitness is taken at min(used + ask, capacity) and
    an over-capacity bid adds pscore and divides by one more."""
    f = available.dtype
    aff_present = aff != 0.0
    aff_term = torch.where(aff_present, aff, 0.0)
    divisor = 1.0 + aff_present.to(f)
    new_used = used[None, :, :] + ask[:, None, :]                    # (G,N,D)
    ok = feas & torch.all(new_used <= avail_cap[None, :, :], dim=2)
    ok = ok & (remaining > 0)[:, None]
    if pscore is None:
        fitness = fit_scores(available[None, :, :], new_used)
        return ok, (fitness + aff_term) / divisor
    fitness = fit_scores(available[None, :, :],
                         torch.minimum(new_used, available[None]))
    over = torch.any(new_used > available[None, :, :], dim=2)
    return ok, (fitness + aff_term + torch.where(over, pscore[None, :], 0.0)
                ) / (divisor + over.to(f))


def resolve_round(vals, idxs, caps, remaining, n: int):
    """One auction round after each eval surfaced its best bids (``vals``
    / ``idxs`` (G, R) in top_k order, ``caps`` (G, R) the capacity of
    each surfaced node against the usage before the round): each node
    goes to its best active bid, ties to the lowest eval; each winner
    spends its remaining demand over its won nodes in score order.
    Returns (amounts (G, R) int32, (n,) bool of the nodes whose price
    rises: contested and drained). Reference batch_solver.py:205-248."""
    g, r = vals.shape
    f = vals.dtype
    dev = vals.device
    neg = vals.new_tensor(NEG)
    g_idx = torch.arange(g, dtype=torch.int64, device=dev)
    active = vals > NEG / 2
    flat_idx = idxs.reshape(-1)
    flat_val = torch.where(active, vals, neg).reshape(-1)
    flat_g = g_idx[:, None].expand(g, r).reshape(-1)
    node_best = torch.full((n,), NEG, dtype=f, device=dev).scatter_reduce(
        0, flat_idx, flat_val, reduce="amax")
    is_best = (flat_val > NEG / 2) & (flat_val >= node_best[flat_idx])
    node_winner = torch.full((n,), g, dtype=torch.int64,
                             device=dev).scatter_reduce(
        0, flat_idx, torch.where(is_best, flat_g, g), reduce="amin")
    won = active & (vals >= node_best[idxs]) & (
        node_winner[idxs] == g_idx[:, None])
    cap = torch.where(won, caps, 0.0)
    # an all-zero ask makes cap inf and its prefix inf - inf = NaN, which
    # converts to 0 as XLA's float -> int32 conversion does
    prefix = torch.cumsum(cap, dim=1) - cap
    amt_f = torch.minimum(torch.clamp_min(
        remaining.to(f)[:, None] - prefix, 0.0), cap)
    amt = torch.where(torch.isnan(amt_f), 0.0, amt_f).to(torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    bids_per_node = zeros.index_add(
        0, flat_idx, active.reshape(-1).to(torch.int32))
    filled = won & (cap > 0) & (amt.to(f) >= cap)
    node_filled = zeros.index_add(
        0, flat_idx, filled.reshape(-1).to(torch.int32)) > 0
    return amt, node_filled & (bids_per_node > 1)


def auction_ref(used0, available, feas, aff, ask, k, jits, *,
                rounds: int = MAX_ROUNDS, price_eps: float = PRICE_EPS,
                evict=None, pscore=None, trace: list = None):
    """B5 in plain torch: one restart, op for op the reference's
    ``_auction`` (batch_solver.py:137-253). ``used0`` is left alone.
    Returns (used (N, D), take (G, N) int32, rounds run). A ``trace``
    list gets one (evals with demand, fitting (eval, node) bids) pair per
    round, the work a round needs on this data."""
    n, d = available.shape
    g = feas.shape[0]
    f = available.dtype
    dev = available.device
    r = min(TOP_R, n)
    neg = available.new_tensor(NEG)
    eps = available.new_tensor(price_eps)
    avail_cap = available if evict is None else available + evict
    g_idx = torch.arange(g, dtype=torch.int64, device=dev)
    ask_pos = ask > 0
    ask_safe = torch.where(ask_pos, ask, 1.0)

    used = used0.clone()
    remaining = k.to(torch.int32).clone()
    take = torch.zeros((g, n), dtype=torch.int32, device=dev)
    price = torch.zeros(n, dtype=f, device=dev)
    rnd, progressed = 0, True
    while rnd < rounds and progressed and bool((remaining > 0).any()):
        ok, score = bid_scores(used, available, avail_cap, feas, aff, ask,
                               remaining, None if evict is None else pscore)
        bid = torch.where(ok, score + jits - price[None, :], neg)
        if trace is not None:
            trace.append((int((remaining > 0).sum()), int(ok.sum())))
        vals, idxs = topr_ref(bid, r)                                # (G,R)
        # capacity of each surfaced node against the usage before this
        # round
        free = avail_cap[idxs] - used[idxs]                          # (G,R,D)
        per_dim = torch.where(ask_pos[:, None, :],
                              torch.floor(free / ask_safe[:, None, :]),
                              math.inf)
        cap = torch.clamp_min(per_dim.amin(dim=2), 0.0)
        amt, bump = resolve_round(vals, idxs, cap, remaining, n)
        delta = ask[:, None, :] * amt[..., None].to(f)             # (G,R,D)
        used = used.index_add(0, idxs.reshape(-1), delta.reshape(-1, d))
        take = take.index_put((g_idx[:, None].expand(g, r), idxs), amt,
                              accumulate=True)
        remaining = remaining - amt.sum(dim=1, dtype=torch.int32)
        price = price + eps * bump.to(f)
        rnd += 1
        progressed = bool((amt > 0).any())
    return used, take, rnd


def auction_restarts_ref(used0, available, feas, aff, ask, k, jits, *,
                         price_eps: Sequence[float], rounds: int = MAX_ROUNDS,
                         evict=None, net_prio=None):
    """Plain version of the auction kernel: one :func:`auction_ref` per
    restart t, each from ``max(used0, 0)`` with ``jits[t]`` and
    ``price_eps[t]``. Returns (used (T, N, D), take (T, G, N) int32,
    rounds (T,) int32)."""
    _ext.COUNTS.plain("auction", used0)
    start = torch.clamp_min(used0, 0.0)
    pscore = None if net_prio is None else preempt_score_ref(net_prio)
    outs = [auction_ref(start, available, feas, aff, ask, k, jits[t],
                        rounds=rounds, price_eps=price_eps[t], evict=evict,
                        pscore=pscore)
            for t in range(len(price_eps))]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.tensor([o[2] for o in outs], dtype=torch.int32,
                         device=used0.device))


def batch_pick_ref(available, used_t, take_t, rounds_t, used_g, counts_g):
    """Plain version of the pick kernel (the end of the reference's
    ``solve_batch``, :329-358): the best restart by (placed, packing
    score), earliest on exact ties, against the greedy arm the same way.
    Returns (used (N, D), counts (G, N) int16, info (6,) float32)."""
    _ext.COUNTS.plain("batch_pick", available)
    best = placed_best = score_best = None
    for t in range(used_t.shape[0]):
        placed = take_t[t].sum(dtype=torch.int32)
        score = packing_score_ref(take_t[t], available, used_t[t])
        if t == 0 or bool(placed > placed_best) or (
                bool(placed == placed_best) and bool(score > score_best)):
            best, placed_best, score_best = t, placed, score
    placed_g = counts_g.to(torch.int32).sum(dtype=torch.int32)
    score_g = packing_score_ref(counts_g, available, used_g)
    pick_a = bool(placed_best > placed_g) or (
        bool(placed_best == placed_g) and bool(score_best > score_g))
    if pick_a:
        used, counts = used_t[best].clone(), take_t[best].to(torch.int16)
    else:
        used, counts = used_g.clone(), counts_g.clone()
    f = torch.float32
    info = torch.stack([score_best.to(f), score_g.to(f), placed_best.to(f),
                        placed_g.to(f), rounds_t[best].to(f),
                        available.new_tensor(float(pick_a), dtype=f)])
    return used, counts, info


def _jitter_his() -> tuple:
    """Each restart's jitter bound ``TIE_JITTER * jscale``, in Python
    floats as the reference computes it."""
    return tuple(TIE_JITTER * jscale for jscale, _ in PORTFOLIO)


def _price_eps() -> tuple:
    return tuple(PRICE_EPS * ptemp for _, ptemp in PORTFOLIO)


def solve_batch_ref(used, available, feas, aff, ask, k, tg_count, seeds,
                    cidx, cdelta, evict=None, net_prio=None, *, g: int,
                    rounds: int = MAX_ROUNDS):
    """Plain torch version of :func:`solve_batch`, step by step the
    reference's ``solve_batch`` (batch_solver.py:256-358)."""
    scatter_add_ref(used, cidx, cdelta)
    n = used.shape[0]
    used_g = used.clone()
    counts_g = bulk_fill_ref(used_g, available, feas, aff, ask, k, seeds)
    jits = jitter_fold_ref(seeds, n, _jitter_his())
    used_t, take_t, rounds_t = auction_restarts_ref(
        used, available, feas, aff, ask, k, jits, price_eps=_price_eps(),
        rounds=rounds, evict=evict, net_prio=net_prio)
    return batch_pick_ref(available, used_t, take_t, rounds_t, used_g,
                          counts_g)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_params_lock = threading.Lock()
_params_cache: Dict[tuple, torch.Tensor] = {}


def _params_tensor(price_eps: Sequence[float], his: Sequence[float],
                   device) -> torch.Tensor:
    """The restarts' price temperatures, then their jitter widths (``hi
    - 0`` in float32, as jax.random.uniform computes it), as one (2T,)
    float32 device tensor, uploaded once per (device, values)."""
    key = (str(device), tuple(float(e) for e in price_eps),
           tuple(_span(hi) for hi in his))
    t = _params_cache.get(key)
    if t is None:
        with _params_lock:
            t = _params_cache.get(key)
            if t is None:
                t = _params_cache[key] = torch.tensor(
                    key[1] + key[2], dtype=torch.float32).to(device)
    return t


_words_lock = threading.Lock()
_words: Dict[tuple, torch.Tensor] = {}


def _stream_words(device, what: str, words) -> torch.Tensor:
    """``what``'s zeroed int32 buffer of ``words()`` words for launches
    from the current stream of ``device``: made once, when first asked
    for, and kept, so launches in stream order share it; launches from
    other streams get their own."""
    get_device, _, raw_stream = _ext._cuda_fns or _ext._cuda()
    index = get_device() if device.index is None else device.index
    key = (what, str(device), raw_stream(index))
    buf = _words.get(key)
    if buf is None:
        with _words_lock:
            buf = _words.get(key)
            if buf is None:
                buf = _words[key] = torch.zeros(
                    words(), dtype=torch.int32, device=device)
    return buf


def _barrier_words(device) -> torch.Tensor:
    """The barrier words (csrc/mesh.cuh) of the auction's and the pick's
    launches from the current stream of ``device``. Every barrier leaves
    them as it found them."""
    return _stream_words(device, "barrier", lambda: BARRIER_WORDS)


def _pick_scratch(device) -> torch.Tensor:
    """The pick's scratch for launches from the current stream of
    ``device``, at the size the library asks for at the most arms and
    nodes the kernel takes: a launch writes every word it reads."""
    return _stream_words(device, "pick", lambda: _ext.scratch_words(
        "nt_batch_pick_scratch_words", MAX_PICK_ARMS - 1, MAX_PICK_NODES))


def auction(used0, available, feas, aff, ask, k, seeds, *,
            his: Sequence[float], price_eps: Sequence[float],
            rounds: int = MAX_ROUNDS, evict=None, net_prio=None,
            scans=None):
    """B5 for T restarts at once, each drawing its own jitter: restart t
    bids with U[0, his[t]) from ``fold_in(PRNGKey(seed), t)`` (B3') and
    prices with ``price_eps[t]``. The CUDA kernel (csrc/batch_solve.cu
    ``nt_auction``, one launch, the draws inside it) for a CUDA tensor;
    :func:`auction_restarts_ref` over :func:`prng.jitter_fold_ref` for a
    CPU tensor. ``seeds`` (G,) int64 in [0, 2**32); ``evict`` (N, D) and
    ``net_prio`` (N,) come together or not at all. On the card
    ``scans``, a (T,) int32 tensor where given, gets each restart's full
    row scans (the first round's and the rescans); the launch is
    cooperative: the first round's scans run on up to G CTAs a restart.
    Returns (used (T, N, D), take (T, G, N) int32, rounds (T,) int32)."""
    if (evict is None) != (net_prio is None):
        raise ValueError("auction: evict and net_prio come together")
    if len(his) != len(price_eps):
        raise ValueError(f"auction: {len(his)} jitter widths for "
                         f"{len(price_eps)} restarts")
    if not used0.is_cuda:
        if used0.device.type != "cpu":
            raise ValueError(f"auction: unsupported device {used0.device}")
        jits = jitter_fold_ref(seeds, used0.shape[0], his)
        return auction_restarts_ref(used0, available, feas, aff, ask, k, jits,
                                    price_eps=price_eps, rounds=rounds,
                                    evict=evict, net_prio=net_prio)
    n, d = used0.shape
    g = feas.shape[0]
    n_t = len(price_eps)
    dev = used0.device
    if d != 4 or not 1 <= g <= MAX_EVALS:
        raise ValueError(f"auction: the kernel takes 4 resource columns and "
                         f"1-{MAX_EVALS} evals, got {d} and {g}")
    if not 1 <= n <= MAX_FILL_NODES:
        raise NotImplementedError(
            f"auction: {n} nodes; a scan thread of the kernel scores at most "
            f"64 nodes of a row, 1 to {MAX_FILL_NODES} in all (ROADMAP A11d: "
            f"the node ceilings)")
    checks = [("used0", used0, torch.float32, (n, d)),
              ("available", available, torch.float32, (n, d)),
              ("feas", feas, torch.bool, (g, n)),
              ("aff", aff, torch.float32, (g, n)),
              ("ask", ask, torch.float32, (g, d)),
              ("k", k, torch.int32, (g,)),
              ("seeds", seeds, torch.int64, (g,))]
    if evict is not None:
        checks += [("evict", evict, torch.float32, (n, d)),
                   ("net_prio", net_prio, torch.float32, (n,))]
    if scans is not None:
        checks.append(("scans", scans, torch.int32, (n_t,)))
    for name, t, dtype, shape in checks:
        _check_cuda("auction", name, t, dtype, shape, dev)
    for name, t in (("used0", used0), ("available", available),
                    ("evict", evict)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"auction: {name} must be 16-byte aligned (the "
                             f"kernel reads its rows as float4)")
    words = _ext.scratch_words("nt_auction_scratch_words", n_t, g)
    lists = torch.empty(words, dtype=torch.int32, device=dev)
    used = torch.empty((n_t, n, d), dtype=torch.float32, device=dev)
    take = torch.empty((n_t, g, n), dtype=torch.int32, device=dev)
    rounds_run = torch.empty(n_t, dtype=torch.int32, device=dev)
    price = torch.empty((n_t, n), dtype=torch.float32, device=dev)
    _ext.launch(
        "auction", dev, _ext.entry("nt_auction"),
        used0.data_ptr(), available.data_ptr(), feas.data_ptr(),
        aff.data_ptr(), ask.data_ptr(), k.data_ptr(), seeds.data_ptr(),
        _params_tensor(price_eps, his, dev).data_ptr(),
        None if evict is None else evict.data_ptr(),
        None if net_prio is None else net_prio.data_ptr(),
        used.data_ptr(), take.data_ptr(), rounds_run.data_ptr(),
        price.data_ptr(), lists.data_ptr(),
        None if scans is None else scans.data_ptr(),
        _barrier_words(dev).data_ptr(), n_t, g, n, int(rounds))
    del lists  # held until the launch is queued
    return used, take, rounds_run


def batch_pick(available, used_t, take_t, rounds_t, used_g, counts_g):
    """The pick of B6: the CUDA kernel (csrc/batch_solve.cu
    ``nt_batch_pick``: one cooperative launch over (arm, chunk) items of
    256-1,024 nodes, N_pad up to ``MAX_PICK_NODES``) for a CUDA
    tensor, :func:`batch_pick_ref` for a CPU tensor. Returns (used (N, D),
    counts (G, N) int16, info (6,))."""
    if not available.is_cuda:
        if available.device.type != "cpu":
            raise ValueError(f"batch_pick: unsupported device "
                             f"{available.device}")
        return batch_pick_ref(available, used_t, take_t, rounds_t, used_g,
                              counts_g)
    n_t, g, n = take_t.shape
    d = available.shape[1]
    dev = available.device
    if n > MAX_PICK_NODES:
        raise NotImplementedError(
            f"batch_pick: {n} nodes; the kernel pads to at most "
            f"{MAX_PICK_NODES} (ROADMAP A11d: the node ceilings)")
    if not 1 <= n_t < MAX_PICK_ARMS:
        raise ValueError(f"batch_pick: the kernel takes 1-{MAX_PICK_ARMS - 1} "
                         f"restarts, got {n_t}")
    for name, t, dtype, shape in (
            ("available", available, torch.float32, (n, d)),
            ("used_t", used_t, torch.float32, (n_t, n, d)),
            ("take_t", take_t, torch.int32, (n_t, g, n)),
            ("rounds_t", rounds_t, torch.int32, (n_t,)),
            ("used_g", used_g, torch.float32, (n, d)),
            ("counts_g", counts_g, torch.int16, (g, n))):
        _check_cuda("batch_pick", name, t, dtype, shape, dev)
    scratch = _pick_scratch(dev)
    used = torch.empty((n, d), dtype=torch.float32, device=dev)
    counts = torch.empty((g, n), dtype=torch.int16, device=dev)
    info = torch.empty(6, dtype=torch.float32, device=dev)
    _ext.launch(
        "batch_pick", dev, _ext.entry("nt_batch_pick"),
        available.data_ptr(), used_t.data_ptr(), take_t.data_ptr(),
        rounds_t.data_ptr(), used_g.data_ptr(), counts_g.data_ptr(),
        used.data_ptr(), counts.data_ptr(), info.data_ptr(),
        scratch.data_ptr(), _barrier_words(dev).data_ptr(), n_t, g, n,
        scratch.shape[0])
    return used, counts, info


def solve_batch(used, available, feas, aff, ask, k, tg_count, seeds, cidx,
                cdelta, evict=None, net_prio=None, *, g: int,
                rounds: int = MAX_ROUNDS):
    """G evals' placements as one assignment problem -> (the chosen
    carry, (G, N) int16 counts, (6,) float32 info row).

    Arguments as :func:`kernels.solve_bulk_multi`'s: used (N, 4) f32
    carry, which takes the correction fold IN PLACE; available (N, 4);
    feas (G, N) bool; aff (G, N) f32; ask (G, 4) f32; k (G,) int32;
    tg_count (G,) f32, kept for signature parity; seeds (G,) int64
    holding uint32 values; cidx (C,) int32 and cdelta (C, 4) f32
    corrections. ``evict`` (N, 4) victim budgets and ``net_prio`` (N,)
    open the auction arm to preempting bids; the greedy arm stays
    victim-blind. Each step runs its kernel on a CUDA tensor and its
    plain version on a CPU tensor."""
    if feas.shape[0] != g or ask.shape[0] != g:
        raise ValueError(f"solve_batch: g={g} but feas/ask carry "
                         f"{feas.shape[0]}/{ask.shape[0]} rows")
    scatter_add(used, cidx, cdelta)
    # each arm updates its own copy of the folded carry and clamps it at
    # 0; the greedy arm is B1 with no correction slots (the fold is done)
    used_g = used.clone()
    counts_g = bulk_fill(used_g, available, feas, aff, ask, k, seeds)
    used_t, take_t, rounds_t = auction(
        used, available, feas, aff, ask, k, seeds, his=_jitter_his(),
        price_eps=_price_eps(), rounds=rounds, evict=evict,
        net_prio=net_prio)
    return batch_pick(available, used_t, take_t, rounds_t, used_g, counts_g)
