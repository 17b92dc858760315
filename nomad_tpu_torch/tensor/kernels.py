"""The placement programs, in torch (reference
``nomad_tpu/tensor/kernels.py``).

Bulk (the C2M path, ``:27-90`` and ``:666-763``): ``solve_bulk_multi``
chains G fresh-placement evals over one usage carry in one call: it
folds the queued usage corrections into the carry (B4,
``tensor/scatter.py``), draws the per-(eval, node) tie-break jitter
(B3, ``tensor/prng.py``), and runs the greedy BestFit fill (B1, with
the fit formula B2 inside). torch has no buffer donation: the carry
passed in is updated in place and returned.

Per eval (the general path, ``:91-473`` and ``:630-663``):
``solve_task_group_fused`` places K requests of one task group in one
launch (B9): a K-step scan in tie-permuted node space whose every step
scores all nodes (B8, ``score_nodes``), takes the first maximal one and
carries usage, placement counts, spread and distinct_property value
counts and the lowest explicit spread boost. ``score_nodes_packed`` is
B8 alone (B10). Both take the packed f32 layout of ``pack_solve_args``;
``score_nodes_once`` packs the reference's arguments for B10.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/``); on a CPU tensor it runs its plain torch version (``*_ref``),
and on nothing else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _ext
from ..device import resolve
from .prng import jitter, jitter_ref
from .scatter import scatter_add, scatter_add_ref

NEG = -1.0e30  # "infeasible" score sentinel
# additive tie-break jitter of the bulk sort key: far below any meaningful
# score gap, far above the f32 ulp at the top of the score range
TIE_JITTER = 3.0e-5
BINPACK_MAX_FIT_SCORE = 18.0  # reference scheduler/rank.go:18
# largest padded node count the one-CTA fill kernel sorts in shared memory
MAX_FILL_NODES = 16384


def _free_fractions(available: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """Free fraction per (node, dim) after ``used`` is placed (reference
    funcs.go:213 computeFreePercentage): x/0 -> -inf free, 0/0 -> 0."""
    pos = available > 0
    safe = torch.where(pos, available, 1.0)
    ratio = torch.where(pos, used / safe,
                        torch.where(used > 0, math.inf, 0.0))
    return 1.0 - ratio


def fit_scores(available: torch.Tensor, used: torch.Tensor,
               spread_alg=False) -> torch.Tensor:
    """Normalized fit score per node in [0, 1] (B2, reference funcs.go:236
    ScoreFitBinPack / :263 ScoreFitSpread):
    BestFit clip(20 - (10^freeCpu + 10^freeMem), 0, 18)/18, or with
    ``spread_alg`` (a bool tensor) WorstFit clip(total - 2, 0, 18)/18."""
    free = _free_fractions(available, used)
    total = torch.pow(10.0, free[..., 0]) + torch.pow(10.0, free[..., 1])
    binpack = torch.clamp(20.0 - total, 0.0, BINPACK_MAX_FIT_SCORE)
    # a 0-dim tensor, not a Python float: on CUDA torch divides by a
    # Python scalar as a multiply by its reciprocal, 1 ulp off the
    # correctly rounded quotient the reference and the kernels compute
    max_fit = binpack.new_full((), BINPACK_MAX_FIT_SCORE)
    if spread_alg is False:
        return binpack / max_fit
    spread = torch.clamp(total - 2.0, 0.0, BINPACK_MAX_FIT_SCORE)
    return torch.where(spread_alg, spread, binpack) / max_fit


def fit_scores_np(available, used) -> np.ndarray:
    """float64 numpy twin of :func:`fit_scores` for host-side scoring
    (the placer's trajectory mean)."""
    available = np.asarray(available, dtype=np.float64)
    used = np.asarray(used, dtype=np.float64)
    safe = np.where(available > 0, available, 1.0)
    ratio = np.where(available > 0, used / safe,
                     np.where(used > 0, np.inf, 0.0))
    free = 1.0 - ratio
    total = 10.0 ** free[..., 0] + 10.0 ** free[..., 1]
    return (np.clip(20.0 - total, 0.0, BINPACK_MAX_FIT_SCORE)
            / BINPACK_MAX_FIT_SCORE)


def bulk_fill_ref(used, available, feas, aff, ask, k, jit) -> torch.Tensor:
    """Plain version of the fill kernel (B1 after the fold and the
    jitter draw): clamps the carry at 0, then fills G evals in order,
    updating ``used`` in place. Returns (G, N) int16 counts."""
    _ext.COUNTS.plain("bulk_fill", used)
    g, n = feas.shape
    used.clamp_min_(0.0)
    counts = torch.zeros((g, n), dtype=torch.int16, device=used.device)
    for gi in range(g):
        ask_g = ask[gi]
        ask_pos = ask_g > 0
        new_used = used + ask_g[None, :]
        ok = feas[gi] & torch.all(new_used <= available, dim=1)
        fitness = fit_scores(available, new_used)
        aff_g = aff[gi]
        aff_present = aff_g != 0.0
        divisor = 1.0 + aff_present.to(torch.float32)
        score = (fitness + torch.where(aff_present, aff_g, 0.0)) / divisor
        score = torch.where(ok, score, NEG)

        free = available - used
        per_dim = torch.where(
            ask_pos[None, :],
            torch.floor(free / torch.where(ask_pos, ask_g, 1.0)[None, :]),
            math.inf)
        cap = torch.clamp_min(torch.min(per_dim, dim=1).values, 0.0)
        cap = torch.where(score > NEG, cap, 0.0)
        budget = k[gi].to(torch.int64)
        cap = torch.minimum(cap, budget.to(torch.float32)).to(torch.int64)
        key = score + jit[gi]
        order = torch.argsort(-key, stable=True)   # residual ties: index
        cap_sorted = cap[order]
        cum = torch.cumsum(cap_sorted, 0)
        take_sorted = torch.minimum(
            torch.clamp_min(budget - (cum - cap_sorted), 0), cap_sorted)
        take = torch.zeros(n, dtype=torch.int64, device=used.device)
        take[order] = take_sorted
        used += ask_g[None, :] * take[:, None].to(torch.float32)
        counts[gi] = take.to(torch.int16)
    return counts


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"bulk_fill: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def bulk_fill(used, available, feas, aff, ask, k, jit) -> torch.Tensor:
    """The fill step of B1: the CUDA kernel (csrc/bulk_fill.cu) for a
    CUDA tensor, :func:`bulk_fill_ref` for a CPU tensor. ``k`` values
    must not exceed 32767 (the int16 counts)."""
    if used.device.type == "cpu":
        return bulk_fill_ref(used, available, feas, aff, ask, k, jit)
    if not used.is_cuda:
        raise ValueError(f"bulk_fill: unsupported device {used.device}")
    n, d = used.shape
    g = feas.shape[0]
    if n & (n - 1) or not 8 <= n <= MAX_FILL_NODES:
        raise NotImplementedError(
            f"bulk_fill: {n} padded nodes; the one-CTA fill sorts a power "
            f"of two up to {MAX_FILL_NODES} in shared memory (ROADMAP "
            f"'make B1 fast': multi-CTA selection)")
    dev = used.device
    _check_cuda("used", used, torch.float32, (n, 4), dev)
    _check_cuda("available", available, torch.float32, (n, 4), dev)
    _check_cuda("feas", feas, torch.bool, (g, n), dev)
    _check_cuda("aff", aff, torch.float32, (g, n), dev)
    _check_cuda("ask", ask, torch.float32, (g, 4), dev)
    _check_cuda("k", k, torch.int32, (g,), dev)
    _check_cuda("jit", jit, torch.float32, (g, n), dev)
    counts = torch.empty((g, n), dtype=torch.int16, device=dev)
    fn = _ext.entry("nt_bulk_fill")
    _ext.check(fn(used.data_ptr(), available.data_ptr(), feas.data_ptr(),
                  aff.data_ptr(), ask.data_ptr(), k.data_ptr(),
                  jit.data_ptr(), counts.data_ptr(), g, n,
                  _ext.stream_handle(dev)), "bulk_fill launch")
    _ext.COUNTS.launched("bulk_fill")
    return counts


def solve_bulk_multi_ref(used, available, feas, aff, ask, k, tg_count, seeds,
                         cidx, cdelta, *, g: int):
    """Plain torch version of :func:`solve_bulk_multi`, step by step the
    reference's ``_solve_bulk_multi_impl``. Updates ``used`` in place."""
    scatter_add_ref(used, cidx, cdelta)
    jit = jitter_ref(seeds, used.shape[0], TIE_JITTER)
    return used, bulk_fill_ref(used, available, feas[:g], aff[:g], ask[:g],
                               k[:g], jit)


def solve_bulk_multi(used, available, feas, aff, ask, k, tg_count, seeds,
                     cidx, cdelta, *, g: int):
    """Chained bulk solves for G fresh-placement evals in one call ->
    (the updated carry, (G, N) int16 per-node counts).

    used (N, 4) f32 carry, updated IN PLACE (no donation in torch);
    available (N, 4) f32; feas (G, N) bool; aff (G, N) f32; ask (G, 4)
    f32; k (G,) int32, each at most 32767; tg_count (G,) f32, kept for
    signature parity; seeds (G,) int64 holding uint32 values; cidx (C,)
    int32 correction rows (0 = no-op slot); cdelta (C, 4) f32."""
    if feas.shape[0] != g or ask.shape[0] != g:
        raise ValueError(f"solve_bulk_multi: g={g} but feas/ask carry "
                         f"{feas.shape[0]}/{ask.shape[0]} rows")
    scatter_add(used, cidx, cdelta)
    jit = jitter(seeds, used.shape[0], TIE_JITTER)
    return used, bulk_fill(used, available, feas, aff, ask, k, jit)


# ---------------------------------------------------------------------------
# the per-eval program: B8 score_nodes, B9 solve_task_group, B10
# ---------------------------------------------------------------------------

# the one-CTA scan keeps these per-node arrays in its step loop's
# registers; wider groups raise rather than run another algorithm
MAX_DIMS = 8
MAX_SPREADS = 8
MAX_PROPS = 8
_INT32_MAX = 2147483647


def pairwise_sum_ref(v: torch.Tensor) -> torch.Tensor:
    """Fixed-tree sum over the leading axis (reference
    ``_pairwise_sum_xp``, kernels.py:91-110): zero-pad to a power of two,
    then halve with v[0::2] + v[1::2]. Its result feeds the spread
    sub-score's != 0 presence test, so the add order is part of the
    answer."""
    n = int(v.shape[0])
    p = 1
    while p < n:
        p *= 2
    if p != n:
        v = torch.cat([v, v.new_zeros((p - n,) + tuple(v.shape[1:]))])
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def score_nodes_ref(*, available, used, ask, feasible, placed_tg, placed_job,
                    affinity_boost, dev_affinity, penalty_idx, spread_val_id,
                    spread_val_ok, spread_counts, spread_desired,
                    spread_has_targets, spread_weight, dp_val_id, dp_val_ok,
                    dp_counts, dp_limit, lowest_boost, tg_count, dh_job,
                    dh_tg, spread_alg):
    """B8 in plain torch, op for op the reference's ``score_nodes``
    (kernels.py:113-249): one placement's score per node, the mean of the
    sub-scores present (fitness, anti-affinity, reschedule penalty, node
    affinity, device affinity, spread), NEG where infeasible. Returns
    (score, fitness, boost (S, N)).

    Floats are f32 tensors, ids int64, flags bool; scalars are 0-dim
    tensors, so the function runs on the card without a host sync."""
    n = available.shape[0]
    f = available.dtype
    new_used = used + ask[None, :]
    ok = feasible & torch.all(new_used <= available, dim=1)
    ok = ok & (~dh_job | (placed_job == 0))
    ok = ok & (~dh_tg | (placed_tg == 0))
    if dp_val_id.shape[0]:
        dp_at = torch.gather(dp_counts, 1, dp_val_id)
        ok = ok & torch.all(dp_val_ok & (dp_at < dp_limit[:, None]), dim=0)

    fitness = fit_scores(available, new_used, spread_alg)
    anti_present = placed_tg > 0
    anti = -(placed_tg.to(f) + 1.0) / torch.clamp_min(tg_count, 1.0)
    resched_present = (torch.arange(n, device=available.device)
                       == penalty_idx)
    aff_present = affinity_boost != 0.0
    dev_present = dev_affinity != 0.0

    counts_at = torch.gather(spread_counts, 1, spread_val_id)
    used_cnt = counts_at.to(f) + 1.0
    desired = torch.gather(spread_desired, 1, spread_val_id)
    explicit = torch.where(
        torch.isnan(desired), -1.0,
        torch.where(desired == 0.0, lowest_boost,
                    (desired - used_cnt)
                    / torch.where(desired == 0.0, 1.0, desired)
                    * spread_weight[:, None]))
    explicit = torch.where(spread_val_ok, explicit, -1.0)

    present_v = spread_counts > 0
    any_present = torch.any(present_v, dim=1)
    minc = torch.where(present_v, spread_counts, _INT32_MAX).amin(dim=1).to(f)
    maxc = torch.where(present_v, spread_counts, 0).amax(dim=1).to(f)
    cur = counts_at.to(f)
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
    even = torch.where(spread_val_ok, even, -1.0)

    boost = torch.where(spread_has_targets[:, None], explicit, even)
    spread_total = pairwise_sum_ref(boost)
    spread_present = spread_total != 0.0

    divisor = (1.0 + anti_present.to(f) + resched_present.to(f)
               + aff_present.to(f) + dev_present.to(f)
               + spread_present.to(f))
    total = (fitness + torch.where(anti_present, anti, 0.0)
             + torch.where(resched_present, -1.0, 0.0)
             + torch.where(aff_present, affinity_boost, 0.0)
             + torch.where(dev_present, dev_affinity, 0.0)
             + torch.where(spread_present, spread_total, 0.0))
    final = total / divisor
    return torch.where(ok, final, NEG), fitness, boost


def _unpack(node_mat, spread_node, spread_tab, spread_meta, dp_node, dp_tab,
            scalars) -> dict:
    """The packed f32 layout of :func:`pack_solve_args` -> the keyword
    arguments of :func:`score_nodes_ref` (less penalty_idx and the
    lowest boost), plus ``tie_perm``; as the reference's fused entry
    unpacks it (kernels.py:452-470)."""
    s = spread_meta.shape[0]
    p = dp_node.shape[0] // 2
    d = (node_mat.shape[1] - 6) // 2
    i64 = torch.int64
    return dict(
        available=node_mat[:, 0:d], used=node_mat[:, d:2 * d],
        placed_tg=node_mat[:, 2 * d].to(torch.int32),
        placed_job=node_mat[:, 2 * d + 1].to(torch.int32),
        ask=scalars[5:5 + d], feasible=node_mat[:, 2 * d + 2] > 0.5,
        affinity_boost=node_mat[:, 2 * d + 3],
        dev_affinity=node_mat[:, 2 * d + 4],
        spread_val_id=spread_node[:s].to(torch.int32).to(i64),
        spread_val_ok=spread_node[s:] > 0.5,
        spread_counts=spread_tab[:s].to(torch.int32),
        spread_desired=spread_tab[s:],
        spread_has_targets=spread_meta[:, 0] > 0.5,
        spread_weight=spread_meta[:, 1],
        dp_val_id=dp_node[:p].to(torch.int32).to(i64),
        dp_val_ok=dp_node[p:] > 0.5,
        dp_counts=dp_tab[:, :-1].to(torch.int32), dp_limit=dp_tab[:, -1],
        tg_count=scalars[1], dh_job=scalars[2] > 0.5,
        dh_tg=scalars[3] > 0.5, spread_alg=scalars[4] > 0.5,
        tie_perm=node_mat[:, 2 * d + 5].to(torch.int32).to(i64))


def solve_task_group_ref(*, available, used, placed_tg, placed_job, ask,
                         feasible, affinity_boost, dev_affinity, penalty_idx,
                         active, spread_val_id, spread_val_ok, spread_counts,
                         spread_desired, spread_has_targets, spread_weight,
                         dp_val_id, dp_val_ok, dp_counts, dp_limit,
                         lowest_boost, tg_count, dh_job, dh_tg, spread_alg,
                         tie_perm=None):
    """B9 in plain torch, step for step the reference's
    ``solve_task_group`` (kernels.py:267-378): with ``tie_perm`` every
    per-node array is gathered into permuted space first
    (``_permute_node_axis``) and choices map back at the end, so equal
    scores go to the lowest permuted position. Returns (choices, founds,
    scores), each (K,)."""
    s = spread_val_id.shape[0]
    p = dp_val_id.shape[0]
    n = available.shape[0]
    dev = available.device
    if tie_perm is not None:
        available, used, placed_tg, placed_job = (
            available[tie_perm], used[tie_perm], placed_tg[tie_perm],
            placed_job[tie_perm])
        feasible, affinity_boost, dev_affinity = (
            feasible[tie_perm], affinity_boost[tie_perm],
            dev_affinity[tie_perm])
        spread_val_id = spread_val_id[:, tie_perm]
        spread_val_ok = spread_val_ok[:, tie_perm]
        if p:
            dp_val_id = dp_val_id[:, tie_perm]
            dp_val_ok = dp_val_ok[:, tie_perm]
        inv = torch.zeros(n, dtype=torch.int64, device=dev)
        inv[tie_perm] = torch.arange(n, device=dev)
        penalty_idx = torch.where(penalty_idx >= 0,
                                  inv[penalty_idx.clamp_min(0)], -1)
    arange = torch.arange(n, device=dev)
    rows_s = torch.arange(s, device=dev)
    rows_p = torch.arange(p, device=dev)
    inf = torch.full((1,), math.inf, dtype=available.dtype, device=dev)
    ptg, pjob = placed_tg.clone(), placed_job.clone()
    scnt, dpcnt = spread_counts.clone(), dp_counts.clone()
    used = used.clone()
    lowest = lowest_boost
    choices, founds, scores = [], [], []
    for step in range(penalty_idx.shape[0]):
        score, _, boost = score_nodes_ref(
            available=available, used=used, ask=ask, feasible=feasible,
            placed_tg=ptg, placed_job=pjob, affinity_boost=affinity_boost,
            dev_affinity=dev_affinity, penalty_idx=penalty_idx[step],
            spread_val_id=spread_val_id, spread_val_ok=spread_val_ok,
            spread_counts=scnt, spread_desired=spread_desired,
            spread_has_targets=spread_has_targets,
            spread_weight=spread_weight, dp_val_id=dp_val_id,
            dp_val_ok=dp_val_ok, dp_counts=dpcnt, dp_limit=dp_limit,
            lowest_boost=lowest, tg_count=tg_count, dh_job=dh_job,
            dh_tg=dh_tg, spread_alg=spread_alg)
        choice = torch.argmax(score)
        best = score[choice]
        found = active[step] & (best > NEG)
        onehot = (arange == choice) & found
        used = used + ask[None, :] * onehot[:, None]
        ptg = ptg + onehot.to(ptg.dtype)
        pjob = pjob + onehot.to(pjob.dtype)
        sel_ok = spread_val_ok[:, choice] & found
        sel_val = spread_val_id[:, choice]
        scnt = scnt.index_put((rows_s, sel_val),
                              sel_ok.to(scnt.dtype), accumulate=True)
        if p:
            dsel_ok = dp_val_ok[:, choice] & found
            dpcnt = dpcnt.index_put((rows_p, dp_val_id[:, choice]),
                                    dsel_ok.to(dpcnt.dtype), accumulate=True)
        chosen = torch.where(spread_has_targets & sel_ok, boost[:, choice],
                             math.inf)
        lowest = torch.minimum(lowest, torch.cat([chosen, inf]).amin())
        choices.append(choice)
        founds.append(found)
        scores.append(best)
    choices = torch.stack(choices)
    if tie_perm is not None:
        choices = tie_perm[choices]
    return choices, torch.stack(founds), torch.stack(scores)


def solve_task_group_fused_ref(node_mat, step_mat, spread_node, spread_tab,
                               spread_meta, dp_node, dp_tab, scalars):
    """Plain version of :func:`solve_task_group_fused`: unpack, run
    :func:`solve_task_group_ref`, stack [choice, found, score] rows."""
    _ext.COUNTS.plain("solve_task_group", node_mat)
    args = _unpack(node_mat, spread_node, spread_tab, spread_meta, dp_node,
                   dp_tab, scalars)
    choices, founds, scores = solve_task_group_ref(
        **args, penalty_idx=step_mat[:, 0].to(torch.int32).to(torch.int64),
        active=step_mat[:, 1] > 0.5, lowest_boost=scalars[0])
    return torch.stack([choices.to(scores.dtype), founds.to(scores.dtype),
                        scores])


def pack_solve_args(available, used0, placed_tg0, placed_job0, ask, feasible,
                    affinity_boost, penalty_idx, active, spread_val_id,
                    spread_val_ok, spread_counts0, spread_desired,
                    spread_has_targets, spread_weight, lowest_boost0,
                    tg_count, dh_job, dh_tg, spread_alg,
                    dev_affinity=None, dp_val_id=None, dp_val_ok=None,
                    dp_counts0=None, dp_limit=None, tie_perm=None):
    """Host-side (numpy) packing of one task group's solve into the eight
    f32 arrays of the kernels' layout (reference kernels.py:402-445):

    node_mat (N, 2D+6): avail[D] | used[D] | placed_tg | placed_job |
                        feasible | affinity | dev_affinity | tie_perm
    step_mat (K, 2): penalty_idx | active
    spread_node (2S, N): val_id rows, then val_ok rows
    spread_tab (2S, V): counts rows, then desired rows
    spread_meta (S, 2): has_targets | weight
    dp_node (2P, N): val_id rows, then val_ok rows
    dp_tab (P, Vd+1): counts columns | limit column
    scalars (5+D,): lowest_boost | tg_count | dh_job | dh_tg | spread_alg
                    | ask[D]
    """
    f = np.float32
    n = np.asarray(available).shape[0]
    if dev_affinity is None:
        dev_affinity = np.zeros(n, f)
    if tie_perm is None:
        tie_perm = np.arange(n)
    node_mat = np.concatenate([
        np.asarray(available, f), np.asarray(used0, f),
        np.asarray(placed_tg0, f)[:, None],
        np.asarray(placed_job0, f)[:, None],
        np.asarray(feasible, f)[:, None],
        np.asarray(affinity_boost, f)[:, None],
        np.asarray(dev_affinity, f)[:, None],
        np.asarray(tie_perm, f)[:, None]], axis=1)
    step_mat = np.stack([np.asarray(penalty_idx, f),
                         np.asarray(active, f)], axis=1)
    spread_node = np.concatenate([np.asarray(spread_val_id, f),
                                  np.asarray(spread_val_ok, f)], axis=0)
    spread_tab = np.concatenate([np.asarray(spread_counts0, f),
                                 np.asarray(spread_desired, f)], axis=0)
    spread_meta = (np.stack([np.asarray(spread_has_targets, f),
                             np.asarray(spread_weight, f)], axis=1)
                   if len(spread_weight) else np.zeros((0, 2), f))
    if dp_val_id is None or not len(dp_val_id):
        dp_node = np.zeros((0, n), f)
        dp_tab = np.zeros((0, 2), f)
    else:
        dp_node = np.concatenate([np.asarray(dp_val_id, f),
                                  np.asarray(dp_val_ok, f)], axis=0)
        dp_tab = np.concatenate([np.asarray(dp_counts0, f),
                                 np.asarray(dp_limit, f)[:, None]], axis=1)
    scalars = np.concatenate([
        np.array([lowest_boost0, tg_count, dh_job, dh_tg, spread_alg], f),
        np.asarray(ask, f)])
    return (node_mat, step_mat, spread_node, spread_tab, spread_meta,
            dp_node, dp_tab, scalars)


def score_nodes_packed_ref(node_mat, spread_node, spread_tab, spread_meta,
                           dp_node, dp_tab, scalars, penalty_idx: int):
    """Plain version of :func:`score_nodes_packed`."""
    _ext.COUNTS.plain("score_nodes", node_mat)
    args = _unpack(node_mat, spread_node, spread_tab, spread_meta, dp_node,
                   dp_tab, scalars)
    args.pop("tie_perm")
    score, _, _ = score_nodes_ref(
        **args, lowest_boost=scalars[0],
        penalty_idx=torch.tensor(penalty_idx, device=node_mat.device))
    return score


def _layout(node_mat, spread_node, spread_tab, spread_meta, dp_node, dp_tab,
            scalars, what: str):
    """Checks the packed layout on the card -> (n, d, s, v, p, vd)."""
    dev = node_mat.device
    n, w = node_mat.shape
    d = (w - 6) // 2
    s, v = spread_meta.shape[0], spread_tab.shape[1]
    p, vd = dp_node.shape[0] // 2, dp_tab.shape[1] - 1
    shapes = {"node_mat": (node_mat, (n, 2 * d + 6)),
              "spread_node": (spread_node, (2 * s, n)),
              "spread_tab": (spread_tab, (2 * s, v)),
              "spread_meta": (spread_meta, (s, 2)),
              "dp_node": (dp_node, (2 * p, n)),
              "dp_tab": (dp_tab, (p, vd + 1)),
              "scalars": (scalars, (5 + d,))}
    for name, (t, shape) in shapes.items():
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous f32 "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if d > MAX_DIMS or s > MAX_SPREADS or p > MAX_PROPS:
        raise NotImplementedError(
            f"{what}: {d} resource columns, {s} spreads, {p} "
            f"distinct_property constraints; the kernel holds at most "
            f"{MAX_DIMS}, {MAX_SPREADS} and {MAX_PROPS}")
    return n, d, s, v, p, vd


def score_nodes_packed(node_mat, spread_node, spread_tab, spread_meta,
                       dp_node, dp_tab, scalars,
                       penalty_idx: int) -> torch.Tensor:
    """B10 on the packed layout: one placement's (N,) f32 score vector.
    The CUDA kernel ``nt_score_nodes`` (csrc/task_group.cu) for CUDA
    tensors, the plain version for CPU tensors."""
    if node_mat.device.type == "cpu":
        return score_nodes_packed_ref(node_mat, spread_node, spread_tab,
                                      spread_meta, dp_node, dp_tab, scalars,
                                      penalty_idx)
    if not node_mat.is_cuda:
        raise ValueError(f"score_nodes_packed: unsupported device "
                         f"{node_mat.device}")
    packed = (node_mat, spread_node, spread_tab, spread_meta, dp_node,
              dp_tab, scalars)
    n, d, s, v, p, vd = _layout(*packed, what="score_nodes_packed")
    out = torch.empty(n, dtype=torch.float32, device=node_mat.device)
    fn = _ext.entry("nt_score_nodes")
    _ext.check(fn(*(t.data_ptr() for t in packed), out.data_ptr(),
                  int(penalty_idx), n, d, s, v, p, vd,
                  _ext.stream_handle(node_mat.device)), "score_nodes launch")
    _ext.COUNTS.launched("score_nodes")
    return out


def score_nodes_once(available, used, ask, feasible, placed_tg, placed_job,
                     affinity_boost, penalty_idx, spread_val_id,
                     spread_val_ok, spread_counts, spread_desired,
                     spread_has_targets, spread_weight, lowest_boost,
                     tg_count, dh_job, dh_tg, spread_alg, dev_affinity=None,
                     dp_val_id=None, dp_val_ok=None, dp_counts=None,
                     dp_limit=None, device=None) -> torch.Tensor:
    """B10: one placement's (N,) score vector (reference kernels.py:630-663,
    same arguments, as host arrays): packed by :func:`pack_solve_args`
    and scored on ``device`` (default the card) by
    :func:`score_nodes_packed`. Scores are computed in f32."""
    node_mat, _, *rest = pack_solve_args(
        available, used, placed_tg, placed_job, ask, feasible,
        affinity_boost, [penalty_idx], [True], spread_val_id, spread_val_ok,
        spread_counts, spread_desired, spread_has_targets, spread_weight,
        lowest_boost, tg_count, dh_job, dh_tg, spread_alg,
        dev_affinity=dev_affinity, dp_val_id=dp_val_id, dp_val_ok=dp_val_ok,
        dp_counts0=dp_counts, dp_limit=dp_limit)
    dev = resolve(device)
    return score_nodes_packed(*(torch.from_numpy(a).to(dev)
                                for a in [node_mat] + rest), int(penalty_idx))


def solve_task_group_fused(node_mat, step_mat, spread_node, spread_tab,
                           spread_meta, dp_node, dp_tab, scalars):
    """B9: place K requests of one task group in one launch from the
    packed layout of :func:`pack_solve_args` -> (3, K) f32 rows of
    [choice (mapped back through tie_perm), found, score] (reference
    kernels.py:448-473). The CUDA kernel ``nt_solve_task_group``
    (csrc/task_group.cu) for CUDA tensors, :func:`solve_task_group_fused_ref`
    for CPU tensors."""
    if node_mat.device.type == "cpu":
        return solve_task_group_fused_ref(node_mat, step_mat, spread_node,
                                          spread_tab, spread_meta, dp_node,
                                          dp_tab, scalars)
    if not node_mat.is_cuda:
        raise ValueError(f"solve_task_group_fused: unsupported device "
                         f"{node_mat.device}")
    n, d, s, v, p, vd = _layout(node_mat, spread_node, spread_tab,
                                spread_meta, dp_node, dp_tab, scalars,
                                what="solve_task_group_fused")
    k = step_mat.shape[0]
    dev = node_mat.device
    if (step_mat.device != dev or step_mat.dtype != torch.float32
            or tuple(step_mat.shape) != (k, 2)
            or not step_mat.is_contiguous()):
        raise ValueError("solve_task_group_fused: step_mat must be a "
                         "contiguous f32 (K, 2) tensor on the card")
    # the permuted-space copy of the per-node columns and the carry
    scratch = torch.empty(n * (2 * d + 6 + 2 * s + 2 * p),
                          dtype=torch.float32, device=dev)
    out = torch.empty((3, k), dtype=torch.float32, device=dev)
    fn = _ext.entry("nt_solve_task_group")
    _ext.check(fn(node_mat.data_ptr(), step_mat.data_ptr(),
                  spread_node.data_ptr(), spread_tab.data_ptr(),
                  spread_meta.data_ptr(), dp_node.data_ptr(),
                  dp_tab.data_ptr(), scalars.data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), n, d, k, s, v, p, vd,
                  _ext.stream_handle(dev)), "solve_task_group launch")
    _ext.COUNTS.launched("solve_task_group")
    return out
