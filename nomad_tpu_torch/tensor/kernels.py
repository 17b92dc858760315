"""The placement programs, in torch (reference
``nomad_tpu/tensor/kernels.py``).

Bulk (the C2M path, ``:27-90`` and ``:666-763``): ``solve_bulk_multi``
chains G fresh-placement evals over one usage carry in one call: it
folds the queued usage corrections into the carry (B4's adds), draws
the per-(eval, node) tie-break jitter (B3's draw) and runs the greedy
BestFit fill (B1, with the fit formula B2 inside), all three in one
launch of ``csrc/bulk_fill.cu``, which finds each eval's cap-weighted
prefix without sorting (csrc/select.cuh). torch has no buffer
donation: the carry passed in is updated in place and returned.

Per eval (the general path, ``:91-473`` and ``:630-663``):
``solve_task_group_fused`` places K requests of one task group in one
launch (B9): a K-step scan in tie-permuted node space whose every step
scores all nodes (B8, ``score_nodes``), takes the first maximal one and
carries usage, placement counts, spread and distinct_property value
counts and the lowest explicit spread boost. The kernels score from
cached node terms and per-value spread tables (csrc/score.cuh states
the identity). ``score_nodes_packed`` is B8 alone (B10). Both take the
packed f32 layout of ``pack_solve_tensors``; ``score_nodes_once``
packs the reference's arguments for B10, and ``solve_task_group`` (the
reference's positional entry) for B9.

Bulk fallbacks (``:494-629``): ``solve_bulk`` (B11) places K identical
requests of one task group as per-node counts, up to 256 a step, each
step rescoring every node with B8 and filling in score order;
``solve_bulk_fused`` is the same scan on device-resident capacity, mask
and affinity with one (N, D+2) matrix per eval and the tie-break
permutation drawn on the device (B11', ``prng.permutation``). The kernel
selects each step's fill without sorting (csrc/select.cuh). Counts are
int32: this is the route for groups above the service's int16 ``MAX_K``.

Preemption (``:766-910``): ``preempt_solve`` (B7) picks the node of each
of K requests after eviction and its victims, a priority-ascending
prefix of the node's victim columns, in one launch; ``preempt_pick``
(B12) is the same node choice without victims.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/``); on a CPU tensor it runs its plain torch version (``*_ref``),
and on nothing else.

The kernels take any count of resource columns (D), spreads (S) and
distinct_property constraints (P), as the reference does: up to 8 of
each a narrow instance (a node's columns and the spread tree in
registers), above a wide one (loops over the columns, the tree by a
carry stack), chosen by the library from the shape. The one shape a
wrapper refuses is one whose tables exceed a CTA's shared memory: it
raises ValueError, naming the bytes, before anything is launched.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _ext
from ..device import resolve
from .prng import (MAX_FILL_NODES, _span, jitter_ref, permutation,
                   permutation_ref)
from .scatter import scatter_add_ref

NEG = -1.0e30  # "infeasible" score sentinel
# additive tie-break jitter of the bulk sort key: far below any meaningful
# score gap, far above the f32 ulp at the top of the score range
TIE_JITTER = 3.0e-5
BINPACK_MAX_FIT_SCORE = 18.0  # reference scheduler/rank.go:18
# B1's node ceiling: one CTA holds the fill's keys and caps, in shared
# memory up to 32,768 nodes and in a global scratch above
MAX_BULK_FILL_NODES = MAX_FILL_NODES


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


def fill_score_cap(used, available, feas_g, aff_g, ask_g, budget):
    """One eval's fill score (NEG where the ask does not fit) and
    capacity per node, ``min(k, floor(free / ask))`` over the asked
    dims, 0 where the score is NEG, as float32 (reference
    ``_solve_bulk_multi_impl``, kernels.py:724-745, and the sharded
    body, sharding.py:223-242)."""
    ask_pos = ask_g > 0
    new_used = used + ask_g[None, :]
    ok = feas_g & torch.all(new_used <= available, dim=1)
    fitness = fit_scores(available, new_used)
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
    return score, torch.minimum(cap, budget.to(torch.float32))


def _fill_ref(used, available, feas, aff, ask, k, jit) -> torch.Tensor:
    """The fill of B1 after the fold and the jitter draw: clamps the
    carry at 0, then fills G evals in order, updating ``used`` in place.
    Returns (G, N) int16 counts."""
    g, n = feas.shape
    used.clamp_min_(0.0)
    counts = torch.zeros((g, n), dtype=torch.int16, device=used.device)
    for gi in range(g):
        ask_g = ask[gi]
        budget = k[gi].to(torch.int64)
        score, cap = fill_score_cap(used, available, feas[gi], aff[gi],
                                    ask_g, budget)
        cap = cap.to(torch.int64)
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


def bulk_fill_ref(used, available, feas, aff, ask, k, seeds, cidx=None,
                  cdelta=None) -> torch.Tensor:
    """Plain version of the fill kernel (B1): the correction slots
    ``cidx`` / ``cdelta`` (where given) added into the carry (B4's
    ``scatter_add_ref``), the jitter of ``seeds`` drawn (B3's
    ``jitter_ref``), then the fill, updating ``used`` in place. Returns
    (G, N) int16 counts."""
    _ext.COUNTS.plain("bulk_fill", used)
    if cidx is not None:
        scatter_add_ref(used, cidx, cdelta)
    jit = jitter_ref(seeds, used.shape[0], TIE_JITTER)
    return _fill_ref(used, available, feas, aff, ask, k, jit)


def _check_cuda(what: str, name: str, t: torch.Tensor, dtype, shape,
                device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` ``shape`` tensor on
    ``device``: what the kernel ``what`` takes."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def bulk_fill(used, available, feas, aff, ask, k, seeds, cidx=None,
              cdelta=None) -> torch.Tensor:
    """B1 in one launch: the CUDA kernel (csrc/bulk_fill.cu: the fold of
    the correction slots ``cidx`` / ``cdelta`` where given, the jitter of
    ``seeds`` drawn in the kernel, the fill) for a CUDA tensor,
    :func:`bulk_fill_ref` for a CPU tensor. ``k`` values must not exceed
    32767 (the int16 counts); ``seeds`` (G,) int64."""
    if not used.is_cuda:
        if used.device.type == "cpu":
            return bulk_fill_ref(used, available, feas, aff, ask, k, seeds,
                                 cidx, cdelta)
        raise ValueError(f"bulk_fill: unsupported device {used.device}")
    n = used.shape[0]
    g = feas.shape[0]
    if not 1 <= n <= MAX_BULK_FILL_NODES:
        raise NotImplementedError(
            f"bulk_fill: {n} padded nodes; the one-CTA fill holds 1 to "
            f"{MAX_BULK_FILL_NODES} (ROADMAP A11d: the node ceilings)")
    dev = used.device
    c = 0 if cidx is None else cidx.shape[0]
    checks = [("used", used, torch.float32, (n, 4)),
              ("available", available, torch.float32, (n, 4)),
              ("feas", feas, torch.bool, (g, n)),
              ("aff", aff, torch.float32, (g, n)),
              ("ask", ask, torch.float32, (g, 4)),
              ("k", k, torch.int32, (g,)),
              ("seeds", seeds, torch.int64, (g,))]
    if cidx is not None:
        checks += [("cidx", cidx, torch.int32, (c,)),
                   ("cdelta", cdelta, torch.float32, (c, 4))]
    for name, t, dtype, shape in checks:
        _check_cuda("bulk_fill", name, t, dtype, shape, dev)
    for name, t in (("used", used), ("available", available), ("ask", ask)):
        if t.data_ptr() % 16:
            raise ValueError(f"bulk_fill: {name} must be 16-byte aligned "
                             f"(the kernel reads its rows as float4)")
    words = _ext.scratch_words("nt_bulk_fill_scratch_words", n)
    scratch = (torch.empty(words, dtype=torch.int32, device=dev)
               if words else None)
    counts = torch.empty((g, n), dtype=torch.int16, device=dev)
    _ext.launch(
        "bulk_fill", dev, _ext.entry("nt_bulk_fill"),
        used.data_ptr(), available.data_ptr(), feas.data_ptr(),
        aff.data_ptr(), ask.data_ptr(), k.data_ptr(), seeds.data_ptr(),
        None if cidx is None else cidx.data_ptr(),
        None if cdelta is None else cdelta.data_ptr(), counts.data_ptr(),
        None if scratch is None else scratch.data_ptr(), g, n, c, words,
        _span(TIE_JITTER))
    del scratch  # held until the launch is queued
    return counts


def solve_bulk_multi_ref(used, available, feas, aff, ask, k, tg_count, seeds,
                         cidx, cdelta, *, g: int):
    """Plain torch version of :func:`solve_bulk_multi`, step by step the
    reference's ``_solve_bulk_multi_impl``. Updates ``used`` in place."""
    return used, bulk_fill_ref(used, available, feas[:g], aff[:g], ask[:g],
                               k[:g], seeds, cidx, cdelta)


def solve_bulk_multi(used, available, feas, aff, ask, k, tg_count, seeds,
                     cidx, cdelta, *, g: int):
    """Chained bulk solves for G fresh-placement evals in one call ->
    (the updated carry, (G, N) int16 per-node counts).

    used (N, 4) f32 carry, updated IN PLACE (no donation in torch);
    available (N, 4) f32; feas (G, N) bool; aff (G, N) f32; ask (G, 4)
    f32; k (G,) int32, each at most 32767; tg_count (G,) f32, kept for
    signature parity; seeds (G,) int64 holding uint32 values; cidx (C,)
    int32 correction rows (0 = no-op slot); cdelta (C, 4) f32. On the
    card one launch of B1 folds, draws the jitter and fills."""
    if feas.shape[0] != g or ask.shape[0] != g:
        raise ValueError(f"solve_bulk_multi: g={g} but feas/ask carry "
                         f"{feas.shape[0]}/{ask.shape[0]} rows")
    return used, bulk_fill(used, available, feas, aff, ask, k, seeds, cidx,
                           cdelta)


# ---------------------------------------------------------------------------
# the per-eval program: B8 score_nodes, B9 solve_task_group, B10
# ---------------------------------------------------------------------------

_INT32_MAX = 2147483647

# a CTA's shared memory on the H100, and what the per-eval scans (B9,
# B10, B16) leave of it beside their static arrays
SMEM_BYTES = 232448
SCAN_SMEM_BYTES = SMEM_BYTES - 1024
# the kernels' narrow instance takes up to 8 columns, 8 spreads and 8
# distinct_property constraints (csrc/score.cuh kMaxDims, kMaxSpreads,
# kMaxProps); a wider shape takes the wide instance
NARROW = 8


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


def is_wide(d: int, s: int = 0, p: int = 0) -> bool:
    """Whether a shape takes the kernels' wide instance (score.cuh
    ``dims_wide``; B7 and B12 by D alone)."""
    return max(d, s, p) > NARROW


def table_bytes(s: int, v: int, p: int, vd: int) -> int:
    """The count tables a CTA of B9, B10, B11 and B16 holds (score.cuh
    ``table_bytes``): counts and desired values (S x V), the count of each
    distinct_property value (P x Vd), five floats a spread and the P
    limits."""
    return 4 * (s * v + p * vd) + 4 * (s * v + 5 * s + p)


def scan_smem_bytes(d: int, s: int, v: int, p: int, vd: int) -> int:
    """B9's least shared memory (csrc/task_group.cu ``scan_smem`` with
    the caches in the scratch): the count tables, then the wide
    instance's winner ids (S + P u16)."""
    if is_wide(d, s, p):
        return _r16(table_bytes(s, v, p, vd)) + _r16(2 * (s + p))
    return table_bytes(s, v, p, vd)


def check_smem(what: str, need: int, limit: int = SCAN_SMEM_BYTES) -> None:
    """Raise ValueError where a launch's shared memory would exceed a
    CTA's: the one shape the kernels refuse."""
    if need > limit:
        raise ValueError(
            f"{what}: the shape needs {need:,} bytes of shared memory in "
            f"one CTA (its count tables), above the {limit:,} the kernel "
            f"has")


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
    """The packed f32 layout of :func:`pack_solve_tensors` -> the keyword
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
    """The reference's host-side packer (kernels.py:402-445), same
    arguments, numpy in and numpy out: :func:`pack_solve_tensors` on the
    CPU, with no dev_affinity taken as zeros and no distinct_property as
    none."""
    n = np.asarray(available).shape[0]
    if dev_affinity is None:
        dev_affinity = np.zeros(n)
    if dp_val_id is None or not len(dp_val_id):
        dp_val_id = dp_val_ok = np.zeros((0, n))
        dp_counts0, dp_limit = np.zeros((0, 1)), np.zeros(0)
    return tuple(t.numpy() for t in pack_solve_tensors(
        available, used0, placed_tg0, placed_job0, ask, feasible,
        affinity_boost, dev_affinity, penalty_idx, active, spread_val_id,
        spread_val_ok, spread_counts0, spread_desired, spread_has_targets,
        spread_weight, dp_val_id, dp_val_ok, dp_counts0, dp_limit,
        lowest_boost0, tg_count, dh_job, dh_tg, spread_alg,
        node_col=tie_perm))


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
    check_smem("score_nodes_packed", table_bytes(s, v, p, vd))
    out = torch.empty(n, dtype=torch.float32, device=node_mat.device)
    fn = _ext.entry("nt_score_nodes")
    _ext.launch(
        "score_nodes", node_mat.device, fn,
        *(t.data_ptr() for t in packed), out.data_ptr(),
        int(penalty_idx), n, d, s, v, p, vd)
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
    packed layout of :func:`pack_solve_tensors` -> (3, K) f32 rows of
    [choice (mapped back through tie_perm), found, score] (reference
    kernels.py:448-473; the tie_perm column a permutation, as the
    reference's is). The CUDA kernel ``nt_solve_task_group``
    (csrc/task_group.cu) for CUDA tensors,
    :func:`solve_task_group_fused_ref` for CPU tensors."""
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
    check_smem("solve_task_group_fused", scan_smem_bytes(d, s, v, p, vd))
    # the permuted columns and carry, the cached terms where they do not
    # fit in shared memory
    words = _ext.scratch_words("nt_solve_task_group_scratch_words",
                               n, d, s, v, p, vd)
    scratch = torch.empty(words, dtype=torch.float32, device=dev)
    out = torch.empty((3, k), dtype=torch.float32, device=dev)
    fn = _ext.entry("nt_solve_task_group")
    _ext.launch(
        "solve_task_group", dev, fn,
        node_mat.data_ptr(), step_mat.data_ptr(),
        spread_node.data_ptr(), spread_tab.data_ptr(),
        spread_meta.data_ptr(), dp_node.data_ptr(),
        dp_tab.data_ptr(), scalars.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), n, d, k, s, v, p, vd, words)
    return out


def pack_solve_tensors(available, used0, placed_tg0, placed_job0, ask,
                       feasible, affinity_boost, dev_affinity, penalty_idx,
                       active, spread_val_id, spread_val_ok, spread_counts0,
                       spread_desired, spread_has_targets, spread_weight,
                       dp_val_id, dp_val_ok, dp_counts0, dp_limit,
                       lowest_boost0, tg_count, dh_job, dh_tg, spread_alg,
                       node_col=None):
    """The one packer of the kernels' f32 layout. Takes the reference's
    first 25 positional arguments of ``solve_task_group``, as arrays or
    tensors, and returns eight contiguous f32 tensors. They lie on the
    device of a tensor ``available``, else on the CPU:

    node_mat (N, 2D+6): avail[D] | used[D] | placed_tg | placed_job |
                        feasible | affinity | dev_affinity | node_col
    step_mat (K, 2): penalty_idx | active
    spread_node (2S, N): val_id rows, then val_ok rows
    spread_tab (2S, V): counts rows, then desired rows
    spread_meta (S, 2): has_targets | weight
    dp_node (2P, N): val_id rows, then val_ok rows
    dp_tab (P, Vd+1): counts columns | limit column
    scalars (5+D,): lowest_boost | tg_count | dh_job | dh_tg | spread_alg
                    | ask[D]

    ``node_col`` is ``tie_perm`` for B9 (default the identity), each
    row's tie-break position for B16."""
    dev = (available.device if isinstance(available, torch.Tensor)
           else torch.device("cpu"))

    def f(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    n = available.shape[0]
    if node_col is None:
        node_col = torch.arange(n, device=dev)
    node_mat = torch.cat([f(available), f(used0)] + [
        f(c)[:, None] for c in (placed_tg0, placed_job0, feasible,
                                affinity_boost, dev_affinity, node_col)],
        dim=1)
    dp_node = torch.cat([f(dp_val_id), f(dp_val_ok)])
    dp_tab = (torch.cat([f(dp_counts0), f(dp_limit)[:, None]], dim=1)
              if len(dp_limit) else torch.zeros((0, 2), device=dev))
    scalars = torch.cat([torch.stack([f(x).reshape(()) for x in (
        lowest_boost0, tg_count, dh_job, dh_tg, spread_alg)]), f(ask)])
    return [t.contiguous() for t in (
        node_mat, torch.stack([f(penalty_idx), f(active)], dim=1),
        torch.cat([f(spread_val_id), f(spread_val_ok)]),
        torch.cat([f(spread_counts0), f(spread_desired)]),
        torch.stack([f(spread_has_targets), f(spread_weight)], dim=1),
        dp_node, dp_tab, scalars)]


def solve_task_group(*args, device=None):
    """B9 with the reference's positional signature (kernels.py:267-378):
    the 25 or 26 arguments of ``solve_task_group`` (tie_perm last, may be
    None), as arrays or tensors -> (choices (K,) int32, founds (K,) bool,
    scores (K,) f32). Packed on ``device`` by :func:`pack_solve_tensors`
    and run by :func:`solve_task_group_fused`: the kernel on the card,
    the plain version on the CPU. ``device`` defaults to that of a tensor
    ``available``, else the card."""
    if len(args) not in (25, 26):
        raise TypeError(f"solve_task_group: 25 or 26 arguments, got "
                        f"{len(args)}")
    if device is None and isinstance(args[0], torch.Tensor):
        device = args[0].device
    dev = resolve(device)
    t = [None if a is None else torch.as_tensor(a).to(dev) for a in args]
    out = solve_task_group_fused(*pack_solve_tensors(
        *t[:25], node_col=t[25] if len(t) > 25 else None))
    return out[0].to(torch.int32), out[1] > 0.5, out[2]


# ---------------------------------------------------------------------------
# the bulk fallbacks: B11 solve_bulk / solve_bulk_fused, B11' tie_perm
# ---------------------------------------------------------------------------

def _fill_takes(score, cap, budget: int) -> torch.Tensor:
    """One bulk-scan step's takes, as the reference computes them
    (kernels.py:562-574): the stable order by score descending (-0.0 with
    +0.0, as XLA's sort comparator puts them), then each position takes
    ``clip(budget - cap before it, 0, cap)``. (N,) int32."""
    key = -score
    key = torch.where(key == 0.0, 0.0, key)
    order = torch.argsort(key, stable=True)
    cap_sorted = cap[order]
    cum = torch.cumsum(cap_sorted, 0)
    take_sorted = torch.minimum(
        torch.clamp_min(budget - (cum - cap_sorted), 0), cap_sorted)
    take = torch.zeros(score.shape[0], dtype=torch.int32, device=score.device)
    take[order] = take_sorted.to(torch.int32)
    return take


def _bulk_scan_ref(available, used0, ask, feasible, placed_tg0, placed_job0,
                   affinity_boost, dev_affinity, spread_val_id, spread_val_ok,
                   spread_counts0, spread_desired, spread_has_targets,
                   spread_weight, k_total, tg_count, dh_job, dh_tg, spread_alg,
                   tie_perm, *, batch: int, n_steps: int) -> torch.Tensor:
    """B11 in plain torch, step for step the reference's ``_bulk_scan``
    (kernels.py:494-594): every per-node array gathered into tie-permuted
    space (``_permute_node_axis``), then up to ``n_steps`` steps that
    score every node (:func:`score_nodes_ref`), cap each node's fill,
    order the nodes by score descending (stable: ties by permuted
    position) and fill the step's budget in that order, carrying usage,
    placement counts and spread value counts; the counts map back through
    ``tie_perm`` at the end. Stops early once a step places nothing (the
    carry then stays put, so no later step could) or ``k_total`` is
    placed. Scalars are Python values. Returns (N,) int32."""
    n = available.shape[0]
    s = spread_val_id.shape[0]
    dev = available.device
    f = available.dtype
    perm = tie_perm.to(torch.int64)
    available, used, ptg, pjob = (available[perm], used0[perm],
                                  placed_tg0[perm], placed_job0[perm])
    feasible, affinity_boost, dev_affinity = (
        feasible[perm], affinity_boost[perm], dev_affinity[perm])
    svid = spread_val_id[:, perm].to(torch.int64)
    sok = spread_val_ok[:, perm]
    c = available.new_tensor
    flags = {name: torch.tensor(bool(v), device=dev) for name, v in (
        ("dh_job", dh_job), ("dh_tg", dh_tg), ("spread_alg", spread_alg))}
    single = bool(dh_job or dh_tg or spread_alg)
    ask_pos = ask > 0
    ask_safe = torch.where(ask_pos, ask, 1.0)
    empty = dict(dp_val_id=torch.zeros((0, n), dtype=torch.int64, device=dev),
                 dp_val_ok=torch.zeros((0, n), dtype=torch.bool, device=dev),
                 dp_counts=torch.zeros((0, 1), dtype=torch.int32, device=dev),
                 dp_limit=torch.zeros(0, dtype=f, device=dev))
    rows = torch.arange(s, device=dev)[:, None].expand(s, n)
    scnt = spread_counts0.clone()
    taken = torch.zeros(n, dtype=torch.int32, device=dev)
    remaining = int(k_total)
    for _ in range(n_steps):
        if remaining <= 0:
            break
        score, _, _ = score_nodes_ref(
            available=available, used=used, ask=ask, feasible=feasible,
            placed_tg=ptg, placed_job=pjob, affinity_boost=affinity_boost,
            dev_affinity=dev_affinity,
            penalty_idx=torch.tensor(-1, device=dev), spread_val_id=svid,
            spread_val_ok=sok, spread_counts=scnt,
            spread_desired=spread_desired,
            spread_has_targets=spread_has_targets,
            spread_weight=spread_weight, lowest_boost=c(-1.0),
            tg_count=c(float(tg_count)), **flags, **empty)
        budget = min(remaining, batch)
        # a zero ask in every dimension is an infinite per-node capacity,
        # clamped to the budget before the int cast
        per_dim = torch.where(ask_pos[None, :],
                              torch.floor((available - used)
                                          / ask_safe[None, :]), math.inf)
        cap = torch.clamp_min(per_dim.amin(dim=1), 0.0)
        cap = torch.where(score > NEG, cap, 0.0)
        if single:
            cap = torch.clamp_max(cap, 1.0)
        cap = torch.clamp_max(cap, float(budget)).to(torch.int32)
        take = _fill_takes(score, cap, budget)
        used = used + ask[None, :] * take[:, None].to(f)
        ptg = ptg + take
        pjob = pjob + take
        if s:
            scnt = scnt.index_put((rows, svid),
                                  torch.where(sok, take[None, :], 0),
                                  accumulate=True)
        placed = int(take.sum())
        taken += take
        remaining -= placed
        if placed == 0:
            break
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[perm] = taken
    return out


def solve_bulk_ref(*args, batch: int, n_steps: int) -> torch.Tensor:
    """Plain version of :func:`solve_bulk`."""
    _ext.COUNTS.plain("bulk_scan", args[0])
    return _bulk_scan_ref(*args, batch=batch, n_steps=n_steps)


def solve_bulk_fused_ref(available, feasible, aff, dyn, ask, k_total,
                         tg_count, seed, *, batch: int,
                         n_steps: int) -> torch.Tensor:
    """Plain version of :func:`solve_bulk_fused`: the permutation from
    :func:`prng.permutation_ref`, ``dyn`` unpacked, no spread tables,
    distinct_hosts or WorstFit (reference kernels.py:597-629)."""
    _ext.COUNTS.plain("bulk_scan", available)
    n, d = available.shape
    dev = available.device
    f = available.dtype
    tie_perm = permutation_ref(seed, n, dev)
    return _bulk_scan_ref(
        available, dyn[:, :d].to(f), ask.to(f), feasible,
        dyn[:, d].to(torch.int32), dyn[:, d + 1].to(torch.int32),
        aff.to(f), torch.zeros(n, dtype=f, device=dev),
        torch.zeros((0, n), dtype=torch.int32, device=dev),
        torch.zeros((0, n), dtype=torch.bool, device=dev),
        torch.zeros((0, 1), dtype=torch.int32, device=dev),
        torch.zeros((0, 1), dtype=f, device=dev),
        torch.zeros(0, dtype=torch.bool, device=dev),
        torch.zeros(0, dtype=f, device=dev),
        k_total, tg_count, False, False, False, tie_perm,
        batch=batch, n_steps=n_steps)


def bulk_scan_smem_bytes(n: int, s: int, v: int) -> int:
    """B11's least shared memory (csrc/bulk_scan.cu ``nt_bulk_scan`` with
    the cached terms in the scratch): the count tables, then the
    reductions' words (11 a warp) and, up to 16,384 positions, each
    slot's key and 16-bit cap, above it threshold_radix's histogram."""
    threads = 1024 if n >= 1024 else (n + 31) // 32 * 32
    nw = threads // 32
    if n > 16384:
        work = 4 * (11 * nw + 2 * 256 + 4)
    else:
        slots = n if n <= 1024 else -(-n // 1024) * 1024
        work = 4 * 11 * nw + 4 * slots + 4 * ((slots + 1) // 2)
    return table_bytes(s, v, 0, 1) + work


def _bulk_dims(what: str, available, s: int = 0, v: int = 1) -> tuple:
    """(n, d) of a bulk scan's node matrix; a node count above what the
    one-CTA kernels take, or spread tables above a CTA's shared memory,
    raise here. The kernel's entry refuses a batch above its 16-bit cap
    field."""
    n, d = available.shape
    if n > MAX_FILL_NODES:
        raise NotImplementedError(
            f"{what}: {n} padded nodes; the one-CTA scan holds at most "
            f"{MAX_FILL_NODES} (ROADMAP A11d: the node ceilings)")
    check_smem(what, bulk_scan_smem_bytes(n, s, v), SMEM_BYTES)
    return n, d


def _launch_bulk_scan(available, dyn, feasible, aff, dev_affinity, tie_perm,
                      spread_node, spread_tab, spread_meta, scalars, k_total,
                      *, s: int, v: int, batch: int, n_steps: int):
    n, d = available.shape
    dev = available.device
    words = _ext.scratch_words("nt_bulk_scan_scratch_words", n, d, s, v)
    scratch = torch.empty(words, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    fn = _ext.entry("nt_bulk_scan")
    _ext.launch(
        "bulk_scan", dev, fn,
        available.data_ptr(), dyn.data_ptr(), feasible.data_ptr(),
        aff.data_ptr(),
        None if dev_affinity is None else dev_affinity.data_ptr(),
        tie_perm.data_ptr(), spread_node.data_ptr(),
        spread_tab.data_ptr(), spread_meta.data_ptr(),
        scalars.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        n, d, s, v, int(k_total), batch, n_steps, words)
    return out


def _scalars(ask, tg_count, dh_job, dh_tg, spread_alg) -> torch.Tensor:
    """The scan's (5 + D,) f32 scalars in pack_solve_tensors' layout:
    lowest_boost (-1) | tg_count | dh_job | dh_tg | spread_alg | ask."""
    head = torch.tensor([-1.0, float(tg_count), float(bool(dh_job)),
                         float(bool(dh_tg)), float(bool(spread_alg))],
                        dtype=torch.float32)
    return torch.cat([head.to(ask.device), ask])


def solve_bulk(available, used0, ask, feasible, placed_tg0, placed_job0,
               affinity_boost, dev_affinity, spread_val_id, spread_val_ok,
               spread_counts0, spread_desired, spread_has_targets,
               spread_weight, k_total, tg_count, dh_job, dh_tg, spread_alg,
               tie_perm, *, batch: int, n_steps: int) -> torch.Tensor:
    """B11, the generic bulk scan (reference ``solve_bulk`` =
    ``_bulk_scan``, kernels.py:494-594, same arguments): ``k_total``
    identical placements of one task group as (N,) int32 per-node counts
    in canonical order, at most ``batch`` a step over at most ``n_steps``
    steps, ties broken by the permutation ``tie_perm``.

    available, used0 (N, D) f32; ask (D,) f32; feasible (N,) bool;
    placed_tg0, placed_job0 (N,) int32; affinity_boost, dev_affinity (N,)
    f32; spread_val_id (S, N) int32; spread_val_ok (S, N) bool;
    spread_counts0 (S, V) int32; spread_desired (S, V) f32 (NaN = no
    target); spread_has_targets (S,) bool; spread_weight (S,) f32;
    tie_perm (N,) int32; k_total, tg_count, dh_job, dh_tg, spread_alg
    Python values. The CUDA kernel ``nt_bulk_scan`` (csrc/bulk_scan.cu,
    N <= 65,536) for CUDA tensors, :func:`solve_bulk_ref` for CPU
    tensors."""
    args = (available, used0, ask, feasible, placed_tg0, placed_job0,
            affinity_boost, dev_affinity, spread_val_id, spread_val_ok,
            spread_counts0, spread_desired, spread_has_targets,
            spread_weight, k_total, tg_count, dh_job, dh_tg, spread_alg,
            tie_perm)
    if available.device.type == "cpu":
        return solve_bulk_ref(*args, batch=batch, n_steps=n_steps)
    if not available.is_cuda:
        raise ValueError(f"solve_bulk: unsupported device "
                         f"{available.device}")
    s, v = spread_counts0.shape
    n, d = _bulk_dims("solve_bulk", available, s, v)
    dev = available.device
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    for name, t, dtype, shape in (
            ("available", available, f32, (n, d)),
            ("used0", used0, f32, (n, d)), ("ask", ask, f32, (d,)),
            ("feasible", feasible, b8, (n,)),
            ("placed_tg0", placed_tg0, i32, (n,)),
            ("placed_job0", placed_job0, i32, (n,)),
            ("affinity_boost", affinity_boost, f32, (n,)),
            ("dev_affinity", dev_affinity, f32, (n,)),
            ("spread_val_id", spread_val_id, i32, (s, n)),
            ("spread_val_ok", spread_val_ok, b8, (s, n)),
            ("spread_counts0", spread_counts0, i32, (s, v)),
            ("spread_desired", spread_desired, f32, (s, v)),
            ("spread_has_targets", spread_has_targets, b8, (s,)),
            ("spread_weight", spread_weight, f32, (s,)),
            ("tie_perm", tie_perm, i32, (n,))):
        _check_cuda("solve_bulk", name, t, dtype, shape, dev)
    # pack_solve_tensors' f32 layout; the counts are exact in f32 below 2^24
    dyn = torch.cat([used0, placed_tg0.to(f32)[:, None],
                     placed_job0.to(f32)[:, None]], dim=1)
    spread_node = torch.cat([spread_val_id.to(f32), spread_val_ok.to(f32)])
    spread_tab = torch.cat([spread_counts0.to(f32), spread_desired])
    spread_meta = torch.stack([spread_has_targets.to(f32), spread_weight],
                              dim=1)
    return _launch_bulk_scan(
        available, dyn, feasible, affinity_boost, dev_affinity, tie_perm,
        spread_node, spread_tab, spread_meta,
        _scalars(ask, tg_count, dh_job, dh_tg, spread_alg), k_total, s=s,
        v=v, batch=batch, n_steps=n_steps)


def solve_bulk_fused(available, feasible, aff, dyn, ask, k_total, tg_count,
                     seed, *, batch: int, n_steps: int) -> torch.Tensor:
    """B11 with B11': the transfer-minimal bulk scan (reference
    ``solve_bulk_fused``, kernels.py:597-629). ``available`` (N, D) f32,
    ``feasible`` (N,) bool and ``aff`` (N,) f32 stay resident on the
    device across evals; each eval brings ``dyn`` (N, D+2) f32 = used |
    placed_tg | placed_job, ``ask`` (D,) f32, and the Python values
    ``k_total``, ``tg_count`` and ``seed`` (uint32), from which the
    tie-break permutation is drawn on the device (:func:`prng.permutation`).
    No spread tables, distinct_hosts or WorstFit (the placer's bulk
    shape). Returns (N,) int32 per-node counts in canonical order: the
    kernels ``nt_tie_perm`` and ``nt_bulk_scan`` (csrc/bulk_scan.cu, N <=
    65,536) for CUDA tensors, :func:`solve_bulk_fused_ref` for CPU
    tensors."""
    if available.device.type == "cpu":
        return solve_bulk_fused_ref(available, feasible, aff, dyn, ask,
                                    k_total, tg_count, seed, batch=batch,
                                    n_steps=n_steps)
    if not available.is_cuda:
        raise ValueError(f"solve_bulk_fused: unsupported device "
                         f"{available.device}")
    n, d = _bulk_dims("solve_bulk_fused", available)
    dev = available.device
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("available", available, f32, (n, d)),
            ("feasible", feasible, torch.bool, (n,)),
            ("aff", aff, f32, (n,)), ("dyn", dyn, f32, (n, d + 2)),
            ("ask", ask, f32, (d,))):
        _check_cuda("solve_bulk_fused", name, t, dtype, shape, dev)
    tie_perm = permutation(seed, n, dev)
    none = torch.empty(0, dtype=f32, device=dev)
    return _launch_bulk_scan(
        available, dyn, feasible, aff, None, tie_perm, none, none, none,
        _scalars(ask, tg_count, False, False, False), k_total, s=0, v=1,
        batch=batch, n_steps=n_steps)


# ---------------------------------------------------------------------------
# preemption: B7 preempt_solve, B12 preempt_pick
# ---------------------------------------------------------------------------

def preempt_score_ref(net_prio: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(0.0048 * (net_prio - 2048)))`` in float32, each
    constant a tensor on ``net_prio``'s device (so no operation is
    rewritten around a Python scalar): the logistic preemption score
    (reference rank.go:894, kernels.py:793)."""
    c = net_prio.new_tensor
    one = c(1.0)
    return one / (one + torch.exp(c(0.0048) * (net_prio - c(2048.0))))


def _preempt_scores(available, used, ask, feasible, ev, pscore):
    """One step's node scores of B7 and B12: the fit at
    ``min(used + ask, available)``, plus the preemption score where the
    node must evict, averaged; NEG where the deficit exceeds what the
    node can evict. Returns (score, deficit, needs_evict)."""
    new_used = used + ask[None, :]
    deficit = torch.clamp_min(new_used - available, 0.0)
    can = feasible & torch.all(deficit <= ev, dim=1)
    needs = torch.any(deficit > 0.0, dim=1)
    fitness = fit_scores(available, torch.minimum(new_used, available))
    divisor = 1.0 + needs.to(available.dtype)
    score = (fitness + torch.where(needs, pscore, 0.0)) / divisor
    return torch.where(can, score, NEG), deficit, needs


def preempt_solve_ref(available, used0, ask, feasible, net_prio, active,
                      v_prio, v_vec, v_elig, v_flag):
    """B7 in plain torch, step for step the reference's ``preempt_solve``
    (kernels.py:823-910); ``used0`` is left alone and no step syncs with
    the host. ``v_prio`` is not read: the columns come sorted. Returns
    (picks (K,) int32, victims (K, V) bool, flagged (K,) bool, scores
    (K,) f32)."""
    _ext.COUNTS.plain("preempt_solve", available)
    f = available.dtype
    pscore = preempt_score_ref(net_prio)
    ev = torch.sum(v_vec * v_elig[:, :, None].to(f), dim=1)
    taken = torch.zeros_like(v_elig)
    used = used0.clone()
    neg = available.new_tensor(NEG)
    picks, victims, flagged, scores = [], [], [], []
    for i in range(active.shape[0]):
        score, deficit, needs = _preempt_scores(available, used, ask,
                                                feasible, ev, pscore)
        best = torch.argmax(score)
        found = (score[best] > NEG) & active[i]
        # the unclaimed eligible prefix of the best node's column that
        # covers its deficit (cumsum-before is the prefix sum: the
        # columns are priority-sorted)
        row = v_elig[best] & ~taken[best]
        vecs = v_vec[best] * row[:, None].to(f)
        cum_before = torch.cumsum(vecs, dim=0) - vecs
        def_b = deficit[best]
        sel = (row & needs[best]
               & torch.any((def_b[None, :] > 0.0)
                           & (cum_before < def_b[None, :]), dim=1))
        sel = sel & found
        evicted = torch.sum(v_vec[best] * sel[:, None].to(f), dim=0)
        used[best] = torch.where(
            found, torch.clamp_min(used[best] + ask - evicted, 0.0),
            used[best])
        ev[best] = torch.where(found, torch.clamp_min(ev[best] - evicted, 0.0),
                               ev[best])
        taken[best] = taken[best] | sel
        picks.append(torch.where(found, best, -1))
        victims.append(sel)
        flagged.append(torch.any(sel & v_flag[best]))
        scores.append(torch.where(found, score[best], neg))
    return (torch.stack(picks).to(torch.int32), torch.stack(victims),
            torch.stack(flagged), torch.stack(scores))


def preempt_pick_ref(available, used0, evictable0, ask, feasible, net_prio,
                     active) -> torch.Tensor:
    """B12 in plain torch, step for step the reference's ``preempt_pick``
    (kernels.py:766-820): the node choice of B7 with the carry (used,
    evictable) and no victims. Returns (K,) int32 picks, -1 where no node
    can take the request."""
    _ext.COUNTS.plain("preempt_pick", available)
    pscore = preempt_score_ref(net_prio)
    used = used0.clone()
    ev = evictable0.clone()
    picks = []
    for i in range(active.shape[0]):
        score, deficit, _ = _preempt_scores(available, used, ask, feasible,
                                            ev, pscore)
        best = torch.argmax(score)
        found = (score[best] > NEG) & active[i]
        used[best] = torch.where(
            found, torch.minimum(used[best] + ask, available[best]),
            used[best])
        ev[best] = torch.where(
            found, torch.clamp_min(ev[best] - deficit[best], 0.0), ev[best])
        picks.append(torch.where(found, best, -1))
    return torch.stack(picks).to(torch.int32)


def preempt_smem_bytes(n: int, d: int, victims: bool) -> int:
    """B7's (``victims``) or B12's least shared memory (csrc/preempt.cu,
    the keys in the scratch): the segment minima of 32 nodes each, and
    B7's wide instance's rows of the chosen node (12 bytes a column; the
    narrow instance, up to 8 columns, keeps them in registers)."""
    rows = 12 * d if victims and is_wide(d) else 0
    return 8 * -(-n // 32) + rows


def _preempt_dims(what: str, available, victims: bool) -> tuple:
    n, d = available.shape
    if d < 2:
        raise ValueError(f"{what}: {d} resource columns; the fit score "
                         f"reads the cpu and memory columns")
    check_smem(what, preempt_smem_bytes(n, d, victims), SMEM_BYTES)
    return n, d


def preempt_solve(available, used0, ask, feasible, net_prio, active, v_prio,
                  v_vec, v_elig, v_flag):
    """B7: K preemption placements in one launch -> (picks (K,) int32,
    victims (K, V) bool, flagged (K,) bool, scores (K,) f32), as the
    reference's ``preempt_solve``. Inputs: available, used0 (N, D) f32;
    ask (D,) f32; feasible (N,) bool; net_prio (N,) f32; active (K,)
    bool; v_prio (N, V) f32 or None, kept for the reference's signature
    and never read (the columns come sorted), so a caller need not copy
    it to the card; v_vec (N, V, D) f32, integral values below 2^24;
    v_elig, v_flag (N, V) bool. The CUDA kernel
    ``nt_preempt_solve`` (csrc/preempt.cu) for CUDA tensors,
    :func:`preempt_solve_ref` for CPU tensors."""
    if available.device.type == "cpu":
        return preempt_solve_ref(available, used0, ask, feasible, net_prio,
                                 active, v_prio, v_vec, v_elig, v_flag)
    if not available.is_cuda:
        raise ValueError(f"preempt_solve: unsupported device "
                         f"{available.device}")
    n, d = _preempt_dims("preempt_solve", available, True)
    v = v_elig.shape[1]
    k = active.shape[0]
    dev = available.device
    f32, b8 = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("available", available, f32, (n, d)),
            ("used0", used0, f32, (n, d)), ("ask", ask, f32, (d,)),
            ("feasible", feasible, b8, (n,)),
            ("net_prio", net_prio, f32, (n,)), ("active", active, b8, (k,)),
            ("v_vec", v_vec, f32, (n, v, d)),
            ("v_elig", v_elig, b8, (n, v)), ("v_flag", v_flag, b8, (n, v))):
        _check_cuda("preempt_solve", name, t, dtype, shape, dev)
    # the carry (used, evictable, a claimed-prefix pointer a node) and,
    # where they do not fit in shared memory, the cached keys; the kernel
    # zeroes the victims (a fresh allocation: 16-byte aligned) itself
    words = _ext.scratch_words("nt_preempt_solve_scratch_words", n, d)
    scratch = torch.empty(words, dtype=f32, device=dev)
    picks = torch.empty(k, dtype=torch.int32, device=dev)
    victims = torch.empty((k, v), dtype=b8, device=dev)
    flagged = torch.empty(k, dtype=b8, device=dev)
    scores = torch.empty(k, dtype=f32, device=dev)
    fn = _ext.entry("nt_preempt_solve")
    _ext.launch(
        "preempt_solve", dev, fn,
        available.data_ptr(), used0.data_ptr(), ask.data_ptr(),
        feasible.data_ptr(), net_prio.data_ptr(), active.data_ptr(),
        v_vec.data_ptr(), v_elig.data_ptr(), v_flag.data_ptr(),
        scratch.data_ptr(), picks.data_ptr(), victims.data_ptr(),
        flagged.data_ptr(), scores.data_ptr(), n, v, k, d, words)
    del scratch  # held until the launch is queued
    return picks, victims, flagged, scores


def preempt_pick(available, used0, evictable0, ask, feasible, net_prio,
                 active) -> torch.Tensor:
    """B12: the node choice of K preemption placements -> (K,) int32
    picks, as the reference's ``preempt_pick``. Inputs as
    :func:`preempt_solve`'s, with evictable0 (N, D) f32 in place of the
    victim columns. The CUDA kernel ``nt_preempt_pick``
    (csrc/preempt.cu: B7's cached keys and one-warp step loop, without
    victims) for CUDA tensors, :func:`preempt_pick_ref` for CPU tensors.
    No placement path calls it, as in the reference."""
    if available.device.type == "cpu":
        return preempt_pick_ref(available, used0, evictable0, ask, feasible,
                                net_prio, active)
    if not available.is_cuda:
        raise ValueError(f"preempt_pick: unsupported device "
                         f"{available.device}")
    n, d = _preempt_dims("preempt_pick", available, False)
    k = active.shape[0]
    dev = available.device
    f32, b8 = torch.float32, torch.bool
    for name, t, dtype, shape in (
            ("available", available, f32, (n, d)),
            ("used0", used0, f32, (n, d)),
            ("evictable0", evictable0, f32, (n, d)), ("ask", ask, f32, (d,)),
            ("feasible", feasible, b8, (n,)),
            ("net_prio", net_prio, f32, (n,)), ("active", active, b8, (k,))):
        _check_cuda("preempt_pick", name, t, dtype, shape, dev)
    # the carry (used, evictable) and, where they do not fit in shared
    # memory, the cached keys
    words = _ext.scratch_words("nt_preempt_pick_scratch_words", n, d)
    scratch = torch.empty(words, dtype=f32, device=dev)
    picks = torch.empty(k, dtype=torch.int32, device=dev)
    fn = _ext.entry("nt_preempt_pick")
    _ext.launch(
        "preempt_pick", dev, fn,
        available.data_ptr(), used0.data_ptr(),
        evictable0.data_ptr(), ask.data_ptr(), feasible.data_ptr(),
        net_prio.data_ptr(), active.data_ptr(), scratch.data_ptr(),
        picks.data_ptr(), n, k, d, words)
    del scratch  # held until the launch is queued
    return picks
