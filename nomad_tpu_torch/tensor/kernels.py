"""The bulk placement program of the C2M path, in torch (reference
``nomad_tpu/tensor/kernels.py:27-90`` and ``:666-763``).

``solve_bulk_multi`` chains G fresh-placement evals over one usage carry
in one call: it folds the queued usage corrections into the carry (B4,
``tensor/scatter.py``), draws the per-(eval, node) tie-break jitter (B3,
``tensor/prng.py``), and runs the greedy BestFit fill (B1, with the fit
formula B2 inside). On a CUDA tensor each step is a hand-written kernel
(``csrc/``); on a CPU tensor each step is its plain torch version.

torch has no buffer donation: the carry passed in is updated in place
and returned, and the caller keeps using that one tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _ext
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


def fit_scores(available: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """Normalized BestFit-v3 fit score per node in [0, 1] (B2):
    clip(20 - (10^freeCpu + 10^freeMem), 0, 18)/18 (reference funcs.go:236
    ScoreFitBinPack). The WorstFit arm belongs to the per-eval slice."""
    free = _free_fractions(available, used)
    total = torch.pow(10.0, free[..., 0]) + torch.pow(10.0, free[..., 1])
    return (torch.clamp(20.0 - total, 0.0, BINPACK_MAX_FIT_SCORE)
            / BINPACK_MAX_FIT_SCORE)


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
