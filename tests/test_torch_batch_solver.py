"""The port's joint solve (nomad_tpu_torch/tensor/batch_solver.py) against
the JAX reference on the CPU: the fixtures of tests/test_batch_solver.py
and tests/test_preempt_solve.py through both packages.

Counts, carry, placed totals, rounds and the pick must be exactly equal;
the two packing scores of the info row to a relative 1e-6 (torch's and
XLA's f32 powf differ by an ulp on a few inputs, which moves a sum of
placed x fitness by far less). The CUDA kernels run only on the card,
where chip_smoke.py holds each against these same plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import batch_solver as ref
from nomad_tpu.tensor.kernels import NEG as REF_NEG
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import batch_solver as bs
from nomad_tpu_torch.tensor import prng
from nomad_tpu_torch.tensor.kernels import NEG, TIE_JITTER

SCORE_RTOL = 1e-6


def _random_problem(seed, n=40, g=6):
    """tests/test_batch_solver.py::_random_problem, verbatim."""
    rng = np.random.default_rng(seed)
    d = 4
    avail = np.zeros((n, d), np.float32)
    avail[:, 0] = rng.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng.choice([8192, 16384, 32768], n)
    avail[:, 2] = 100_000
    avail[:, 3] = 1000
    used0 = np.zeros((n, d), np.float32)
    used0[:, 0] = rng.integers(0, 2000, n)
    used0[:, 1] = rng.integers(0, 4000, n)
    feas = rng.random((g, n)) > 0.25
    aff = np.where(rng.random((g, n)) > 0.7, 0.3, 0.0).astype(np.float32)
    ask = np.zeros((g, d), np.float32)
    ask[:, 0] = rng.integers(50, 400, g)
    ask[:, 1] = rng.integers(32, 512, g)
    k = rng.integers(10, 150, g).astype(np.int32)
    seeds = rng.integers(0, 2**31, g).astype(np.uint32)
    return avail, used0, feas, aff, ask, k, seeds


def _batch_problem(seed):
    """tests/test_preempt_solve.py::_batch_problem: n=32, g=4, k < 100."""
    rng = np.random.default_rng(seed)
    n, g, d = 32, 4, 4
    avail = np.zeros((n, d), np.float32)
    avail[:, 0] = rng.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng.choice([8192, 16384, 32768], n)
    avail[:, 2] = 100_000
    avail[:, 3] = 1000
    used0 = np.zeros((n, d), np.float32)
    used0[:, 0] = rng.integers(0, 2000, n)
    used0[:, 1] = rng.integers(0, 4000, n)
    feas = rng.random((g, n)) > 0.25
    aff = np.where(rng.random((g, n)) > 0.7, 0.3, 0.0).astype(np.float32)
    ask = np.zeros((g, d), np.float32)
    ask[:, 0] = rng.integers(50, 400, g)
    ask[:, 1] = rng.integers(32, 512, g)
    k = rng.integers(10, 100, g).astype(np.int32)
    seeds = rng.integers(0, 2**31, g).astype(np.uint32)
    return avail, used0, feas, aff, ask, k, seeds


def _both(avail, used0, feas, aff, ask, k, seeds, cidx=None, cdelta=None,
          evict=None, net_prio=None):
    """solve_batch through JAX and through the port's plain version."""
    g, d = ask.shape
    if cidx is None:
        cidx = np.zeros(1, np.int32)
        cdelta = np.zeros((1, d), np.float32)
    tgc = k.astype(np.float32)
    kw = {}
    if evict is not None:
        kw = dict(evict=jnp.asarray(evict), net_prio=jnp.asarray(net_prio))
    want = ref.solve_batch(
        jnp.asarray(used0), *(jnp.asarray(x) for x in (
            avail, feas, aff, ask, k, tgc, seeds, cidx, cdelta)), g=g, **kw)
    t = torch.from_numpy
    got = bs.solve_batch(
        t(used0.copy()), t(avail), t(feas), t(aff), t(ask), t(k), t(tgc),
        t(seeds.astype(np.int64)), t(cidx), t(cdelta),
        None if evict is None else t(evict),
        None if net_prio is None else t(net_prio), g=g)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _assert_equal_to_reference(want, got):
    used_w, counts_w, info_w = want
    used_g, counts_g, info_g = got
    assert counts_g.dtype == np.int16 and info_g.dtype == np.float32
    np.testing.assert_array_equal(counts_g, counts_w)
    np.testing.assert_array_equal(used_g, used_w)
    np.testing.assert_array_equal(info_g[2:], info_w[2:])
    np.testing.assert_allclose(info_g[:2], info_w[:2], rtol=SCORE_RTOL,
                               atol=0)


@pytest.mark.parametrize("seed", range(6))
def test_solve_batch_equals_reference(seed):
    want, got = _both(*_random_problem(seed))
    _assert_equal_to_reference(want, got)
    assert got[1].sum() > 0


@pytest.mark.parametrize("overshoot", [False, True])
def test_solve_batch_folds_and_clamps_corrections(overshoot):
    """The reference's correction case (test_batch_solver.py:161-183) and
    a negative correction larger than the node's usage: both arms start
    from max(used0 + fold, 0)."""
    avail, used0, feas, aff, ask, k, seeds = _random_problem(11)
    d = ask.shape[1]
    cidx = np.array([0, 3], np.int32)
    cdelta = np.zeros((2, d), np.float32)
    cdelta[:, 0] = [500.0, -200.0]
    if overshoot:
        cdelta[1, :2] = -(used0[3, :2] + 1000.0)
    want, got = _both(avail, used0, feas, aff, ask, k, seeds, cidx, cdelta)
    _assert_equal_to_reference(want, got)
    start = used0.copy()
    start[0, 0] += 500.0
    start[3] = np.maximum(start[3] + cdelta[1], 0.0)
    recon = start + (got[1][:, :, None].astype(np.float32)
                     * ask[:, None, :]).sum(axis=0)
    np.testing.assert_allclose(got[0], recon, atol=1e-2)


def test_solve_batch_evict_budget_equals_reference():
    """test_preempt_solve.py's saturated cluster: only the auction arm,
    bidding over the victim budgets, places anything."""
    rng = np.random.default_rng(5)
    n, g, d = 16, 3, 4
    avail = np.full((n, d), 8000, np.float32)
    avail[:, 2:] = 100_000
    used0 = avail.copy()
    feas = np.ones((g, n), bool)
    aff = np.zeros((g, n), np.float32)
    ask = np.zeros((g, d), np.float32)
    ask[:, 0] = 500
    ask[:, 1] = 500
    k = np.full(g, 8, np.int32)
    seeds = rng.integers(0, 2**31, g).astype(np.uint32)
    evict = np.zeros((n, d), np.float32)
    evict[:, 0] = 4000
    evict[:, 1] = 4000
    net_prio = np.full(n, 25.0, np.float32)
    want, got = _both(avail, used0, feas, aff, ask, k, seeds, evict=evict,
                      net_prio=net_prio)
    _assert_equal_to_reference(want, got)
    assert int(got[1].sum()) == 3 * 8 and got[2][5] == 1.0
    assert (got[0] <= avail + evict).all()


@pytest.mark.parametrize("seed", range(4))
def test_solve_batch_zero_evict_equals_victim_blind(seed):
    """Zero budgets and a huge net priority (preemption score exactly 0)
    give the victim-blind graph's counts, in both packages."""
    avail, used0, feas, aff, ask, k, seeds = _batch_problem(seed)
    n, d = avail.shape
    want_blind, got_blind = _both(avail, used0, feas, aff, ask, k, seeds)
    want, got = _both(avail, used0, feas, aff, ask, k, seeds,
                      evict=np.zeros((n, d), np.float32),
                      net_prio=np.full(n, 1.0e7, np.float32))
    _assert_equal_to_reference(want_blind, got_blind)
    _assert_equal_to_reference(want, got)
    np.testing.assert_array_equal(got[1], got_blind[1])
    np.testing.assert_array_equal(got[2][2:4], got_blind[2][2:4])


def test_solve_batch_zero_ask_row_equals_reference():
    """An all-zero ask makes every won cap inf and its fill prefix
    inf - inf = NaN; the reference's conversion turns that into 0, so
    the auction never places the row. The other rows are unaffected."""
    avail, used0, feas, aff, ask, k, seeds = _random_problem(2)
    ask[1] = 0.0
    want, got = _both(avail, used0, feas, aff, ask, k, seeds)
    _assert_equal_to_reference(want, got)


def _jits(seeds, n, t, jscale):
    return np.array(jax.vmap(lambda s: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(s), t), (n,), jnp.float32, 0.0,
        ref.TIE_JITTER * jscale))(seeds))


@pytest.mark.parametrize("t", range(len(bs.PORTFOLIO)))
@pytest.mark.parametrize("evict_arm", [False, True])
def test_auction_ref_equals_reference_auction(t, evict_arm):
    """B5 alone, one restart: used, take and the round count exactly as
    the reference's _auction, with and without the evict arm."""
    avail, used0, feas, aff, ask, k, seeds = _random_problem(t + 20)
    n = avail.shape[0]
    g = ask.shape[0]
    jscale, ptemp = bs.PORTFOLIO[t]
    jits = _jits(seeds, n, t, jscale)
    evict = net_prio = pscore_w = None
    if evict_arm:
        rng = np.random.default_rng(t)
        used0[:, :2] = avail[:, :2] * rng.uniform(0.7, 1.0, (n, 1))
        used0 = np.floor(used0)
        evict = np.zeros_like(avail)
        evict[:, :2] = np.floor(avail[:, :2] * rng.uniform(0, 0.3, (n, 1)))
        net_prio = np.full(n, 900.0, np.float32)
        pscore_w = 1.0 / (1.0 + jnp.exp(0.0048 * (jnp.asarray(net_prio)
                                                  - 2048.0)))
    used_w, take_w, rnd_w = ref._auction(
        jnp.asarray(used0), jnp.asarray(avail), jnp.asarray(feas),
        jnp.asarray(aff), jnp.asarray(ask), jnp.asarray(k),
        jnp.asarray(jits), g, ref.MAX_ROUNDS,
        price_eps=ref.PRICE_EPS * ptemp,
        evict=None if evict is None else jnp.asarray(evict), pscore=pscore_w)
    tt = torch.from_numpy
    used_g, take_g, rnd_g = bs.auction_ref(
        tt(used0), tt(avail), tt(feas), tt(aff), tt(ask), tt(k), tt(jits),
        price_eps=bs.PRICE_EPS * ptemp,
        evict=None if evict is None else tt(evict),
        pscore=None if net_prio is None else bs.preempt_score_ref(
            tt(net_prio)))
    assert rnd_g == int(rnd_w) >= 1
    np.testing.assert_array_equal(take_g.numpy(), np.asarray(take_w))
    np.testing.assert_array_equal(used_g.numpy(), np.asarray(used_w))
    if evict_arm:
        np.testing.assert_allclose(
            bs.preempt_score_ref(tt(net_prio)).numpy(),
            np.asarray(pscore_w), rtol=SCORE_RTOL)


def test_topr_ref_is_jax_top_k_order():
    """Ties, NEG entries and both zeros: XLA's top_k sorts by value in the
    float total order (-0.0 below +0.0) and breaks ties by lower index."""
    neg = np.float32(NEG)
    assert NEG == REF_NEG
    rows = np.array([
        [-0.0, 0.0, 1.0, 1.0, neg, neg, 0.0, -0.0],
        [neg] * 8,
        [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
        [-1.0, neg, -0.0, 2.0, -1.0, 0.0, 2.0, neg],
        [3e-5, -3e-5, 0.0, -0.0, neg, 3e-5, 1e30, -1e30],
    ], np.float32)
    rng = np.random.default_rng(0)
    rows = np.concatenate([rows, rng.choice(
        np.array([-0.0, 0.0, 0.25, -0.25, neg], np.float32), (12, 8))])
    for r in (1, 3, 8):
        vals_w, idx_w = jax.lax.top_k(jnp.asarray(rows), r)
        vals_g, idx_g = bs.topr_ref(torch.from_numpy(rows), r)
        np.testing.assert_array_equal(idx_g.numpy(), np.asarray(idx_w))
        assert np.array_equal(vals_g.numpy().view(np.uint32),
                              np.asarray(vals_w).view(np.uint32))
    _, idx = bs.topr_ref(torch.from_numpy(rows[:1]), 8)
    assert idx.tolist() == [[2, 3, 1, 6, 0, 7, 4, 5]]


def test_packing_scores_equal_reference():
    rng = np.random.default_rng(2)
    avail = rng.uniform(1000, 32000, (24, 4))
    used = avail * rng.uniform(0, 1, (24, 4))
    counts = rng.integers(0, 5, (6, 24))
    assert bs.packing_score_np(counts, avail, used) == pytest.approx(
        ref.packing_score_np(counts, avail, used), rel=1e-12)
    a32, u32 = avail.astype(np.float32), used.astype(np.float32)
    want = float(ref._packing_score_xp(
        jnp, jnp.asarray(counts.astype(np.int32)), jnp.asarray(a32),
        jnp.asarray(u32)))
    got = float(bs.packing_score_ref(torch.from_numpy(counts.astype(
        np.int32)), torch.from_numpy(a32), torch.from_numpy(u32)))
    assert got == pytest.approx(want, rel=SCORE_RTOL)


def test_portfolio_and_constants_equal_reference():
    assert bs.PORTFOLIO == ref.PORTFOLIO
    assert bs.RESTARTS == ref.RESTARTS
    assert (bs.MAX_ROUNDS, bs.TOP_R, bs.PRICE_EPS) == (
        ref.MAX_ROUNDS, ref.TOP_R, ref.PRICE_EPS)
    # the draw's bound is TIE_JITTER * jscale in Python floats, cast to
    # float32 at the call; the scales are powers of two, so it equals the
    # float32 product
    for jscale, _ in bs.PORTFOLIO:
        assert np.float32(TIE_JITTER * jscale) == (
            np.float32(TIE_JITTER) * np.float32(jscale))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    avail, used0, feas, aff, ask, k, seeds = _random_problem(0, n=16, g=3)
    t = torch.from_numpy
    before = _ext.COUNTS.snapshot()
    his = (TIE_JITTER, 8 * TIE_JITTER)
    eps = (bs.PRICE_EPS, bs.PRICE_EPS / 4)
    s64 = t(seeds.astype(np.int64))
    used_t, take_t, rnd_t = bs.auction(
        t(used0), t(avail), t(feas), t(aff), t(ask), t(k), s64, his=his,
        price_eps=eps)
    assert used_t.shape == (2, 16, 4) and take_t.dtype == torch.int32
    assert rnd_t.dtype == torch.int32 and rnd_t.shape == (2,)
    # the seeds' fold_in draws, then the plain auction of each restart
    want = bs.auction_restarts_ref(
        t(used0), t(avail), t(feas), t(aff), t(ask), t(k),
        prng.jitter_fold_ref(s64, 16, his), price_eps=eps)
    for x, y in zip((used_t, take_t, rnd_t), want):
        assert torch.equal(x, y)
    counts_g = torch.zeros((3, 16), dtype=torch.int16)
    used, counts, info = bs.batch_pick(t(avail), used_t, take_t, rnd_t,
                                       t(used0), counts_g)
    # an empty greedy arm loses to any auction that placed something
    assert info[5] == 1.0 and info[3] == 0.0 and info[2] > 0
    assert counts.dtype == torch.int16 and int(counts.sum()) == info[2]
    assert _ext.COUNTS.snapshot() == before   # plain runs on the CPU


def test_wrappers_reject_unsupported_devices():
    meta = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        bs.auction(meta, meta, meta, meta, meta, meta, meta, his=(1.0,),
                   price_eps=(1.0,))
    with pytest.raises(ValueError):
        bs.batch_pick(meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError):
        bs.auction(torch.zeros((8, 4)), None, None, None, None, None, None,
                   his=(1.0,), price_eps=(1.0,), evict=torch.zeros((8, 4)))
    with pytest.raises(ValueError):
        bs.auction(torch.zeros((8, 4)), None, None, None, None, None, None,
                   his=(1.0, 2.0), price_eps=(1.0,))
