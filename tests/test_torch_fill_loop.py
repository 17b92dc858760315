"""B1's one-launch schedule (nomad_tpu_torch/csrc/bulk_fill.cu
``nt_bulk_fill``) on the CPU: its steps in plain torch, and its host call
on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of what one launch does, step for step: the correction
slots added into the carry (atomics: integral sums, exact in any order)
and the clamp; then per eval the score and cap of every node (the fit and
the jitter skipped where the cap is 0), the jitter drawn as the kernel
draws it (threefry.cuh's bits and float), the order key, and the takes of
csrc/select.cuh's ``threshold_radix`` (the best key's level, else a radix
search 8 bits a pass) with ``threshold_base`` / ``take_at``; then the
counts and the carry. The model must equal ``solve_bulk_multi_ref`` and
the JAX package's ``solve_bulk_multi`` exactly (counts and carry are
integral), on tests/test_torch_kernels.py's fixtures and at N_pad 32,768.
The radix search must give the full stable sort's takes at every step.

Then the wrappers on stub cards: one ``nt_bulk_fill`` a
``solve_bulk_multi`` (the fold and the jitter inside it: no B4 or B3
launch), and ``solve_batch``'s greedy arm as B1 with no slots after B4's
fold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import batch_solver as bs
from nomad_tpu_torch.tensor import kernels
from nomad_tpu_torch.tensor.kernels import TIE_JITTER, fill_score_cap
from nomad_tpu_torch.tensor.prng import (_span, jitter_ref, seed_keys,
                                         threefry2x32)
from test_torch_bulk_scan import desc_key_ref, threshold_takes_ref
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)
from test_torch_kernels import G, VARIANTS, _fixture, _port_args

RADIX_BITS = 8
NO_KEY = 0xFFFFFFFF   # a cap-0 node's key: read by nothing
THREADS = 1024        # the kernel's block


def kernel_jitter_ref(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """The jitter as bulk_fill.cu draws it: threefry.cuh's
    ``threefry_bits`` under the key (seed >> 32, seed & mask) at the
    counter (0, node), and ``bits_to_unit``: bitcast((bits >> 9) |
    0x3F800000) - 1, times the f32 width, plus 0, floored at 0."""
    keys = seed_keys(seeds)
    node = torch.arange(n, dtype=torch.int64)[None, :]
    o0, o1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(node),
                          node)
    bits = o0 ^ o1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    span = torch.tensor(_span(TIE_JITTER), dtype=torch.float32)
    return torch.clamp_min(f * span + 0.0, 0.0)


def radix_takes_ref(key: torch.Tensor, w: torch.Tensor, budget: int):
    """csrc/select.cuh ``threshold_radix`` with ``threshold_base`` and
    ``take_at``, in plain torch: the level T at which the weight of the
    keys <= T reaches ``budget`` -- the best key's level where it covers
    the budget, else fixed 8 bits a pass, most significant first, below
    the bits the best and the worst key share, each pass a histogram of
    the weights of the keys holding the prefix so far. ``key`` int64
    values in [0, 2^32), ``w`` the caps clipped to the budget. Returns
    ((N,) int64 takes, the route: "all", "first" or "radix", and the
    passes)."""
    w = w.to(torch.int64)
    live = w > 0
    total = int(w.sum())
    if total <= budget:
        return w.clone(), "all", 0
    best = int(key[live].min())
    if int(w[live & (key == best)].sum()) >= budget:
        level, above, route, passes = best, 0, "first", 0
    else:
        worst = int(key[live].max())
        shift = (best ^ worst).bit_length()
        prefix, above, passes = worst >> shift, 0, 0
        while shift > 0:
            bits = min(RADIX_BITS, shift)
            shift -= bits
            lo = prefix << (shift + bits)
            hi = lo | ((1 << (shift + bits)) - 1)
            at = live & (key >= lo) & (key <= hi)
            digit = (key >> shift) & ((1 << bits) - 1)
            hist = torch.zeros(1 << RADIX_BITS, dtype=torch.int64)
            hist.index_add_(0, digit[at], w[at])
            reach = (above + torch.cumsum(hist, 0)) >= budget
            d = int(reach.nonzero()[0])
            above += int(hist[:d].sum())
            prefix = (prefix << bits) | d
            passes += 1
        level, route = prefix, "radix"
    bucket = torch.where(key == level, w, 0)
    excl = above + torch.cumsum(bucket, 0) - bucket
    shared = torch.minimum(torch.clamp_min(budget - excl, 0), w)
    takes = torch.where(key < level, w, torch.where(key == level, shared, 0))
    return takes, route, passes


def fill_loop_model(used, avail, feas, aff, ask, k, seeds, cidx, cdelta,
                    audit=None):
    """One nt_bulk_fill launch in plain torch -> (carry, (G, N) int16
    counts). ``audit`` (a dict) collects each eval's route and passes."""
    used = used.clone()
    used.index_add_(0, cidx.to(torch.int64), cdelta)
    used.clamp_min_(0.0)
    g, n = feas.shape
    jit = kernel_jitter_ref(seeds, n)
    counts = torch.zeros((g, n), dtype=torch.int16)
    for e in range(g):
        budget = int(k[e])
        score, cap = fill_score_cap(used, avail, feas[e], aff[e], ask[e],
                                    k[e])
        cap = cap.to(torch.int64)
        key = torch.where(cap > 0, desc_key_ref(score + jit[e]), NO_KEY)
        if budget > 0:
            takes, route, passes = radix_takes_ref(key, cap, budget)
        else:
            takes, route, passes = torch.zeros_like(cap), "none", 0
        if audit is not None:
            audit.setdefault("routes", []).append(route)
            audit.setdefault("passes", []).append(passes)
        used += ask[e][None, :] * takes[:, None].to(torch.float32)
        counts[e] = takes.to(torch.int16)
    return used, counts


def _jax_solve(f, g):
    used, counts = ref_kernels.solve_bulk_multi(
        jnp.asarray(f["used"]), jnp.asarray(f["avail"]),
        jnp.asarray(f["feas"]), jnp.asarray(f["aff"]), jnp.asarray(f["ask"]),
        jnp.asarray(f["k"]), jnp.ones(g, jnp.float32),
        jnp.asarray(f["seeds"]), jnp.asarray(f["cidx"]),
        jnp.asarray(f["cdelta"]), g=g)
    return np.asarray(used), np.asarray(counts)


def _model_args(f):
    a = _port_args(f)
    return (a[0], a[1], a[2], a[3], a[4], a[6], a[7], a[8])


def test_kernel_jitter_equals_b3_bit_for_bit():
    """The jitter B1 draws in its launch is B3's draw, bit for bit,
    edge seeds included."""
    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 12345, 987654321],
                         dtype=torch.int64)
    got = kernel_jitter_ref(seeds, 3000)
    want = jitter_ref(seeds, 3000, TIE_JITTER)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed", range(8))
def test_radix_takes_equal_the_full_stable_sort(seed):
    """threshold_radix's takes equal the reference's full stable sort and
    scan (kernels._fill_takes) and select.cuh's threshold_select
    (threshold_takes_ref), on keys with ties, cap-0 positions and -0.0,
    at budgets the first level covers, the radix reaches and the total
    does not reach."""
    rng = np.random.default_rng(seed)
    n = 700
    score = rng.choice([0.25, 0.5, 0.75, -0.0, 0.0],
                       n).astype(np.float32)
    score += rng.integers(0, 4, n).astype(np.float32) * np.float32(1e-6)
    score[rng.random(n) < 0.05] = kernels.NEG
    cap = rng.integers(0, 9, n)
    cap[rng.random(n) < 0.3] = 0
    cap[int(np.argmax(score))] = 40   # the best position alone covers 40
    score_t = torch.from_numpy(score)
    key = desc_key_ref(score_t)
    routes = set()
    for budget in (1, 30, 41, 200, 900, 5000):
        w = torch.from_numpy(np.minimum(cap, budget))
        cap_t = torch.where(score_t > kernels.NEG, w, 0)
        got, route, _ = radix_takes_ref(torch.where(cap_t > 0, key, NO_KEY),
                                        cap_t, budget)
        routes.add(route)
        want = kernels._fill_takes(score_t, cap_t.to(torch.float32), budget)
        assert torch.equal(got.to(torch.int32), want.to(torch.int32)), budget
        assert torch.equal(got, threshold_takes_ref(key, cap_t, budget))
    assert routes == {"first", "radix", "all"}


@pytest.mark.parametrize("i,variant", list(enumerate(VARIANTS)))
def test_fill_loop_equals_plain_and_jax(i, variant):
    """The one-launch schedule on tests/test_torch_kernels.py's fixtures:
    counts and carry exactly equal to solve_bulk_multi_ref and to the JAX
    package's solve_bulk_multi."""
    f = _fixture(variant, seed=100 + i)
    audit = {}
    used, counts = fill_loop_model(torch.from_numpy(f["used"]),
                                   *_model_args(f), audit=audit)
    want_used, want = kernels.solve_bulk_multi_ref(
        torch.from_numpy(f["used"].copy()), *_port_args(f), g=G)
    assert torch.equal(counts, want) and torch.equal(used, want_used)
    jax_used, jax_counts = _jax_solve(f, G)
    assert np.array_equal(counts.numpy(), jax_counts)
    assert np.array_equal(used.numpy(), jax_used)
    if variant == "baseline":
        assert "radix" in audit["routes"]
    if variant == "small_k_ties":
        assert "first" in audit["routes"]


def _wide_fixture(n_pad=32768, seed=5):
    """N_pad 32,768 (5/8 real, as the C2M path pads 10,240 to 16,384),
    above B1's old one-CTA sort ceiling: duplicate correction rows driven
    past the clamp, an all-infeasible row, k 0 rows, and an eval whose
    budget the best node takes alone (k 1: the first level)."""
    rng = np.random.default_rng(seed)
    g, real, c = 8, n_pad * 5 // 8, 64
    avail = np.zeros((n_pad, 4), np.float32)
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2:] = (102400, 12001)
    used = np.zeros((n_pad, 4), np.float32)
    fill = rng.integers(0, 120, real).astype(np.float32)
    used[:real, :3] = fill[:, None] * np.array([50, 32, 300], np.float32)
    feas = np.zeros((g, n_pad), bool)
    feas[:, :real] = rng.random((g, real)) < 0.95
    feas[3] = False
    aff = np.zeros((g, n_pad), np.float32)
    aff[5, :real] = rng.choice([0.0, 0.5, -0.5, 1.0], real)
    ask = np.tile(np.array([50, 32, 300, 0], np.float32), (g, 1))
    k = np.full(g, 4000, np.int32)
    k[1] = 0
    k[6] = 1
    seeds = rng.integers(0, 2 ** 32, g).astype(np.uint32)
    cidx = np.zeros(c, np.int32)
    cdelta = np.zeros((c, 4), np.float32)
    rows = rng.integers(0, real, 40)
    cidx[:40] = rows
    cidx[40:48] = rows[0]                         # duplicate rows
    cdelta[:48, :3] = -used[cidx[:48], :3] - 1000.0  # past the clamp
    return dict(used=used, avail=avail, feas=feas, aff=aff, ask=ask, k=k,
                seeds=seeds, cidx=cidx, cdelta=cdelta), g


def test_fill_loop_at_32768_nodes():
    """Above the old ceiling: the model equals solve_bulk_multi_ref and
    the JAX package exactly; the k 1 eval is one node's (the first
    level), the others reach the radix search."""
    f, g = _wide_fixture()
    a = _port_args(f)
    audit = {}
    used, counts = fill_loop_model(
        torch.from_numpy(f["used"]), a[0], a[1], a[2], a[3], a[4], a[6],
        a[7], a[8], audit=audit)
    want_used, want = kernels.solve_bulk_multi_ref(
        torch.from_numpy(f["used"].copy()), a[0], a[1], a[2], a[3], a[4],
        torch.ones(g), a[6], a[7], a[8], g=g)
    assert torch.equal(counts, want) and torch.equal(used, want_used)
    jax_used, jax_counts = _jax_solve(f, g)
    assert np.array_equal(counts.numpy(), jax_counts)
    assert np.array_equal(used.numpy(), jax_used)
    assert audit["routes"][6] == "first" and int((counts[6] > 0).sum()) == 1
    assert "radix" in audit["routes"] and max(audit["passes"]) >= 2
    assert int(counts[3].sum()) == 0 and int(counts[1].sum()) == 0


def _slot_of(t, q, chunk):
    """bulk_fill.cu ``FillPositions::slot_of``."""
    spread = 1 if chunk >= 32 else 32 // chunk
    return q * THREADS + (t ^ ((q * spread) & 31))


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32, 64])
def test_slot_layout_is_a_bijection_and_bank_free(chunk):
    """B1's swizzled slots: every (thread, q) its own slot; a warp's
    reads of one q (select.cuh's loops) and the scoring pass's stores (32
    consecutive nodes) each fall in 32 distinct banks of 32-bit keys."""
    t = np.arange(THREADS)[:, None]
    q = np.arange(chunk)[None, :]
    slots = _slot_of(t, q, chunk)
    assert np.array_equal(np.sort(slots.ravel()),
                          np.arange(THREADS * chunk))
    for w in range(0, THREADS, 32):
        for qq in range(chunk):
            assert len({s % 32 for s in _slot_of(t[w:w + 32, 0], qq,
                                                 chunk)}) == 32
    for first in range(0, THREADS * chunk, 32):
        node = np.arange(first, first + 32)
        banks = _slot_of(node // chunk, node % chunk, chunk) % 32
        assert len(set(banks.tolist())) == 32


# ---------------------------------------------------------------------------
# the wrappers on stub cards: one launch a call
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch, stub_libs, cards):  # noqa: F811
    """CPU tensors taken for a card's (``is_cuda`` true), every library a
    stub: the wrappers take their kernel routes and launch stubs."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    _ext.scratch_words.cache_clear()
    yield stub_libs
    _ext.scratch_words.cache_clear()


def _stub_solve_inputs(n=64, g=4, c=8):
    rng = np.random.default_rng(0)
    return (torch.zeros((n, 4)), torch.full((n, 4), 1000.0),
            torch.ones((g, n), dtype=torch.bool), torch.zeros((g, n)),
            torch.ones((g, 4)), torch.full((g,), 8, dtype=torch.int32),
            torch.ones(g), torch.from_numpy(rng.integers(0, 2 ** 32, g)),
            torch.arange(c, dtype=torch.int32), torch.ones((c, 4)))


def _launch_counts():
    return dict(_ext.COUNTS.snapshot()["launches"])


def test_solve_bulk_multi_is_one_launch(fake_card):
    """The fold, the jitter and the fill are one nt_bulk_fill: its
    pointers, the slots', the jitter width; no B4 or B3 call."""
    used, avail, feas, aff, ask, k, tgc, seeds, cidx, cdelta = (
        _stub_solve_inputs())
    before = _launch_counts()
    out_used, counts = kernels.solve_bulk_multi(
        used, avail, feas, aff, ask, k, tgc, seeds, cidx, cdelta, g=4)
    lib = fake_card["bulk_fill"].fns
    (call,) = lib["nt_bulk_fill"].calls
    assert call[:10] == (used.data_ptr(), avail.data_ptr(), feas.data_ptr(),
                         aff.data_ptr(), ask.data_ptr(), k.data_ptr(),
                         seeds.data_ptr(), cidx.data_ptr(),
                         cdelta.data_ptr(), counts.data_ptr())
    assert call[10] is None                     # no scratch at 64 nodes
    assert call[11:15] == (4, 64, 8, 0)
    assert call[15] == pytest.approx(TIE_JITTER) and call[16] == 1000
    assert lib["nt_bulk_fill_scratch_words"].calls == [(64,)]
    assert not fake_card["scatter"].nt_scatter_add.calls
    assert not fake_card["jitter"].nt_jitter.calls
    after = _launch_counts()
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {"bulk_fill": 1}
    assert out_used is used and counts.shape == (4, 64)


def test_bulk_fill_sizes_its_scratch_and_refuses_above_its_ceiling(
        fake_card):
    """Above 32,768 nodes the keys and caps go to a global scratch sized
    by the library's query; above 65,536 the wrapper raises (ROADMAP
    A11b) and launches nothing."""
    query = _ext.entry("nt_bulk_fill_scratch_words")
    query.code = 98304
    n = 40000
    args = (torch.zeros((n, 4)), torch.zeros((n, 4)),
            torch.ones((1, n), dtype=torch.bool), torch.zeros((1, n)),
            torch.ones((1, 4)), torch.ones(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64))
    kernels.bulk_fill(*args)
    (call,) = fake_card["bulk_fill"].fns["nt_bulk_fill"].calls
    assert call[10] is not None and call[14] == 98304
    assert call[7] is None and call[8] is None and call[13] == 0
    n = kernels.MAX_BULK_FILL_NODES + 1
    big = (torch.zeros((n, 4)), torch.zeros((n, 4)),
           torch.ones((1, n), dtype=torch.bool), torch.zeros((1, n)),
           torch.ones((1, 4)), torch.ones(1, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="A11b"):
        kernels.bulk_fill(*big)
    assert len(fake_card["bulk_fill"].fns["nt_bulk_fill"].calls) == 1


def test_solve_batch_greedy_arm_is_b1_without_slots(fake_card, monkeypatch):
    """solve_batch folds with B4 (both arms share the fold), then its
    greedy arm is one nt_bulk_fill with no correction slots, drawing the
    jitter itself: no nt_jitter call; the auction draws its own (B5 takes
    the seeds: no nt_jitter_fold call)."""
    calls = []
    monkeypatch.setattr(bs, "auction", lambda *a, **kw: calls.append("B5")
                        or (None, None, None))
    monkeypatch.setattr(bs, "batch_pick", lambda *a: calls.append("B6")
                        or a)
    used, avail, feas, aff, ask, k, tgc, seeds, cidx, cdelta = (
        _stub_solve_inputs())
    before = _launch_counts()
    out = bs.solve_batch(used, avail, feas, aff, ask, k, tgc, seeds, cidx,
                         cdelta, g=4)
    (fold,) = fake_card["scatter"].fns["nt_scatter_add"].calls
    assert fold[:3] == (used.data_ptr(), cidx.data_ptr(), cdelta.data_ptr())
    (call,) = fake_card["bulk_fill"].fns["nt_bulk_fill"].calls
    used_g, counts_g = out[4], out[5]
    assert call[0] == used_g.data_ptr() != used.data_ptr()
    assert call[7] is None and call[8] is None and call[13] == 0
    assert call[9] == counts_g.data_ptr()
    assert calls == ["B5", "B6"]
    assert not fake_card["jitter"].nt_jitter.calls
    assert not fake_card["jitter"].nt_jitter_fold.calls
    after = _launch_counts()
    assert {name: after[name] - before[name] for name in after
            if after[name] != before[name]} == {"scatter_add": 1,
                                                "bulk_fill": 1}
