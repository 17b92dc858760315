"""The B6 pick's schedule (nomad_tpu_torch/csrc/batch_solve.cu
``nt_batch_pick``) on the CPU: its split of the pairwise tree in plain
torch, and its host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of what one launch does. Each (arm, chunk) item sums
placed x fitness over an aligned chunk of the zero-padded nodes by the
block's halving (sort.cuh ``block_pairwise_sum``) and counts its placed
allocs; after the barrier one warp an arm combines the C chunk sums, a
lane's run of C / 32 consecutive sums halved in registers, then the lanes
paired by shuffles; then the restart chain (earliest on exact ties), the
pick against the greedy arm and the chosen carry, counts and info row.

The reference's ``_pairwise_sum_xp`` pads to a power of two and halves by
``v[0::2] + v[1::2]``, so its value over an aligned chunk is the chunk's
own tree, and the whole sum is the same tree over the chunk sums. The
model's chunked sums must equal it bit for bit for n in {1, 3, 1,000,
4,096, 10,247, 32,768} at chunks of 256, 512 and 1,024. The model's pick
must equal ``batch_pick_ref`` bit for bit, and the JAX package's
``solve_batch`` on tests/test_torch_batch_solver.py's fixtures (carry,
counts and info[2:] exactly; the two packing scores within
``SCORE_RTOL``: torch's and XLA's f32 ``10**x`` may round 1 ulp apart),
with exact (placed, score) ties between restarts and against the greedy
arm, and with arms that place nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import batch_solver as ref
from nomad_tpu.tensor.kernels import _pairwise_sum_xp
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import batch_solver as bs
from nomad_tpu_torch.tensor.kernels import bulk_fill_ref, fit_scores
from nomad_tpu_torch.tensor.prng import jitter_fold_ref
from test_torch_batch_solver import (SCORE_RTOL, _batch_problem, _both,
                                     _random_problem)
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)

# the nodes an (arm, chunk) item may sum, and the items a launch aims at
# (batch_solve.cu kMinPickChunk..kMaxPickChunk, kPickItems)
CHUNKS = (256, 512, 1024)
ITEMS = 384
LANES = 32


def _pad(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def kernel_chunk(n_t: int, n: int) -> int:
    """The chunk nt_batch_pick takes for T restarts over n nodes: the
    smallest whose (T + 1) x p / chunk items (p the padded count) stay
    within ITEMS, the largest past that."""
    for chunk in CHUNKS:
        if (n_t + 1) * (_pad(n) // chunk) <= ITEMS:
            return chunk
    return CHUNKS[-1]


def chunk_sums(v: torch.Tensor, chunk: int) -> torch.Tensor:
    """The items' sums: each aligned chunk of the zero-padded values
    halved in place, as one CTA's block_pairwise_sum (a chunk is the
    padded count where that is smaller)."""
    n = v.shape[0]
    p = _pad(n)
    chunk = min(chunk, p)
    items = torch.zeros(p, dtype=v.dtype)
    items[:n] = v
    items = items.reshape(p // chunk, chunk)
    while items.shape[1] > 1:
        items = items[:, 0::2] + items[:, 1::2]
    return items[:, 0]


def combine(sums: torch.Tensor) -> torch.Tensor:
    """One warp's tree over an arm's C chunk sums: each lane halves its
    run of C / 32 consecutive sums (one sum a lane when C <= 32), then
    lane l takes lane l + off's sum where l is a multiple of 2 off, for
    off = 1, 2, 4, ..."""
    c = sums.shape[0]
    q = c // LANES if c > LANES else 1
    runs = sums.reshape(c // q, q)
    while runs.shape[1] > 1:
        runs = runs[:, 0::2] + runs[:, 1::2]
    lane = runs[:, 0].clone()
    off = 1
    while off < lane.shape[0]:
        at = torch.arange(0, lane.shape[0], 2 * off)
        lane[at] = lane[at] + lane[at + off]
        off *= 2
    return lane[0]


def pick_model(available, used_t, take_t, rounds_t, used_g, counts_g,
               chunk=None):
    """One nt_batch_pick launch in plain torch -> (used, counts, info);
    by default at the kernel's chunk."""
    n_t = used_t.shape[0]
    chunk = chunk or kernel_chunk(n_t, used_t.shape[1])
    arms = [(take_t[t], used_t[t]) for t in range(n_t)] + [(counts_g,
                                                            used_g)]
    scores, placed = [], []
    for take, used in arms:
        per_node = take.to(torch.int32).sum(dim=0)
        v = per_node.to(torch.float32) * fit_scores(available, used)
        scores.append(combine(chunk_sums(v, chunk)))
        items = _item_counts(per_node, min(chunk, _pad(v.shape[0])))
        placed.append(int(items.sum()))
    best = 0
    for t in range(1, n_t):
        if placed[t] > placed[best] or (
                placed[t] == placed[best] and bool(scores[t] > scores[best])):
            best = t
    pick_a = placed[best] > placed[n_t] or (
        placed[best] == placed[n_t] and bool(scores[best] > scores[n_t]))
    if pick_a:
        used, counts = used_t[best].clone(), take_t[best].to(torch.int16)
    else:
        used, counts = used_g.clone(), counts_g.clone()
    info = torch.stack([scores[best], scores[n_t],
                        torch.tensor(float(placed[best])),
                        torch.tensor(float(placed[n_t])),
                        rounds_t[best].to(torch.float32),
                        torch.tensor(float(pick_a))]).to(torch.float32)
    return used, counts, info


def _item_counts(per_node: torch.Tensor, chunk: int) -> torch.Tensor:
    """Each item's placed count (int32 adds: exact in any order)."""
    p = _pad(per_node.shape[0])
    padded = torch.zeros(p, dtype=torch.int64)
    padded[:per_node.shape[0]] = per_node
    return padded.reshape(p // chunk, chunk).sum(dim=1)


def _values(n: int, seed: int) -> np.ndarray:
    """float32 values over six decades, signs mixed: an add order other
    than the tree's moves the last bits."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", [1, 3, 1000, 4096, 10247, 32768])
def test_chunked_tree_equals_pairwise_sum(n, chunk):
    v = _values(n, n)
    got = combine(chunk_sums(torch.from_numpy(v), chunk))
    want = np.float32(_pairwise_sum_xp(jnp, jnp.asarray(v)))
    assert got.numpy().view(np.uint32) == want.view(np.uint32)
    assert torch.equal(got, bs.pairwise_sum_ref(torch.from_numpy(v)))


# B14's pick (csrc/sharded.cu joint_pick): one CTA's tree over chunks of
# at most this many nodes in shared memory
B14_TREE_CHUNK = 16384


def b14_tree(v: torch.Tensor) -> torch.Tensor:
    """joint_pick's sum: each aligned chunk of B14_TREE_CHUNK (the padded
    count where smaller) halved by block_pairwise_sum, then thread 0
    halving the chunk sums in place (sum[i] = sum[2i] + sum[2i + 1], i
    ascending, one level at a time)."""
    sums = chunk_sums(v, B14_TREE_CHUNK).clone()
    m = sums.shape[0]
    while m > 1:
        for i in range(m // 2):
            sums[i] = sums[2 * i] + sums[2 * i + 1]
        m //= 2
    return sums[0]


@pytest.mark.parametrize("n", [1, 1000, 16384, 16385, 20000, 32768, 40000,
                               65536])
def test_b14_pick_tree_chunks_equal_pairwise_sum(n):
    """B14's pick sums up to 65,536 nodes (32,768 before, one tree in
    shared memory); its chunked tree equals the reference's
    _pairwise_sum_xp and pairwise_sum_ref bit for bit, at one chunk and at
    two, three (padded to four) and four."""
    v = _values(n, n + 7)
    got = b14_tree(torch.from_numpy(v))
    want = np.float32(_pairwise_sum_xp(jnp, jnp.asarray(v)))
    assert got.numpy().view(np.uint32) == want.view(np.uint32)
    assert torch.equal(got, bs.pairwise_sum_ref(torch.from_numpy(v)))


def test_the_values_tell_add_orders_apart():
    """The values above do tell orders apart: a left-to-right float32 sum
    of them differs from the tree's in the last bits."""
    v = _values(10247, 10247)
    tree = combine(chunk_sums(torch.from_numpy(v), 256)).numpy()
    assert np.cumsum(v, dtype=np.float32)[-1] != tree


def _pick_inputs(avail, used0, feas, aff, ask, k, seeds):
    """The pick's inputs as solve_batch_ref forms them (no corrections):
    the restarts' ends and the greedy arm's."""
    t = torch.from_numpy
    used = torch.clamp_min(t(used0), 0.0)
    s64 = t(seeds.astype(np.int64))
    used_g = used.clone()
    counts_g = bulk_fill_ref(used_g, t(avail), t(feas), t(aff), t(ask), t(k),
                             s64)
    jits = jitter_fold_ref(s64, avail.shape[0], bs._jitter_his())
    used_t, take_t, rounds_t = bs.auction_restarts_ref(
        used, t(avail), t(feas), t(aff), t(ask), t(k), jits,
        price_eps=bs._price_eps())
    return t(avail), used_t, take_t, rounds_t, used_g, counts_g


def _assert_same(got, want, what):
    for name, x, y in zip(("used", "counts", "info"), got, want):
        assert x.dtype == y.dtype, f"{what}: {name}"
        assert torch.equal(x, y), f"{what}: {name}"


FIXTURES = ([(f"random{s}", lambda s=s: _random_problem(s))
             for s in range(6)]
            + [(f"batch{s}", lambda s=s: _batch_problem(s))
               for s in range(4)]
            + [("random1500", lambda: _random_problem(7, n=1500, g=6))])


@pytest.mark.parametrize("name,make", FIXTURES, ids=[f for f, _ in FIXTURES])
def test_pick_model_equals_plain_and_jax(name, make):
    problem = make()
    p_args = _pick_inputs(*problem)
    want = bs.batch_pick_ref(*p_args)
    for chunk in CHUNKS:
        _assert_same(pick_model(*p_args, chunk=chunk), want,
                     f"{name} chunk {chunk}")
    jx, _ = _both(*problem)
    used, counts, info = (x.numpy() for x in want)
    np.testing.assert_array_equal(used, jx[0])
    np.testing.assert_array_equal(counts, jx[1])
    np.testing.assert_array_equal(info[2:], jx[2][2:])
    np.testing.assert_allclose(info[:2], jx[2][:2], rtol=SCORE_RTOL, atol=0)
    # the tree itself, bit for bit, on this fixture's products
    avail, used_t, take_t = p_args[:3]
    per_node = take_t[0].sum(dim=0).to(torch.float32) * fit_scores(
        avail, used_t[0])
    tree = np.float32(_pairwise_sum_xp(jnp, jnp.asarray(per_node.numpy())))
    assert combine(chunk_sums(per_node, 256)).numpy().view(np.uint32) == (
        tree.view(np.uint32))


def _synthetic(n, n_t=5, g=4, seed=0):
    """Pick inputs without an auction: usage at 30-100% of capacity,
    takes of 0-2 allocs on a tenth of the (row, node) pairs."""
    rng = np.random.default_rng(seed)
    avail = np.zeros((n, 4), np.float32)
    avail[:, 0] = rng.choice([4000, 8000, 16000], n)
    avail[:, 1] = rng.choice([8192, 16384, 32768], n)
    avail[:, 2:] = (100_000, 1000)
    used_t = np.floor(avail[None] * rng.uniform(0.3, 1.0, (n_t, n, 1)))
    take_t = (rng.random((n_t, g, n)) < 0.1) * rng.integers(1, 3,
                                                          (n_t, g, n))
    used_g = np.floor(avail * rng.uniform(0.3, 1.0, (n, 1)))
    counts_g = (rng.random((g, n)) < 0.1) * rng.integers(1, 3, (g, n))
    rounds_t = rng.integers(1, 65, n_t)
    t = torch.from_numpy
    return [t(avail), t(used_t.astype(np.float32)),
            t(take_t.astype(np.int32)), t(rounds_t.astype(np.int32)),
            t(used_g.astype(np.float32)), t(counts_g.astype(np.int16))]


def _jax_chain(p_args):
    """The reference's chain and pick (batch_solver.py:329-358) on the
    port's arm ends, with the reference's own packing score."""
    avail, used_t, take_t, rounds_t, used_g, counts_g = (
        jnp.asarray(x.numpy()) for x in p_args)
    best = score_best = placed_best = None
    for t in range(used_t.shape[0]):
        placed = take_t[t].sum(dtype=jnp.int32)
        score = ref._packing_score_xp(jnp, take_t[t], avail, used_t[t])
        if t == 0 or bool((placed > placed_best) | (
                (placed == placed_best) & (score > score_best))):
            best, score_best, placed_best = t, score, placed
    placed_g = counts_g.astype(jnp.int32).sum()
    score_g = ref._packing_score_xp(jnp, counts_g.astype(jnp.int32), avail,
                                    used_g)
    pick_a = bool((placed_best > placed_g) | (
        (placed_best == placed_g) & (score_best > score_g)))
    return best, pick_a, int(placed_best), int(placed_g)


def _check_chain(p_args, best, pick_a):
    want = bs.batch_pick_ref(*p_args)
    for chunk in CHUNKS:
        _assert_same(pick_model(*p_args, chunk=chunk), want, f"chunk {chunk}")
    j_best, j_pick, j_placed, j_placed_g = _jax_chain(p_args)
    assert (j_best, j_pick) == (best, pick_a)
    info = want[2]
    assert info[4] == p_args[3][best] and bool(info[5]) == pick_a
    assert (info[2], info[3]) == (j_placed, j_placed_g)
    return want


def test_exact_ties_between_restarts_go_to_the_earliest():
    """Restarts 1 and 3 end alike and beat the others: the chain keeps
    restart 1 (its rounds in the info row), and the auction wins."""
    p_args = _synthetic(600)
    used_t, take_t, rounds_t = p_args[1], p_args[2], p_args[3]
    take_t[1] += 1                       # restart 1 places the most
    used_t[3], take_t[3] = used_t[1], take_t[1]
    rounds_t[3] = rounds_t[1] + 1
    p_args[5] = torch.zeros_like(p_args[5])
    _check_chain(p_args, best=1, pick_a=True)


def test_an_exact_tie_with_greedy_goes_to_greedy():
    """The best restart and the greedy arm end alike: greedy keeps the
    batch (the auction must be strictly better)."""
    p_args = _synthetic(600, seed=1)
    take_t = p_args[2]
    take_t[2] += 1
    p_args[4] = p_args[1][2].clone()
    p_args[5] = take_t[2].to(torch.int16)
    want = _check_chain(p_args, best=2, pick_a=False)
    assert torch.equal(want[0], p_args[4]) and want[2][0] == want[2][1]


@pytest.mark.parametrize("which", ["restart", "greedy", "all"])
def test_arms_that_place_nothing(which):
    """A k = 0 arm: a restart that places nothing (the chain passes it),
    an empty greedy arm (any placing auction beats it), and every arm
    empty (0 against 0: greedy keeps its zero counts)."""
    p_args = _synthetic(300, seed=2)
    if which in ("restart", "all"):
        p_args[2][0] = 0
    if which in ("greedy", "all"):
        p_args[5] = torch.zeros_like(p_args[5])
    if which == "all":
        p_args[2][:] = 0
    best, pick_a, _, _ = _jax_chain(p_args)
    want = _check_chain(p_args, best, pick_a)
    if which == "restart":
        assert best != 0
    elif which == "greedy":
        assert pick_a
    else:
        assert best == 0 and not pick_a and not want[1].any()
        assert want[2][2] == want[2][3] == 0


@pytest.mark.parametrize("n", [32768, 65536])
def test_pick_model_at_the_wide_pads(n):
    """The pick alone at N_pad 32,768 and 65,536, past B5's 16,384: 128
    and 256 chunk sums an arm at the smallest chunk (4 and 8 a lane)."""
    p_args = _synthetic(n - 7, n_t=3, g=2, seed=n)
    want = bs.batch_pick_ref(*p_args)
    for chunk in CHUNKS:
        _assert_same(pick_model(*p_args, chunk=chunk), want, f"chunk {chunk}")


@pytest.mark.parametrize("n,chunk", [(1, 256), (40, 256), (4096, 256),
                                     (16384, 256), (16385, 512),
                                     (32768, 512), (65536, 1024)])
def test_the_kernel_s_chunk_keeps_a_launch_within_its_items(n, chunk):
    """Five restarts and the greedy arm: the smallest chunk whose items
    stay within ITEMS (4,096 nodes: 96 items of 256; 65,536: 384 of
    1,024), and the model's pick at that chunk equals batch_pick_ref."""
    assert kernel_chunk(5, n) == chunk
    assert 6 * (_pad(n) // chunk) <= ITEMS or chunk == 1024
    p_args = _synthetic(n, n_t=5, g=1, seed=n)
    _assert_same(pick_model(*p_args), bs.batch_pick_ref(*p_args),
                 f"chunk {chunk}")


# ---------------------------------------------------------------------------
# the wrapper on stub cards
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch, stub_libs, cards):  # noqa: F811
    """CPU tensors taken for a card's (``is_cuda`` true), every library a
    stub, no stream's buffers kept yet: the wrapper takes its kernel route
    and launches a stub."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(bs, "_words", {})
    _ext.scratch_words.cache_clear()
    yield stub_libs
    _ext.scratch_words.cache_clear()


def test_batch_pick_is_one_launch_with_its_library_sized_scratch(fake_card):
    """One nt_batch_pick a call: the inputs' pointers, the outputs, the
    stream's scratch (its size the library's at the most arms and nodes,
    asked once) and barrier words, then T, G, N and the scratch's word
    count."""
    p_args = _synthetic(1000, n_t=5, g=4)
    query = fake_card["batch_solve"].nt_batch_pick_scratch_words
    query.code = 96
    before = _ext.COUNTS.snapshot()["launches"]["batch_pick"]
    for _ in range(2):
        used, counts, info = bs.batch_pick(*p_args)
    first, call = fake_card["batch_solve"].fns["nt_batch_pick"].calls
    assert call[:6] == tuple(a.data_ptr() for a in p_args)
    assert call[6:9] == (used.data_ptr(), counts.data_ptr(),
                         info.data_ptr())
    dev = p_args[0].device
    assert call[9] == first[9] == bs._pick_scratch(dev).data_ptr()
    assert call[10] == first[10] == bs._barrier_words(dev).data_ptr()
    assert call[11:15] == (5, 4, 1000, 96)
    assert query.calls == [(bs.MAX_PICK_ARMS - 1, bs.MAX_PICK_NODES)]
    assert used.shape == (1000, 4) and counts.dtype == torch.int16
    assert info.shape == (6,)
    assert _ext.COUNTS.snapshot()["launches"]["batch_pick"] == before + 2


def test_batch_pick_refuses_what_the_kernel_does_not_take(fake_card):
    """Above N_pad 65,536 (A11d) and at 64 restarts or more the wrapper
    raises and launches nothing; 65,536 nodes go to the kernel."""
    n = bs.MAX_PICK_NODES + 1
    big = [torch.zeros((n, 4)), torch.zeros((1, n, 4)),
           torch.zeros((1, 1, n), dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32), torch.zeros((n, 4)),
           torch.zeros((1, n), dtype=torch.int16)]
    with pytest.raises(NotImplementedError, match="A11d"):
        bs.batch_pick(*big)
    many = _synthetic(64, n_t=bs.MAX_PICK_ARMS, g=1)
    with pytest.raises(ValueError, match="restarts"):
        bs.batch_pick(*many)
    assert not fake_card["batch_solve"].fns.get("nt_batch_pick")
    edge = [big[0][:-1], big[1][:, :-1], big[2][..., :-1], big[3],
            big[4][:-1], big[5][:, :-1]]
    bs.batch_pick(*edge)
    (call,) = fake_card["batch_solve"].fns["nt_batch_pick"].calls
    assert call[11:14] == (1, 1, bs.MAX_PICK_NODES)
