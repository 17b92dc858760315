"""The stable sort of B11' (nomad_tpu_torch/csrc/bulk_scan.cu ``nt_tie_perm``)
on the CPU: its passes in plain torch, and its host call on stub cards.

The kernel cannot run here (no ``nvcc``, no card), so this module keeps a
plain-torch model of one launch at the kernel's digit width: each round
draws one 32-bit word a position (threefry, ``prng.random_bits_keys``)
beside the sequence so far, sorts the (draw, value) pairs by the draws'
high halves with two LSD passes of 8-bit digits, then sorts each run of
equal high halves by the whole draw, keeping equal draws in order. A pass
is the kernel's: warp w of 32 owns the positions [w x chunk, (w + 1) x
chunk), chunk the least power of two of at least 64 with 32 x chunk >= n,
and walks them in order 32 at a time; an item's rank is its digit's count in the warp's earlier groups of
32 plus its peers (same digit) on lower lanes of its own group (eight
ballots); the (digit, warp) counts take one exclusive scan in
digit-major order, and the item goes to its (digit, warp) offset plus its
rank. (The kernel counts a pass's items while the previous pass scatters
them: the same counts.)

The passes must equal ``torch.sort(stable=True)`` on random words with
injected duplicates, and the model's permutation must equal
``permutation_ref`` and ``jax.random.permutation(PRNGKey(seed), n)`` at n
1, 2, 1,625, 1,626 (the round-count edge), 16,384 and 65,536, for seeds
0, 7, 2^31, 2^32 - 1 and ``COLLIDING_SEED``, whose second round draws two
pairs of equal words at n 16,384 (chip_smoke.py runs it on the card)."""

import jax
import numpy as np
import pytest
import torch

from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import prng
from test_torch_ext import cards, stub_libs  # noqa: F401  (fixtures)

RADIX_BITS = 8
BINS = 1 << RADIX_BITS
WARPS = 32            # the kernel's 1,024 threads
LANES = 32
# the second round of permutation(113, 16,384) draws two pairs of equal
# words: a sort that is not stable swaps them
COLLIDING_SEED = 113
SEEDS = (0, 7, 2 ** 31, 2 ** 32 - 1, COLLIDING_SEED)
SIZES = (1, 2, 1625, 1626, 16384, 65536)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the passes are small ops, and several test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def radix_pass_ref(keys: torch.Tensor, vals: torch.Tensor, shift: int):
    """One stable LSD pass of the kernel, in its own arithmetic: (n,)
    int64 words and their values -> both reordered by the 8-bit digit of
    the words at ``shift``."""
    n = keys.shape[0]
    chunk = 64                 # the least power of two, at least 64,
    while WARPS * chunk < n:   # with which 32 warps cover n
        chunk *= 2
    padded = -(-n // LANES) * LANES
    digit = torch.full((padded,), BINS, dtype=torch.int64)  # no item
    digit[:n] = (keys >> shift) & (BINS - 1)
    groups = digit.reshape(-1, LANES)                      # 32 lanes each
    warp = torch.arange(groups.shape[0]) * LANES // chunk  # group's warp
    # peers on lower lanes of the same group
    lane = torch.arange(LANES)
    same = groups[:, :, None] == groups[:, None, :]
    below = (same & (lane[None, :] < lane[:, None])[None]).sum(dim=2)
    # the digit's count in the warp's earlier groups
    hist = torch.zeros((groups.shape[0], BINS + 1), dtype=torch.int64)
    hist.scatter_add_(1, groups, torch.ones_like(groups))
    before = torch.cumsum(hist, dim=0) - hist
    seen = before - before[torch.searchsorted(warp, warp)]
    rank = torch.gather(seen, 1, groups) + below
    # (digit, warp) counts, their exclusive scan in digit-major order
    counts = torch.zeros((BINS + 1, WARPS), dtype=torch.int64)
    counts.index_put_((groups.reshape(-1),
                       warp.repeat_interleave(LANES)),
                      torch.ones(padded, dtype=torch.int64), accumulate=True)
    counts = counts[:BINS].reshape(-1)
    offsets = (torch.cumsum(counts, 0) - counts).reshape(BINS, WARPS)
    valid = torch.arange(padded) < n
    d = groups.reshape(-1)[valid]
    w = warp.repeat_interleave(LANES)[valid]
    pos = offsets[d, w] + rank.reshape(-1)[valid]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    out_k[pos] = keys
    out_v[pos] = vals
    return out_k, out_v


def sort_runs_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Each run of equal high halves (the pairs already in order of them)
    sorted stably by the whole word, as the kernel's insertion sort
    leaves it."""
    run = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64),
                                  (keys[1:] >> 16 != keys[:-1] >> 16)
                                  .to(torch.int64)]), 0)
    order = torch.sort(run * 2 ** 32 + keys, stable=True).indices
    return keys[order], vals[order]


def radix_sort_ref(keys: torch.Tensor, vals: torch.Tensor):
    """A round's sort: (n,) 32-bit words (int64) and their values, sorted
    stably by the words: two passes over the high halves, then the
    runs."""
    for shift in (16, 24):
        keys, vals = radix_pass_ref(keys, vals, shift)
    return sort_runs_ref(keys, vals)


def permutation_model(seed: int, n: int) -> torch.Tensor:
    """One nt_tie_perm launch in plain torch: each round's draws sorted
    with the sequence so far as their values."""
    key = prng.seed_keys(torch.tensor([seed], dtype=torch.int64))
    vals = torch.arange(n, dtype=torch.int64)
    for _ in range(prng.permutation_rounds(n)):
        key, sub = prng.split_ref(key)
        _, vals = radix_sort_ref(prng.random_bits_keys(sub, n)[0], vals)
    return vals.to(torch.int32)


@pytest.mark.parametrize("n", [1, 31, 1000, 1025, 16384, 40000])
def test_passes_equal_the_stable_sort(n):
    """Random words with a run of injected duplicates (a tenth of them
    copies of a few words) and words that share their high half: the
    passes and the run sort give torch.sort's stable order, values and
    all."""
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 32, n)
    dup = rng.random(n) < 0.1
    words[dup] = rng.choice(words[:max(1, n // 50)], int(dup.sum()))
    near = rng.random(n) < 0.2
    words[near] = (rng.choice(words[:max(1, n // 20)], int(near.sum()))
                   & 0xFFFF0000) | rng.integers(0, 2 ** 16, int(near.sum()))
    keys = torch.from_numpy(words.astype(np.int64))
    got_k, got_v = radix_sort_ref(keys, torch.arange(n))
    want = torch.sort(keys, stable=True)
    assert torch.equal(got_k, want.values)
    assert torch.equal(got_v, want.indices)


def test_the_colliding_seed_draws_equal_words():
    """COLLIDING_SEED's second round at n 16,384 holds two pairs of equal
    draws, so a sort that is not stable gives another permutation."""
    n = 16384
    key = prng.seed_keys(torch.tensor([COLLIDING_SEED]))
    repeats = []
    for _ in range(prng.permutation_rounds(n)):
        key, sub = prng.split_ref(key)
        _, counts = torch.unique(prng.random_bits_keys(sub, n)[0],
                                 return_counts=True)
        repeats.append(int((counts > 1).sum()))
    assert repeats == [0, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_model_equals_plain_and_jax(n, seed):
    got = permutation_model(seed, n)
    assert torch.equal(got, prng.permutation_ref(seed, n))
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrapper on stub cards
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_card(monkeypatch, stub_libs, cards):  # noqa: F811
    """Every library a stub; a "cuda" allocation made on the CPU."""
    real = torch.empty

    def empty(*shape, device=None, **kw):
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    _ext.scratch_words.cache_clear()
    yield stub_libs
    _ext.scratch_words.cache_clear()


@pytest.mark.parametrize("n,words", [(1, 0), (16384, 32768),
                                     (16385, 98310), (65536, 393216)])
def test_permutation_launches_up_to_its_ceiling(stub_card, n, words):
    """1 to 65,536 positions are one host call; the scratch (the draws,
    and the pairs where they do not fit in shared memory) comes from the
    library's query, and the ceiling is MAX_PERM_NODES, the one-card
    kernels' MAX_FILL_NODES."""
    assert prng.MAX_FILL_NODES == prng.MAX_PERM_NODES == 65536
    query = _ext.entry("nt_tie_perm_scratch_words")
    query.code = words
    before = _ext.COUNTS.snapshot()["launches"]["tie_perm"]
    out = prng.permutation(2 ** 32 - 1, n, "cuda")
    (call,) = stub_card["bulk_scan"].fns["nt_tie_perm"].calls
    rounds = prng.permutation_rounds(n)
    assert call[:3] == (2 ** 32 - 1, n, rounds)
    assert (call[3] is None) == (words == 0)
    assert call[4] == out.data_ptr() and call[5] == words
    assert query.calls == [(n, rounds)]
    assert _ext.COUNTS.snapshot()["launches"]["tie_perm"] == before + 1
    assert out.shape == (n,) and out.dtype == torch.int32
