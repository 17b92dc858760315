"""threefry2x32 in torch, bit-exact with ``jax.random`` at the three call
sites the port runs: the bulk path's
``jax.random.uniform(jax.random.PRNGKey(seed), (n,), float32, 0.0, hi)``
(reference ``nomad_tpu/tensor/kernels.py:720-723``), the joint
solve's restarts, which draw from ``fold_in(PRNGKey(seed), t)``
(``nomad_tpu/tensor/batch_solver.py:319-323``), and the fused bulk
scan's tie-break permutation ``jax.random.permutation(PRNGKey(seed), n)``
(``nomad_tpu/tensor/kernels.py:618-619``).

JAX's default threefry mode is partitionable: element ``i`` of a 1-D draw
hashes the 64-bit counter ``(hi=0, lo=i)`` under the key ``(seed >> 32,
seed & 0xFFFFFFFF)`` and keeps ``out0 ^ out1``. ``fold_in(key, t)`` is
the key pair ``(out0, out1)`` of one threefry of the counter ``(0, t)``
under ``key``; ``split(key)`` is the two key pairs of the counters
``(0, 0)`` and ``(0, 1)``. The bits become a float as
``bitcast((bits >> 9) | 0x3F800000) - 1``, scaled by ``hi - lo``, shifted
by ``lo`` and floored at ``lo``. ``permutation`` is ``_shuffle``: 1
round for n <= 1,625, 2 up to ~2.6M, each a split, a 32-bit draw for
every position from the subkey, and a STABLE sort of the positions by
those bits (in round 2 equal bits keep the round-1 order).

torch's uint32 support is thin, so the 32-bit words ride in int64 and
every add and shift is masked back to 32 bits. The jitter kernels
(``csrc/jitter.cu``) and the permutation kernel (``csrc/bulk_scan.cu``
``nt_tie_perm``) compute the same functions on the card and are held
bit-for-bit against :func:`jitter_ref`, :func:`jitter_fold_ref` and
:func:`permutation_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from .. import _ext

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
MAX_FOLDS = 8        # restarts one keyed jitter launch draws (jitter.cu)
# the padded node count every one-card kernel takes at most (ROADMAP
# A11d): B1, B5, B6's pick, B11 (with B11'), a B13 shard and B14's pick
# over all shards. The one-CTA kernels keep their keys in shared memory up
# to 16,384 nodes (B1: 32,768) and in a global scratch above.
MAX_FILL_NODES = 65536
# the count the permutation kernel (B11') sorts: the same (16-bit values;
# its pairs in a global scratch above 16,384)
MAX_PERM_NODES = MAX_FILL_NODES


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """20-round threefry2x32 on int64 tensors holding uint32 words
    (keys broadcast against counters). Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def seed_keys(seeds: torch.Tensor) -> torch.Tensor:
    """(G,) seeds (any integer dtype, values in [0, 2**32)) -> (G, 2)
    int64 key pairs ``PRNGKey(seed)``: ``(seed >> 32, seed & mask)``."""
    s = seeds.to(torch.int64)
    return torch.stack([(s >> 32) & MASK32, s & MASK32], dim=1)


def fold_in(seeds: torch.Tensor, t: int) -> torch.Tensor:
    """(G,) seeds -> (G, 2) int64 key pairs
    ``jax.random.fold_in(PRNGKey(seed), t)``: the two output words of one
    threefry of the counter ``(0, t)`` under the seed's key."""
    keys = seed_keys(seeds)
    zero = torch.zeros_like(keys[:, 0])
    o0, o1 = threefry2x32(keys[:, 0], keys[:, 1], zero,
                          torch.full_like(zero, int(t) & MASK32))
    return torch.stack([o0, o1], dim=1)


def split_ref(keys: torch.Tensor):
    """(G, 2) key pairs -> (key, subkey), each (G, 2):
    ``jax.random.split(key)`` in partitionable mode, the output words of
    threefry of the counters ``(0, 0)`` and ``(0, 1)`` under the key."""
    k = keys.to(torch.int64)
    zero = torch.zeros_like(k[:, 0])
    a0, a1 = threefry2x32(k[:, 0], k[:, 1], zero, zero)
    b0, b1 = threefry2x32(k[:, 0], k[:, 1], zero, torch.ones_like(zero))
    return torch.stack([a0, a1], dim=1), torch.stack([b0, b1], dim=1)


def random_bits_keys(keys: torch.Tensor, n: int,
                     offset: int = 0) -> torch.Tensor:
    """(G, 2) key pairs (int64 holding uint32 words) -> (G, n) int64
    tensor of the uint32 words ``jax.random.bits(key, (offset + n,),
    uint32)[:, offset:]``: element i hashes the counter of node offset + i
    alone, so a node shard draws its own slice."""
    k = keys.to(torch.int64)
    lo = torch.arange(offset, offset + n, dtype=torch.int64,
                      device=keys.device).reshape(1, -1)
    o0, o1 = threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(lo), lo)
    return o0 ^ o1


def random_bits(seeds: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """(G,) seeds -> (G, n) int64 tensor of the uint32 words
    ``jax.random.bits`` would draw from ``PRNGKey(seed)`` for nodes
    [offset, offset + n)."""
    return random_bits_keys(seed_keys(seeds), n, offset)


def bits_to_uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [lo, hi), the ``_uniform``
    float construction of jax.random."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    span = torch.tensor(hi, dtype=torch.float32, device=bits.device) - lo_t
    return torch.maximum(lo_t, f * span + lo_t)


def jitter_ref(seeds: torch.Tensor, n: int, hi: float,
               offset: int = 0) -> torch.Tensor:
    """Plain version of the jitter kernel: (G,) seeds -> (G, n) float32
    draws of U[0, hi) for nodes [offset, offset + n), one row per seed."""
    _ext.COUNTS.plain("jitter", seeds)
    return bits_to_uniform(random_bits(seeds, n, offset), 0.0, hi)


def jitter_keys_ref(keys: torch.Tensor, n: int, hi: float,
                    offset: int = 0) -> torch.Tensor:
    """(G, 2) key pairs -> (G, n) float32 draws of U[0, hi), one row per
    key: ``jax.random.uniform(key, (offset + n,), float32, 0.0,
    hi)[offset:]``."""
    return bits_to_uniform(random_bits_keys(keys, n, offset), 0.0, hi)


def jitter_fold_ref(seeds: torch.Tensor, n: int, his: Sequence[float],
                    offset: int = 0) -> torch.Tensor:
    """Plain version of the keyed jitter kernel: (G,) seeds -> (T, G, n)
    float32, row t the draws of U[0, his[t]) from
    ``fold_in(PRNGKey(seed), t)`` for nodes [offset, offset + n)."""
    _ext.COUNTS.plain("jitter_fold", seeds)
    return torch.stack([jitter_keys_ref(fold_in(seeds, t), n, hi, offset)
                        for t, hi in enumerate(his)])


@functools.lru_cache(maxsize=None)
def permutation_rounds(n: int) -> int:
    """``jax.random._shuffle``'s number of sort rounds for n elements:
    ceil(3 ln n / ln(2**32 - 1)), in float64 as JAX computes it."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation_ref(seed: int, n: int, device=None) -> torch.Tensor:
    """Plain version of the permutation kernel: (n,) int32
    ``jax.random.permutation(jax.random.PRNGKey(seed), n)`` for a seed in
    [0, 2**32), on ``device`` (default the CPU)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    key = seed_keys(torch.tensor([int(seed)], dtype=torch.int64,
                                 device=dev))
    x = torch.arange(n, device=dev)
    for _ in range(permutation_rounds(n)):
        key, sub = split_ref(key)
        bits = random_bits_keys(sub, n)[0]
        x = x[torch.sort(bits, stable=True).indices]
    out = x.to(torch.int32)
    _ext.COUNTS.plain("tie_perm", out)
    return out


def permutation(seed: int, n: int, device) -> torch.Tensor:
    """(n,) int32 ``jax.random.permutation(PRNGKey(seed), n)`` for a seed
    in [0, 2**32): the CUDA kernels (csrc/bulk_scan.cu ``nt_tie_perm``: the
    draws on many SMs, then one CTA's stable radix sort, n <= 65,536) on
    a CUDA device, :func:`permutation_ref` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return permutation_ref(seed, n, dev)
    if dev.type != "cuda":
        raise ValueError(f"permutation: unsupported device {dev}")
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"permutation: seed {seed} outside [0, 2**32)")
    if not 1 <= n <= MAX_PERM_NODES:
        raise NotImplementedError(
            f"permutation: n={n}; the one-CTA kernel sorts 1 to "
            f"{MAX_PERM_NODES} positions (ROADMAP A11d: the node "
            f"ceilings)")
    rounds = permutation_rounds(n)
    words = _ext.scratch_words("nt_tie_perm_scratch_words", n, rounds)
    # the scratch and the result in one allocation (one fewer on the
    # host's path); the result is its tail
    buf = torch.empty(words + n, dtype=torch.int32, device=dev)
    out = buf[words:]
    fn = _ext.entry("nt_tie_perm")
    _ext.launch(
        "tie_perm", dev, fn,
        int(seed), n, rounds, buf.data_ptr() if words else None,
        out.data_ptr(), words)
    return out


def _seeds_u32(seeds: torch.Tensor, what: str) -> torch.Tensor:
    """The uint32 seed words, reinterpreted as int32 for a kernel."""
    if seeds.dim() != 1 or seeds.dtype != torch.int64:
        raise ValueError(f"{what}: seeds must be a 1-D int64 tensor")
    return torch.where(seeds >= 2 ** 31, seeds - 2 ** 32, seeds).to(
        torch.int32).contiguous()


def _span(hi: float) -> float:
    """``hi - lo`` in float32, as jax.random.uniform computes it."""
    return float(np.float32(hi) - np.float32(0.0))


def jitter_fold(seeds: torch.Tensor, n: int, his: Sequence[float],
                offset: int = 0) -> torch.Tensor:
    """(G,) int64 seeds in [0, 2**32) -> (T, G, n) float32, row t the
    draws of U[0, his[t]) from ``fold_in(PRNGKey(seed), t)`` for nodes
    [offset, offset + n): the CUDA kernel (csrc/jitter.cu
    ``nt_jitter_fold``, one launch for all T) for a CUDA tensor,
    :func:`jitter_fold_ref` for a CPU tensor."""
    if seeds.device.type == "cpu":
        return jitter_fold_ref(seeds, n, his, offset)
    if not seeds.is_cuda:
        raise ValueError(f"jitter_fold: unsupported device {seeds.device}")
    s32 = _seeds_u32(seeds, "jitter_fold")
    g, n_t = s32.shape[0], len(his)
    if not 1 <= n_t <= MAX_FOLDS or n_t * g > 65535:
        raise ValueError(f"jitter_fold: the kernel draws 1-{MAX_FOLDS} "
                         f"restarts of at most 65,535 rows in all, got "
                         f"{n_t} x {g}")
    out = torch.empty((n_t, g, n), dtype=torch.float32, device=seeds.device)
    spans = (ctypes.c_float * n_t)(*(_span(hi) for hi in his))
    fn = _ext.entry("nt_jitter_fold")
    _ext.launch(
        "jitter_fold", seeds.device, fn,
        s32.data_ptr(), spans, n_t, out.data_ptr(), g, n,
        int(offset))
    return out


def jitter(seeds: torch.Tensor, n: int, hi: float,
           offset: int = 0) -> torch.Tensor:
    """(G,) int64 seeds in [0, 2**32) -> (G, n) float32 U[0, hi) for
    nodes [offset, offset + n): the CUDA kernel (csrc/jitter.cu) for a
    CUDA tensor, :func:`jitter_ref` for a CPU tensor."""
    if seeds.device.type == "cpu":
        return jitter_ref(seeds, n, hi, offset)
    if not seeds.is_cuda:
        raise ValueError(f"jitter: unsupported device {seeds.device}")
    s32 = _seeds_u32(seeds, "jitter")
    g = s32.shape[0]
    out = torch.empty((g, n), dtype=torch.float32, device=seeds.device)
    fn = _ext.entry("nt_jitter")
    _ext.launch(
        "jitter", seeds.device, fn,
        s32.data_ptr(), out.data_ptr(), g, n, _span(hi),
        int(offset))
    return out
