"""threefry2x32 in torch, bit-exact with ``jax.random`` at the call site
the bulk path uses (reference ``nomad_tpu/tensor/kernels.py:720-723``):
``jax.random.uniform(jax.random.PRNGKey(seed), (n,), float32, 0.0, hi)``.

JAX's default threefry mode is partitionable: element ``i`` of a 1-D draw
hashes the 64-bit counter ``(hi=0, lo=i)`` under the key ``(seed >> 32,
seed & 0xFFFFFFFF)`` and keeps ``out0 ^ out1``. The bits become a float as
``bitcast((bits >> 9) | 0x3F800000) - 1``, scaled by ``hi - lo``, shifted
by ``lo`` and floored at ``lo``.

torch's uint32 support is thin, so the 32-bit words ride in int64 and
every add and shift is masked back to 32 bits. The jitter kernel
(``csrc/jitter.cu``) computes the same function on the card and is held
bit-for-bit against :func:`jitter_ref`.
"""

from __future__ import annotations

import torch

from .. import _ext

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


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


def random_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(G,) seeds (any integer dtype, values in [0, 2**32)) -> (G, n)
    int64 tensor of the uint32 words ``jax.random.bits`` would draw from
    ``PRNGKey(seed)`` for shape (n,)."""
    s = seeds.to(torch.int64).reshape(-1, 1)
    k0 = (s >> 32) & MASK32
    k1 = s & MASK32
    lo = torch.arange(n, dtype=torch.int64, device=seeds.device).reshape(1, -1)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return o0 ^ o1


def bits_to_uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [lo, hi), the ``_uniform``
    float construction of jax.random."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    span = torch.tensor(hi, dtype=torch.float32, device=bits.device) - lo_t
    return torch.maximum(lo_t, f * span + lo_t)


def jitter_ref(seeds: torch.Tensor, n: int, hi: float) -> torch.Tensor:
    """Plain version of the jitter kernel: (G,) seeds -> (G, n) float32
    draws of U[0, hi), one row per seed."""
    _ext.COUNTS.plain("jitter", seeds)
    return bits_to_uniform(random_bits(seeds, n), 0.0, hi)


def jitter(seeds: torch.Tensor, n: int, hi: float) -> torch.Tensor:
    """(G,) int64 seeds in [0, 2**32) -> (G, n) float32 U[0, hi): the
    CUDA kernel (csrc/jitter.cu) for a CUDA tensor, :func:`jitter_ref`
    for a CPU tensor."""
    if seeds.device.type == "cpu":
        return jitter_ref(seeds, n, hi)
    if not seeds.is_cuda:
        raise ValueError(f"jitter: unsupported device {seeds.device}")
    if seeds.dim() != 1 or seeds.dtype != torch.int64:
        raise ValueError("jitter: seeds must be a 1-D int64 tensor")
    # the uint32 words, reinterpreted as int32 for the kernel's pointer
    s32 = torch.where(seeds >= 2 ** 31, seeds - 2 ** 32, seeds).to(
        torch.int32).contiguous()
    g = s32.shape[0]
    out = torch.empty((g, n), dtype=torch.float32, device=seeds.device)
    span = float(torch.tensor(hi, dtype=torch.float32)
                 - torch.tensor(0.0, dtype=torch.float32))
    fn = _ext.entry("nt_jitter")
    _ext.check(fn(s32.data_ptr(), out.data_ptr(), g, n, span,
                  _ext.stream_handle(seeds.device)), "jitter launch")
    _ext.COUNTS.launched("jitter")
    return out
