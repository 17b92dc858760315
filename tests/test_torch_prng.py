"""The port's threefry2x32 jitter (nomad_tpu_torch/tensor/prng.py) against
jax.random, bit for bit, at the call the bulk kernel makes
(nomad_tpu/tensor/kernels.py:720-723)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor.kernels import TIE_JITTER as REF_TIE_JITTER
from nomad_tpu_torch.tensor import prng
from nomad_tpu_torch.tensor.kernels import TIE_JITTER

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1] + [
    int(s) for s in np.random.default_rng(20).integers(0, 2 ** 32, 4)]


@pytest.mark.parametrize("n", [1, 7, 256, 10240])
def test_jitter_bits_equal_jax_uniform(n):
    assert TIE_JITTER == REF_TIE_JITTER
    got = prng.jitter(torch.tensor(SEEDS, dtype=torch.int64), n,
                      TIE_JITTER).numpy()
    for i, s in enumerate(SEEDS):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(s), (n,), jnp.float32, 0.0, TIE_JITTER))
        # exact: the float bit patterns must match
        assert np.array_equal(got[i].view(np.uint32), want.view(np.uint32)), s


@pytest.mark.parametrize("n", [7, 10240])
def test_random_bits_equal_jax_bits(n):
    got = prng.random_bits(torch.tensor(SEEDS, dtype=torch.int64), n).numpy()
    for i, s in enumerate(SEEDS):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(s), (n,),
                                          jnp.uint32)).astype(np.int64)
        assert np.array_equal(got[i], want), s


def test_jitter_matches_the_vmapped_uint32_seed_call():
    """The reference draws under vmap from a (G,) uint32 seed array."""
    seeds = np.array(SEEDS, dtype=np.uint32)
    want = np.asarray(jax.vmap(lambda s: jax.random.uniform(
        jax.random.PRNGKey(s), (300,), jnp.float32, 0.0, TIE_JITTER))(seeds))
    got = prng.jitter_ref(torch.from_numpy(seeds.astype(np.int64)), 300,
                          TIE_JITTER).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_jitter_wrapper_rejects_unsupported_device():
    with pytest.raises(ValueError):
        prng.jitter(torch.zeros(2, dtype=torch.int64, device="meta"), 4,
                    TIE_JITTER)
