"""The port's threefry2x32 jitter (nomad_tpu_torch/tensor/prng.py) against
jax.random, bit for bit, at the call the bulk kernel makes
(nomad_tpu/tensor/kernels.py:720-723) and at the joint solve's restart
draws from fold_in (nomad_tpu/tensor/batch_solver.py:319-323)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor.batch_solver import PORTFOLIO as REF_PORTFOLIO
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


def test_fold_in_keys_equal_jax():
    assert prng.fold_in(torch.tensor([7]), 3).tolist() == [
        [276534068, 1641862660]]
    for t in range(5):
        got = prng.fold_in(torch.tensor(SEEDS, dtype=torch.int64), t).numpy()
        for i, s in enumerate(SEEDS):
            want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), t))
            assert np.array_equal(got[i], want.astype(np.int64)), (s, t)


@pytest.mark.parametrize("t,jscale", [(t, js) for t, (js, _) in
                                      enumerate(REF_PORTFOLIO)])
@pytest.mark.parametrize("n", [7, 4096])
def test_jitter_fold_bits_equal_jax(t, jscale, n):
    """The restart draws as the reference vmaps them over (G,) uint32
    seeds, for every PORTFOLIO entry's jitter scale."""
    seeds = np.array(SEEDS, dtype=np.uint32)
    want = np.asarray(jax.vmap(lambda s: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(s), t), (n,), jnp.float32,
        0.0, REF_TIE_JITTER * jscale))(seeds))
    his = [TIE_JITTER * js for js, _ in REF_PORTFOLIO]
    assert his[t] == TIE_JITTER * jscale
    s = torch.from_numpy(seeds.astype(np.int64))
    got = prng.jitter_fold(s, n, his)
    assert got.shape == (len(his), len(SEEDS), n)
    assert np.array_equal(got[t].numpy().view(np.uint32),
                          want.view(np.uint32))
    # a shorter list of bounds draws the same leading rows
    prefix = prng.jitter_fold(s, n, his[:t + 1])[t].numpy()
    assert np.array_equal(prefix.view(np.uint32), want.view(np.uint32))


def test_keyed_bits_equal_jax_bits():
    keys = prng.fold_in(torch.tensor(SEEDS, dtype=torch.int64), 2)
    got = prng.random_bits_keys(keys, 300).numpy()
    for i, s in enumerate(SEEDS):
        key = jax.random.fold_in(jax.random.PRNGKey(s), 2)
        want = np.asarray(jax.random.bits(key, (300,), jnp.uint32))
        assert np.array_equal(got[i], want.astype(np.int64)), s


def test_jitter_fold_rejects_unsupported_device():
    with pytest.raises(ValueError):
        prng.jitter_fold(torch.zeros(2, dtype=torch.int64, device="meta"),
                         4, (TIE_JITTER,))
