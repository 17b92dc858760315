"""The port's bulk program (nomad_tpu_torch/tensor/kernels.py and
tensor/scatter.py) against the JAX reference on the CPU.

Counts and carry must be exactly equal: the carry is integral float32.
The CUDA kernels themselves run only on the card, where chip_smoke.py
holds each against these same plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.tensor import incremental as ref_incremental
from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu_torch import _ext
from nomad_tpu_torch.tensor import kernels, scatter

N, N_REAL, G, C = 4096, 4000, 16, 64
STANDARD_ASK = (50.0, 32.0, 300.0, 0.0)


def _fixture(variant: str, seed: int):
    rng = np.random.default_rng(seed)
    avail = np.zeros((N, 4), np.float32)
    avail[:N_REAL, 0] = rng.choice([8000, 16000, 32000], N_REAL)
    avail[:N_REAL, 1] = rng.choice([16384, 32768, 65536], N_REAL)
    avail[:N_REAL, 2] = 102400
    avail[:N_REAL, 3] = 12001
    used = np.zeros((N, 4), np.float32)
    fill = rng.integers(0, 60, N_REAL).astype(np.float32)
    used[:N_REAL, :3] = fill[:, None] * np.array([50, 32, 300], np.float32)
    feas = np.zeros((G, N), bool)
    feas[:, :N_REAL] = True
    aff = np.zeros((G, N), np.float32)
    ask = np.tile(np.array(STANDARD_ASK, np.float32), (G, 1))
    k = np.full(G, 4000, np.int32)
    seeds = rng.integers(0, 2 ** 32, G).astype(np.uint32)
    cidx = np.zeros(C, np.int32)
    cdelta = np.zeros((C, 4), np.float32)
    if variant == "k0_padding":
        k[G // 2:] = 0
    elif variant == "zero_ask_dim":
        ask[::2, 1] = 0.0          # memory-free asks
        ask[1::4, 0] = 0.0         # cpu-free asks
    elif variant == "all_infeasible_row":
        feas[3] = False
        feas[9, : N_REAL // 2] = False
    elif variant == "affinity_present":
        aff[:, :N_REAL] = rng.choice([0.0, 0.25, -0.5, 1.0], (G, N_REAL))
    elif variant == "affinity_absent_partial_feas":
        feas[:, :N_REAL] = rng.random((G, N_REAL)) < 0.7
    elif variant == "negative_corrections_clamp":
        rows = rng.choice(N_REAL, C, replace=False)
        cidx[:] = rows
        cdelta[:, :3] = -used[rows, :3] - 500.0
    elif variant == "duplicate_corrections":
        rows = rng.integers(0, N_REAL, 8)
        cidx[:48] = np.repeat(rows, 6)
        cdelta[:48, :3] = rng.integers(-3, 4, (48, 1)) * np.array(
            [50, 32, 300], np.float32)
    elif variant == "near_full_cluster":
        used[:N_REAL, :3] = avail[:N_REAL, :3] - np.array(
            [50, 32, 300], np.float32) * rng.integers(0, 4, (N_REAL, 1))
        used[:N_REAL, 2] = np.minimum(used[:N_REAL, 2], 101000)
    elif variant == "large_asks":
        ask[:] = (4000.0, 8192.0, 300.0, 0.0)
    elif variant == "small_k_ties":
        used[:] = 0.0              # identical nodes: ties everywhere
        avail[:N_REAL, 0] = 16000
        avail[:N_REAL, 1] = 32768
        k[:] = rng.integers(1, 17, G)
    elif variant == "zero_capacity_dims":
        zero = rng.random(N_REAL) < 0.2
        avail[:N_REAL][zero, 1] = 0.0
        used[:N_REAL][zero, 1] = 0.0
        used[:N_REAL][zero[: N_REAL] & (rng.random(N_REAL) < 0.5), 1] = 32.0
        ask[::3, 1] = 0.0
    elif variant == "edge_seeds":
        seeds[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    elif variant == "mixed":
        k[5] = 0
        feas[7] = False
        ask[2, 1] = 0.0
        aff[4, :N_REAL] = rng.choice([0.0, 0.5], N_REAL)
        rows = rng.integers(0, N_REAL, 16)
        cidx[:32] = np.concatenate([rows, rows])
        cdelta[:32, :3] = -1.0e5
    return dict(used=used, avail=avail, feas=feas, aff=aff, ask=ask, k=k,
                seeds=seeds, cidx=cidx, cdelta=cdelta)


VARIANTS = ["baseline", "k0_padding", "zero_ask_dim", "all_infeasible_row",
            "affinity_present", "affinity_absent_partial_feas",
            "negative_corrections_clamp", "duplicate_corrections",
            "near_full_cluster", "large_asks", "small_k_ties",
            "zero_capacity_dims", "edge_seeds", "mixed"]


def _ref_solve(f):
    used, counts = ref_kernels.solve_bulk_multi(
        jnp.asarray(f["used"]), jnp.asarray(f["avail"]),
        jnp.asarray(f["feas"]), jnp.asarray(f["aff"]), jnp.asarray(f["ask"]),
        jnp.asarray(f["k"]), jnp.ones(G, jnp.float32),
        jnp.asarray(f["seeds"]), jnp.asarray(f["cidx"]),
        jnp.asarray(f["cdelta"]), g=G)
    return np.asarray(used), np.asarray(counts)


def _port_args(f):
    return (torch.from_numpy(f["avail"]), torch.from_numpy(f["feas"]),
            torch.from_numpy(f["aff"]), torch.from_numpy(f["ask"]),
            torch.from_numpy(f["k"]), torch.ones(G),
            torch.from_numpy(f["seeds"].astype(np.int64)),
            torch.from_numpy(f["cidx"]), torch.from_numpy(f["cdelta"]))


@pytest.mark.parametrize("i,variant", list(enumerate(VARIANTS)))
def test_solve_bulk_multi_ref_equals_jax(i, variant):
    f = _fixture(variant, seed=100 + i)
    want_used, want_counts = _ref_solve(f)
    used, counts = kernels.solve_bulk_multi_ref(
        torch.from_numpy(f["used"].copy()), *_port_args(f), g=G)
    assert counts.dtype == torch.int16 and want_counts.dtype == np.int16
    assert np.array_equal(counts.numpy(), want_counts), variant
    assert np.array_equal(used.numpy(), want_used), variant
    if variant not in ("all_infeasible_row",):
        assert want_counts.sum() > 0


def test_solve_bulk_multi_on_cpu_runs_the_plain_versions():
    """The dispatching entry point on CPU tensors: same result as the
    plain composition, no kernel launch counted."""
    f = _fixture("mixed", seed=7)
    before = _ext.COUNTS.snapshot()
    used_a, counts_a = kernels.solve_bulk_multi(
        torch.from_numpy(f["used"].copy()), *_port_args(f), g=G)
    used_b, counts_b = kernels.solve_bulk_multi_ref(
        torch.from_numpy(f["used"].copy()), *_port_args(f), g=G)
    assert torch.equal(counts_a, counts_b) and torch.equal(used_a, used_b)
    after = _ext.COUNTS.snapshot()
    assert after["launches"] == before["launches"]
    assert after["plain_on_cuda"] == before["plain_on_cuda"]


def test_kernel_wrappers_reject_unsupported_devices():
    meta = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        kernels.bulk_fill(meta, meta, torch.zeros((1, 8), dtype=torch.bool,
                                                  device="meta"),
                          meta, meta, meta, meta)
    with pytest.raises(ValueError):
        scatter.scatter_add(meta, torch.zeros(2, dtype=torch.int32,
                                              device="meta"),
                            torch.zeros((2, 4), device="meta"))


def _fit_inputs(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    avail = np.stack([rng.choice([0, 8000, 16000, 32000], n),
                      rng.choice([0, 16384, 32768, 65536], n),
                      np.full(n, 102400.0), np.full(n, 12001.0)],
                     1).astype(np.float32)
    used = (rng.integers(0, 400, (n, 1))
            * np.array([[50, 32, 300, 0]])).astype(np.float32)
    used[rng.random(n) < 0.1] = 0.0    # the 0/0 -> free 0 case
    return avail, used


def test_fit_scores_match_reference_numpy():
    """f32 torch vs the reference's f64 numpy formula, normwise
    relative error <= 1e-6. Elementwise relative error is no measure
    here: near an empty node the score is 20 - (10^f0 + 10^f1) with the
    sum close to 20, so an f32 result of ~1e-3 carries a relative error
    of ~1e-5 from one ulp of the sum."""
    avail, used = _fit_inputs()
    want = ref_kernels.fit_scores_np(avail, used)
    got = kernels.fit_scores(torch.from_numpy(avail),
                             torch.from_numpy(used)).numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_fit_scores_np_equals_reference_exactly():
    avail, used = _fit_inputs(seed=1)
    assert np.array_equal(kernels.fit_scores_np(avail, used),
                          ref_kernels.fit_scores_np(avail, used))


def test_scatter_add_ref_equals_reference_scatter():
    rng = np.random.default_rng(3)
    used = rng.integers(0, 5000, (1024, 4)).astype(np.float32)
    b = 256
    idx = rng.integers(0, 1024, b).astype(np.int32)
    idx[10:40] = idx[0]                      # duplicates accumulate
    idx[-32:] = 0                            # (0, 0) padding slots
    delta = rng.integers(-400, 400, (b, 4)).astype(np.float32)
    delta[-32:] = 0.0
    want = np.asarray(ref_incremental._scatter_fn(False)(
        jnp.asarray(used), jnp.asarray(idx), jnp.asarray(delta)))
    got = scatter.scatter_add_ref(torch.from_numpy(used.copy()),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(delta))
    assert np.array_equal(got.numpy(), want)
    # the dispatching wrapper takes the same plain path on CPU tensors
    got2 = scatter.scatter_add(torch.from_numpy(used.copy()),
                               torch.from_numpy(idx), torch.from_numpy(delta))
    assert np.array_equal(got2.numpy(), want)

