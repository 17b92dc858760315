"""The port's entry points (nomad_tpu_torch/graft_entry.py) and B16, the
sharded per-eval scan (tensor/sharding.py ``solve_task_group_sharded``),
against the JAX package on the CPU.

The JAX side runs ``__graft_entry__`` and nomad_tpu/tensor on conftest's 8
virtual CPU devices; the port side runs its plain versions, B16's on a
NodeMesh of S CPU shards. Choices and founds must agree exactly; scores
within 1e-6 (torch's and XLA's f32 ``10**x`` may round 1 ulp apart). The
sharded plain version must equal the port's single-device B9 exactly:
the mesh only changes where the rows live. The CUDA kernel runs only on
the card, where chip_smoke.py holds it against these plain versions and
against B9."""

from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nomad_tpu.tensor import kernels as ref_kernels
from nomad_tpu.tensor import sharding as ref_sharding
from nomad_tpu_torch import _ext, graft_entry
from nomad_tpu_torch.tensor import sharding as sh
from nomad_tpu_torch.tensor.kernels import (pack_solve_tensors,
                                            solve_task_group)

SCORE_ATOL = 1e-6
SHARDS = (1, 2, 4, 8)
F32 = np.float32


def _hazard_args():
    """96 nodes, K 32: an explicit-target spread with a zero and a
    missing desired count beside an even spread with missing values;
    distinct_hosts on the group; a binding distinct_property limit;
    penalty and inactive steps; 48 identical nodes under a shuffled
    tie_perm, so equal scores cross shard boundaries; and fewer fitting
    nodes than steps, so the last steps find nothing."""
    rng = np.random.RandomState(7)
    n, k = 96, 32
    args = list(graft._example_solve_args(n_nodes=n, k=k, s=2, v=6))
    args[0][:48] = [4000.0, 8192.0, 102400.0, 12001.0]
    args[1][:48] = [500.0, 1024.0, 0.0, 0.0]
    args[2][rng.rand(n) < 0.1] = 1                       # placed_tg0
    args[5] = rng.rand(n) < 0.6                          # feasible
    args[6] = np.where(rng.rand(n) < 0.2, 0.5, 0.0).astype(F32)
    args[8][[1, 5, 9]] = [3, 50, 77]                     # penalty rows
    args[9][[4, 12]] = False                             # inactive steps
    args[11][1, ::7] = False                             # missing values
    args[12][0] = [2, 0, 0, 1, 0, 0]
    args[13][0] = [10.0, 0.0, np.nan, 5.0, 8.0, 3.0]
    args[14] = np.array([True, False])
    args[15] = np.array([0.7, 0.3], F32)
    args[16] = rng.randint(0, 4, (1, n)).astype(np.int32)
    args[17] = rng.rand(1, n) > 0.05
    args[18] = np.array([[1, 0, 2, 0]], np.int32)
    args[19] = np.array([6.0], F32)                      # binding
    args[23] = np.bool_(True)                            # dh_tg
    args[25] = rng.permutation(n).astype(np.int32)
    return tuple(args)


# tests/test_sharding.py's TestShardedSolve fixtures, and the hazards
FIXTURES = {
    "n96_s2": lambda: graft._example_solve_args(n_nodes=96, k=16, s=2, v=4),
    "n64_k32": lambda: graft._example_solve_args(n_nodes=64, k=32),
    "n64": lambda: graft._example_solve_args(n_nodes=64),
    "n100_padded": lambda: graft._example_solve_args(n_nodes=100, k=8),
    "hazard": _hazard_args,
}


def _np(out):
    return tuple(np.asarray(o) for o in out)


def _port_np(out):
    return tuple(o.cpu().numpy() for o in out)


def _assert_same(got, want, what):
    gc, gf, gs = got
    wc, wf, ws = want
    np.testing.assert_array_equal(gc, wc, f"{what}: choices")
    np.testing.assert_array_equal(gf, wf, f"{what}: founds")
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL,
                               err_msg=f"{what}: scores")


@pytest.fixture(scope="module")
def jax_sharded(eight_devices):
    """JAX solve_task_group_sharded per (fixture, S), computed once."""
    cache = {}

    def run(name, s):
        if (name, s) not in cache:
            mesh = ref_sharding.node_mesh(eight_devices[:s])
            cache[name, s] = _np(ref_sharding.solve_task_group_sharded(
                mesh, FIXTURES[name]()))
        return cache[name, s]
    return run


@pytest.mark.parametrize("shape", [(64, 16, 1, 4), (96, 16, 2, 4),
                                   (100, 8, 1, 4), (64, 8, 1, 4),
                                   (32, 8, 1, 4)])
def test_example_solve_args_equal_the_reference(shape):
    n, k, s, v = shape
    got = graft_entry._example_solve_args(n_nodes=n, k=k, s=s, v=v)
    want = graft._example_solve_args(n_nodes=n, k=k, s=s, v=v)
    assert len(got) == len(want) == 26
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pack_solve_tensors_equals_pack_solve_args(name):
    """The port's one packer, from tensors, gives the reference's
    pack_solve_args arrays."""
    args = FIXTURES[name]()
    (avail, used, ptg, pjob, ask, feas, aff, dev_aff, pen, active, svid, sok,
     scnt, sdes, has_t, weight, dvid, dok, dcnt, dlim, lowest, tg, dh_job,
     dh_tg, alg, tie_perm) = args
    want = ref_kernels.pack_solve_args(
        avail, used, ptg, pjob, ask, feas, aff, pen, active, svid, sok, scnt,
        sdes, has_t, weight, lowest, tg, dh_job, dh_tg, alg,
        dev_affinity=dev_aff, dp_val_id=dvid, dp_val_ok=dok, dp_counts0=dcnt,
        dp_limit=dlim, tie_perm=tie_perm)
    got = pack_solve_tensors(*(torch.as_tensor(a) for a in args[:25]),
                             node_col=torch.as_tensor(tie_perm))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_solve_task_group_matches_jax(name):
    args = FIXTURES[name]()
    want = _np(ref_kernels.solve_task_group(*args))
    got = _port_np(solve_task_group(*args, device="cpu"))
    assert got[0].dtype == np.int32 and got[1].dtype == np.bool_
    _assert_same(got, want, name)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_sharded_plain_matches_jax(name, s, jax_sharded):
    _ext.COUNTS.reset()
    got = _port_np(sh.solve_task_group_sharded(sh.NodeMesh(["cpu"] * s),
                                               FIXTURES[name]()))
    _assert_same(got, jax_sharded(name, s), f"{name} S={s}")
    assert _ext.COUNTS.launches["task_group_shard"] == 0


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_sharded_plain_equals_single_device(name, s):
    args = FIXTURES[name]()
    got = sh.solve_task_group_sharded(sh.NodeMesh(["cpu"] * s), args)
    want = solve_task_group(*args, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), name


def test_hazard_fixture_exercises_its_hazards():
    args = _hazard_args()
    c, f, s = _port_np(solve_task_group(*args, device="cpu"))
    assert f[:4].all() and not f[-4:].any()     # steps that find nothing
    assert not f[4] and not f[12]                # the inactive steps
    assert len(set(c[f].tolist())) == int(f.sum())   # distinct_hosts
    limit = int(args[19][0])
    dp = np.bincount(args[16][0][c[f]], minlength=4) + args[18][0]
    assert dp.max() == limit                     # the limit binds
    tied = c[f][c[f] < 48]
    assert len(tied) >= 2                        # identical nodes won


@pytest.mark.parametrize("s", (2, 4, 8))
def test_shard_solve_args_layout(s):
    args = graft_entry._example_solve_args(n_nodes=100, k=8)
    mesh = sh.NodeMesh(["cpu"] * s)
    parts = sh.shard_solve_args(mesh, args)
    padded = sh.pad_node_axis(args, s)
    n_pad = -(-100 // s) * s
    n_loc = n_pad // s
    assert len(parts) == 26
    for i, p in enumerate(parts):
        assert len(p) == s
        for part, dev in zip(p, mesh.devices):
            assert part.device == dev
        if i in sh.SOLVE_ROWS:
            assert {q.shape[0] for q in p} == {n_loc}
        elif i in sh.SOLVE_COLS:
            assert {q.shape[-1] for q in p} == {n_loc}
        else:
            for q in p:
                np.testing.assert_array_equal(q.numpy(), padded[i].numpy())
    pad = n_pad - 100
    feas = torch.cat(parts[5])
    assert feas[:100].all() and not feas[100:].any()
    assert not torch.cat(parts[11], dim=1)[:, 100:].any()
    assert not torch.cat(parts[0])[100:].any()
    tie_perm = parts[25][0]
    assert tie_perm.tolist() == list(range(100 + pad))


def test_pad_node_axis_puts_dummies_last_in_tie_perm():
    args = list(graft_entry._example_solve_args(n_nodes=13, k=4))
    args[25] = np.random.RandomState(3).permutation(13).astype(np.int32)
    padded = sh.pad_node_axis(tuple(args), 8)
    want = ref_sharding.pad_node_axis(tuple(args), 8)
    for g, w in zip(padded, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert padded[25][13:].tolist() == [13, 14, 15]


def test_dryrun_body_on_the_cpu():
    _ext.COUNTS.reset()
    graft_entry._dryrun_body(8, device="cpu")
    counts = _ext.COUNTS.snapshot()
    assert counts["launches"]["task_group_shard"] == 0
    assert counts["plain_on_cuda"]["task_group_shard"] == 0


def test_entry_shapes_equal_the_reference():
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    ref_fn, ref_args = graft.entry()
    want = _np(ref_fn(*ref_args))
    assert [tuple(o.shape) for o in got] == [o.shape for o in want]
    _assert_same(_port_np(got), want, "entry")


def test_dryrun_multichip_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: dryrun_multichip runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        graft_entry.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        graft_entry.entry()


def test_shard_mesh_places_shards():
    """n CPU shards when asked for the CPU; without a card the default
    (the card) raises rather than falling back."""
    assert sh.shard_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device found"):
            sh.shard_mesh(2)


def test_every_launch_makes_its_device_current():
    """A shard's launch on a second card needs that card current: every
    wrapper goes through _ext.launch, the one place that reads a stream
    handle."""
    root = Path(graft_entry.__file__).parent
    readers = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                     if "_cuda_getCurrentRawStream" in p.read_text()
                     or ".cuda_stream" in p.read_text())
    assert readers == ["_ext.py"]
