"""The port's entry points (reference ``__graft_entry__.py``).

The flagship program is the per-eval placement scan (B9,
``tensor/kernels.py``): K steps that score every node for one placement
and commit the best.

- :func:`entry`: the single-device scan and example arguments for it;
- :func:`dryrun_multichip`: the same scan with its node rows sharded
  over an n-shard :class:`NodeMesh` (B16, one global argmax a step), and
  the sharded bulk fill (B13) against its single-device kernel (B1).

Both run on the card unless the caller passes ``device="cpu"``, and raise
without one; ``sharding.shard_mesh`` puts the shards on the visible
cards in turn, so one card holds n shards, each with its own parts and
launches.

    python -c "from nomad_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve
from .tensor.kernels import solve_bulk_multi, solve_task_group
from .tensor.sharding import (NodeMesh, shard_bulk_state, shard_cols,
                              shard_mesh, solve_bulk_multi_sharded,
                              solve_task_group_sharded)


def _example_solve_args(n_nodes: int = 64, k: int = 16, s: int = 1,
                        v: int = 4):
    """Small arrays for the solve, the reference's own: a mixed cluster,
    one task group asking 500 MHz / 256 MB, one even-spread attribute."""
    rng = np.random.RandomState(0)
    f = np.float32
    available = np.stack([
        rng.choice([2000, 4000, 8000], n_nodes),
        rng.choice([4096, 8192], n_nodes),
        np.full(n_nodes, 100 * 1024),
        np.full(n_nodes, 12001),       # dynamic port slots (R_PORTS dim)
    ], axis=1).astype(f)
    used0 = np.zeros((n_nodes, 4), f)
    used0[:, 0] = rng.randint(0, 1000, n_nodes)
    used0[:, 1] = rng.randint(0, 2048, n_nodes)
    ask = np.array([500.0, 256.0, 0.0, 2.0], f)
    p = 1  # one distinct_property cap table (high limit: never binding here)
    return (
        available,
        used0,
        np.zeros(n_nodes, np.int32),                      # placed_tg0
        np.zeros(n_nodes, np.int32),                      # placed_job0
        ask,
        np.ones(n_nodes, bool),                           # feasible
        np.zeros(n_nodes, f),                             # affinity_boost
        np.zeros(n_nodes, f),                             # dev_affinity
        np.full(k, -1, np.int32),                         # penalty_idx
        np.ones(k, bool),                                 # active
        rng.randint(0, v, (s, n_nodes)).astype(np.int32),  # spread_val_id
        np.ones((s, n_nodes), bool),                      # spread_val_ok
        np.zeros((s, v), np.int32),                       # spread_counts0
        np.full((s, v), np.nan, f),                       # spread_desired
        np.zeros(s, bool),                                # spread_has_targets
        np.full(s, 1.0, f),                               # spread_weight
        rng.randint(0, v, (p, n_nodes)).astype(np.int32),  # dp_val_id
        np.ones((p, n_nodes), bool),                      # dp_val_ok
        np.zeros((p, v), np.int32),                       # dp_counts0
        np.full(p, 1e9, f),                               # dp_limit
        f(-1.0),                                          # lowest_boost0
        f(k),                                             # tg_count
        np.bool_(False),                                  # dh_job
        np.bool_(False),                                  # dh_tg
        np.bool_(False),                                  # spread_alg
        np.arange(n_nodes, dtype=np.int32),               # tie_perm
    )


def entry(device: DeviceLike = None):
    """-> (solve_task_group, its example arguments as tensors on the
    device); ``fn(*args)`` runs B9 there."""
    dev = resolve(device)
    return solve_task_group, tuple(torch.as_tensor(a).to(dev)
                                   for a in _example_solve_args())


def _dryrun_body(n_shards: int, device: DeviceLike = None) -> None:
    """The multi-shard step, with every check of the reference's body."""
    mesh = shard_mesh(n_shards, device)

    n_nodes = max(8 * n_shards, 32)
    args = _example_solve_args(n_nodes=n_nodes, k=8)
    choices, founds, scores = (t.cpu().numpy() for t in
                               solve_task_group_sharded(mesh, args))

    assert founds.all(), "dryrun: every placement should fit"
    assert (choices >= 0).all() and (choices < n_nodes).all()
    assert np.isfinite(scores).all()
    # sequential greedy must not oversubscribe any node
    ask, avail, used = args[4], args[0], args[1]
    per_node = np.bincount(choices, minlength=n_nodes)
    assert ((used + per_node[:, None] * ask[None, :]) <= avail + 1e-3).all()

    # sharded and single-shard solves agree: the mesh only changes where
    # the rows live
    single = NodeMesh(mesh.devices[:1])
    c1, f1, s1 = (t.cpu().numpy() for t in
                  solve_task_group_sharded(single, args))
    assert (c1 == choices).all() and (f1 == founds).all()
    assert np.allclose(s1, scores, atol=1e-6)

    # the bulk engine on the mesh (the C2M path): sharded greedy fill
    # (B13) against the single-device fill (B1), exact counts and no
    # oversubscription
    rng = np.random.RandomState(1)
    n, d, g = max(16 * n_shards, 64), 4, 4
    f32 = np.float32
    avail = np.zeros((n, d), f32)
    avail[:, 0] = rng.choice([2000, 4000, 8000], n)
    avail[:, 1] = rng.choice([4096, 8192], n)
    used0 = np.zeros((n, d), f32)
    feas = rng.rand(g, n) > 0.2
    aff = np.zeros((g, n), f32)
    ask2 = np.tile(np.array([500.0, 256.0, 0.0, 0.0], f32), (g, 1))
    dev0 = mesh.devices[0]

    def on(x, dtype=None):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev0)

    kk = on(np.full(g, 16), torch.int32)
    seeds = on(np.arange(g), torch.int64)
    cidx = on(np.zeros(8), torch.int32)
    cdelta = on(np.zeros((8, d), f32))
    us, av = shard_bulk_state(mesh, on(used0), on(avail))
    us, c8, _ = solve_bulk_multi_sharded(
        mesh, us, av, shard_cols(mesh, torch.as_tensor(feas)),
        shard_cols(mesh, torch.as_tensor(aff)), on(ask2), kk, seeds, cidx,
        cdelta, g=g)
    c8 = torch.cat([c.cpu() for c in c8], dim=1).numpy()
    u8 = torch.cat([u.cpu() for u in us]).numpy()
    _, c1b = solve_bulk_multi(on(used0), on(avail), on(feas), on(aff),
                              on(ask2), kk, on(np.ones(g, f32)), seeds,
                              cidx, cdelta, g=g)
    assert (c8 == c1b.cpu().numpy()).all(), "sharded bulk counts diverge"
    assert (u8 <= avail + 1e-3).all(), "sharded bulk oversubscribed"


def dryrun_multichip(n_shards: int, device: DeviceLike = None) -> None:
    """The placement step with its node rows sharded over ``n_shards``
    shards, on the card (the visible cards in turn, one card holding
    several shards) or, when asked, the CPU; raises without a card. It
    never moves to the CPU by itself, as the reference's re-execution on
    a virtual CPU mesh does."""
    _dryrun_body(n_shards, device)


if __name__ == "__main__":
    fn, ex = entry()
    out = fn(*ex)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
    print("dryrun_multichip ok")
