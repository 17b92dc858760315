"""The node-sharded solve (reference ``nomad_tpu/tensor/sharding.py``).

The long axis of the workload is nodes. A :class:`NodeMesh` is one
controller process and an ordered list of S devices; shard s owns the
global node rows ``[s * n_loc, (s + 1) * n_loc)``, ``n_loc = N / S``,
and holds them on ``devices[s]``. A sharded array is a list of S
per-shard *parts*: rows ``(n_loc, ...)`` of an (N, ...) array, or
columns ``(..., n_loc)`` of a (G, N) array. The list may repeat a
device: that is how one card holds S shards, as the reference's tests
hold them on virtual CPU devices; each shard keeps its own parts and
launches all the same, so one card runs the layout of S cards.

Four programs run on a mesh, each a per-shard body plus the one
collective, :func:`all_gather`:

- B15 :func:`state_scatter_sharded` (``:144-179``): ``used[idx] +=
  delta`` with each shard adding only the rows it owns;
- B13 :func:`solve_bulk_multi_sharded` (``:198-365``): the greedy bulk
  fill. Per eval, rounds of a distributed top-R: each shard surfaces its
  R best (key, cap, global id) candidates, the pools are all-gathered
  and merged by (key desc, global id asc), and every candidate above the
  best-covered shard's worst entry is consumed in that order until the
  budget is spent;
- B14 :func:`solve_batch_sharded` (``:368-629``): the joint auction
  portfolio against that greedy arm. Per auction round each shard bids
  over its own nodes and surfaces each eval's top 16, one all-gather
  merges them to each eval's exact global top 16, and winners, fills and
  price bumps follow as in the single-device auction; each shard applies
  its own rows. The arm scores sum the per-node contributions in the
  global node order by the fixed pairwise tree, so every layout picks
  alike;
- B16 :func:`solve_task_group_sharded` (``:107-122``): the per-eval scan
  B9 with its rows sharded. Per placement each shard scores its rows and
  surfaces its best (score desc, tie-break position asc) with the value
  ids and flags the commit needs, one all-gather, and every shard takes
  the same global best: its owner commits the usage, every shard the
  replicated value counts. Choices, founds and scores equal B9's.

Each has a plain torch version (``*_ref``) that follows the reference's
per-shard body step by step with explicit gathers; the replicated math
after a gather is computed once, since every shard would compute the
same. On CUDA the wrappers launch ``csrc/sharded.cu`` (B16
``csrc/task_group_shard.cu``). B15 is one host call that launches once a
shard. B13 and B14 (after B15's correction fold) and B16 are one host
call each, which makes one cooperative launch a card: every round (B16:
every step) runs inside it, each shard's CTA stores its pool row (B16:
its candidate) straight into every shard's buffer and waits on the
device-side barrier of ``csrc/mesh.cuh``, and the host reads no flag, so
a solve returns as soon as it is queued. :func:`all_gather` serves the
plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, List, Sequence

import torch

from .. import _ext
from ..device import DeviceLike, resolve
from .batch_solver import (MAX_ROUNDS, PORTFOLIO, TOP_R, _jitter_his,
                           _price_eps, bid_scores, resolve_round, topr_ref)
from .kernels import (MAX_FILL_NODES, NEG, TIE_JITTER, _check_cuda, _layout,
                      fill_score_cap, fit_scores, pack_solve_tensors,
                      pairwise_sum_ref, preempt_score_ref, score_nodes_ref)
from .prng import _span, jitter_fold_ref, jitter_ref

MAX_SHARDS = 64
# the barrier words of B13's and B14's launches (csrc/mesh.cuh): one group
# a line of GROUP_WORDS int32: B13's one group, or B14's all-CTA join,
# greedy arm and one a restart
GROUP_WORDS = 32
MESH_GROUPS = 2 + len(PORTFOLIO)
MAX_MERGE = 2048     # gathered B13 pool entries one merge CTA sorts
MAX_PICK_NODES = 32768  # nodes the B14 pick's pairwise tree holds
# one host thread at a time issues the cooperative launches of a mesh
# that spans cards (B13, B14, B16): two solves whose launches reached two
# cards in opposite orders would each wait on the other's barrier
_MESH_LAUNCH_LOCK = threading.Lock()


class NodeMesh:
    """S node shards over an ordered device list (repeats allowed)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("NodeMesh: no devices")
        self.devices = tuple(resolve(d) for d in devices)
        self.size = len(self.devices)
        if self.size > MAX_SHARDS:
            raise ValueError(f"NodeMesh: at most {MAX_SHARDS} shards")
        self.distinct = tuple(dict.fromkeys(self.devices))
        self.cards = len(self.distinct)
        # the shards' card ordinals (-1 on the CPU), and as the C array
        # B15's host call takes
        self.indices = tuple(-1 if d.index is None else d.index
                             for d in self.devices)
        self.ordinals = (ctypes.c_int * self.size)(*self.indices)
        # each shard's place in ``distinct`` and the distinct cards'
        # ordinals, as the C arrays B13's and B14's host calls take
        self.card_of = (ctypes.c_int * self.size)(
            *[self.distinct.index(d) for d in self.devices])
        self.card_ordinals = (ctypes.c_int * self.cards)(
            *[-1 if d.index is None else d.index for d in self.distinct])
        self._words: Dict[tuple, torch.Tensor] = {}
        self._words_lock = threading.Lock()

    def barrier_words(self, device: torch.device) -> torch.Tensor:
        """The barrier words of B13's and B14's launches on this mesh from
        the cards' current streams, on ``device`` (shard 0's): zeroed
        once, when first asked for, and kept. Every barrier leaves them as
        it found them (csrc/mesh.cuh), so launches in stream order share
        them with no reset; launches from other streams get words of
        their own."""
        raw_stream = _ext._cuda()[2]
        key = tuple(raw_stream(d.index) for d in self.distinct)
        words = self._words.get(key)
        if words is None:
            with self._words_lock:
                words = self._words.get(key)
                if words is None:
                    words = torch.zeros(MESH_GROUPS * GROUP_WORDS,
                                        dtype=torch.int32, device=device)
                    if self.cards > 1 and device.type == "cuda":
                        # the other cards' launches read them at once
                        torch.cuda.synchronize(device)
                    self._words[key] = words
        return words

    def n_loc(self, n: int) -> int:
        if n % self.size:
            raise ValueError(f"{n} nodes do not divide over {self.size} "
                             f"shards")
        return n // self.size

    def __repr__(self) -> str:
        return f"NodeMesh({', '.join(map(str, self.devices))})"


def shard_mesh(n_shards: int, device: DeviceLike = None) -> NodeMesh:
    """n shards on the CPU, or on the visible cards in turn (one card
    holds them all)."""
    dev = resolve(device)
    if dev.type == "cpu":
        return NodeMesh([dev] * n_shards)
    cards = torch.cuda.device_count()
    return NodeMesh([torch.device("cuda", i % cards)
                     for i in range(n_shards)])


def shard_rows(mesh: NodeMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """(N, ...) rows -> the shards' parts, each on its device."""
    n_loc = mesh.n_loc(x.shape[0])
    return [x[s * n_loc:(s + 1) * n_loc].to(dev, non_blocking=True)
            .contiguous() for s, dev in enumerate(mesh.devices)]


def shard_cols(mesh: NodeMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """(..., N) columns -> the shards' parts, each on its device."""
    n_loc = mesh.n_loc(x.shape[-1])
    return [x[..., s * n_loc:(s + 1) * n_loc].to(dev, non_blocking=True)
            .contiguous() for s, dev in enumerate(mesh.devices)]


def shard_bulk_state(mesh: NodeMesh, used0, available):
    """The bulk carry and capacity as float32 row parts."""
    return (shard_rows(mesh, torch.as_tensor(used0, dtype=torch.float32)),
            shard_rows(mesh, torch.as_tensor(available,
                                             dtype=torch.float32)))


def replicate(mesh: NodeMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """One copy of ``x`` for each shard, on its device (no copy where
    ``x`` already lies)."""
    return [x.to(dev, non_blocking=True) for dev in mesh.devices]


def gather_rows(parts: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The parts put together along ``dim`` on the first part's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def all_gather(mesh: NodeMesh, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The one collective. ``bufs`` holds one (S, ...) buffer per shard,
    on its device, and shard s has written row s of its own. Every
    buffer gets the other rows copied in. Where the shards lie on more
    than one card, every card's stream waits on every other's before the
    copies (no row is read before it is written) and after them (no
    shard's next launch overwrites its row before the others have copied
    it, and none reads its buffer before the copies into it are done);
    torch's peer copies order some of this on their own, the barriers
    do not rely on it. On one card every launch and copy shares a
    stream."""
    cards = [d for d in mesh.distinct if d.type == "cuda"]
    if len(cards) > 1:
        _barrier(cards)
    for d, (dev, dst) in enumerate(zip(mesh.devices, bufs)):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            for q, src in enumerate(bufs):
                if q != d:
                    dst[q].copy_(src[q], non_blocking=True)
    if len(cards) > 1:
        _barrier(cards)
    return bufs


def _barrier(cards) -> None:
    """Each card's current stream waits on every other card's."""
    done = {}
    for dev in cards:
        done[dev] = torch.cuda.Event()
        done[dev].record(torch.cuda.current_stream(dev))
    for dev in cards:
        stream = torch.cuda.current_stream(dev)
        for src, ev in done.items():
            if src != dev:
                stream.wait_event(ev)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def state_scatter_sharded_ref(mesh: NodeMesh, used: List[torch.Tensor],
                              idx: torch.Tensor, delta: torch.Tensor, *,
                              clamp: bool = False) -> List[torch.Tensor]:
    """Plain version of B15 (``make_state_scatter_sharded``), in place:
    each shard masks off-shard rows to a zero delta and clips the index
    local; with ``clamp`` (the B13/B14 correction fold) the shard's rows
    are then clamped at 0."""
    _ext.COUNTS.plain("scatter_shard", used[0])
    for s, rows in enumerate(used):
        n_loc = rows.shape[0]
        dev = rows.device
        local = idx.to(dev, torch.int64) - s * n_loc
        own = (local >= 0) & (local < n_loc)
        safe = local.clamp(0, n_loc - 1)
        rows.index_add_(0, safe, torch.where(own[:, None], delta.to(dev),
                                             0.0))
        if clamp:
            rows.clamp_min_(0.0)
    return used


def _lexsort_desc(keys: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Order of the last axis by key descending, global id ascending on
    equal keys, -0.0 equal to +0.0: ``jnp.lexsort((gids, -keys))`` and
    the two-key ``lax.sort`` of the reference."""
    o1 = torch.argsort(gids, dim=-1, stable=True)
    k1 = torch.gather(keys, -1, o1)
    o2 = torch.argsort(-k1 + 0.0, dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _bulk_body_ref(mesh, used, avail, feas, aff, ask, k, seeds, *, g, top_r):
    """B13's per-shard body after the fold (sharding.py:222-315) on the
    row parts ``used`` (updated in place). Returns (counts parts (G, *)
    int16, rounds (G,) int32)."""
    s_n = mesh.size
    dev0 = used[0].device
    n_loc = used[0].shape[0]
    r = min(top_r, n_loc)
    jits = [jitter_ref(seeds.to(dev), n_loc, TIE_JITTER, offset=s * n_loc)
            for s, dev in enumerate(mesh.devices)]
    counts = [torch.zeros((g, n_loc), dtype=torch.int16, device=dev)
              for dev in mesh.devices]
    rounds = torch.zeros(g, dtype=torch.int32, device=dev0)
    pools = [torch.zeros((s_n, 3, r), dtype=torch.float32, device=dev)
             for dev in mesh.devices]
    for e in range(g):
        budget = int(k[e])
        keys, caps, takes = [], [], []
        for s, dev in enumerate(mesh.devices):
            # the eval's start (sharding.py:223-249)
            score, cap = fill_score_cap(used[s], avail[s], feas[s][e],
                                        aff[s][e], ask[e].to(dev),
                                        k[e].to(dev))
            keys.append(score + jits[s][e])
            caps.append(cap.to(torch.int32))
            takes.append(torch.zeros(n_loc, dtype=torch.int32, device=dev))
        rnd, go = 0, budget > 0
        while go:
            for s in range(s_n):
                masked = torch.where(caps[s] > 0, keys[s], NEG)
                vals, loc = topr_ref(masked, r)
                pools[s][s] = torch.stack([
                    vals, caps[s][loc].to(torch.float32),
                    (loc + s * n_loc).to(torch.float32)])
            all_gather(mesh, pools)
            p = pools[0]
            keys_all = p[:, 0, :].reshape(-1)
            caps_all = p[:, 1, :].reshape(-1).to(torch.int32)
            gidx_all = p[:, 2, :].reshape(-1).to(torch.int64)
            thresh = p[:, 0, r - 1].max()
            order = _lexsort_desc(keys_all, gidx_all)
            keys_s = keys_all[order]
            caps_s = caps_all[order]
            eligible = keys_s > thresh
            eligible[0] = keys_s[0] > NEG
            caps_e = torch.where(eligible, caps_s, 0)
            cum = torch.cumsum(caps_e, 0, dtype=torch.int32)
            take_s = torch.minimum(torch.clamp_min(
                budget - (cum - caps_e), 0), caps_e)
            consumed = int(take_s.sum())
            take_c = torch.zeros_like(caps_all)
            take_c[order] = take_s
            elig_c = torch.zeros_like(eligible)
            elig_c[order] = eligible
            for s in range(s_n):
                dev = takes[s].device
                pos = gidx_all.to(dev) - s * n_loc
                mine = (pos >= 0) & (pos < n_loc)
                takes[s].index_add_(0, pos[mine], take_c.to(dev)[mine])
                caps[s][pos[mine & elig_c.to(dev)]] = 0
            budget -= consumed
            rnd += 1
            go = budget > 0 and bool(keys_s[0] > NEG) and consumed > 0
        for s, rows in enumerate(used):
            rows += ask[e].to(rows.device)[None, :] * takes[s][:, None].to(
                torch.float32)
            counts[s][e] = takes[s].to(torch.int16)
        rounds[e] = rnd
    return counts, rounds


def solve_bulk_multi_sharded_ref(mesh, used, avail, feas, aff, ask, k, seeds,
                                 cidx, cdelta, *, g: int, top_r: int = 64):
    """Plain version of :func:`solve_bulk_multi_sharded`, step by step
    the reference's ``_bulk_shard_body``. Updates the ``used`` parts in
    place."""
    _ext.COUNTS.plain("bulk_shard", used[0])
    state_scatter_sharded_ref(mesh, used, cidx, cdelta, clamp=True)
    counts, rounds = _bulk_body_ref(mesh, used, avail, feas, aff, ask, k,
                                    seeds, g=g, top_r=top_r)
    return used, counts, rounds


def _det_score_ref(mesh, avail, used, take):
    """``det_score`` of an arm's carry and (G, N) take parts: per-node
    placed x fitness, gathered in global node order and summed by the
    pairwise tree; placed is an integer psum."""
    contrib, placed = [], 0
    for t, a, u in zip(take, avail, used):
        node = t.to(torch.int32).sum(dim=0, dtype=torch.int32)
        placed += int(node.sum())
        contrib.append((node.to(torch.float32) * fit_scores(a, u)).to(
            mesh.devices[0]))
    return pairwise_sum_ref(torch.cat(contrib)), placed


def _auction_sharded_ref(mesh, used0, avail, avail_cap, feas, aff, ask, k,
                         jits, pscore, *, g, rounds, price_eps):
    """One portfolio restart of ``_joint_body`` (sharding.py:452-541).
    ``used0`` is left alone. Returns (used parts, take parts (G, *)
    int32, rounds run)."""
    s_n = mesh.size
    n_loc = used0[0].shape[0]
    n = n_loc * s_n
    dev0 = used0[0].device
    r_loc = min(TOP_R, n_loc)
    r_glob = min(TOP_R, n)
    f = torch.float32
    used = [u.clone() for u in used0]
    take = [torch.zeros((g, u.shape[0]), dtype=torch.int32, device=u.device)
            for u in used0]
    price = torch.zeros(n, dtype=f, device=dev0)
    remaining = k.to(dev0, torch.int32).clone()
    g_idx = torch.arange(g, device=dev0)
    pools = [torch.zeros((s_n, 3, g, r_loc), dtype=f, device=dev)
             for dev in mesh.devices]
    rnd, progressed = 0, True
    while rnd < rounds and progressed and bool((remaining > 0).any()):
        for s, (u, dev) in enumerate(zip(used, mesh.devices)):
            cap_s = avail_cap[s]
            a_s = ask.to(dev)
            ok, score = bid_scores(
                u, avail[s], cap_s, feas[s], aff[s], a_s, remaining.to(dev),
                None if pscore is None else pscore[s])
            price_loc = price[s * n_loc:(s + 1) * n_loc].to(dev)
            bid = torch.where(ok, score + jits[s] - price_loc[None, :], NEG)
            lvals, lidx = topr_ref(bid, r_loc)                       # (G, RL)
            free = cap_s[lidx] - u[lidx]                             # (G,RL,D)
            ask_pos = a_s > 0
            per_dim = torch.where(
                ask_pos[:, None, :],
                torch.floor(free / torch.where(ask_pos, a_s, 1.0)[:, None, :]),
                float("inf"))
            lcap = torch.clamp_min(per_dim.amin(dim=2), 0.0)
            pools[s][s] = torch.stack([lvals, lcap,
                                        (lidx + s * n_loc).to(f)])
        all_gather(mesh, pools)
        # each eval's exact global top r_glob (value desc, id asc), then
        # the round resolved over the replicated boards
        p = pools[0]
        vals_m = p[:, 0].permute(1, 0, 2).reshape(g, -1)
        caps_m = p[:, 1].permute(1, 0, 2).reshape(g, -1)
        gids_m = p[:, 2].permute(1, 0, 2).reshape(g, -1).to(torch.int64)
        order = _lexsort_desc(vals_m, gids_m)
        vals = torch.gather(vals_m, 1, order)[:, :r_glob]
        gids = torch.gather(gids_m, 1, order)[:, :r_glob]
        caps = torch.gather(caps_m, 1, order)[:, :r_glob]
        amt, bump = resolve_round(vals, gids, caps, remaining, n)
        for s, (u, dev) in enumerate(zip(used, mesh.devices)):
            pos = gids.to(dev) - s * n_loc
            mine = (pos >= 0) & (pos < n_loc)
            posc = pos.clamp(0, n_loc - 1)
            amt_mine = torch.where(mine, amt.to(dev), 0)
            u.index_add_(0, posc.reshape(-1), (
                ask.to(dev)[:, None, :] * amt_mine[..., None].to(f)
            ).reshape(-1, u.shape[1]))
            take[s].index_put_((g_idx.to(dev)[:, None].expand(g, r_glob), posc),
                          amt_mine, accumulate=True)
        remaining = remaining - amt.sum(dim=1, dtype=torch.int32)
        price = price + price_eps * bump.to(f)
        rnd += 1
        progressed = bool((amt > 0).any())
    return used, take, rnd


def solve_batch_sharded_ref(mesh, used, avail, feas, aff, ask, k, seeds,
                            cidx, cdelta, evict=None, net_prio=None, *,
                            g: int, rounds: int = MAX_ROUNDS,
                            top_r: int = 64):
    """Plain version of :func:`solve_batch_sharded`, step by step the
    reference's ``_joint_body``. The ``used`` parts take the correction
    fold in place; the returned carry parts are new tensors. Returns
    (used parts, counts parts (G, *) int16, info (6,), gathers)."""
    _ext.COUNTS.plain("joint_shard", used[0])
    dev0 = used[0].device
    state_scatter_sharded_ref(mesh, used, cidx, cdelta, clamp=True)
    used_g = [u.clone() for u in used]
    counts_g, rounds_g = _bulk_body_ref(mesh, used_g, avail, feas, aff, ask,
                                        k, seeds, g=g, top_r=top_r)
    gathers = int(rounds_g.sum())
    avail_cap = (avail if evict is None
                 else [a + e for a, e in zip(avail, evict)])
    pscore = (None if net_prio is None
              else [preempt_score_ref(p) for p in net_prio])
    n_loc = used[0].shape[0]
    jits_all = [jitter_fold_ref(seeds.to(dev), n_loc, _jitter_his(),
                                offset=s * n_loc)
                for s, dev in enumerate(mesh.devices)]
    best = None
    for t, eps in enumerate(_price_eps()):
        used_t, take_t, rnd_t = _auction_sharded_ref(
            mesh, used, avail, avail_cap, feas, aff, ask, k,
            [j[t] for j in jits_all], pscore, g=g, rounds=rounds,
            price_eps=eps)
        gathers += rnd_t + 1
        score_t, placed_t = _det_score_ref(mesh, avail, used_t, take_t)
        if best is None or placed_t > best[3] or (
                placed_t == best[3] and bool(score_t > best[2])):
            best = (used_t, take_t, score_t, placed_t, rnd_t)
    used_a, take, score_a, placed_a, rnd = best
    score_g, placed_g = _det_score_ref(mesh, avail, used_g, counts_g)
    gathers += 1
    pick_a = placed_a > placed_g or (placed_a == placed_g
                                     and bool(score_a > score_g))
    if pick_a:
        out_used, out_counts = used_a, [t.to(torch.int16) for t in take]
    else:
        out_used, out_counts = used_g, counts_g
    info = torch.tensor([float(score_a), float(score_g), float(placed_a),
                         float(placed_g), float(rnd), float(pick_a)],
                        dtype=torch.float32).to(dev0)
    return (out_used, out_counts, info,
            torch.tensor(gathers, dtype=torch.int32, device=dev0))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _is_cpu(mesh: NodeMesh) -> bool:
    if all(d.type == "cpu" for d in mesh.devices):
        return True
    if any(d.type != "cuda" for d in mesh.devices):
        raise ValueError(f"unsupported mesh {mesh}")
    return False


def _check_parts(what, mesh, name, parts, dtype, shape):
    if len(parts) != mesh.size:
        raise ValueError(f"{what}: {name} has {len(parts)} parts for "
                         f"{mesh.size} shards")
    for p, dev in zip(parts, mesh.devices):
        _check_cuda(what, name, p, dtype, shape, dev)


def _scatter_launch(mesh, used, idx, delta, clamp: bool) -> None:
    """B15 from one host call: ``nt_scatter_shards`` launches every
    shard's kernel on its card's current stream (without the clamp and
    with no rows, nothing)."""
    args, copies = _scatter_args(mesh, used, idx, delta)
    if clamp or idx.shape[0]:
        _ext.launch("scatter_shard", mesh.devices,
                    _ext.entry("nt_scatter_shards"), *args, int(clamp))
    del copies  # held until the launch is queued


def _scatter_args(mesh, used, idx, delta):
    """B15's checks -> (its arguments up to the clamp flag: the shards'
    carry, idx and delta pointers and card ordinals, S, B and n_loc; the
    copies those pointers point into). ``idx`` and ``delta`` are copied
    once to each card of the mesh they do not lie on; the caller holds
    the copies until the launch is queued (freed earlier, another
    thread's allocation could take their memory first)."""
    what = "state_scatter_sharded"
    n_loc = used[0].shape[0]
    b = idx.shape[0]
    here = idx.get_device()
    if not (here >= 0 and idx.dtype is torch.int32 and idx.dim() == 1
            and idx.is_contiguous()):
        raise ValueError(f"{what}: idx must be a contiguous int32 (B,) "
                         f"tensor on a card, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if not (delta.get_device() == here and delta.dtype is torch.float32
            and delta.shape == (b, 4) and delta.is_contiguous()):
        raise ValueError(f"{what}: delta must be a contiguous float32 "
                         f"({b}, 4) tensor on idx's card, got {delta.dtype} "
                         f"{tuple(delta.shape)} on {delta.device}")
    if len(used) != mesh.size:
        raise ValueError(f"{what}: used has {len(used)} parts for "
                         f"{mesh.size} shards")
    shape = (n_loc, 4)
    for p, i in zip(used, mesh.indices):
        if not (p.get_device() == i and p.dtype is torch.float32
                and p.shape == shape and p.is_contiguous()
                and p.data_ptr() % 16 == 0):
            raise ValueError(f"{what}: every used part must be a contiguous, "
                             f"16-byte aligned float32 {shape} tensor on its "
                             f"shard's card, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")
    reps = {dev.index: (idx, delta) if dev.index == here else
            (idx.to(dev, non_blocking=True), delta.to(dev, non_blocking=True))
            for dev in mesh.distinct}
    arr = ctypes.c_void_p * mesh.size
    return (arr(*[p.data_ptr() for p in used]),
            arr(*[reps[i][0].data_ptr() for i in mesh.indices]),
            arr(*[reps[i][1].data_ptr() for i in mesh.indices]),
            mesh.ordinals, mesh.size, b, n_loc), reps


def state_scatter_sharded(mesh: NodeMesh, used: List[torch.Tensor],
                          idx: torch.Tensor,
                          delta: torch.Tensor) -> List[torch.Tensor]:
    """B15: ``used[idx] += delta`` on the row parts of a (N, 4) carry,
    in place, each shard adding the rows it owns. ``idx`` (B,) int32
    global rows and ``delta`` (B, 4) f32 are replicated (on a CUDA mesh:
    on one of its cards, and copied to the others). The CUDA kernel
    (csrc/sharded.cu ``nt_scatter_shards``, one launch a shard from one
    host call) on a CUDA mesh, the plain version on a CPU mesh."""
    if _is_cpu(mesh):
        return state_scatter_sharded_ref(mesh, used, idx, delta)
    _scatter_launch(mesh, used, idx, delta, clamp=False)
    return used


def barrier_probe(device: DeviceLike, ctas: int, participants: int,
                  rounds: int, timeout_ms: int = 4000) -> torch.Tensor:
    """The barrier of csrc/mesh.cuh on its own, on one card: ``ctas``
    CTAs in one cooperative launch pass ``rounds`` barriers of
    ``participants``. Each round every CTA writes the round into its slot
    of a buffer double-buffered by parity and, after the barrier, reads
    every CTA's slot. Returns the (2 x ctas + 1) int32 words, the last
    the count of stale reads (0 when the barrier holds). With more
    participants than CTAs no barrier completes: the launch traps after
    ``timeout_ms`` and the next synchronisation raises."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"barrier_probe: runs on a card, not {dev}")
    words = torch.zeros(GROUP_WORDS, dtype=torch.int32, device=dev)
    out = torch.zeros(2 * ctas + 1, dtype=torch.int32, device=dev)
    _ext.launch("mesh_barrier", dev, _ext.entry("nt_mesh_barrier_probe"),
                words.data_ptr(), out.data_ptr(), ctas, participants, rounds,
                timeout_ms)
    return out


def _issue(mesh: NodeMesh):
    """The lock a mesh's cooperative launches are issued under: the
    module's where the mesh spans cards, none on one card."""
    return _MESH_LAUNCH_LOCK if mesh.cards > 1 else contextlib.nullcontext()


def _ptrs(parts) -> ctypes.Array:
    return (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])


def _card_inputs(mesh: NodeMesh, used, ask, k, seeds):
    """Each card's copy of the replicated ask (G, 4) f32, k (G,) int32 and
    seeds (G,) int64, where the card's first shard's parts lie, and the C
    arrays of their pointers (one a card). The caller holds the copies
    until the launch is queued."""
    if seeds.dim() != 1 or seeds.dtype != torch.int64:
        raise ValueError("the mesh solves take (G,) int64 seeds")
    first = [mesh.card_of[:].index(c) for c in range(mesh.cards)]
    reps = [tuple(x.to(used[s].device, non_blocking=True) for x in (
        ask.to(torch.float32).contiguous(), k.to(torch.int32).contiguous(),
        seeds.contiguous())) for s in first]
    return [_ptrs([r[i] for r in reps]) for i in range(3)], reps


def _bulk_checks(what, mesh, used, avail, feas, aff, g, top_r):
    n = sum(p.shape[0] for p in used)
    n_loc = mesh.n_loc(n)
    if not 1 <= n_loc <= MAX_FILL_NODES:
        raise NotImplementedError(
            f"{what}: {n_loc} nodes a shard; the one-CTA shard pool sorts "
            f"1 to {MAX_FILL_NODES} keys in shared memory")
    if mesh.size * min(top_r, n_loc) > MAX_MERGE:
        raise NotImplementedError(
            f"{what}: {mesh.size} shards x top_r {top_r}; the one-CTA merge "
            f"sorts at most {MAX_MERGE} gathered entries")
    _check_parts(what, mesh, "used", used, torch.float32, (n_loc, 4))
    _check_parts(what, mesh, "avail", avail, torch.float32, (n_loc, 4))
    _check_parts(what, mesh, "feas", feas, torch.bool, (g, n_loc))
    _check_parts(what, mesh, "aff", aff, torch.float32, (g, n_loc))
    return n_loc


def solve_bulk_multi_sharded(mesh: NodeMesh, used, avail, feas, aff, ask, k,
                             seeds, cidx, cdelta, *, g: int,
                             top_r: int = 64):
    """B13: G chained greedy bulk fills on a node-sharded carry ->
    (used parts, counts parts (G, *) int16, rounds (G,) int32 on the
    first shard's device).

    ``used`` / ``avail``: (N, 4) f32 row parts, ``used`` updated IN
    PLACE; ``feas`` (G, N) bool and ``aff`` (G, N) f32 column parts;
    ``ask`` (G, 4) f32, ``k`` (G,) int32 (at most 32,767), ``seeds`` (G,)
    int64, ``cidx`` (C,) int32 and ``cdelta`` (C, 4) f32 replicated.
    Counts equal :func:`kernels.solve_bulk_multi`'s; ``rounds`` (the
    all-gathers of each eval) depends on the layout. On a CUDA mesh two
    host calls, neither of which waits for the card: the correction fold
    (B15) and the solve (one launch a card, csrc/sharded.cu); on a CPU
    mesh the plain version."""
    if feas[0].shape[0] != g or ask.shape[0] != g:
        raise ValueError(f"solve_bulk_multi_sharded: g={g} but feas/ask "
                         f"carry {feas[0].shape[0]}/{ask.shape[0]} rows")
    if _is_cpu(mesh):
        return solve_bulk_multi_sharded_ref(mesh, used, avail, feas, aff,
                                            ask, k, seeds, cidx, cdelta, g=g,
                                            top_r=top_r)
    _bulk_checks("solve_bulk_multi_sharded", mesh, used, avail, feas, aff, g,
                 top_r)
    _scatter_launch(mesh, used, cidx, cdelta, clamp=True)
    # one cooperative launch a card runs every eval and round of the chain
    # (csrc/sharded.cu); every allocation lies where its shard's parts lie
    n_loc = used[0].shape[0]
    r = min(top_r, n_loc)
    words = _ext.scratch_words("nt_bulk_shard_solve_scratch_words", g,
                               n_loc, mesh.size, r)
    scratch = [torch.empty(words, dtype=torch.int32, device=u.device)
               for u in used]
    counts = [torch.empty((g, n_loc), dtype=torch.int16, device=u.device)
              for u in used]
    rounds = torch.empty(g, dtype=torch.int32, device=used[0].device)
    (ask_p, k_p, seeds_p), copies = _card_inputs(mesh, used, ask, k, seeds)
    with _issue(mesh):
        _ext.launch(
            "bulk_shard", mesh.distinct, _ext.entry("nt_bulk_shard_solve"),
            _ptrs(used), _ptrs(avail), _ptrs(feas), _ptrs(aff),
            _ptrs(counts), _ptrs(scratch), ask_p, k_p, seeds_p,
            rounds.data_ptr(), mesh.barrier_words(used[0].device).data_ptr(),
            mesh.card_of, mesh.card_ordinals, mesh.cards, mesh.size, g,
            n_loc, r, _span(TIE_JITTER))
    del copies, scratch  # held until the launch is queued
    return used, counts, rounds


def _joint_consts() -> ctypes.Array:
    """The greedy arm's jitter width, the restarts' widths, then their
    price temperatures, as float32 (as the kernels B3, B3' and B5 take
    them)."""
    his, eps = _jitter_his(), _price_eps()
    vals = [_span(TIE_JITTER)] + [_span(hi) for hi in his] + list(eps)
    return (ctypes.c_float * len(vals))(*vals)


def solve_batch_sharded(mesh: NodeMesh, used, avail, feas, aff, ask, k,
                        seeds, cidx, cdelta, evict=None, net_prio=None, *,
                        g: int, rounds: int = MAX_ROUNDS, top_r: int = 64):
    """B14: the joint auction portfolio against the B13 greedy arm on a
    node-sharded carry -> (used parts, counts parts (G, *) int16, info
    (6,) f32, gathers (0-dim int32)), as
    :func:`batch_solver.solve_batch` computes them on one device.

    Arguments as :func:`solve_bulk_multi_sharded`'s; ``evict`` (N, 4)
    row parts and ``net_prio`` (N,) parts come together or not at all.
    The ``used`` parts take the correction fold in place; the returned
    carry parts are new tensors. ``gathers`` is the reference's count of
    all-gathers: the greedy arm's rounds, each restart's rounds plus one,
    and one. On a CUDA mesh two host calls, neither of which waits for
    the card: the fold (B15) and the solve (one launch a card, csrc/
    sharded.cu); on a CPU mesh the plain version."""
    if (evict is None) != (net_prio is None):
        raise ValueError("solve_batch_sharded: evict and net_prio come "
                         "together")
    if feas[0].shape[0] != g or ask.shape[0] != g:
        raise ValueError(f"solve_batch_sharded: g={g} but feas/ask carry "
                         f"{feas[0].shape[0]}/{ask.shape[0]} rows")
    if _is_cpu(mesh):
        return solve_batch_sharded_ref(mesh, used, avail, feas, aff, ask, k,
                                       seeds, cidx, cdelta, evict, net_prio,
                                       g=g, rounds=rounds, top_r=top_r)
    n_loc = _bulk_checks("solve_batch_sharded", mesh, used, avail, feas, aff,
                         g, top_r)
    if not 1 <= g <= 64:
        raise ValueError(f"solve_batch_sharded: 1-64 evals, got {g}")
    if n_loc * mesh.size > MAX_PICK_NODES:
        raise NotImplementedError(
            f"solve_batch_sharded: {n_loc * mesh.size} nodes; the pick sums "
            f"at most {MAX_PICK_NODES} in one CTA's shared memory")
    if evict is not None:
        _check_parts("solve_batch_sharded", mesh, "evict", evict,
                     torch.float32, (n_loc, 4))
        _check_parts("solve_batch_sharded", mesh, "net_prio", net_prio,
                     torch.float32, (n_loc,))
    _scatter_launch(mesh, used, cidx, cdelta, clamp=True)
    # one cooperative launch a card: the greedy arm and the T restarts at
    # once, then the arm scores and the pick (csrc/sharded.cu)
    n_t = len(PORTFOLIO)
    r, rl = min(top_r, n_loc), min(TOP_R, n_loc)
    rg = min(TOP_R, n_loc * mesh.size)
    words = _ext.scratch_words("nt_joint_shard_solve_scratch_words", g,
                               n_loc, mesh.size, r, rl, n_t)
    scratch = [torch.empty(words, dtype=torch.int32, device=u.device)
               for u in used]
    used_out = [torch.empty((n_loc, 4), dtype=torch.float32, device=u.device)
                for u in used]
    counts = [torch.empty((g, n_loc), dtype=torch.int16, device=u.device)
              for u in used]
    dev0 = used[0].device
    info = torch.empty(6, dtype=torch.float32, device=dev0)
    gathers = torch.empty((), dtype=torch.int32, device=dev0)
    (ask_p, k_p, seeds_p), copies = _card_inputs(mesh, used, ask, k, seeds)
    with _issue(mesh):
        _ext.launch(
            "joint_shard", mesh.distinct, _ext.entry("nt_joint_shard_solve"),
            _ptrs(used), _ptrs(avail), _ptrs(feas), _ptrs(aff),
            None if evict is None else _ptrs(evict),
            None if net_prio is None else _ptrs(net_prio), _ptrs(used_out),
            _ptrs(counts), _ptrs(scratch), ask_p, k_p, seeds_p,
            info.data_ptr(), gathers.data_ptr(),
            mesh.barrier_words(dev0).data_ptr(), mesh.card_of,
            mesh.card_ordinals, _joint_consts(), mesh.cards, mesh.size, g,
            n_loc, r, rl, rg, n_t, rounds)
    del copies, scratch  # held until the launch is queued
    return used_out, counts, info, gathers


# ---------------------------------------------------------------------------
# B16: the per-eval scan with its node rows sharded
# ---------------------------------------------------------------------------

# solve_task_group's node-axis arguments (reference sharding.py:82-99):
# (N, ...) rows and (., N) columns; the rest is replicated
SOLVE_ROWS = (0, 1, 2, 3, 5, 6, 7)
SOLVE_COLS = (10, 11, 16, 17)


def pad_node_axis(args: tuple, multiple: int) -> tuple:
    """Pad the node axis of solve_task_group's arguments up to a multiple
    of ``multiple`` with dummy rows (reference ``:37-70``): zero capacity
    and usage, infeasible, no attribute value; tie_perm gets them at the
    lowest priority. The argmax never picks them, so choices stay rows
    of the real nodes. Returns the arguments as tensors."""
    args = [None if a is None else torch.as_tensor(a) for a in args]
    n = args[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return tuple(args)

    def _pad(x, dim):
        shape = list(x.shape)
        shape[dim] = pad
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    for i in SOLVE_ROWS:
        args[i] = _pad(args[i], 0)
    for i in SOLVE_COLS:
        args[i] = _pad(args[i], 1)
    if len(args) > 25 and args[25] is not None:
        tp = args[25]
        args[25] = torch.cat([tp, torch.arange(n, n + pad, dtype=tp.dtype,
                                               device=tp.device)])
    return tuple(args)


def shard_solve_args(mesh: NodeMesh, args: tuple) -> tuple:
    """solve_task_group's arguments, padded to the mesh (pad_node_axis),
    as parts: the node rows and columns through shard_rows / shard_cols,
    the rest (tie_perm too) one copy a shard through replicate
    (reference ``:73-104``). A missing tie_perm stays None."""
    args = pad_node_axis(args, mesh.size)
    return tuple(None if a is None
                 else shard_rows(mesh, a) if i in SOLVE_ROWS
                 else shard_cols(mesh, a) if i in SOLVE_COLS
                 else replicate(mesh, a) for i, a in enumerate(args))


def _positions(n: int, tie_perm, dev) -> torch.Tensor:
    """The n rows' places in the tie-break order, on ``dev``: the inverse
    of tie_perm (the identity where it is None)."""
    pos = torch.arange(n, device=dev)
    if tie_perm is not None:
        inv = torch.empty_like(pos)
        inv[tie_perm.to(dev, torch.int64)] = pos
        pos = inv
    return pos


def _first_best(score: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Index of the highest score, the lowest position among equals; a
    NaN above every number, as argmax takes it."""
    best = score.max()
    tie = (score == best) | (torch.isnan(score) & torch.isnan(best))
    return torch.where(tie, pos, torch.iinfo(torch.int64).max).argmin()


def solve_task_group_sharded_ref(mesh: NodeMesh, sharded: tuple):
    """Plain version of B16 on the parts of :func:`shard_solve_args`,
    step for step B9 (``kernels.solve_task_group_ref``) with the rows
    sharded. Per step each shard scores its rows (``score_nodes_ref``)
    and writes its best (score desc, tie-break position asc) to its row
    of a gather buffer: score, position, global row, and the row's
    spread and distinct_property value ids and ok flags and explicit
    spread boosts; one all_gather; then the global best and its commit:
    usage and placement counts on the owning shard only, the value counts
    and the lowest boost replicated (computed once). Returns (choices
    int32, founds bool, scores f32), each (K,), on the first shard's
    device."""
    (avail, used, ptg, pjob, ask, feas, aff, dev_aff, pen, active, svid,
     sok, scnt, sdes, has_t, weight, dvid, dok, dcnt, dlim, lowest,
     tg_count, dh_job, dh_tg, spread_alg) = sharded[:25]
    _ext.COUNTS.plain("task_group_shard", avail[0])
    n_loc = avail[0].shape[0]
    s_sp, p = svid[0].shape[0], dvid[0].shape[0]
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    tie_perm = sharded[25] if len(sharded) > 25 else None
    tie_perm = None if tie_perm is None else tie_perm[0]
    pos = _positions(n_loc * mesh.size, tie_perm, mesh.devices[0])
    pos = [pos[s * n_loc:(s + 1) * n_loc].to(d)
           for s, d in enumerate(mesh.devices)]
    used = [u.to(f32, copy=True) for u in used]
    ptg = [x.to(i32, copy=True) for x in ptg]
    pjob = [x.to(i32, copy=True) for x in pjob]
    scnt, dcnt = scnt[0].to(i32, copy=True), dcnt[0].to(i32, copy=True)
    low = lowest[0].to(f32)
    rows_s = torch.arange(s_sp, device=scnt.device)
    rows_p = torch.arange(p, device=dcnt.device)
    inf = torch.full((1,), math.inf, device=low.device)
    width = 3 + 3 * s_sp + 2 * p
    bufs = [torch.empty((mesh.size, width), dtype=torch.float64, device=d)
            for d in mesh.devices]
    arange = [torch.arange(n_loc, device=d) for d in mesh.devices]
    choices, founds, scores = [], [], []
    for t in range(pen[0].shape[0]):
        for s, d in enumerate(mesh.devices):
            lo = s * n_loc
            pen_t = pen[s][t].to(i64)
            own = (pen_t >= lo) & (pen_t < lo + n_loc)
            score, _, boost = score_nodes_ref(
                available=avail[s].to(f32), used=used[s],
                ask=ask[s].to(f32), feasible=feas[s].bool(),
                placed_tg=ptg[s], placed_job=pjob[s],
                affinity_boost=aff[s].to(f32),
                dev_affinity=dev_aff[s].to(f32),
                penalty_idx=torch.where(own, pen_t - lo, -1),
                spread_val_id=svid[s].to(i64), spread_val_ok=sok[s].bool(),
                spread_counts=scnt.to(d), spread_desired=sdes[s].to(f32),
                spread_has_targets=has_t[s].bool(),
                spread_weight=weight[s].to(f32), dp_val_id=dvid[s].to(i64),
                dp_val_ok=dok[s].bool(), dp_counts=dcnt.to(d),
                dp_limit=dlim[s].to(f32), lowest_boost=low.to(d),
                tg_count=tg_count[s].to(f32), dh_job=dh_job[s].bool(),
                dh_tg=dh_tg[s].bool(), spread_alg=spread_alg[s].bool())
            j = _first_best(score, pos[s])
            bufs[s][s] = torch.cat([
                torch.stack([score[j].double(), pos[s][j].double(),
                             (j + lo).double()]),
                svid[s][:, j].double(), sok[s][:, j].double(),
                dvid[s][:, j].double(), dok[s][:, j].double(),
                boost[:, j].double()])
        all_gather(mesh, bufs)
        cand = bufs[0]
        win = cand[_first_best(cand[:, 0], cand[:, 1].to(i64))]
        best = win[0].to(f32)
        row = win[2].to(i64)
        found = active[0][t].bool() & (best > NEG)
        sel_ok = (win[3 + s_sp:3 + 2 * s_sp] > 0.5) & found
        scnt = scnt.index_put((rows_s, win[3:3 + s_sp].to(i64)),
                              sel_ok.to(i32), accumulate=True)
        if p:
            at = 3 + 2 * s_sp
            dsel_ok = (win[at + p:at + 2 * p] > 0.5) & found
            dcnt = dcnt.index_put((rows_p, win[at:at + p].to(i64)),
                                  dsel_ok.to(i32), accumulate=True)
        chosen = torch.where(has_t[0].bool() & sel_ok,
                             win[3 + 2 * s_sp + 2 * p:].to(f32), math.inf)
        low = torch.minimum(low, torch.cat([chosen, inf]).amin())
        for s, d in enumerate(mesh.devices):
            onehot = (arange[s] == (row - s * n_loc).to(d)) & found.to(d)
            used[s] = used[s] + ask[s].to(f32)[None, :] * onehot[:, None]
            ptg[s] = ptg[s] + onehot.to(i32)
            pjob[s] = pjob[s] + onehot.to(i32)
        choices.append(row)
        founds.append(found)
        scores.append(best)
    dev0 = mesh.devices[0]
    if not choices:
        return (torch.zeros(0, dtype=i32, device=dev0),
                torch.zeros(0, dtype=torch.bool, device=dev0),
                torch.zeros(0, dtype=f32, device=dev0))
    return (torch.stack(choices).to(i32), torch.stack(founds),
            torch.stack(scores))


def solve_task_group_sharded(mesh: NodeMesh, args: tuple):
    """B16: place K allocations of one task group as B9 does, with the
    node rows sharded over ``mesh`` (reference ``:107-122``). ``args``:
    the 25 or 26 positional arguments of ``solve_task_group``, as arrays
    or tensors, padded to the mesh (:func:`pad_node_axis`).
    -> (choices (K,) int32 rows of the real nodes, founds (K,) bool,
    scores (K,) f32) on the first shard's device, equal to B9's. On a
    CUDA mesh one host call, which makes one cooperative launch a card
    (csrc/task_group_shard.cu: a CTA a shard, every step inside it, each
    shard's candidate pushed into every shard's gather buffer, one
    barrier a step). On a CPU mesh the plain version."""
    if _is_cpu(mesh):
        return solve_task_group_sharded_ref(mesh,
                                            shard_solve_args(mesh, args))
    return _task_group_shard_solve(mesh, args)


def _task_group_shard_solve(mesh: NodeMesh, args: tuple):
    """B16 on a CUDA mesh: the arguments padded to the mesh and packed
    once in B9's layout (with node_mat's last column the rows' tie-break
    positions) where they lie (host arrays on the host: eight copies to a
    card, not one an argument), one copy of the pack on each card, and
    one ``nt_task_group_shard_solve`` for the whole solve with each
    shard's pointers into its card's copy: its rows of node_mat, its
    columns of spread_node and dp_node."""
    args = pad_node_axis(args, mesh.size)
    pos = _positions(args[0].shape[0], args[25] if len(args) > 25 else None,
                     args[0].device)
    pack = pack_solve_tensors(*args[:25], node_col=pos)
    packs = {dev: [t.to(dev) for t in pack] for dev in mesh.distinct}
    pack = packs[mesh.devices[0]]
    n_all, d, s_sp, v, p, vd = _layout(pack[0], *pack[2:],
                                       what="solve_task_group_sharded")
    n = mesh.n_loc(n_all)
    w = 2 * d + 6

    def at(i, s, dev):
        t = packs[dev][i]
        if t.numel() == 0:
            return t.data_ptr()                   # read by nothing
        if i == 0:
            return t.data_ptr() + 4 * s * n * w   # its rows
        if i in (2, 5):
            return t.data_ptr() + 4 * s * n       # its columns
        return t.data_ptr()

    ptrs = [(ctypes.c_void_p * mesh.size)(
        *[at(i, s, dev) for s, dev in enumerate(mesh.devices)])
        for i in range(8)]
    k = pack[1].shape[0]
    home = pack[0].device
    out = torch.empty((3, k), dtype=torch.float32, device=home)
    if k:
        words = _ext.scratch_words("nt_task_group_shard_solve_scratch_words",
                                   n, d, s_sp, v, p, vd, mesh.size)
        scratch = [torch.empty(words, dtype=torch.int32,
                               device=packs[dev][0].device)
                   for dev in mesh.devices]
        with _issue(mesh):
            _ext.launch(
                "task_group_shard", mesh.distinct,
                _ext.entry("nt_task_group_shard_solve"), *ptrs,
                _ptrs(scratch), out.data_ptr(),
                mesh.barrier_words(home).data_ptr(), mesh.card_of,
                mesh.card_ordinals, mesh.cards, mesh.size, k, n, d, s_sp, v,
                p, vd, n_all)
        del scratch, packs  # held until the launch is queued
    return out[0].to(torch.int32), out[1] > 0.5, out[2]
