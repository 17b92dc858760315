#!/usr/bin/env python3
"""Chip smoke test of the port (nomad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device  -- require a CUDA card; print its name and power limit.
2. build   -- compile the CUDA kernels from nomad_tpu_torch/csrc (one nvcc
              per source, in parallel) into build/nomad_tpu_torch/.
3. B3      -- jitter kernel vs jitter_ref at G=16 x N_pad=16,384: bitwise.
4. B4      -- scatter kernel vs scatter_add_ref on (16,384, 4) with 1,024
              rows including duplicates and (0, 0) padding: exact.
5. B1      -- solve_bulk_multi (scatter + jitter + fill kernels) vs
              solve_bulk_multi_ref at the C2M width (10,240 nodes padded to
              16,384, G=16, k=4,000) with the hazard rows mixed in: counts
              and carry exact.
6. B10     -- score_nodes_packed (B8 alone) vs its plain version at
              N_pad=8,192 with spread (explicit and even), distinct_hosts,
              distinct_property and penalty rows: NEG mask exact, scores
              within 1e-6.
7. B9      -- solve_task_group_fused vs its plain version at the cfg3
              width (5,120 nodes padded to 8,192, K=500 padded to 512, one
              rack spread over 20 values padded to 32, tie_perm) and four
              hazard variants: choices and founds exact, scores within 1e-6.
8. path    -- the C2M bulk path: 10,240 nodes, 64 batch jobs x 4,000 allocs
              (cpu 50, mem 32) through Harness.process("tpu-binpack") from
              16 threads. Every alloc placed once, no node over capacity
              (recomputed from the store), B1/B3/B4 launched, no plain
              version on CUDA.
9. spread  -- the per-eval path at cfg3 (bench.py cfg3_spread_50k): 5,120
              nodes, 100 service jobs x 500 allocs (cpu 100, mem 64) with
              spread on ${attr.rack} weight 50, through
              Harness.process("tpu-binpack") from 2 threads. Every alloc
              placed once, no node over capacity, B9 launched once per job,
              no plain version on CUDA; prints allocs/s and the per-job
              rack-count spread.
10. parity -- two pinned 256-node workloads (the bulk jobs, and the spread
              / distinct_hosts / distinct_property / host-oracle jobs) on the
              card and on the CPU plain versions: the same placements.

Before the last line it prints one JSON line with every kernel's launches
on its path, error against its plain version, times and bound, and the
card's name and power limit; the last line is the device summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and the
# 32-bit rate outside the tensor cores, used for integer and float ops alike
HBM_BPS = 3.35e12
ALU_OPS = 67e12
N_NODES = 10240
N_PAD = 16384
G = 16
K = 4000
JOBS = 64
THREADS = 16
# the per-eval path at bench.py cfg3_spread_50k's shape
CFG3_NODES = 5120
CFG3_PAD = 8192
CFG3_K = 500
CFG3_JOBS = 100
CFG3_THREADS = 2
SCORE_TOL = 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, setup=None, reps=15, warmup=2) -> float:
    """Median device time of fn(setup()) over reps, by CUDA events."""
    for _ in range(warmup):
        fn(setup() if setup else None)
    times = []
    for _ in range(reps):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = ops / ALU_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_jitter(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.kernels import TIE_JITTER
    from nomad_tpu_torch.tensor.prng import jitter, jitter_ref

    seeds = torch.tensor(
        np.concatenate([[0, 1, 2 ** 31, 2 ** 32 - 1],
                        rng.integers(0, 2 ** 32, G - 4)]).astype(np.int64),
        device=dev)
    got = jitter(seeds, N_PAD, TIE_JITTER)
    want = jitter_ref(seeds, N_PAD, TIE_JITTER)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("B3 jitter kernel differs from jitter_ref")
    err = float((got - want).abs().max())
    ms = cuda_time_ms(torch, lambda _: jitter(seeds, N_PAD, TIE_JITTER))
    plain = cuda_time_ms(torch, lambda _: jitter_ref(seeds, N_PAD,
                                                      TIE_JITTER))
    # 20 threefry rounds of add/rotate/xor plus key injections and the
    # float build: ~120 32-bit ops per element; seeds in, floats out
    b_ms, b_by = bound(G * 8 + G * N_PAD * 4, G * N_PAD * 120)
    print(f"B3 jitter   [{card}] bitwise equal; kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"name": "jitter", "source": "nomad_tpu_torch/csrc/jitter.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:720",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_scatter(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.scatter import scatter_add, scatter_add_ref

    used0 = torch.tensor(rng.integers(0, 5000, (N_PAD, 4)).astype(np.float32),
                         device=dev)
    b = 1024
    idx_np = rng.integers(0, N_NODES, b).astype(np.int32)
    idx_np[100:200] = idx_np[0]             # duplicates accumulate
    idx_np[-64:] = 0                        # (0, 0) padding slots
    delta_np = rng.integers(-300, 300, (b, 4)).astype(np.float32)
    delta_np[-64:] = 0.0
    idx = torch.tensor(idx_np, device=dev)
    delta = torch.tensor(delta_np, device=dev)
    got = scatter_add(used0.clone(), idx, delta)
    want = scatter_add_ref(used0.clone(), idx, delta)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("B4 scatter kernel differs from scatter_add_ref")
    err = float((got - want).abs().max())
    ms = cuda_time_ms(torch, lambda u: scatter_add(u, idx, delta),
                      setup=used0.clone)
    plain = cuda_time_ms(torch, lambda u: scatter_add_ref(u, idx, delta),
                         setup=used0.clone)
    idx64 = idx.to(torch.int64)
    lib = cuda_time_ms(torch, lambda u: u.index_add_(0, idx64, delta),
                       setup=used0.clone)
    rows = len(np.unique(idx_np))
    b_ms, b_by = bound(b * 4 + b * 16 + 2 * rows * 16, b * 4)
    print(f"B4 scatter  [{card}] exact; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, index_add_ {lib:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by})")
    return {"name": "scatter_add", "source": "nomad_tpu_torch/csrc/scatter.cu",
            "replaces": "nomad_tpu/tensor/incremental.py:101",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def b1_inputs(torch, dev, rng):
    """C2M-width inputs with the hazard rows of the CPU tests mixed in."""
    avail = np.zeros((N_PAD, 4), np.float32)
    avail[:N_NODES, 0] = rng.choice([8000, 16000, 32000], N_NODES)
    avail[:N_NODES, 1] = rng.choice([16384, 32768, 65536], N_NODES)
    avail[:N_NODES, 2] = 102400
    avail[:N_NODES, 3] = 12001
    used = np.zeros((N_PAD, 4), np.float32)
    fill = rng.integers(0, 120, N_NODES).astype(np.float32)
    used[:N_NODES, 0] = fill * 50
    used[:N_NODES, 1] = fill * 32
    used[:N_NODES, 2] = fill * 300
    feas = np.zeros((G, N_PAD), bool)
    feas[:, :N_NODES] = rng.random((G, N_NODES)) < 0.95
    feas[3] = False                          # an all-infeasible row
    aff = np.zeros((G, N_PAD), np.float32)
    aff[5, :N_NODES] = rng.choice([0.0, 0.5, -0.5, 1.0], N_NODES)
    ask = np.tile(np.array([50, 32, 300, 0], np.float32), (G, 1))
    ask[7] = [100, 0, 300, 0]                # zero ask in mem (and ports)
    ask[9] = [4000, 8192, 300, 0]            # large ask hits capacity
    k = np.full(G, K, np.int32)
    k[11] = 0                                # k=0 padding rows
    k[15] = 0
    seeds = rng.integers(0, 2 ** 32, G).astype(np.int64)
    c = 64
    cidx = np.zeros(c, np.int32)
    cdelta = np.zeros((c, 4), np.float32)
    rows = rng.integers(0, N_NODES, 40)
    cidx[:40] = rows
    cidx[40:48] = rows[0]                    # duplicate correction rows
    cdelta[:48, :3] = -used[cidx[:48], :3] - 1000.0   # hits the >=0 clamp
    t = {name: torch.tensor(v, device=dev) for name, v in (
        ("used", used), ("avail", avail), ("feas", feas), ("aff", aff),
        ("ask", ask), ("k", k), ("seeds", seeds), ("cidx", cidx),
        ("cdelta", cdelta))}
    t["tgc"] = torch.ones(G, device=dev)
    return t


def phase_fill(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.kernels import (TIE_JITTER, bulk_fill,
                                                bulk_fill_ref,
                                                solve_bulk_multi,
                                                solve_bulk_multi_ref)
    from nomad_tpu_torch.tensor.prng import jitter_ref

    t = b1_inputs(torch, dev, rng)
    args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"], t["tgc"],
            t["seeds"], t["cidx"], t["cdelta"])
    got_used, got = solve_bulk_multi(t["used"].clone(), *args, g=G)
    want_used, want = solve_bulk_multi_ref(t["used"].clone(), *args, g=G)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_used, want_used)):
        diff = int((got != want).sum())
        raise AssertionError(f"B1 fill differs from solve_bulk_multi_ref: "
                             f"{diff} count cells")
    err = max(float((got.int() - want.int()).abs().max()),
              float((got_used - want_used).abs().max()))
    placed = int(got.sum())
    jit = jitter_ref(t["seeds"], N_PAD, TIE_JITTER)
    fill_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"], jit)
    ms = cuda_time_ms(torch, lambda u: bulk_fill(u, *fill_args),
                      setup=t["used"].clone, reps=10)
    plain = cuda_time_ms(torch, lambda u: bulk_fill_ref(u, *fill_args),
                         setup=t["used"].clone, reps=5, warmup=1)
    # bytes: carry in and out, capacity, the (G, N) mask/affinity/jitter
    # rows in, the (G, N) int16 counts out. ops: ~60 flops per node and
    # eval for fit, score and cap (two powf counted as 20 each) plus an
    # N log2 N comparison order per eval
    n_bytes = (N_PAD * 16 * 3 + G * N_PAD * (1 + 4 + 4 + 2) + G * 20)
    n_ops = G * (N_PAD * 60 + N_PAD * 14)
    b_ms, b_by = bound(n_bytes, n_ops)
    print(f"B1 fill     [{card}] counts and carry exact ({placed} placed "
          f"over {G} rows); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    return {"name": "bulk_fill", "source": "nomad_tpu_torch/csrc/bulk_fill.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:666",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_path(torch, card, device="cuda"):
    """The C2M bulk path; returns the launch counts of its run."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    h = Harness(device=device)
    t0 = time.perf_counter()
    mock.build_nodes(h.store, N_NODES, seed=0)
    jobs = []
    for _ in range(JOBS):
        j = mock.service_job(K, cpu=50, mem=32, batch=True)
        h.store.upsert_job(j)
        jobs.append(j)
    evals = [mock.eval_for(j) for j in jobs]
    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    print(f"path        setup {time.perf_counter() - t0:.2f} s "
          f"({N_NODES} nodes, {JOBS} jobs x {K} allocs)")
    svc = get_service(device)
    base = dict(svc.stats)
    _ext.COUNTS.reset()
    t1 = time.perf_counter()
    with ThreadPoolExecutor(THREADS) as pool:
        for f in [pool.submit(h.process, ev, cfg) for ev in evals]:
            f.result()
    wall = time.perf_counter() - t1
    counts = _ext.COUNTS.snapshot()
    stats = {k: svc.stats[k] - base[k] for k in base}
    svc.stop()

    snap = h.store.snapshot()
    total = sum(len(snap.allocs_by_job(j.id)) for j in jobs)
    ids = [a.id for a in snap.allocs()]
    if total != JOBS * K or len(ids) != JOBS * K or len(set(ids)) != len(ids):
        raise AssertionError(f"placed {total} / {len(ids)} allocs "
                             f"({len(set(ids))} unique ids), want {JOBS * K}")
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    for block in snap.alloc_blocks():
        for m, nid in enumerate(block.node_ids):
            usage[row[nid]] += block.allocated_vec * float(block.counts[m])
    over = int((usage > cap).any(axis=1).sum())
    if over:
        raise AssertionError(f"{over} nodes over capacity")
    bad = [e for e in h.evals if e.status != enums.EVAL_STATUS_COMPLETE
           or e.failed_tg_allocs]
    if bad:
        raise AssertionError(f"{len(bad)} evals not cleanly complete")
    for name in ("jitter", "scatter_add", "bulk_fill"):
        if counts["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    per_launch = stats["solves"] / max(stats["launches"], 1)
    print(f"path        [{card}] {total} allocs in {wall:.3f} s = "
          f"{total / wall:.1f} allocs/s; launches {stats['launches']}, "
          f"evals/launch {per_launch:.2f}, resyncs {stats['resyncs']}, "
          f"corrections {stats['corrections']}; kernel launches "
          f"{counts['launches']}; plain on CUDA {counts['plain_on_cuda']}")
    return counts["launches"]


def fingerprint(h, jobs):
    snap = h.store.snapshot()
    ordinal = {n.id: i for i, n in enumerate(snap.nodes())}
    out = {}
    for j in jobs:
        per, scores = {}, set()
        allocs = snap.allocs_by_job(j.id)
        for a in allocs:
            per[ordinal[a.node_id]] = per.get(ordinal[a.node_id], 0) + 1
            scores.update(a.metrics.scores.values())
        out[j.id] = (len(allocs), sorted(per.items()), sorted(scores))
    return out


def phase_parity():
    """The same pinned small workload on the card and on the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    prints = []
    for device in ("cuda", "cpu"):
        h = Harness(device=device)
        mock.build_nodes(h.store, 256, seed=0)
        jobs = []
        for i, (count, cpu, mem) in enumerate(
                ((700, 50, 32), (900, 60, 48), (500, 80, 64))):
            j = mock.service_job(count, cpu=cpu, mem=mem, batch=True)
            j.id = f"parity-{i}"
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"parity-ev-{i}"), cfg)
            jobs.append(j)
        prints.append(fingerprint(h, jobs))
        get_service(device).stop()
    if prints[0] != prints[1]:
        raise AssertionError("card and CPU placements differ on the "
                             "pinned 256-node workload")
    print(f"parity      card == CPU on 3 pinned jobs "
          f"({sum(v[0] for v in prints[0].values())} allocs)")


def cfg3_packed(rng, variant: str):
    """One task group's packed solve (pack_solve_args) at the cfg3 width,
    with a hazard variant: "cfg3" is the path's own shape (one even rack
    spread, 500 of 512 steps active, tie_perm); "targets" adds explicit
    targets with a zero and a missing desired count and penalty steps;
    "distinct" has distinct_hosts and a distinct_property cap and runs
    out of feasible nodes; "worstfit" has three spreads (the padded
    pairwise tree), WorstFit and near-full nodes; "infeasible" finds no
    node at all."""
    from nomad_tpu_torch.tensor.kernels import pack_solve_args

    n, real, k_pad = CFG3_PAD, CFG3_NODES, 512
    avail = np.zeros((n, 4))
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2] = 102400
    avail[:real, 3] = 12001
    used = np.zeros((n, 4))
    fill = rng.integers(0, 30, real)
    used[:real, 0] = fill * 100
    used[:real, 1] = fill * 64
    used[:real, 2] = fill * 300
    ptg = np.zeros(n)
    pjob = np.zeros(n)
    feas = np.zeros(n, bool)
    feas[:real] = True
    aff = np.zeros(n)
    pen = np.full(k_pad, -1)
    active = np.zeros(k_pad, bool)
    active[:CFG3_K] = True
    s, v = 1, 32
    svid = np.zeros((s, n))
    svid[0, :real] = np.arange(real) % 20
    sok = np.zeros((s, n), bool)
    sok[0, :real] = True
    scnt = np.zeros((s, v))
    sdes = np.full((s, v), np.nan)
    has_t = np.zeros(s, bool)
    weight = np.ones(s)
    dh_tg, spread_alg = False, False
    dp = {}
    if variant == "targets":
        has_t[0] = True
        sdes[0, :18] = 25.0
        sdes[0, 3] = 0.0                     # a zero target -> lowest boost
        scnt[0, :20] = rng.integers(0, 30, 20)
        pen[rng.integers(0, CFG3_K, 40)] = rng.integers(0, real, 40)
        ptg[:real] = rng.integers(0, 3, real) * (rng.random(real) < 0.1)
        aff[:real] = rng.choice([0.0, 0.0, 0.5, -0.5], real)
    elif variant == "distinct":
        dh_tg = True
        feas[:real] = rng.random(real) < 0.08   # ~410 nodes for 500 steps
        ptg[:real] = rng.random(real) < 0.02
        dp = dict(dp_val_id=(np.arange(n) % 7)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 3)[None, :],
                  dp_counts0=rng.integers(0, 3, (1, 8)),
                  dp_limit=np.array([60.0]))
    elif variant == "worstfit":
        spread_alg = True
        s = 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 3]).astype(float)
        sok = np.tile(np.arange(n) < real, (s, 1))
        sok[2, ::11] = False                 # a missing attribute
        scnt = rng.integers(0, 40, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        sdes[1, :4] = [200.0, 150.0, 100.0, 50.0]
        has_t = np.array([False, True, False])
        weight = np.array([0.2, 0.5, 0.3])
        used[:real, 0] = avail[:real, 0] - 100 * rng.integers(0, 5, real)
    elif variant == "infeasible":
        feas[:] = False
    tie_perm = rng.permutation(n)
    return pack_solve_args(
        avail, used, ptg, pjob, np.array([100.0, 64.0, 300.0, 0.0]), feas,
        aff, pen, active, svid, sok, scnt, sdes, has_t, weight, -1.0,
        float(CFG3_K), False, dh_tg, spread_alg, tie_perm=tie_perm, **dp)


def score_err(got, want, what: str) -> float:
    """NEG mask exact, scores within SCORE_TOL; returns max |diff|."""
    from nomad_tpu_torch.tensor.kernels import NEG

    got, want = got.double().cpu(), want.double().cpu()
    if not bool(((got <= NEG / 2) == (want <= NEG / 2)).all()):
        raise AssertionError(f"{what}: NEG masks differ")
    live = want > NEG / 2
    err = float((got[live] - want[live]).abs().max()) if live.any() else 0.0
    if err > SCORE_TOL:
        raise AssertionError(f"{what}: scores differ by {err}")
    return err


def scan_bound(packed):
    """Least time of one B9 launch on these inputs: the packed inputs read
    once and the (3, K) rows written once; and the 32-bit operations the
    function needs on this data. Only the chosen node's own terms change
    in a step; every node's spread boost changes only through its value
    id's entry of the S x V boost table. So: each feasible node scored
    once in full (~100 operations, two powf counted as 20 each); then per
    active step the S x V and P x Vd tables refreshed (~12 per entry),
    the chosen node re-scored (~100), and per feasible node a gather and
    add per spread and distinct_property, the division, the mask and the
    argmax (~8 + 3 per spread or property)."""
    node_mat, step_mat, _, spread_tab, _, dp_node, dp_tab, _ = packed
    d = (node_mat.shape[1] - 6) // 2
    feasible = int((node_mat[:, 2 * d + 2] > 0.5).sum())
    active = int((step_mat[:, 1] > 0.5).sum())
    s, v = spread_tab.shape[0] // 2, spread_tab.shape[1]
    p, vd = dp_node.shape[0] // 2, dp_tab.shape[1] - 1
    n_bytes = 4 * (sum(t.numel() for t in packed) + 3 * step_mat.shape[0])
    ops = feasible * 100 + active * (
        12 * (s * v + p * vd) + 100 + feasible * (8 + 3 * (s + p)))
    return bound(n_bytes, ops)


def phase_score_once(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.kernels import (score_nodes_packed,
                                                score_nodes_packed_ref)

    err = 0.0
    packed_main = None
    for variant, pen in (("cfg3", -1), ("targets", 17), ("distinct", -1),
                         ("worstfit", 4000)):
        packed = [torch.tensor(a, device=dev)
                  for a in cfg3_packed(rng, variant)]
        packed = [packed[0]] + packed[2:]    # no step_mat
        got = score_nodes_packed(*packed, pen)
        want = score_nodes_packed_ref(*packed, pen)
        torch.cuda.synchronize()
        err = max(err, score_err(got, want, f"B10 {variant}"))
        if variant == "cfg3":
            packed_main = packed
    ms = cuda_time_ms(torch, lambda _: score_nodes_packed(*packed_main, -1))
    plain = cuda_time_ms(torch,
                         lambda _: score_nodes_packed_ref(*packed_main, -1))
    b_ms, b_by = bound(4 * (CFG3_PAD * 14 + 2 * CFG3_PAD + 64 + 2 + 9
                            + CFG3_PAD), CFG3_PAD * 100)
    print(f"B10 score   [{card}] 4 variants within {SCORE_TOL} (max "
          f"{err:.3g}); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    return {"name": "score_nodes", "source":
            "nomad_tpu_torch/csrc/task_group.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:632",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_scan(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.kernels import (solve_task_group_fused,
                                                solve_task_group_fused_ref)

    err = 0.0
    main = None
    notes = []
    for variant in ("cfg3", "targets", "distinct", "worstfit", "infeasible"):
        packed = [torch.tensor(a, device=dev)
                  for a in cfg3_packed(rng, variant)]
        got = solve_task_group_fused(*packed)
        want = solve_task_group_fused_ref(*packed)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            diff = int((got[:2] != want[:2]).any(0).sum())
            raise AssertionError(f"B9 {variant}: choices/founds differ from "
                                 f"the plain version at {diff} steps")
        err = max(err, score_err(got[2], want[2], f"B9 {variant}"))
        notes.append(f"{variant} {int(got[1].sum())}/{CFG3_K}")
        if variant == "cfg3":
            main = packed
    ms = cuda_time_ms(torch, lambda _: solve_task_group_fused(*main), reps=10)
    plain = cuda_time_ms(torch, lambda _: solve_task_group_fused_ref(*main),
                         reps=2, warmup=1)
    b_ms, b_by = scan_bound(main)
    print(f"B9 scan     [{card}] choices and founds exact, scores within "
          f"{SCORE_TOL} (max {err:.3g}); found {', '.join(notes)}; kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"name": "solve_task_group", "source":
            "nomad_tpu_torch/csrc/task_group.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:448",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_spread(torch, card, device="cuda"):
    """The per-eval path at cfg3; returns the launch counts of its run."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import Spread, enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.testing import Harness

    h = Harness(device=device)
    t0 = time.perf_counter()
    mock.build_nodes(h.store, CFG3_NODES, seed=0)
    spreads = [Spread(attribute="${attr.rack}", weight=50)]
    jobs = []
    for _ in range(CFG3_JOBS):
        j = mock.service_job(CFG3_K, spreads=spreads)
        h.store.upsert_job(j)
        jobs.append(j)
    evals = [mock.eval_for(j) for j in jobs]
    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    print(f"spread      setup {time.perf_counter() - t0:.2f} s "
          f"({CFG3_NODES} nodes, {CFG3_JOBS} jobs x {CFG3_K} allocs)")
    _ext.COUNTS.reset()
    t1 = time.perf_counter()
    with ThreadPoolExecutor(CFG3_THREADS) as pool:
        for f in [pool.submit(h.process, ev, cfg) for ev in evals]:
            f.result()
    wall = time.perf_counter() - t1
    counts = _ext.COUNTS.snapshot()

    snap = h.store.snapshot()
    total = sum(len(snap.allocs_by_job(j.id)) for j in jobs)
    allocs = list(snap.allocs())
    ids = {a.id for a in allocs}
    want = CFG3_JOBS * CFG3_K
    if total != want or len(allocs) != want or len(ids) != want:
        raise AssertionError(f"placed {total} / {len(allocs)} allocs "
                             f"({len(ids)} unique ids), want {want}")
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    rack_of = {n.id: n.attributes["rack"] for n in nodes}
    spread = []
    for j in jobs:
        per_rack = {}
        for a in snap.allocs_by_job(j.id):
            usage[row[a.node_id]] += a.allocated_vec
            r = rack_of[a.node_id]
            per_rack[r] = per_rack.get(r, 0) + 1
        spread.append(max(per_rack.values()) - min(per_rack.values())
                      if len(per_rack) == 20 else CFG3_K)
    over = int((usage > cap).any(axis=1).sum())
    if over:
        raise AssertionError(f"{over} nodes over capacity")
    bad = [e for e in h.evals if e.status != enums.EVAL_STATUS_COMPLETE
           or e.failed_tg_allocs]
    if bad:
        raise AssertionError(f"{len(bad)} evals not cleanly complete")
    if counts["launches"]["solve_task_group"] != CFG3_JOBS:
        raise AssertionError(f"B9 launched {counts['launches']} times, want "
                             f"one per job ({CFG3_JOBS})")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    print(f"spread      [{card}] {total} allocs in {wall:.3f} s = "
          f"{total / wall:.1f} allocs/s; per-job rack-count spread "
          f"(max - min over 20 racks) median {statistics.median(spread)}, "
          f"max {max(spread)}; kernel launches {counts['launches']}; plain "
          f"on CUDA {counts['plain_on_cuda']}")
    return counts["launches"]


PINNED_SPREAD = (  # (count, spread attribute, targets, constraint)
    (300, "${attr.rack}", (), None),
    (100, "${attr.zone}", (("z0", 50), ("z1", 20)), None),
    (40, None, (), ("", "", "distinct_hosts")),
    (60, None, (), ("${attr.rack}", "4", "distinct_property")),
    (10, None, (), None),
)


def phase_spread_parity():
    """The pinned spread / distinct / host-oracle workload on the card and
    on the CPU: counts per node equal, scores within SCORE_TOL."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.testing import Harness

    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    prints = []
    for device in ("cuda", "cpu"):
        h = Harness(device=device)
        mock.build_nodes(h.store, 256, seed=0)
        jobs = []
        for i, (count, attr, targets, cons) in enumerate(PINNED_SPREAD):
            spreads = ([Spread(attribute=attr, weight=70, targets=[
                SpreadTarget(v, pct) for v, pct in targets])]
                if attr else None)
            constraints = [Constraint(*cons)] if cons else None
            j = mock.service_job(count, spreads=spreads,
                                 constraints=constraints)
            j.id = f"spread-parity-{i}"
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"spread-parity-ev-{i}"), cfg)
            jobs.append(j)
        prints.append(fingerprint(h, jobs))
    for jid, (n_g, per_g, scores_g) in prints[0].items():
        n_w, per_w, scores_w = prints[1][jid]
        if n_g != n_w or per_g != per_w or len(scores_g) != len(scores_w):
            raise AssertionError(f"card and CPU placements differ on {jid}")
        diff = max((abs(a - b) for a, b in zip(scores_g, scores_w)),
                   default=0.0)
        if diff > SCORE_TOL:
            raise AssertionError(f"card and CPU scores differ by {diff} on "
                                 f"{jid}")
    print(f"parity      card == CPU on {len(PINNED_SPREAD)} pinned spread / "
          f"distinct / host-oracle jobs "
          f"({sum(v[0] for v in prints[0].values())} allocs)")


def main() -> int:
    if not (REPO / "nomad_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: nomad_tpu_torch/ not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device found (torch.cuda.is_available() "
              "is False); the port runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from nomad_tpu_torch import _ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device      {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = _ext.build()
    print(f"build       {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(built))})")
    for name, info in sorted(built.items()):
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    bulk = [phase_jitter(torch, dev, card, rng),
            phase_scatter(torch, dev, card, rng),
            phase_fill(torch, dev, card, rng)]
    per_eval = [phase_score_once(torch, dev, card, rng),
                phase_scan(torch, dev, card, rng)]
    launches = phase_path(torch, card)
    for k in bulk:
        k["launches"] = launches[k["name"]]
    launches = phase_spread(torch, card)
    for k in per_eval:
        k["launches"] = launches[k["name"]]
    phase_parity()
    phase_spread_parity()

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    kernels = bulk + per_eval
    for k in kernels:
        k["route"] = "cuda"
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
