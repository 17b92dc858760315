#!/usr/bin/env python3
"""Chip smoke test of the port (nomad_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device  -- require a CUDA card; print its name and power limit.
2. build   -- compile the CUDA kernels from nomad_tpu_torch/csrc (one nvcc
              per source, in parallel) into build/nomad_tpu_torch/.
3. B3      -- jitter kernel vs jitter_ref at G=16 x N_pad=16,384: bitwise
              (the kernel is on no path: B1 draws the same jitter in its
              launch).
4. B4      -- scatter kernel vs scatter_add_ref on (16,384, 4) with 1,024
              rows including duplicates and (0, 0) padding: exact. Timed
              beside index_add_ twice: host issue (cuda_time_ms, the
              event window around one call, as every record) and
              device-only (device_only_ms: a sleep kernel holds the stream
              while the host queues 100 calls). The wrapper must raise
              ValueError on a wrong dtype, shape or device and launch
              nothing, and launch nothing for no rows.
5. B1      -- solve_bulk_multi (one launch: the correction fold, the
              jitter and the fill) vs solve_bulk_multi_ref at the C2M width
              (10,240 nodes padded to 16,384, G=16, k=4,000) with the
              hazard rows mixed in: counts and carry exact. Then at N_pad
              32,768 (keys in shared memory) and 65,536 (in the global
              scratch): exact, one launch a call, timed.
6. B10     -- score_nodes_packed (B8 alone) vs its plain version at
              N_pad=8,192 with spread (explicit and even), distinct_hosts,
              distinct_property and penalty rows: NEG mask exact, scores
              within 1e-6.
7. B9      -- solve_task_group_fused vs its plain version at the cfg3
              width (5,120 nodes padded to 8,192, K=500 padded to 512, one
              rack spread over 20 values padded to 32, tie_perm), six
              hazard variants (two with value tables beyond warp 0's
              256 entries) and a second size (10,240 nodes padded to
              16,384, three spreads, a distinct_property, penalty steps):
              choices and founds exact, scores within 1e-6 (the max
              printed); timed at cfg3 and at 16,384, with the ms of an
              active step beside each launch time. Two more variants carry
              device and core count columns and a device-affinity
              sub-score: d = 6 on the lean cache (one spread, no
              distinct_property) and d = 8 (MAX_DIMS) with three spreads
              and a distinct_property; both exact and timed.
8. path    -- the C2M bulk path: 10,240 nodes, 64 batch jobs x 4,000 allocs
              (cpu 50, mem 32) through Harness.process("tpu-binpack") from
              16 threads. Every alloc placed once, no node over capacity
              (recomputed from the store), B1 launched once a
              solve_bulk_multi and B3/B4 never, no plain version on CUDA.
   server -- the same shape through the port's Server (bench.py
              run_server, cfg_c2m): nodes into the store, the first job's
              shape registered and deregistered (its 4,000 allocs stopped),
              then 64 jobs registered at once to 24 workers, one eval a
              dequeue, every plan re-checked by the plan applier; on
              cfg_c2m's two arms, a fresh Server each: the incremental feed
              on (NOMAD_TPU_INCR=1) and off (0, the kill switch). Every
              alloc live once, no node over capacity (recomputed from the
              store's live allocs), no eval left blocked, B1 launched once
              a service launch, no plain version on CUDA. The feed's arm
              also gates fast_hits > 0 and deltas_applied > 0, every
              service resync on the twin route, and an end-of-run check on
              the service's stream: the twin caught up by one B4 flush, the
              twin route's fold (one B4 launch) of the run's last 16 blocks
              as ledger entries equal to the host route's fold, and the
              feed's verify exact (base against a gen-bounded rebuild, the
              twin against base.astype(f32)); each B4 launch the feed and
              the twin route make is captured and replayed bit-exact
              against scatter_add_ref, the largest timed. The kill switch's
              arm gates that the feed builds, uploads and launches nothing.
              Prints allocs/s beside the Harness path's wall, the
              applier's applied / nodes_rejected / partial_commits /
              commit_batches, the rejection rate, each rejected node's
              usage rows against its capacity (watch_rejections: a false
              rejection or one that does not fit), the span medians per
              phase (obs/trace.py), and per arm the worker.tensor_build
              median, its changed_allocs, the feed's stats and the
              service's twin / host resyncs.
   binpack -- bench.py cfg_c2m's serial sample: 2 x 512 allocs (cpu 50,
              mem 32) on 10,240 nodes through Harness.process, under
              "tpu-binpack" and under "binpack" (the host placer), each
              after a warm-up job: 1,024 placed in each, no node over
              capacity; prints both walls.
9. spread  -- the per-eval path at cfg3 (bench.py cfg3_spread_50k): 5,120
              nodes, 100 service jobs x 500 allocs (cpu 100, mem 64) with
              spread on ${attr.rack} weight 50, through
              Harness.process("tpu-binpack") from 2 threads. Every alloc
              placed once, no node over capacity, B9 launched once per job,
              no plain version on CUDA; prints allocs/s and the per-job
              rack-count spread.
   devices -- BASELINE config 5 (bench.py cfg5_devices_numa): 2,048 GPU
              nodes (8 nvidia/gpu/a100 instances, 16 cores in two NUMA
              domains), a warm-up job processed and deleted, then 16 jobs
              x 512 allocs (cpu 200, mem 256, one GPU, two cores,
              numa_affinity "prefer") through Harness.process
              ("tpu-binpack"): one B9 launch a job with a device and a
              cores column (d = 6), then the host's instance and core
              assignment per placement. Gates: 8,192 placed with one
              instance and two cores each, no instance or core held twice
              on a node, no node over capacity or its instance count, B9
              once a job at d = 6 and nothing else, no plain version on
              CUDA; each launch's inputs copied and replayed exact against
              the plain version and the path's output, timed. Prints the
              wall, allocs/s, the B9 calls' and the id assignment's share
              of it; then the host "binpack" on the 2-job sample.
   constraints -- BASELINE config 2 (bench.py cfg2_batch_constraints)
              through the port's Server: 1,024 nodes, 10 batch jobs x
              1,024 allocs with an instance.type and a version constraint
              and a zone affinity, 4 workers. Gates as "server" (10,240
              live, no node over capacity, no eval blocked), every alloc on
              a node its constraints admit, B1 once a service launch;
              prints the plan rejection rate.
10. B3'     -- the joint solve's fold_in jitter (jitter_fold) vs its plain
              version: 5 restarts x G=16 x N_pad=16,384 in one launch,
              bitwise (the kernel is on no path: B5 draws the same jitter
              in its launch).
11. B5/B6  -- the auction (5 restarts, one launch, its draws inside) and
              the pick vs their plain versions (B5's on jitter_fold_ref's
              draws), then solve_batch vs solve_batch_ref, at the
              C2M width (build_nodes capacities of 10,240 nodes padded to
              16,384, G=16, k=800, bench asks) on six variants (main:
              contested near-full nodes; evict; overshooting corrections;
              k=0 / sparse / infeasible rows; a 3-round cap; wide: free
              capacity on every node, long auctions): take, used, rounds,
              counts and info exact; each restart's rounds and full row
              scans printed. B5 also at G 64 (the path shape's rows four
              times over: its lists in the global scratch, several rows
              a scanning CTA), exact. The pick alone at N_pad 32,768 and
              65,536 (synthetic takes and carries from the seed, restart 3
              an exact copy of restart 1; B5 stops at 16,384), exact. B5
              timed on main and wide, with its time per round; the pick on
              main, wide and the two wide pads, by events and device-only.
12. solve  -- the "tpu-solve" path at bench.py cfg_solve_ab's c2m_mini shape:
              2,560 nodes, 50 batch jobs x 800 allocs cycling its asks, in
              worker batches of 8 (one thread per member inside
              batch_member) through Harness.process("tpu-solve"). Every
              alloc placed once, no node over capacity, joint launches >= 1,
              joint score >= greedy score, B5/B6/B1 launched once per
              joint launch (B4's fold before them where there are
              corrections), B3 and B3' never, no plain version on CUDA.
              Each joint launch's inputs are copied as it is dispatched.
    runs   -- those joint launches replayed at the path's shape (N_pad
              4,096, G 16): solve_batch, B5 and the pick exact against
              their plain versions on each (B5's rounds and full row scans
              printed), B3' bitwise on the same seeds; B3', B5, the pick,
              B1 and the whole launch timed on each, and the launches'
              device time set against the path's wall. The kernel records
              of B3', B5 and the pick are these means.
   server solve -- that shape through the Server: 8 workers in batches of
              8 (cfg_solve_ab), the batch's members meeting in the solver
              service's rendezvous, on the two feed arms; the gates of
              "server", joint launches >= 1, B5 and the pick launched once
              a joint launch.
13. B7/B12 -- preempt_solve and preempt_pick vs their plain versions at the
              C2M width (build_nodes capacities of 10,240 nodes padded to
              16,384, K 512, V 8, cpu and memory used at 95-105%) on ten
              variants (main, ties, inactive, infeasible, wide: one node
              with 512 victims, flagged, fits; allneg: every node NEG
              after 200 steps, B7's early exit; ragged: N_pad 10,247, the
              tree's part-empty segment; n32768: N_pad 32,768, B7's keys
              in the global scratch): B7 picks, victims, flags and scores
              exact, B12 picks exact. Both timed on main beside their
              plain versions and numpy mirrors, and on infeasible (each
              one's set-up pass alone: every step after it exits early),
              with the time of a placed step past it.
14. cfg4   -- BASELINE config 4 (bench.py cfg4_system_preemption): 1,024
              nodes, a warm job deleted, a priority-20 filler, then the
              priority-80 service of 512 allocs (one preempt_solve launch
              at N_pad 1,024, K_pad 512, V_pad 512) and the system job
              through Harness.process("tpu-binpack", preemption on). Gates:
              512 + 1,024 placed, no node over capacity, no alloc evicted
              twice, every victim 10 or more priorities below its evictor,
              kernel_preempted 512 / host_preempted 0 /
              victim_parity_checked 512, preempt_solve launched, no plain
              version on CUDA. Each launch's inputs are copied as it is
              dispatched.
    runs   -- that launch replayed: exact against the plain version and the
              numpy mirror; kernel, plain, mirror and the inputs' copy to
              the card timed; the kernel's set-up pass alone (the same
              inputs with no feasible node) and its time a placed step.
15. cutover -- the numpy mirror against the kernel with its copies at
              (N_pad, K_pad) = (256, 64), (1,024, 128), (1,024, 512),
              (4,096, 512), V 8: the H100's side of PREEMPT_DEVICE_MIN.
16. B11'    -- the fused bulk scan's tie-break permutation (nt_tie_perm) vs
              permutation_ref at n 1,024 (one round), 16,384, 32,768 and
              65,536 (two rounds; the buffers in a global scratch above
              16,384), nine seeds including 0, 2^32 - 1 and one whose
              draws collide at 16,384: bitwise. Timed at 16,384 and
              65,536 beside the plain version and, as a yardstick only,
              torch.sort(stable=True) of one round's int64 keys.
17. B11    -- the bulk scan vs its plain version at the C2M width (N_pad
              16,384, D 4, k 40,000) on seven variants: fused main, fused
              with a remainder, fused with an all-zero ask, generic with
              WorstFit, with distinct_hosts, with two spread tables, and
              fused on identical nodes: counts exact. The cap <= 1
              variants (WorstFit, distinct_hosts) and the spread tables
              timed, with their time an active step.
18. large  -- the bulk fallback's path ("C2M large groups"): 10,240 nodes,
              8 batch jobs of one group of 40,000 allocs (cpu 50, mem 32),
              one after another from one thread through
              Harness.process("tpu-binpack"); each group is above the
              service's MAX_K, so each eval is one solve_bulk_fused call.
              Gates: 320,000 placed, no node over capacity, 8 B11 and 8
              B11' launches, no service launch, no plain version on CUDA;
              prints the eval walls and B11's share of them on the card.
    runs   -- those calls replayed: exact against the plain version; the
              scan and the permutation timed alone beside their plain
              versions. The B11 and B11' records are their means.
19. parity -- job 0 of that path through Harness(device="cpu"): the card's
              per-node counts. Then the reference's bulk-preemption
              scenario (16 nodes, BULK_MIN 16, both groups through
              _place_bulk) on the mirror route and with PREEMPT_DEVICE_MIN
              0 on the kernel, on the card and on the CPU: 32 placed,
              victims unique, capacity holds, card == CPU.
20. parity -- the pinned 256-node bulk workload under "tpu-binpack" and under
              "tpu-solve", the spread / distinct_hosts / distinct_property /
              host-oracle workload, and cfg4, on the card and on the CPU
              plain versions: the same placements (and victims).
21. barrier -- csrc/mesh.cuh's barrier alone (sharding.barrier_probe):
              2,000 rounds of 48 CTAs, no stale read of a double-buffered
              slot, timed a round; then a barrier missing one of its
              participants, in a process of its own: the launch must raise
              (the bounded spin traps) after the bound, not hang.
    shards -- the node-sharded kernels on one process's mesh (shards on the
              card's devices in turn; with one card every shard on cuda:0,
              each with its own parts): every shard's B3 / B3'
              jitter slice bitwise equal to the full draw; B15
              (nt_scatter_shards, one host call for the S launches) exact
              against its plain version and B4 at S 2, 4, 8 on 1,024 and
              4,096 rows, and with the clamp of the correction fold
              against its plain version; its wrapper raises ValueError on
              a wrong dtype, shape or device and launches nothing for no
              rows; timed at S 4 beside
              index_add_ (host issue); the incremental feed's twin on an
              S 4 mesh at the C2M width, flushed by B15's adds (one launch
              a shard), equal to its single-device twin flushed by B4 and
              to base.astype(f32); B13 (the sharded greedy
              fill) at bench.py cfg7_sharded_5k's shape (10,240 nodes, G 16,
              k 512) and at the C2M width with the B1 hazards (N_pad 16,384,
              k 4,000) at S 2, 4, 8, and a top_r 8 many-round variant:
              counts, carry and rounds exact against the plain version,
              counts and carry against single-device B1; B14 (the sharded
              joint solve) on the six B5/B6 variants at S 2, 4, 8: used,
              counts, info and gathers exact against the plain version,
              counts, used and info[2:] against single-device solve_batch,
              scores within 1e-6; B14 also at S 32 on the "cap" variant
              against the plain version (on one card more CTAs than it
              holds at once: each CTA takes two shards). Each B13 and B14
              solve launches its
              kernel once a card (nt_bulk_shard_solve, nt_joint_shard_solve:
              every round on the device) and B15's fold, nothing else. Then
              one B13 and one B14 solve at S 4 timed on the phase's mesh
              and, where that spans cards, on one card.
22. shard path -- the C2M path (10,240 nodes, 64 x 4,000, 16 threads)
              through a service with a 4-shard mesh: the path gates,
              sharded == launches, all-gathers == the launches' rounds,
              B13 launched once a card a solve and B15 once a shard, no
              plain version on CUDA; prints the host calls a solve (from
              the launch counts: 2, the fold and the solve); each launch's
              inputs copied as it is dispatched.
23. shard solve -- the tpu-solve c2m_mini path (2,560 nodes, 50 x 800,
              batches of 8) through a 4-shard mesh service: the same gates,
              joint score >= greedy score, B14 launched once a card a
              solve (its greedy arm inside: no B13 launch).
    runs   -- both paths' launches replayed: exact against the plain sharded
              versions and the single-device kernels; B13 and B14 timed
              beside B1 and solve_batch at the same inputs. Then B15 on
              the C2M path's corrections: the launch the path makes (the
              correction fold: adds, then the clamp of every row) and
              state_scatter_sharded (the adds alone), each exact against
              its plain version and timed host issue and device-only,
              the adds beside index_add_ (both readings). The kernel
              records of B13, B14 and B15 are these means.
24. parity -- a pinned one-thread workload at 10,240 nodes (8 x 4,000
              tpu-binpack, 8 x 800 tpu-solve) on a service with no mesh and
              with 2, 4 and 8 shards: the same fingerprint at every S.
25. B16    -- the sharded per-eval scan (nt_task_group_shard_solve: one
              host call, one cooperative launch a card a solve, every step
              inside it) at S 2, 4, 8 on the five cfg3 variants of B9 (5,120
              nodes padded to 8,192, K 512) and at the C2M width (10,240
              build_nodes capacities padded to 16,384, K 512, S 8):
              choices, founds and score bits equal to single-device B9
              (solve_task_group), one launch a card a solve and nothing
              else; against its plain
              version (cfg3 at S 4, the others at S 2) choices and founds
              exact, scores within 1e-6. Timed at cfg3, S 4, beside B9 on
              the same inputs.
26. entry  -- the port's entry points on the card: graft_entry.entry()'s
              solve, then dryrun_multichip(2), (4) and (8) (B16 against a
              one-shard mesh, B13 against B1); prints each mesh's shards
              and distinct cards. Gates: B16, B9, B13 and B1 launched, B16
              once a card a solve (6 solves), no plain version on CUDA.
              Its B16 launches are the record's.
              After the counts are read, B16 at the dryruns' own shapes
              (32, 32, 64 nodes at S 2, 4, 8, K 8): against its plain version
              choices and founds exact, scores within 1e-6 (into the
              record's max_abs_err), score bits equal to B9.

cfg4's two evals print the time the interpreter's garbage collector
took inside them (gc.callbacks): their walls are host-bound, and a full
collection can land in either.

``python3 chip_smoke.py --server`` runs the build, the Server phases
(C2M and tpu-solve, each on both feed arms) and the binpack sample
alone, then prints their records as one JSON line.
``python3 chip_smoke.py --devices`` runs the build, B9 on its variants
and the config 5 ("devices") and config 2 ("constraints") phases alone,
then prints their records as one JSON line.
``python3 chip_smoke.py --sharded`` runs the build and phases 21 (the
feed's sharded twin included), 25 and 26 alone: with several visible cards, every mesh puts its
shards on the cards in turn, so the gathers cross cards (B13's, B14's
and B16's pushes and barriers through peer access).
``python3 chip_smoke.py --shard-times`` runs the build and phases 22
and 23's paths, replays their launches exact against the plain
versions and times B13, B14, B1 and solve_batch on them, through
wrappers that its parent has too: copied into another checkout, it
times that one's B13 and B14 in the same call.
``python3 chip_smoke.py --kernel-times`` runs the build and times B5,
the whole solve_batch and the pick alone at the tpu-solve path's shape
and at "main" and "wide", B3' by events and device-only, B7 at cfg4's
shape and at the C2M width, B11' at n 16,384, B9 at cfg3, B11 on its
seven variants, B16 at cfg3, S 4 beside B9 on the same inputs, B1
(solve_bulk_multi) beside B13 at S 4 on phase 5's inputs, and B12 at the
C2M width and its set-up pass alone (each checked against its plain
version, B16 against B9, B13 against B1's counts) through wrappers an
older checkout has too: copied into another checkout, it times that
one's kernels in the same call.
``python3 chip_smoke.py --b5-split`` runs the build and B5's phases:
batch_solve.cu built with -DB5_SPLIT, which adds up clock64 between its
barriers (the first round's scans and set-up, then each phase of a
round), swapped in for nt_auction on "path", "main" and "wide", each
exact.
``python3 chip_smoke.py --launch-split`` runs the build and only the
split of a launch's host time: B4, B15 (S 4 on the card) and
index_add_, and each piece of a launch alone (_ext.entry, a device
switch and read, the stream handle, the bare ctypes call, ...),
perf_counter_ns over 2,000 calls; then the three calls' device-only
times.

Before the kernel line it prints the Server phases' records, the
binpack sample's walls and the config 5 and config 2 records as one JSON
line (``{"server": ...}``: per arm
allocs/s, the applier's counts, each rejected node's rows, the service's
counts, the feed's stats, its B4 launches, the kernel launches and the
span split).
Before the last line it prints one JSON line with every kernel's launches
on its path, error against its plain version, times and bound (B4's
record adds ``device_ms`` and ``library_device_ms``, the device-only
readings, ``server_launches``, its launches in the fed Server arm's
timed window, and ``twin``, its time at the twin's shape on that arm; B15's, the launch its path makes, adds ``device_ms`` and
``without_clamp``, the adds alone beside index_add_; B7's and B12's add
``ms_per_step`` and ``setup_ms``; the B11' record adds ``by_n``, its times at
16,384 and 65,536 beside one round's torch.sort; B9's adds ``by_d``, its
times at d = 6 and d = 8 on the device variants; ``solve_task_group_d6``
is B9 on the config 5 path, its launches there and its replayed launches'
mean; B1's adds ``constraints_launches``, its launches on the config 2
path), and the card's name
and power limit; the last line is the device summary.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import random
import statistics
import subprocess
import sys
import time
from collections import Counter
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
# the joint solve ("tpu-solve"): bench.py cfg_solve_ab's asks (:678-679)
# and its c2m_mini shape (:689-695), batches of 8 as Worker.process_batch
# runs them at eval_batch_size=8
SOLVE_ASKS = ((60, 48), (240, 96), (100, 192), (180, 64), (80, 160),
              (220, 48), (140, 128), (60, 224), (200, 80), (120, 112))
SOLVE_K = 800
MINI_NODES = 2560
MINI_JOBS = 50
MINI_BATCH = 8
PATH_PAD = 4096     # the service's N_pad for 2,560 nodes
# the Server path (nomad_tpu_torch/core) at bench.py run_server's shape
SERVER_WORKERS = 24       # cfg_c2m (bench.py:428-431)
# waves of jobs a Server phase times. The service resyncs at the first
# launch that sees RESYNC_SOLVES (64) solves since the warm-up's resync;
# two waves are 2 x 64 (C2M) or 2 x 50 (tpu-solve) solves, past 64 by more
# than one launch's group (16 or 8), so a resync falls in the timed window
# whatever the grouping: on the fed arm the twin route, with its B4 flush
WAVES = 2
SOLVE_WORKERS = 8         # cfg_solve_ab's c2m_mini (bench.py:693-695)
# BASELINE config 5 (bench.py cfg5_devices_numa, :820-889): GPU nodes,
# jobs of device asks with two reserved cores, its 2-job host sample
CFG5_NODES = 2048
CFG5_JOBS = 16
CFG5_K = 512
CFG5_SAMPLE = 2
# BASELINE config 2 (bench.py cfg2_batch_constraints, :288-337) through
# the Server: 4 workers race the plan applier
CFG2_NODES = 1024
CFG2_JOBS = 10
CFG2_K = 1024
CFG2_WORKERS = 4


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


class GcClock:
    """Wall time the interpreter's garbage collector takes while the
    clock is open, by generation (``gc.callbacks``): host-bound walls
    move with where a full collection lands."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self.n = [0, 0, 0]
        self._t0 = None

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3
            self.n[g] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._tick)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)
        return False

    def __str__(self) -> str:
        return (f"gc {sum(self.ms):.1f} ms in {sum(self.n)} collections "
                f"(full: {self.n[2]}, {self.ms[2]:.1f} ms)")


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
    u = used0.clone()
    dev_ms = device_only_ms(torch, lambda: scatter_add(u, idx, delta))
    lib_dev = device_only_ms(torch, lambda: u.index_add_(0, idx64, delta))
    refusals(torch, "B4", scatter_add, (used0.clone(), idx, delta))
    rows = len(np.unique(idx_np))
    b_ms, b_by = bound(b * 4 + b * 16 + 2 * rows * 16, b * 4)
    print(f"B4 scatter  [{card}] exact; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, index_add_ {lib:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}); device-only: kernel {dev_ms:.4f} ms, index_add_ "
          f"{lib_dev:.4f} ms; ValueError on a wrong dtype, shape and device")
    return {"name": "scatter_add", "source": "nomad_tpu_torch/csrc/scatter.cu",
            "replaces": "nomad_tpu/tensor/incremental.py:101",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "device_ms": dev_ms, "library_device_ms": lib_dev}


def refusals(torch, what, call, args):
    """``call(used, idx, delta)`` raises ValueError and launches nothing
    when idx is int64, delta (B, 3), idx or delta on the CPU, or the
    carry float64; for a mesh's parts (a list), also when the second
    part lies on the CPU. (A CPU carry alone takes the plain version.)
    With no rows it launches nothing."""
    from nomad_tpu_torch import _ext

    used, idx, delta = args
    mesh = isinstance(used, list)
    cases = {
        "int64 idx": (used, idx.to(torch.int64), delta),
        "(B, 3) delta": (used, idx, delta[:, :3].contiguous()),
        "idx on the CPU": (used, idx.cpu(), delta),
        "delta on the CPU": (used, idx, delta.cpu()),
        "float64 carry": ([p.double() for p in used] if mesh
                          else used.double(), idx, delta),
    }
    if mesh:
        cases["a part on the CPU"] = (
            [p.cpu() if s == 1 else p for s, p in enumerate(used)], idx,
            delta)
    before = _ext.COUNTS.snapshot()["launches"]
    for name, bad in cases.items():
        try:
            call(*bad)
        except ValueError:
            continue
        raise AssertionError(f"{what}: no ValueError for {name}")
    call(used, idx[:0], delta[:0])
    torch.cuda.synchronize()
    if _ext.COUNTS.snapshot()["launches"] != before:
        raise AssertionError(f"{what}: a refused call, or one with no "
                             f"rows, launched")


SPLIT_CALLS = 2000
SLEEP_CYCLES = 20_000_000


def host_us(torch, fn, calls=SPLIT_CALLS) -> float:
    """Mean host time of one ``fn()`` in us over ``calls`` back-to-back
    calls (perf_counter_ns), after a warm-up, the card idle before."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def device_only_ms(torch, fn, reps=100) -> float:
    """The card's own time of one ``fn()``: a sleep kernel queued ahead
    holds the stream while the host issues ``reps`` calls back to back,
    then the event window of the calls over ``reps``. The sleep doubles
    until it outlasts the host's issue, so no host time is in the
    window."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(6):
        before, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        before.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if before.elapsed_time(start) > issue_ms:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise AssertionError("device_only_ms: the host's issue outlasted every "
                         "sleep")


def phase_launch_split(torch, dev, card):
    """The host's time to issue B4 and B15 (S 4 on this card) and
    index_add_ on phase 4's inputs, split into the pieces of a launch,
    each timed alone over SPLIT_CALLS calls; then the three calls'
    device-only times. ``--launch-split`` alone; not in the full run."""
    from nomad_tpu_torch import _ext
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.scatter import scatter_add

    rng = np.random.default_rng(4)
    used = torch.tensor(rng.integers(0, 5000, (N_PAD, 4)).astype(np.float32),
                        device=dev)
    b = 1024
    idx = torch.tensor(rng.integers(0, N_NODES, b).astype(np.int32),
                       device=dev)
    delta = torch.tensor(rng.integers(-300, 300, (b, 4)).astype(np.float32),
                         device=dev)
    idx64 = idx.to(torch.int64)
    mesh = mesh_of(4)
    parts = sh.shard_rows(mesh, used.clone())
    fn = _ext.entry("nt_scatter_add")
    ptrs = (used.data_ptr(), idx.data_ptr(), delta.data_ptr())
    handle = torch.cuda.current_stream(dev).cuda_stream
    i = dev.index

    def switch():
        with torch.cuda.device(dev):
            pass

    pieces = (
        ("B4 call (scatter_add)", lambda: scatter_add(used, idx, delta)),
        ("B15 call, S 4 (state_scatter_sharded)",
         lambda: sh.state_scatter_sharded(mesh, parts, idx, delta)),
        ("index_add_", lambda: used.index_add_(0, idx64, delta)),
        ("_ext.launch of B4", lambda: _ext.launch(
            "scatter_add", dev, fn, *ptrs, b, 4, N_PAD)),
        ("_ext.entry", lambda: _ext.entry("nt_scatter_add")),
        ("device switch (torch.cuda.device)", switch),
        ("device read (torch.cuda.current_device)",
         torch.cuda.current_device),
        ("device read (torch._C._cuda_getDevice)", torch._C._cuda_getDevice),
        ("stream handle (current_stream().cuda_stream)",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("stream handle (_cuda_getCurrentRawStream)",
         lambda: torch._C._cuda_getCurrentRawStream(i)),
        ("ctypes call returning at once (b 0)",
         lambda: fn(*ptrs, 0, 4, N_PAD, handle)),
        ("ctypes call with its launch (b 1,024)",
         lambda: fn(*ptrs, b, 4, N_PAD, handle)),
        ("data_ptr x 3", lambda: (used.data_ptr(), idx.data_ptr(),
                                  delta.data_ptr())),
        ("a shard's idx/delta .to() x 2", lambda: (
            idx.to(dev, torch.int32, non_blocking=True).contiguous(),
            delta.to(dev, torch.float32, non_blocking=True).contiguous())),
        ("COUNTS bump", lambda: _ext.COUNTS.launched("scatter_add")),
        ("one launch through torch's runtime (torch.cuda._sleep(0))",
         lambda: torch.cuda._sleep(0)),
    )
    b15 = _ext.entry("nt_scatter_shards")
    # the copies b15_args point into are held while the pieces run
    b15_args, b15_copies = sh._scatter_args(mesh, parts, idx, delta)
    pieces += (
        ("B15's checks and arguments (sharding._scatter_args)",
         lambda: sh._scatter_args(mesh, parts, idx, delta)),
        ("B15's _ext.launch, S 4, arguments built",
         lambda: _ext.launch("scatter_shard", mesh.devices, b15, *b15_args,
                             0)),
    )
    us = {label: host_us(torch, f) for label, f in pieces}
    us["B4's Python around its ctypes call (by difference)"] = (
        us["B4 call (scatter_add)"]
        - us["ctypes call with its launch (b 1,024)"])
    for label, v in us.items():
        print(f"split       [{card}] {label}: {v:.3f} us a call")
    dev_ms = {
        "B4": device_only_ms(torch, lambda: scatter_add(used, idx, delta)),
        "B15 S 4": device_only_ms(torch, lambda: sh.state_scatter_sharded(
            mesh, parts, idx, delta)),
        "index_add_": device_only_ms(
            torch, lambda: used.index_add_(0, idx64, delta)),
    }
    print(f"split       [{card}] device-only, {b} rows on ({N_PAD}, 4): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items()))


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


def fill_bound(t, counts):
    """Least time of one B1 launch on these inputs: the carry in and out,
    capacity, the (G, N) mask and affinity rows and the slots in, the
    (G, N) int16 counts out; and the 32-bit operations this data needs:
    the slots' adds and the clamp of every row, then per eval every
    feasible node's fit, score and cap (~60, two powf counted as 20 each)
    and, where its cap is above 0, its threefry draw and key (~125), and
    the fill's level over those keys (~10 a node)."""
    n = t["used"].shape[0]
    g, c = t["feas"].shape[0], t["cidx"].shape[0]
    n_bytes = (n * 16 * 3 + g * n * (1 + 4 + 2) + g * 24 + c * 20)
    feasible = int(t["feas"].sum())
    live = int((counts > 0).sum())  # at least the nodes that took
    return bound(n_bytes, c * 4 + n * 4 + feasible * 60 + live * 135)


def phase_fill(torch, dev, card, rng):
    from nomad_tpu_torch.tensor.kernels import (bulk_fill, bulk_fill_ref,
                                                solve_bulk_multi,
                                                solve_bulk_multi_ref)

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
    fill_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"],
                 t["seeds"], t["cidx"], t["cdelta"])
    ms = cuda_time_ms(torch, lambda u: bulk_fill(u, *fill_args),
                      setup=t["used"].clone, reps=10)
    plain = cuda_time_ms(torch, lambda u: bulk_fill_ref(u, *fill_args),
                         setup=t["used"].clone, reps=5, warmup=1)
    b_ms, b_by = fill_bound(t, got)
    print(f"B1 fill     [{card}] counts and carry exact ({placed} placed "
          f"over {G} rows, the fold and the jitter in the launch); kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"name": "bulk_fill", "source": "nomad_tpu_torch/csrc/bulk_fill.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:666",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def wide_fill_inputs(torch, dev, rng, n_pad: int):
    """b1_inputs' hazards at N_pad ``n_pad`` (5/8 of it real nodes, the
    C2M ratio): duplicate correction rows past the clamp, an
    all-infeasible row, k 0 rows, and an eval whose budget the best node
    takes alone (k 1)."""
    real = n_pad * 5 // 8
    avail = np.zeros((n_pad, 4), np.float32)
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2] = 102400
    avail[:real, 3] = 12001
    used = np.zeros((n_pad, 4), np.float32)
    fill = rng.integers(0, 120, real).astype(np.float32)
    used[:real, :3] = fill[:, None] * np.array([50, 32, 300], np.float32)
    feas = np.zeros((G, n_pad), bool)
    feas[:, :real] = rng.random((G, real)) < 0.95
    feas[3] = False
    aff = np.zeros((G, n_pad), np.float32)
    aff[5, :real] = rng.choice([0.0, 0.5, -0.5, 1.0], real)
    ask = np.tile(np.array([50, 32, 300, 0], np.float32), (G, 1))
    ask[7] = [100, 0, 300, 0]
    ask[9] = [4000, 8192, 300, 0]
    k = np.full(G, K, np.int32)
    k[11] = 0
    k[13] = 1                                # the best node alone
    seeds = rng.integers(0, 2 ** 32, G).astype(np.int64)
    c = 64
    cidx = np.zeros(c, np.int32)
    cdelta = np.zeros((c, 4), np.float32)
    rows = rng.integers(0, real, 40)
    cidx[:40] = rows
    cidx[40:48] = rows[0]
    cdelta[:48, :3] = -used[cidx[:48], :3] - 1000.0
    t = {name: torch.tensor(v, device=dev) for name, v in (
        ("used", used), ("avail", avail), ("feas", feas), ("aff", aff),
        ("ask", ask), ("k", k), ("seeds", seeds), ("cidx", cidx),
        ("cdelta", cdelta))}
    t["tgc"] = torch.ones(G, device=dev)
    return t


def phase_fill_wide(torch, dev, card, rng):
    """B1 above the old 16,384-node ceiling: N_pad 32,768 (keys and caps
    in shared memory) and 65,536 (in the global scratch), exact against
    solve_bulk_multi_ref, each timed."""
    from nomad_tpu_torch import _ext
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)

    notes = []
    for n_pad in (32768, 65536):
        t = wide_fill_inputs(torch, dev, rng, n_pad)
        args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"],
                t["tgc"], t["seeds"], t["cidx"], t["cdelta"])
        before = _ext.COUNTS.snapshot()["launches"]
        got_used, got = solve_bulk_multi(t["used"].clone(), *args, g=G)
        after = _ext.COUNTS.snapshot()["launches"]
        want_used, want = solve_bulk_multi_ref(t["used"].clone(), *args,
                                               g=G)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got_used, want_used)):
            raise AssertionError(f"B1 at N_pad {n_pad}: differs from "
                                 f"solve_bulk_multi_ref "
                                 f"({int((got != want).sum())} count cells)")
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        if launched != {"bulk_fill": 1}:
            raise AssertionError(f"B1 at N_pad {n_pad}: launched {launched}")
        ms = cuda_time_ms(torch, lambda u: solve_bulk_multi(u, *args, g=G),
                          setup=t["used"].clone, reps=5)
        b_ms, _ = fill_bound(t, got)
        notes.append(f"N_pad {n_pad}: {int(got.sum())} placed (eval 13, "
                     f"k 1: node {int(got[13].argmax())}), {ms:.4f} ms "
                     f"(bound {b_ms:.6f})")
    print(f"B1 wide     [{card}] counts and carry exact, one launch a call: "
          + "; ".join(notes))


def fold_bound(n_t: int, g: int, n: int):
    """Least time of one B3' launch: seeds in, (T, G, n) floats out; one
    threefry (~120 32-bit ops with the float build) per element and one
    fold_in per (t, eval) row."""
    return bound(g * 8 + n_t * g * n * 4, n_t * g * (n + 1) * 120)


def phase_jitter_fold(torch, dev, card, rng):
    """B3': the restarts' fold_in draws for all five PORTFOLIO entries,
    16 x 16,384 each, in one launch, bitwise."""
    from nomad_tpu_torch.tensor.batch_solver import _jitter_his
    from nomad_tpu_torch.tensor.prng import jitter_fold, jitter_fold_ref

    seeds = torch.tensor(
        np.concatenate([[0, 1, 2 ** 31, 2 ** 32 - 1],
                        rng.integers(0, 2 ** 32, G - 4)]).astype(np.int64),
        device=dev)
    his = _jitter_his()
    got = jitter_fold(seeds, N_PAD, his)
    want = jitter_fold_ref(seeds, N_PAD, his)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = [t for t in range(len(his))
               if not torch.equal(got[t].view(torch.int32),
                                  want[t].view(torch.int32))]
        raise AssertionError(f"B3' jitter_fold differs from its plain "
                             f"version at restarts {bad}")
    ms = cuda_time_ms(torch, lambda _: jitter_fold(seeds, N_PAD, his))
    plain = cuda_time_ms(torch, lambda _: jitter_fold_ref(seeds, N_PAD, his))
    b_ms, b_by = fold_bound(len(his), G, N_PAD)
    print(f"B3' fold    [{card}] bitwise equal, {len(his)} restarts x {G} x "
          f"{N_PAD} in one launch; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")


_CAPACITY = {}


def c2m_capacity(n_nodes: int = N_NODES) -> np.ndarray:
    """(n_nodes, 4) capacities of build_nodes(..., n_nodes, seed 0)."""
    if n_nodes not in _CAPACITY:
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.state import StateStore

        store = StateStore()
        mock.build_nodes(store, n_nodes, seed=0)
        _CAPACITY[n_nodes] = np.stack(
            [n.available_vec() for n in store.snapshot().nodes()])
    return _CAPACITY[n_nodes]


def solve_inputs(torch, dev, rng, variant: str):
    """B5/B6 inputs at the C2M width: N_pad 16,384 with the build_nodes
    capacities of 10,240 nodes and zero padded rows, G = 16 evals of
    SOLVE_K allocs cycling the bench asks, and usage pre-filled so that
    ~5% of the nodes hold all the free capacity (a few dozen allocs each)
    and the demand is ~75% of the free cpu: the evals contest the same
    near-full nodes round after round. Variants: "main"; "evict" (victim
    budgets and net priorities, twice the demand, so only evicting bids
    can place it all); "correction" (negative
    corrections that overshoot, so the clamp matters); "sparse" (k = 0
    rows, a row with 5 feasible nodes, an all-infeasible row); "cap"
    (rounds = 3); "wide" (the same demand, but the free capacity spread
    over every node, a few allocs' worth each: no auction converges
    within the round cap); "path" (the tpu-solve path's launch shape:
    the build_nodes capacities of 2,560 nodes padded to 4,096, a worker
    batch of 8 evals and 8 k = 0 padding rows, every node part used)."""
    from nomad_tpu_torch import mock

    n_nodes, n_pad = ((MINI_NODES, PATH_PAD) if variant == "path"
                      else (N_NODES, N_PAD))
    avail = np.zeros((n_pad, 4), np.float32)
    avail[:n_nodes] = c2m_capacity(n_nodes)
    ask = np.stack([mock.service_job(1, cpu=c, mem=m).task_groups[0]
                    .combined_resources().vec()
                    for c, m in (SOLVE_ASKS[i % len(SOLVE_ASKS)]
                                 for i in range(G))]).astype(np.float32)
    k = np.full(G, SOLVE_K, np.int32)
    if variant == "path":
        k[MINI_BATCH:] = 0
    demand = float((k * ask[:, 0]).sum())
    open_nodes = rng.random(n_nodes) < (0.05 if variant in (
        "main", "evict", "correction", "sparse", "cap") else 1.0)
    share = demand / 0.75 / float(avail[:n_nodes, 0][open_nodes].sum())
    fill = np.where(open_nodes, 1.0 - share * rng.uniform(0.5, 1.5, n_nodes),
                    1.0)
    if variant == "path":
        fill = rng.uniform(0.0, 0.5, n_nodes)
    used = np.zeros((n_pad, 4), np.float32)
    used[:n_nodes, :3] = np.floor(avail[:n_nodes, :3] * fill[:, None])
    feas = np.zeros((G, n_pad), bool)
    feas[:, :n_nodes] = rng.random((G, n_nodes)) < 0.95
    aff = np.zeros((G, n_pad), np.float32)
    aff[5, :n_nodes] = rng.choice([0.0, 0.0, 0.5, -0.5], n_nodes)
    seeds = rng.integers(0, 2 ** 32, G).astype(np.int64)
    cidx = np.zeros(64, np.int32)
    cdelta = np.zeros((64, 4), np.float32)
    evict = net_prio = None
    rounds = 64
    if variant == "evict":
        k[:] = 2 * SOLVE_K          # past the free capacity: evictions pay
        evict = np.zeros((n_pad, 4), np.float32)
        victims = rng.random(n_nodes) < 0.4
        evict[:n_nodes, 0] = victims * 2000.0
        evict[:n_nodes, 1] = victims * 4096.0
        net_prio = np.zeros(n_pad, np.float32)
        net_prio[:n_nodes] = rng.uniform(0.0, 4000.0, n_nodes)
    elif variant == "correction":
        rows = rng.integers(0, n_nodes, 48)
        cidx[:48] = rows
        cdelta[:48, :3] = -used[rows, :3] - 1000.0   # overshoots: clamp
    elif variant == "sparse":
        k[[11, 15]] = 0
        feas[3] = False
        feas[3, rng.choice(n_nodes, 5, replace=False)] = True
        feas[8] = False
    elif variant == "cap":
        rounds = 3
    t = {name: torch.tensor(v, device=dev) for name, v in (
        ("used", used), ("avail", avail), ("feas", feas), ("aff", aff),
        ("ask", ask), ("k", k), ("seeds", seeds), ("cidx", cidx),
        ("cdelta", cdelta))}
    t["tgc"] = t["k"].float()
    t["evict"] = None if evict is None else torch.tensor(evict, device=dev)
    t["net_prio"] = (None if net_prio is None
                     else torch.tensor(net_prio, device=dev))
    t["rounds"] = rounds
    t["free_share"] = demand / float(np.maximum(
        avail[:n_nodes, 0] - used[:n_nodes, 0], 0.0).sum())
    return t


def auction_ops(torch, used0, avail, feas, aff, ask, k, jits, price_eps,
                rounds=64, evict=None, net_prio=None):
    """The operations of the rounds each B5 restart ran on these inputs,
    counted from the plain version's trace of this run: per (eval with
    demand, node) ~6 for the mask and fit test, per fitting pair ~60 more
    (fitness with two powf counted 20 each, score, jitter, price, the
    top-R test), per round ~30 per surfaced entry (winner, cap, fill,
    price). Returns (operations, rounds per restart, the pairs that fit in
    the first round: each one's draw is needed at least once)."""
    from nomad_tpu_torch.tensor.batch_solver import (TOP_R, auction_ref,
                                                     preempt_score_ref)

    n, g = avail.shape[0], feas.shape[0]
    start = torch.clamp_min(used0, 0.0)
    pscore = None if net_prio is None else preempt_score_ref(net_prio)
    ops = drawn = 0
    run = []
    for r, eps in enumerate(price_eps):
        trace = []
        auction_ref(start, avail, feas, aff, ask, k, jits[r], rounds=rounds,
                    price_eps=eps, evict=evict, pscore=pscore, trace=trace)
        run.append(len(trace))
        ops += sum(live * n * 6 + fit * 60 + g * TOP_R * 30
                   for live, fit in trace)
        drawn += trace[0][1] if trace else 0
    return ops, run, drawn


def auction_bound(torch, used0, avail, feas, aff, ask, k, jits, price_eps,
                  rounds=64, evict=None, net_prio=None):
    """Least time of one B5 launch on these inputs: the inputs (the seeds,
    not the draws) read once and the outputs written once; and
    :func:`auction_ops` plus ~120 operations (a threefry2x32) for the draw
    of each pair that fits in the first round. Returns ((ms, by), rounds
    per restart, (ms, by) of the parent's yardstick: the (T, G, N) draws
    read as an input, no draw made)."""
    n, g = avail.shape[0], feas.shape[0]
    ops, run, drawn = auction_ops(torch, used0, avail, feas, aff, ask, k,
                                  jits, price_eps, rounds, evict, net_prio)
    n_t = len(price_eps)
    n_bytes = (n * 16 * 2 + g * n * 5 + g * 24
               + n_t * (n * 16 + g * n * 4 + 4))
    if evict is not None:
        n_bytes += n * 20
    return (bound(n_bytes + g * 8, ops + drawn * 120), run,
            bound(n_bytes + n_t * g * n * 4, ops))


def pick_bound(n_t: int, g: int, n: int):
    """Least time of one pick launch: the T restarts' carries and takes,
    the greedy arm's carry and counts and the capacity read once, the
    chosen carry, counts and info row written once; ~60 operations per
    node for its fitness and ~G for its placed count, per arm."""
    return bound(n_t * (g * n * 4 + n * 16) + g * n * 2 + n * 16 * 3
                 + g * n * 2 + 24, (n_t + 1) * n * (g + 60))


# the pick alone above B5's 16,384 nodes
PICK_WIDE = (32768, 65536)


def pick_inputs(torch, dev, rng, n_pad: int, n_t: int = 5, g: int = G):
    """The pick's inputs at ``n_pad`` nodes without an auction (B5 takes
    at most 16,384): the build_nodes capacities of 10,240 nodes tiled over
    all but the last 7 rows (zero rows padded), each arm's final usage at
    30-100% of capacity, takes of 0-2 allocs on a tenth of the (row,
    node) pairs, restart 3 an exact copy of restart 1 (an exact tie the
    chain must give to the earlier), greedy counts from the same draw.
    Returns the pick's argument tuple on the card."""
    n_real = n_pad - 7
    avail = np.zeros((n_pad, 4), np.float32)
    avail[:n_real] = np.resize(c2m_capacity(), (n_real, 4))
    used_t = np.floor(avail[None] * rng.uniform(0.3, 1.0, (n_t, n_pad, 1)))
    take_t = (rng.random((n_t, g, n_pad)) < 0.1) * rng.integers(
        1, 3, (n_t, g, n_pad))
    take_t[:, :, n_real:] = 0
    used_t[3], take_t[3] = used_t[1], take_t[1]
    used_g = np.floor(avail * rng.uniform(0.3, 1.0, (n_pad, 1)))
    counts_g = (rng.random((g, n_pad)) < 0.1) * rng.integers(1, 3, (g, n_pad))
    counts_g[:, n_real:] = 0
    rounds_t = rng.integers(1, 65, n_t)
    return (torch.tensor(avail, device=dev),
            torch.tensor(used_t.astype(np.float32), device=dev),
            torch.tensor(take_t.astype(np.int32), device=dev),
            torch.tensor(rounds_t.astype(np.int32), device=dev),
            torch.tensor(used_g.astype(np.float32), device=dev),
            torch.tensor(counts_g.astype(np.int16), device=dev))


def check_pick(torch, bs, got, p_args, what):
    """The pick's (used, counts, info) against the plain version."""
    want = bs.batch_pick_ref(*p_args)
    torch.cuda.synchronize()
    for name, x, y in zip(("used", "counts", "info"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"B6 pick {what}: {name} differs from the "
                                 f"plain version")


def auction_runner(torch, bs, used0, a_args, seeds, his, price_eps,
                   **kw):
    """One B5 launch as a callable, through whichever ``auction`` this
    checkout has: the seeds and the jitter widths (the draws inside the
    launch) or, in a checkout before that, the (T, G, N) draws of one
    ``jitter_fold`` made here, outside the call."""
    import inspect

    if "his" in inspect.signature(bs.auction).parameters:
        return lambda: bs.auction(used0, *a_args, seeds, his=his,
                                  price_eps=price_eps, **kw)
    from nomad_tpu_torch.tensor.prng import jitter_fold

    jits = jitter_fold(seeds, used0.shape[0], his)
    return lambda: bs.auction(used0, *a_args, jits, price_eps=price_eps,
                              **kw)


def check_auction(torch, bs, got, used0, a_args, jits, eps, what, **kw):
    """B5's (used, take, rounds) against the plain version on the same
    draws."""
    want = bs.auction_restarts_ref(used0, *a_args, jits, price_eps=eps,
                                   **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("used", "take", "rounds"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"B5 {what}: {name} differs from the plain "
                                 f"version")


def phase_solve(torch, dev, card, rng):
    """B5 and B6 at the C2M width on six variants, each exact against its
    plain version on the card: the auction alone (used, take, rounds; its
    draws against jitter_fold_ref's), the pick alone (used, counts, info)
    and the whole solve_batch (the fold and clamp, both arms, the pick).
    Then the pick alone at N_pad 32,768 and 65,536, past B5's ceiling.
    Prints each restart's rounds and full row scans. Times B5 on "main"
    and "wide" and the pick on those and the two wide pads."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor.kernels import bulk_fill
    from nomad_tpu_torch.tensor.prng import jitter_fold_ref

    eps, his = bs._price_eps(), bs._jitter_his()
    notes = []
    timed = {}
    picks = []   # (what, the pick's arguments), timed below
    for variant in ("main", "evict", "correction", "sparse", "cap", "wide"):
        t = solve_inputs(torch, dev, rng, variant)
        jits = jitter_fold_ref(t["seeds"], N_PAD, his)
        a_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"])
        a_kw = dict(rounds=t["rounds"], evict=t["evict"],
                    net_prio=t["net_prio"])
        scans = torch.zeros(len(eps), dtype=torch.int32, device=dev)
        got = bs.auction(t["used"], *a_args, t["seeds"], his=his,
                         price_eps=eps, scans=scans, **a_kw)
        check_auction(torch, bs, got, t["used"], a_args, jits, eps, variant,
                      **a_kw)
        used_g = torch.clamp_min(t["used"], 0.0)
        counts_g = bulk_fill(used_g, t["avail"], t["feas"], t["aff"],
                             t["ask"], t["k"], t["seeds"])
        p_args = (t["avail"], *got, used_g, counts_g)
        check_pick(torch, bs, bs.batch_pick(*p_args), p_args, variant)
        s_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"],
                  t["tgc"], t["seeds"], t["cidx"], t["cdelta"], t["evict"],
                  t["net_prio"])
        s_got = bs.solve_batch(t["used"].clone(), *s_args, g=G,
                               rounds=t["rounds"])
        s_want = bs.solve_batch_ref(t["used"].clone(), *s_args, g=G,
                                    rounds=t["rounds"])
        torch.cuda.synchronize()
        for name, x, y in zip(("used", "counts", "info"), s_got, s_want):
            if not torch.equal(x, y):
                raise AssertionError(f"B6 solve_batch {variant}: {name} "
                                     f"differs from the plain version")
        info = s_got[2].cpu().numpy()
        notes.append(f"{variant}: rounds {got[2].tolist()}, scans "
                     f"{scans.tolist()}, placed auction {int(info[2])} / "
                     f"greedy {int(info[3])}, auction won {int(info[5])}")
        if variant in ("main", "wide"):
            timed[variant] = (t, a_args, a_kw, jits)
            picks.append((variant, p_args))
    # G 64: the lists in the global scratch and several rows a scanning
    # CTA; the path shape's rows four times over, each with its own seed
    t = solve_inputs(torch, dev, rng, "path")
    a_args = (t["avail"], t["feas"].repeat(4, 1), t["aff"].repeat(4, 1),
              t["ask"].repeat(4, 1), t["k"].repeat(4))
    seeds = torch.tensor(rng.integers(0, 2 ** 32, 4 * G), device=dev)
    scans = torch.zeros(len(eps), dtype=torch.int32, device=dev)
    got = bs.auction(t["used"], *a_args, seeds, his=his, price_eps=eps,
                     scans=scans)
    check_auction(torch, bs, got, t["used"], a_args,
                  jitter_fold_ref(seeds, PATH_PAD, his), eps, "G 64")
    notes.append(f"G 64 at N_pad {PATH_PAD} (B5 alone): rounds "
                 f"{got[2].tolist()}, scans {scans.tolist()}")
    # the pick alone above B5's ceiling, up to its own
    for n_pad in PICK_WIDE:
        p_args = pick_inputs(torch, dev, rng, n_pad)
        got = bs.batch_pick(*p_args)
        check_pick(torch, bs, got, p_args, f"N_pad {n_pad}")
        picks.append((f"alone at N_pad {n_pad}", p_args))
        info = got[2].cpu().numpy()
        notes.append(f"pick alone at N_pad {n_pad}: placed auction "
                     f"{int(info[2])} / greedy {int(info[3])}, auction won "
                     f"{int(info[5])}")
    print(f"B5/B6 solve [{card}] 6 variants exact (take, used, rounds, "
          f"counts, info) at N_pad {N_PAD}, G {G}, B5 at G 64 and the pick "
          f"at N_pad {PICK_WIDE}; " + "; ".join(notes))
    for variant, (t, a_args, a_kw, jits) in timed.items():
        ms_a = cuda_time_ms(torch, lambda _: bs.auction(
            t["used"], *a_args, t["seeds"], his=his, price_eps=eps, **a_kw),
            reps=5)
        plain_a = cuda_time_ms(torch, lambda _: bs.auction_restarts_ref(
            t["used"], *a_args, jits, price_eps=eps, **a_kw), reps=2,
            warmup=1)
        (b_a, by_a), rounds, (b_y, by_y) = auction_bound(
            torch, t["used"], *a_args, jits, eps, rounds=t["rounds"],
            evict=t["evict"], net_prio=t["net_prio"])
        print(f"B5 auction  [{card}] {variant} (demand {t['free_share']:.2f} "
              f"of the free cpu): kernel {ms_a:.4f} ms ({len(eps)} restarts "
              f"side by side, rounds {rounds}: {ms_a / max(rounds):.4f} ms a "
              f"round of the longest restart), plain {plain_a:.4f} ms, bound "
              f"{b_a:.6f} ms ({by_a}; the parent's yardstick, the draws "
              f"read: {b_y:.6f} ms, {by_y})")
    for what, p_args in picks:
        n_pad = p_args[0].shape[0]
        ms_p = cuda_time_ms(torch, lambda _: bs.batch_pick(*p_args))
        plain_p = cuda_time_ms(torch, lambda _: bs.batch_pick_ref(*p_args),
                               reps=5)
        b_p, by_p = pick_bound(len(eps), G, n_pad)
        print(f"B6 pick     [{card}] {what} (N_pad {n_pad}): kernel "
              f"{ms_p:.4f} ms, device-only "
              f"{device_only_ms(torch, lambda: bs.batch_pick(*p_args)):.4f} "
              f"ms, plain {plain_p:.4f} ms, bound {b_p:.6f} ms ({by_p})")


# B5's phases in the order of batch_solve.cu's B5_STAMP slots (k 0-5)
B5_PHASES = ("loop condition", "update", "top R and rescans", "winners",
             "fill", "updates and buckets")


def b5_split(torch, dev, card, rng) -> int:
    """``--b5-split``: where B5's time goes. Builds csrc/batch_solve.cu
    with -DB5_SPLIT into build/b5_split/ (its restart CTAs add up
    ``clock64`` between barriers: the first round's scans and set-up, then
    each phase of the first round and of the later ones), swaps it in for
    nt_auction, and runs "main", "wide" and the "path" shape, each exact
    against the plain version. Prints the cycles of the slowest restart."""
    import ctypes

    from nomad_tpu_torch import _ext
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor.prng import jitter_fold_ref

    out = REPO / "build" / "b5_split"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([_ext._nvcc()] + _ext.NVCC_FLAGS + [
        "-DB5_SPLIT", "-I", str(_ext.CSRC), "-o", str(out / "lib.so"),
        str(_ext.CSRC / "batch_solve.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    fn = lib.nt_auction
    fn.argtypes, fn.restype = _ext._SIGNATURES["nt_auction"][1], ctypes.c_int
    lib.b5_split_read.argtypes = [ctypes.c_void_p]
    real = _ext.entry("nt_auction")
    his, eps = bs._jitter_his(), bs._price_eps()
    for variant in ("path", "main", "wide"):
        t = solve_inputs(torch, dev, rng, variant)
        a_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"])
        _ext._fns["nt_auction"] = fn
        try:
            got = bs.auction(t["used"], *a_args, t["seeds"], his=his,
                             price_eps=eps, rounds=t["rounds"])
            torch.cuda.synchronize()
        finally:
            _ext._fns["nt_auction"] = real
        check_auction(torch, bs, got, t["used"], a_args,
                      jitter_fold_ref(t["seeds"], t["avail"].shape[0], his),
                      eps, variant, rounds=t["rounds"])
        buf = (ctypes.c_longlong * 256)()
        if lib.b5_split_read(buf):
            raise AssertionError("--b5-split: the read failed")
        ph = np.array(buf[:]).reshape(16, 16)[:len(eps)]
        worst = int(ph.sum(axis=1).argmax())
        row, rnd = ph[worst], int(got[2][worst])
        print(f"B5 split    [{card}] {variant}: restart {worst}, {rnd} "
              f"rounds, {int(row.sum())} cycles: first round's scans and "
              f"set-up {row[6]}; round 1: "
              + ", ".join(f"{name} {row[k]}"
                          for k, name in enumerate(B5_PHASES))
              + "; a later round: "
              + ", ".join(f"{name} {row[8 + k] / max(rnd - 1, 1):.0f}"
                          for k, name in enumerate(B5_PHASES)))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"B5 split    SM clock {clocks}")
    print(card)
    return 0


def phase_path(torch, card, device="cuda"):
    """The C2M bulk path; returns the launch counts of its run and its
    wall in s."""
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

    total = JOBS * K
    path_gates(h, jobs, total, "C2M path")
    launched = counts["launches"]
    if not 0 < launched["bulk_fill"] == stats["launches"]:
        raise AssertionError(f"B1 launched {launched['bulk_fill']} times for "
                             f"{stats['launches']} solve_bulk_multi calls")
    if launched["jitter"] or launched["scatter_add"]:
        raise AssertionError(f"B3 or B4 launched on the C2M path: "
                             f"{launched}")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    per_launch = stats["solves"] / max(stats["launches"], 1)
    print(f"path        [{card}] {total} allocs in {wall:.3f} s = "
          f"{total / wall:.1f} allocs/s; launches {stats['launches']}, "
          f"evals/launch {per_launch:.2f}, resyncs {stats['resyncs']}, "
          f"corrections {stats['corrections']}; kernel launches "
          f"{counts['launches']}; plain on CUDA {counts['plain_on_cuda']}")
    return counts["launches"], wall


def phase_solve_path(torch, card, device="cuda"):
    """The "tpu-solve" path at bench.py cfg_solve_ab's c2m_mini shape:
    2,560 nodes, 50 batch jobs x 800 allocs cycling the bench asks, evals
    in worker batches of 8, each member on its own thread inside
    batch_member(ctx) calling Harness.process. Each joint launch's inputs
    are copied on the service's stream as it dispatches them (ten small
    device copies a launch), for phase_solve_launches to replay. Returns
    (the launch counts of its run, its wall in s, the copied inputs)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.tensor import solver
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import (batch_member, get_service,
                                               open_batch)
    from nomad_tpu_torch.testing import Harness

    h = Harness(device=device)
    t0 = time.perf_counter()
    mock.build_nodes(h.store, MINI_NODES, seed=0)
    jobs = []
    for i in range(MINI_JOBS):
        cpu, mem = SOLVE_ASKS[i % len(SOLVE_ASKS)]
        j = mock.service_job(SOLVE_K, cpu=cpu, mem=mem, batch=True)
        h.store.upsert_job(j)
        jobs.append(j)
    evals = [mock.eval_for(j) for j in jobs]
    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_SOLVE)
    print(f"solve path  setup {time.perf_counter() - t0:.2f} s "
          f"({MINI_NODES} nodes, {MINI_JOBS} jobs x {SOLVE_K} allocs)")

    def member(ctx, ev):
        with batch_member(ctx):
            h.process(ev, cfg)

    captured = []
    real_solve = solver.solve_batch

    def capture(*args, **kw):
        captured.append(([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
        return real_solve(*args, **kw)

    svc = get_service(device)
    base = dict(svc.stats)
    solver.solve_batch = capture
    try:
        _ext.COUNTS.reset()
        t1 = time.perf_counter()
        with ThreadPoolExecutor(MINI_BATCH) as pool:
            for b in range(0, len(evals), MINI_BATCH):
                batch = evals[b:b + MINI_BATCH]
                ctx = open_batch(len(batch))
                for f in [pool.submit(member, ctx, ev) for ev in batch]:
                    f.result()
        wall = time.perf_counter() - t1
        counts = _ext.COUNTS.snapshot()
    finally:
        solver.solve_batch = real_solve
    stats = {k: svc.stats[k] - base[k] for k in base}
    svc.stop()

    total = MINI_JOBS * SOLVE_K
    path_gates(h, jobs, total, "tpu-solve path")
    joint = stats["joint_launches"]
    launched = counts["launches"]
    if joint < 1:
        raise AssertionError("no joint launch on the tpu-solve path")
    if stats["joint_score"] < stats["greedy_score"]:
        raise AssertionError(f"joint score {stats['joint_score']} below the "
                             f"greedy score {stats['greedy_score']}")
    for name in ("auction", "batch_pick", "bulk_fill"):
        if launched[name] != joint:
            raise AssertionError(f"{name} launched {launched[name]} times "
                                 f"for {joint} joint launches")
    if launched["jitter"] or launched["jitter_fold"]:
        raise AssertionError(f"B3 or B3' launched on the tpu-solve path (B1 "
                             f"and B5 draw their jitter): {launched}")
    if len(captured) != joint:
        raise AssertionError(f"{len(captured)} joint launches copied, "
                             f"{joint} counted")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    delta = (100.0 * (stats["joint_score"] - stats["greedy_score"])
             / max(stats["greedy_score"], 1e-9))
    print(f"solve path  [{card}] {total} allocs in {wall:.3f} s = "
          f"{total / wall:.1f} allocs/s; joint launches {joint}, solves/"
          f"launch {stats['joint_solves'] / joint:.2f}, auction won "
          f"{stats['auction_won']}, rounds/launch "
          f"{stats['auction_rounds'] / joint:.2f}, joint score "
          f"{stats['joint_score']:.4f} vs greedy {stats['greedy_score']:.4f} "
          f"(score_delta_pct {delta:.4f}); kernel launches {launched}; plain "
          f"on CUDA {counts['plain_on_cuda']}")
    return launched, wall, captured


def phase_solve_launches(torch, card, wall, captured):
    """The tpu-solve path's own joint launches, replayed from their copied
    inputs at the shape the path gave them (N_pad 4,096, G 16): the whole
    solve_batch and B5 and the pick exact against the plain versions, B5
    with its rounds and full row scans per restart; the kernels, B1 and
    the whole launch timed on each. B3' (``jitter_fold``, off the path
    since B5 draws its jitter) is held bitwise against its plain version
    and timed on the same seeds. Returns the kernel records of B3', B5
    and the pick: times and bounds are means over the path's launches."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor.kernels import bulk_fill, bulk_fill_ref
    from nomad_tpu_torch.tensor.prng import jitter_fold, jitter_fold_ref
    from nomad_tpu_torch.tensor.scatter import scatter_add_ref

    torch.cuda.synchronize()
    his, eps = bs._jitter_his(), bs._price_eps()
    rows = {name: [] for name in ("jitter_fold", "auction", "batch_pick")}
    b1_ms, b1_plain, whole_ms, rounds, scans, yard = [], [], [], [], [], []
    for i, (args, kw) in enumerate(captured):
        used0, avail, feas, aff, ask, k, tgc, seeds, cidx, cdelta = args[:10]
        rest = args[1:]
        n, g = used0.shape[0], feas.shape[0]
        s_got = bs.solve_batch(used0.clone(), *rest, **kw)
        s_want = bs.solve_batch_ref(used0.clone(), *rest, **kw)
        torch.cuda.synchronize()
        for name, x, y in zip(("used", "counts", "info"), s_got, s_want):
            if not torch.equal(x, y):
                raise AssertionError(f"path launch {i}: solve_batch {name} "
                                     f"differs from the plain version")
        folded = scatter_add_ref(used0.clone(), cidx, cdelta)
        jits = jitter_fold_ref(seeds, n, his)
        if not torch.equal(jitter_fold(seeds, n, his).view(torch.int32),
                           jits.view(torch.int32)):
            raise AssertionError(f"path launch {i}: B3' differs from the "
                                 f"plain version")
        a_args = (avail, feas, aff, ask, k)
        count = torch.zeros(len(eps), dtype=torch.int32, device=used0.device)
        got = bs.auction(folded, *a_args, seeds, his=his, price_eps=eps,
                         scans=count)
        check_auction(torch, bs, got, folded, a_args, jits, eps,
                      f"path launch {i}")
        fill_args = (avail, feas, aff, ask, k, seeds)
        used_g = folded.clone()
        counts_g = bulk_fill(used_g, *fill_args)
        p_args = (avail, *got, used_g, counts_g)
        p_got = bs.batch_pick(*p_args)
        p_want = bs.batch_pick_ref(*p_args)
        torch.cuda.synchronize()
        for name, x, y in zip(("used", "counts", "info"), p_got, p_want):
            if not torch.equal(x, y):
                raise AssertionError(f"path launch {i}: pick {name} differs "
                                     f"from the plain version")
        rows["jitter_fold"].append((
            cuda_time_ms(torch, lambda _: jitter_fold(seeds, n, his)),
            cuda_time_ms(torch, lambda _: jitter_fold_ref(seeds, n, his),
                         reps=5),
            fold_bound(len(his), g, n)))
        b_a, run, b_y = auction_bound(torch, folded, *a_args, jits, eps)
        rows["auction"].append((
            cuda_time_ms(torch, lambda _: bs.auction(
                folded, *a_args, seeds, his=his, price_eps=eps), reps=5),
            cuda_time_ms(torch, lambda _: bs.auction_restarts_ref(
                folded, *a_args, jitter_fold_ref(seeds, n, his),
                price_eps=eps), reps=2, warmup=1),
            b_a))
        rows["batch_pick"].append((
            cuda_time_ms(torch, lambda _: bs.batch_pick(*p_args)),
            cuda_time_ms(torch, lambda _: bs.batch_pick_ref(*p_args),
                         reps=5),
            pick_bound(len(eps), g, n)))
        b1_ms.append(cuda_time_ms(torch, lambda u: bulk_fill(u, *fill_args),
                                  setup=folded.clone))
        b1_plain.append(cuda_time_ms(
            torch, lambda u: bulk_fill_ref(u, *fill_args),
            setup=folded.clone, reps=5, warmup=1))
        whole_ms.append(cuda_time_ms(
            torch, lambda u: bs.solve_batch(u, *rest, **kw),
            setup=used0.clone, reps=5))
        rounds.append(run)
        scans.append(count.tolist())
        yard.append(b_y[0])
    n_l = len(captured)
    mean = statistics.fmean
    print(f"solve runs  [{card}] the path's {n_l} joint launches replayed at "
          f"N_pad {n}, G {g}: solve_batch, B5 (its draws included) and the "
          f"pick exact on each, B3' bitwise; rounds per restart {rounds}; "
          f"full row scans per restart {scans}")
    print(f"solve runs  [{card}] per launch (mean): solve_batch "
          f"{mean(whole_ms):.4f} ms, of it B1 {mean(b1_ms):.4f} ms (plain "
          f"{mean(b1_plain):.4f} ms), "
          + ", ".join(f"{name} {mean(r[0] for r in v):.4f} ms"
                      for name, v in rows.items())
          + f" (jitter_fold off the path); B5's bound on the parent's "
          f"yardstick (the draws read) {mean(yard):.6f} ms; {n_l} launches "
          f"{sum(whole_ms):.4f} ms of device time = "
          f"{100.0 * sum(whole_ms) / 1e3 / wall:.2f}% of the path's "
          f"{wall:.3f} s wall")
    out = []
    for name, v in rows.items():
        by = Counter(r[2][1] for r in v).most_common(1)[0][0]
        rec = {"name": name, "source": ("nomad_tpu_torch/csrc/jitter.cu"
                                        if name == "jitter_fold" else
                                        "nomad_tpu_torch/csrc/batch_solve.cu"),
               "replaces": {"jitter_fold":
                            "nomad_tpu/tensor/batch_solver.py:319",
                            "auction": "nomad_tpu/tensor/batch_solver.py:137",
                            "batch_pick":
                            "nomad_tpu/tensor/batch_solver.py:256"}[name],
               "max_abs_err": 0.0, "ms": mean(r[0] for r in v),
               "plain_ms": mean(r[1] for r in v),
               "bound_ms": mean(r[2][0] for r in v), "bound_by": by,
               "library_ms": None}
        out.append(rec)
    return out


SERVER_PHASES = ("eval.queued", "worker.snapshot", "worker.schedule",
                 "worker.tensor_build", "worker.solve_bulk", "solver.wait",
                 "solver.launch", "solver.apply", "plan.submit",
                 "plan.verify", "plan.commit_round", "plan.commit",
                 "eval.persist")


def span_split(spans, t0: float) -> dict:
    """Per span name of the SERVER_PHASES opened after t0: count, median
    and total ms."""
    from nomad_tpu_torch.obs.trace import R_NAME, R_T0, R_T1

    by = {}
    for r in spans:
        if r[R_T0] >= t0 and r[R_NAME] in SERVER_PHASES:
            by.setdefault(r[R_NAME], []).append(1e3 * (r[R_T1] - r[R_T0]))
    return {name: {"n": len(v), "p50_ms": statistics.median(v),
                   "total_ms": sum(v)}
            for name, v in sorted(by.items())}


def server_gates(srv, jobs, want: int, what: str) -> dict:
    """path_gates for the Server: every alloc of the timed jobs placed
    once and live, no node over capacity (recomputed from the store's
    live allocs), each job's newest eval cleanly complete and none left
    blocked or queued. Returns the eval statuses of the jobs."""
    from nomad_tpu_torch.structs import enums

    snap = srv.store.snapshot()
    live = 0
    for j in jobs:
        live += sum(1 for a in snap.allocs_by_job(j.id)
                    if not a.terminal_status())
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    ids = set()
    n_allocs = 0
    for a in snap.allocs():
        n_allocs += 1
        ids.add(a.id)
        if not a.terminal_status():
            usage[row[a.node_id]] += a.allocated_vec
    if live != want or len(ids) != n_allocs:
        raise AssertionError(f"{what}: {live} live allocs of {want} wanted; "
                             f"{n_allocs - len(ids)} duplicate ids")
    over = int((usage > cap).any(axis=1).sum())
    if over:
        raise AssertionError(f"{what}: {over} nodes over capacity")
    if srv.blocked.blocked_count() or srv.broker.ready_count():
        raise AssertionError(f"{what}: evals left blocked or ready")
    newest = {}
    statuses = Counter()
    job_ids = {j.id for j in jobs}
    for e in snap.evals():
        if e.job_id not in job_ids:
            continue
        statuses[e.status] += 1
        if (e.job_id not in newest
                or e.modify_index > newest[e.job_id].modify_index):
            newest[e.job_id] = e
    bad = [e for e in newest.values()
           if e.status != enums.EVAL_STATUS_COMPLETE or e.failed_tg_allocs]
    if len(newest) != len(jobs) or bad:
        raise AssertionError(f"{what}: {len(bad)} jobs' newest evals not "
                             f"cleanly complete")
    return dict(statuses)


def blocked_report(srv) -> str:
    """What a Server's blocked evals say: the tracker's counts, the evals
    by status, and each blocked eval's reason and failed groups (nodes
    evaluated, filtered, exhausted by dimension)."""
    snap = srv.store.snapshot()
    statuses = Counter(e.status for e in snap.evals())
    rows = []
    for ev in list(srv.blocked._by_job.values())[:4]:
        # the failures sit on the eval that created the blocked one
        failing = [e for e in snap.evals()
                   if e.job_id == ev.job_id and e.failed_tg_allocs]
        failed = {name: (m.nodes_evaluated, m.nodes_filtered,
                         dict(m.dimension_exhausted),
                         dict(m.constraint_filtered), m.coalesced_failures)
                  for e in failing[-1:]
                  for name, m in e.failed_tg_allocs.items()}
        rows.append(f"{ev.job_id} ({ev.triggered_by}, "
                    f"{ev.status_description!r}, queued "
                    f"{ev.queued_allocations}, failed {failed})")
    return (f"{srv.blocked.blocked_count()} blocked "
            f"{dict(srv.blocked.stats)}; evals {dict(statuses)}; "
            + "; ".join(rows))


def watch_rejections(applier) -> list:
    """Wraps the applier's fit re-check for a run: for every node a plan
    is rejected on, the usage row the store's snapshot holds and the part
    of it placed one alloc at a time (not in an AllocBlock: B9 or the
    host oracle, outside the solver service's carry), the row with the
    in-flight overlay, the plan's own ask and the capacity, and the
    overlay's AllocBlocks on the node that the snapshot already holds
    (the overlay skips them; the reference counts them twice until their
    commit round is answered, ROADMAP §C3). ``false`` is True where the
    node fits once those blocks are counted once: a false rejection, not
    an over-placement the applier caught. Returns the list the wrapper
    appends one record a rejected node to."""
    from nomad_tpu_torch.core.plan_apply import _OverlaySnapshot

    seen = []
    evaluate = applier._evaluate

    def watched(snap, plan):
        result, rejected = evaluate(snap, plan)
        if not rejected:
            return result, rejected
        overlay = isinstance(snap, _OverlaySnapshot)
        base = snap._snap if overlay else snap
        for nid in rejected:
            node = base.node_by_id(nid)
            cap = node.available_vec()
            store_u = base.node_usage(nid)
            store_u = np.zeros_like(cap) if store_u is None else store_u
            singles = np.zeros_like(cap)
            for a in base.allocs_by_node(nid):
                if "." not in a.id and not a.terminal_status():
                    singles = singles + a.allocated_vec
            ask = np.zeros_like(cap)
            for a in plan.node_allocation.get(nid, ()):
                ask = ask + a.allocated_vec
            for block in plan.alloc_blocks:
                for m in block.live_rows():
                    if block.node_ids[m] == nid:
                        ask = ask + block.allocated_vec * int(block.counts[m])
            twice, twice_u = [], np.zeros_like(cap)
            for block, m in (snap._block_rows.get(nid, ()) if overlay
                             else ()):
                if base.alloc_block_by_id(block.id) is not None:
                    twice.append(block.id[:8])
                    twice_u = twice_u + (block.allocated_vec
                                         * int(block.counts[m]))
            over_u = snap.node_usage(nid)
            seen.append({
                "eval": (plan.eval_id or "")[:8], "node": nid[:8],
                "store": store_u.tolist(), "singles": singles.tolist(),
                "overlay": over_u.tolist(),
                "ask": ask.tolist(), "capacity": cap.tolist(),
                "landed_blocks_in_overlay": twice,
                "false": bool(twice) and bool(
                    (over_u - twice_u + ask <= cap).all())})
        return result, rejected

    applier._evaluate = watched
    return seen


@contextlib.contextmanager
def incr_arm(incr):
    """NOMAD_TPU_INCR set to ``incr`` for the block (None: as it is)."""
    prev = os.environ.get("NOMAD_TPU_INCR")
    if incr is not None:
        os.environ["NOMAD_TPU_INCR"] = incr
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("NOMAD_TPU_INCR", None)
        else:
            os.environ["NOMAD_TPU_INCR"] = prev


@contextlib.contextmanager
def capture_b4(captured):
    """B4 wrapped where the feed's twin flush (``incremental``) and the
    service's twin fold (``solver``) call it: for each call its site, the
    carry before and after, its rows and deltas, copied on the call's
    stream (a call with no rows launches nothing)."""
    from nomad_tpu_torch.tensor import incremental, solver

    real = {m: m.scatter_add for m in (incremental, solver)}

    def wrap(site, fn):
        def capture(used, idx, delta):
            before = used.clone()
            out = fn(used, idx, delta)
            captured.append((site, before, idx.clone(), delta.clone(),
                             out.clone()))
            return out
        return capture

    incremental.scatter_add = wrap("flush", real[incremental])
    solver.scatter_add = wrap("fold", real[solver])
    try:
        yield captured
    finally:
        for m, fn in real.items():
            m.scatter_add = fn


def replay_b4(torch, captured, what) -> dict:
    """Every captured B4 launch against scatter_add_ref on its inputs:
    bit-exact. Returns the launches, their rows and their sites."""
    from nomad_tpu_torch.tensor.scatter import scatter_add_ref

    runs = [c for c in captured if c[2].shape[0]]
    for site, before, idx, delta, after in runs:
        want = scatter_add_ref(before.clone(), idx, delta)
        torch.cuda.synchronize()
        if not torch.equal(after, want):
            raise AssertionError(f"{what}: B4's {site} launch of "
                                 f"{idx.shape[0]} rows differs from "
                                 f"scatter_add_ref")
    return {"launches": len(runs),
            "rows": [int(c[2].shape[0]) for c in runs],
            "sites": Counter(c[0] for c in runs)}


def time_b4(torch, captured) -> dict:
    """The captured B4 launch with the most rows timed beside its plain
    version and index_add_ on the same inputs, its bound from its rows;
    {} when none launched."""
    from nomad_tpu_torch.tensor.scatter import scatter_add, scatter_add_ref

    runs = [c for c in captured if c[2].shape[0]]
    if not runs:
        return {}
    site, before, idx, delta, _ = max(runs, key=lambda c: c[2].shape[0])
    b = idx.shape[0]
    idx64 = idx.to(torch.int64)
    rows = int(torch.unique(idx).numel())
    b_ms, b_by = bound(b * 4 + b * 16 + 2 * rows * 16, b * 4)
    return dict(
        timed_site=site, timed_rows=b, n_pad=int(before.shape[0]),
        ms=cuda_time_ms(torch, lambda u: scatter_add(u, idx, delta),
                        setup=before.clone),
        plain_ms=cuda_time_ms(torch,
                              lambda u: scatter_add_ref(u, idx, delta),
                              setup=before.clone),
        library_ms=cuda_time_ms(torch,
                                lambda u: u.index_add_(0, idx64, delta),
                                setup=before.clone),
        bound_ms=b_ms, bound_by=b_by)


def run_server_path(torch, card, what, algorithm, n_nodes, jobs_fn,
                    workers, batch, harness_wall=None, incr=None):
    """bench.py run_server (:186-270) on the port's Server on the card:
    nodes straight into the store, the first job's shape registered and
    deregistered as the warm-up, then WAVES waves of ``jobs_fn()``: every
    job of a wave registered at once and the queue drained,
    conflict-blocked evals included, before the next. The first wave's
    wall is the record's; the second runs the service past its
    RESYNC_SOLVES, so a resync falls in the timed window. Gates as
    server_gates over both waves, B1 launched once a service launch and
    no plain version on CUDA; with the feed on, every resync of the window
    on the twin route, at least one, and a B4 flush of the twin among the
    window's launches. ``incr`` sets NOMAD_TPU_INCR for the run (the
    incremental feed on or off; None leaves it). Returns (the launch
    counts of the timed run, its record)."""
    with incr_arm(incr):
        return _run_server_path(torch, card, what, algorithm, n_nodes,
                                jobs_fn, workers, batch, harness_wall, incr)


def _run_server_path(torch, card, what, algorithm, n_nodes, jobs_fn,
                     workers, batch, harness_wall, incr):
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.obs import RECORDER, REGISTRY, TRACER
    from nomad_tpu_torch.obs.trace import R_ARGS, R_NAME, R_T0, R_T1
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import incremental
    from nomad_tpu_torch.tensor.overlay import INFLIGHT
    from nomad_tpu_torch.tensor.solver import get_service

    fed = incremental.incr_enabled()
    what = f"{what} ({'feed on' if fed else 'feed off'})"
    srv = Server(ServerConfig(
        num_workers=workers, eval_batch_size=batch, device="cuda",
        sched_config=SchedulerConfiguration(scheduler_algorithm=algorithm),
        nack_timeout=900.0, failed_eval_followup_delay=3600.0,
        failed_eval_unblock_interval=0.5))
    t_setup = time.perf_counter()
    mock.build_nodes(srv.store, n_nodes, seed=0)
    waves = [jobs_fn() for _ in range(WAVES)]
    jobs = [j for wave in waves for j in wave]
    walls = []
    svc = get_service(srv.device)
    rejections = watch_rejections(srv.plan_applier)
    with srv:
        warm = jobs_fn()[0]
        srv.register_job(warm)
        if not srv.wait_for_idle(120.0, include_delayed=False):
            raise AssertionError(f"{what}: the warm-up did not drain")
        srv.deregister_job(warm.id)
        if not srv.wait_for_idle(120.0, include_delayed=False):
            raise AssertionError(f"{what}: the warm job's stop did not drain")
        stopped = srv.store.snapshot().allocs_by_job(warm.id)
        if not stopped or any(not a.server_terminal() for a in stopped):
            raise AssertionError(f"{what}: the warm job's allocs not stopped")
        srv.plan_applier.stats.update(
            applied=0, nodes_rejected=0, partial_commits=0, commit_batches=0,
            batched_commits=0, batched_eval_updates=0)
        del rejections[:]
        print(f"{what:<11} setup and warm-up "
              f"{time.perf_counter() - t_setup:.2f} s ({n_nodes} nodes, "
              f"{WAVES} waves of {len(waves[0])} jobs x "
              f"{jobs[0].task_groups[0].count} allocs, "
              f"{workers} workers, eval_batch_size {batch})")
        base = dict(svc.stats)
        feed = incremental.feed_for(srv.store)
        f0 = feed.stats()
        captured = []
        TRACER.clear()
        RECORDER.clear()
        REGISTRY.reset()
        with capture_b4(captured):
            _ext.COUNTS.reset()
            t_wall = time.time()
            for wave in waves:
                t0 = time.perf_counter()
                for j in wave:
                    srv.register_job(j)
                deadline = time.time() + 300.0
                while True:
                    if not srv.wait_for_idle(
                            max(1.0, deadline - time.time()),
                            include_delayed=False):
                        raise AssertionError(f"{what}: the eval queue did "
                                             f"not drain")
                    if srv.blocked.blocked_count() == 0:
                        break
                    if time.time() > deadline:
                        raise AssertionError(f"{what}: blocked evals did "
                                             f"not drain: "
                                             f"{blocked_report(srv)}")
                    time.sleep(0.05)
                walls.append(time.perf_counter() - t0)
            counts = _ext.COUNTS.snapshot()
            spans = TRACER.spans()
            f1 = feed.stats()
            in_window = len(captured)
            if fed:
                # the feed's end-of-run check, on the service's stream: the
                # twin caught up by one flush; the twin route's fold of the
                # run's last G blocks as open ledger entries, against the
                # host route's fold of them; then base and twin against a
                # gen-bounded rebuild (the fold must leave the twin as it
                # was)
                static = feed._epoch.static_ref
                blocks = sorted(srv.store.snapshot().alloc_blocks(),
                                key=lambda b: b.create_index)[-G:]
                entries = []
                for b in blocks:
                    live = list(b.live_rows())
                    entries.append((
                        np.array([static.node_index[b.node_ids[m]]
                                  for m in live], dtype=np.int64),
                        np.asarray(b.counts)[live].astype(np.int64),
                        np.asarray(b.allocated_vec, dtype=np.float32)))
                with svc._stream_ctx():
                    twin = feed.device_used(static, svc.device)
                    carry = svc._fold_base_scatter(twin, static, entries)
                host = feed.base_for(static).astype(np.float32)
                for idx, cnt, ask in entries:
                    host[idx] += cnt[:, None].astype(np.float32) * ask[None]
                INFLIGHT.fold(host[:len(static.nodes)], static.node_index)
                if not torch.equal(carry.cpu(), torch.from_numpy(host)):
                    raise AssertionError(f"{what}: the twin route's fold "
                                         f"differs from the host route's")
                verified = feed.force_verify()
                caught_up = bool(feed._epoch.twins) and all(
                    t.cursor == len(feed._epoch.devlog)
                    for t in feed._epoch.twins.values())
                if not (verified and caught_up):
                    raise AssertionError(
                        f"{what}: the feed's verify failed (verified "
                        f"{verified}, twin caught up {caught_up}; "
                        f"{incremental.GLOBAL.violations[-1:]})")
        partials = [(t, fields) for t, _, _, event, fields
                    in RECORDER.events("plan") if event == "partial_reject"]
        stats = dict(srv.plan_applier.stats)
        svc_stats = {k: svc.stats[k] - base[k] for k in base}
        want = sum(j.task_groups[0].count for j in jobs)
        statuses = server_gates(srv, jobs, want, what)
    svc.stop()
    feed_stats = {k: f1[k] - f0[k] for k in f0}
    window = replay_b4(torch, captured[:in_window], what)
    end = replay_b4(torch, captured[in_window:], what)
    timed = time_b4(torch, captured)
    builds = [(1e3 * (r[R_T1] - r[R_T0]), r[R_ARGS]["changed_allocs"])
              for r in spans if r[R_NAME] == "worker.tensor_build"
              and r[R_T0] >= t_wall and "changed_allocs" in r[R_ARGS]]
    if fed:
        if not (feed_stats["fast_hits"] > 0
                and feed_stats["deltas_applied"] > 0):
            raise AssertionError(f"{what}: the fed base was not used: "
                                 f"{feed_stats}")
        if (svc_stats["twin_resyncs"] < 1 or svc_stats["host_resyncs"]
                or svc_stats["twin_misses"]):
            raise AssertionError(f"{what}: not every resync of the window "
                                 f"took the twin route, or none ran: "
                                 f"{svc_stats}")
        if window["sites"]["flush"] < 1:
            raise AssertionError(f"{what}: no resync of the window flushed "
                                 f"the twin by B4: {window}, {feed_stats}")
    elif (feed_stats["builds"] or feed_stats["twin_uploads"]
          or feed_stats["twin_flushes"] or svc_stats["twin_resyncs"]
          or captured):
        raise AssertionError(f"{what}: the feed worked with the kill switch "
                             f"on: {feed_stats}, {svc_stats}")
    launched = counts["launches"]
    if not 0 < launched["bulk_fill"] == svc_stats["launches"]:
        raise AssertionError(f"{what}: B1 launched {launched['bulk_fill']} "
                             f"times for {svc_stats['launches']} service "
                             f"launches")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    rejected = stats["nodes_rejected"]
    rate = rejected / max(want + rejected, 1)
    split = span_split(spans, t_wall)
    # the first wave is the headline (the cut every earlier run timed);
    # the second runs past the service's RESYNC_SOLVES
    per_wave = want // WAVES
    wall = walls[0]
    rec = {"incr": "1" if fed else "0",
           "allocs": per_wave, "wall_s": wall,
           "allocs_per_s": per_wave / wall,
           "waves": [{"allocs": per_wave, "wall_s": w,
                      "allocs_per_s": per_wave / w} for w in walls],
           "applied": stats["applied"], "nodes_rejected": rejected,
           "partial_commits": stats["partial_commits"],
           "commit_batches": stats["commit_batches"],
           "rejection_rate": rate, "rejections": rejections,
           "false_rejections": sum(r["false"] for r in rejections),
           "evals": statuses,
           "service": {k: svc_stats[k] for k in
                       ("launches", "solves", "resyncs", "corrections",
                        "joint_launches", "joint_solves", "twin_resyncs",
                        "host_resyncs", "twin_misses")},
           "feed": feed_stats,
           "tensor_build_p50_ms": (statistics.median(b[0] for b in builds)
                                   if builds else None),
           "changed_allocs": {
               "builds": len(builds), "sum": sum(b[1] for b in builds),
               "p50": (statistics.median(b[1] for b in builds)
                       if builds else None)},
           "b4_window": window, "b4_end_flush": end, "b4_timed": timed,
           "launches": {k: v for k, v in launched.items() if v},
           "spans": split, "card": card}
    if harness_wall is not None:
        rec["harness_wall_s"] = harness_wall
    print(f"{what:<11} [{card}] {per_wave} allocs in {wall:.3f} s = "
          f"{per_wave / wall:.1f} allocs/s through the Server (the second "
          f"wave: {walls[-1]:.3f} s; {want} placed in all)"
          + (f" (the Harness path: {harness_wall:.3f} s)"
             if harness_wall is not None else "")
          + f"; applied {stats['applied']}, nodes_rejected {rejected}, "
          f"partial_commits {stats['partial_commits']}, rejection rate "
          f"{rate:.6f}; evals {statuses}; service {rec['service']}; kernel "
          f"launches {rec['launches']}")
    for t, fields in partials:
        print(f"{what:<11} partial_reject at +{t - t_wall:.3f} s: {fields}")
    for r in rejections:
        print(f"{what:<11} rejected node {r['node']} (eval {r['eval']}): "
              f"store {r['store']} (one at a time {r['singles']}), overlay "
              f"{r['overlay']}, ask {r['ask']}, "
              f"capacity {r['capacity']}; landed blocks in the overlay "
              f"{r['landed_blocks_in_overlay']}; "
              + ("false (fits with them counted once)" if r["false"]
                 else "does not fit with them counted once"))
    print(f"{what:<11} [{card}] span p50 ms (n, total ms): " + "; ".join(
        f"{k} {v['p50_ms']:.3f} ({v['n']}, {v['total_ms']:.1f})"
        for k, v in split.items()))
    print(f"{what:<11} [{card}] worker.tensor_build p50 "
          f"{rec['tensor_build_p50_ms']} ms over {len(builds)} builds; "
          f"changed_allocs {rec['changed_allocs']}; feed {feed_stats}; "
          f"resyncs twin {svc_stats['twin_resyncs']} / host "
          f"{svc_stats['host_resyncs']} (misses {svc_stats['twin_misses']}); "
          f"B4 from the feed in the window {window}, at the end flush "
          f"{end}; timed {timed}")
    return launched, rec


def phase_server(torch, card, harness_wall=None):
    """The C2M path through the port's Server (bench.py cfg_c2m's shape,
    its 500 jobs cut to JOBS as phase_path) on cfg_c2m's two arms, a
    fresh Server each: the incremental feed on (NOMAD_TPU_INCR=1, the
    headline arm) and off (0, the kill switch). Returns {incr: (the
    launch counts, the record)}."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums

    def jobs():
        return [mock.service_job(K, cpu=50, mem=32, batch=True)
                for _ in range(JOBS)]

    arms = {incr: run_server_path(
        torch, card, "server", enums.SCHED_ALG_TPU_BINPACK, N_NODES, jobs,
        SERVER_WORKERS, 1, harness_wall, incr=incr) for incr in ("1", "0")}
    print(f"server      [{card}] arms (feed on / off): wall "
          + " / ".join(f"{arms[i][1]['wall_s']:.3f} s" for i in arms)
          + "; worker.tensor_build p50 "
          + " / ".join(f"{arms[i][1]['tensor_build_p50_ms']} ms"
                       for i in arms)
          + "; resyncs (twin, host) "
          + " / ".join(f"({arms[i][1]['service']['twin_resyncs']}, "
                       f"{arms[i][1]['service']['host_resyncs']})"
                       for i in arms))
    return arms


def phase_binpack(torch, card, device="cuda"):
    """bench.py cfg_c2m's serial sample (:452-458, run_harness :126-155):
    2 jobs x 512 allocs (cpu 50, mem 32) on 10,240 nodes through
    Harness.process, "tpu-binpack" against "binpack" (the host placer),
    each after a warm-up job of the same shape. Gates: 1,024 placed in
    each arm, every alloc once, no node over capacity. Returns the
    walls."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    walls = {}
    for alg in (enums.SCHED_ALG_TPU_BINPACK, enums.SCHED_ALG_BINPACK):
        h = Harness(device=device)
        mock.build_nodes(h.store, N_NODES, seed=0)
        jobs = [mock.service_job(512, cpu=50, mem=32, batch=True)
                for _ in range(2)]
        for j in jobs:
            h.store.upsert_job(j)
        cfg = SchedulerConfiguration(scheduler_algorithm=alg)
        warm = mock.service_job(512, cpu=50, mem=32, batch=True)
        h.store.upsert_job(warm)
        h.process(mock.eval_for(warm), cfg)
        h.store.delete_job(warm.id)
        t0 = time.perf_counter()
        for j in jobs:
            h.process(mock.eval_for(j), cfg)
        walls[alg] = time.perf_counter() - t0
        snap = h.store.snapshot()
        placed = sum(len([a for a in snap.allocs_by_job(j.id)
                          if not a.terminal_status()]) for j in jobs)
        nodes = list(snap.nodes())
        row = {n.id: i for i, n in enumerate(nodes)}
        cap = np.stack([n.available_vec() for n in nodes])
        usage = np.zeros_like(cap)
        ids = [a.id for a in snap.allocs()]
        for a in snap.allocs():
            if not a.terminal_status():
                usage[row[a.node_id]] += a.allocated_vec
        over = int((usage > cap).any(axis=1).sum())
        if placed != 1024 or len(ids) != len(set(ids)) or over:
            raise AssertionError(f"binpack sample {alg}: placed {placed} of "
                                 f"1024, {len(ids) - len(set(ids))} "
                                 f"duplicate ids, {over} nodes over capacity")
    get_service(device).stop()
    tpu, host = (walls[enums.SCHED_ALG_TPU_BINPACK],
                 walls[enums.SCHED_ALG_BINPACK])
    print(f"binpack     [{card}] 2 x 512 allocs on {N_NODES} nodes: "
          f"tpu-binpack {tpu:.3f} s, binpack (host placer) {host:.3f} s; "
          f"per-alloc ratio {host / tpu:.2f} (bench.py's vs_baseline "
          f"formula); 1024 placed in each")
    return {"tpu-binpack_s": tpu, "binpack_s": host}


def phase_server_solve(torch, card, harness_wall=None, incr=None):
    """The "tpu-solve" c2m_mini shape through the port's Server: worker
    batches of 8 meet in the service's rendezvous, one joint launch (B1,
    B5, the pick) a batch. ``incr`` as run_server_path's."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums

    def jobs():
        return [mock.service_job(SOLVE_K, cpu=SOLVE_ASKS[i % len(SOLVE_ASKS)][0],
                                 mem=SOLVE_ASKS[i % len(SOLVE_ASKS)][1],
                                 batch=True) for i in range(MINI_JOBS)]

    launched, rec = run_server_path(
        torch, card, "server solve", enums.SCHED_ALG_TPU_SOLVE, MINI_NODES,
        jobs, SOLVE_WORKERS, MINI_BATCH, harness_wall, incr=incr)
    joint = rec["service"]["joint_launches"]
    if joint < 1:
        raise AssertionError("server solve: no joint launch")
    for name in ("auction", "batch_pick"):
        if launched.get(name, 0) != joint:
            raise AssertionError(f"server solve: {name} launched "
                                 f"{launched.get(name, 0)} times for {joint} "
                                 f"joint launches")
    return launched, rec


def devices_only(torch, dev, card, rng) -> int:
    """The build, B9 on its variants (d = 6 and d = 8 among them) and the
    config 5 and config 2 phases alone; their records as one JSON line."""
    b9 = phase_scan(torch, dev, card, rng)
    _, devices, b9_devices = phase_devices(torch, card)
    _, constraints = phase_constraints(torch, card)
    print(json.dumps({"devices": devices, "constraints": constraints,
                      "b9_by_d": b9["by_d"], "b9_d6_path": b9_devices}))
    print(card)
    return 0


def server_only(torch, card) -> int:
    """``--server``: the Server phases (C2M and tpu-solve, each on both
    feed arms) and the binpack sample alone."""
    arms = phase_server(torch, card)
    records = {"server": arms["1"][1], "server_incr0": arms["0"][1]}
    for incr, key in (("1", "server_solve"), ("0", "server_solve_incr0")):
        records[key] = phase_server_solve(torch, card, incr=incr)[1]
    records["binpack"] = phase_binpack(torch, card)
    print(json.dumps({"server": records}))
    print(card)
    return 0


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


def phase_parity(algorithm):
    """The same pinned small workload on the card and on the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    cfg = SchedulerConfiguration(scheduler_algorithm=algorithm)
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
    print(f"parity      card == CPU on 3 pinned jobs under {algorithm} "
          f"({sum(v[0] for v in prints[0].values())} allocs)")


def cfg3_args(rng, variant: str):
    """One task group's solve at the cfg3 width, as the 26 positional
    arguments of the reference's solve_task_group, with a hazard variant:
    "cfg3" is the path's own shape (one even rack spread, 500 of 512
    steps active, tie_perm); "targets" adds explicit targets with a zero
    and a missing desired count and penalty steps; "distinct" has
    distinct_hosts and a distinct_property cap and runs out of feasible
    nodes; "worstfit" has three spreads (the padded pairwise tree),
    WorstFit and near-full nodes; "infeasible" finds no node at all;
    "wide" is the second size, N_pad 16,384 (10,240 nodes), with three
    spreads (racks, zones with targets, a missing attribute), a
    distinct_property cap and penalty steps; "many" (a spread over 600
    racks) and "many_dp" (a distinct_property over 300 values) have value
    tables above the 256 entries warp 0 rebuilds alone; "devices" adds a
    device column and a cores column (d = 6, config 5's shape: one ask,
    the lean cache at one spread and no distinct_property) with a
    device-affinity sub-score; "devices_wide" four such columns (d = 8,
    MAX_DIMS) with three spreads and a distinct_property (the full
    cache)."""
    n, real, k_pad = CFG3_PAD, CFG3_NODES, 512
    if variant == "wide":
        n, real = N_PAD, N_NODES
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
    elif variant == "many":                  # 600 racks: the block's tables
        v = 1024
        svid[0, :real] = np.arange(real) % 600
        scnt = np.zeros((s, v))
        scnt[0, :600] = rng.integers(0, 3, 600)
        sdes = np.full((s, v), np.nan)
    elif variant == "many_dp":               # 300 property values, the same
        dp = dict(dp_val_id=(np.arange(n) % 300)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 7)[None, :],
                  dp_counts0=rng.integers(0, 2, (1, 300)),
                  dp_limit=np.array([3.0]))
    elif variant == "wide":
        s = 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 7]).astype(float)
        sok = np.tile(np.arange(n) < real, (s, 1))
        sok[2, ::13] = False                 # a missing attribute
        scnt = rng.integers(0, 30, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        sdes[1, :4] = [900.0, 600.0, 300.0, 0.0]
        has_t = np.array([False, True, False])
        weight = np.array([0.5, 0.3, 0.2])
        pen[rng.integers(0, CFG3_K, 60)] = rng.integers(0, real, 60)
        aff[:real] = rng.choice([0.0, 0.0, 0.25, -0.25], real)
        dp = dict(dp_val_id=(np.arange(n) % 9)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 5)[None, :],
                  dp_counts0=rng.integers(0, 20, (1, 9)),
                  dp_limit=np.array([70.0]))
    ask, dev_aff = np.array([100.0, 64.0, 300.0, 0.0]), np.zeros(n)
    if variant in ("devices", "devices_wide"):
        extra = 2 if variant == "devices" else 4
        cap, xused, xask, dev_aff = device_columns(rng, n, real, extra)
        avail = np.concatenate([avail, cap], axis=1)
        used = np.concatenate([used, xused], axis=1)
        ask = np.concatenate([ask, xask])
    if variant == "devices_wide":
        s = 3
        svid = np.stack([np.arange(n) % 20, np.arange(n) % 4,
                         np.arange(n) % 3]).astype(float)
        sok = np.tile(np.arange(n) < real, (s, 1))
        scnt = rng.integers(0, 30, (s, v)) * (np.arange(v) < 20)
        sdes = np.full((s, v), np.nan)
        sdes[1, :4] = [300.0, 100.0, 100.0, 0.0]
        has_t = np.array([False, True, False])
        weight = np.array([0.5, 0.3, 0.2])
        dp = dict(dp_val_id=(np.arange(n) % 9)[None, :].astype(float),
                  dp_val_ok=(np.arange(n) < real - 5)[None, :],
                  dp_counts0=rng.integers(0, 20, (1, 9)),
                  dp_limit=np.array([80.0]))
    tie_perm = rng.permutation(n)
    dp = dp or dict(dp_val_id=np.zeros((0, n)),
                    dp_val_ok=np.zeros((0, n), bool),
                    dp_counts0=np.zeros((0, 1)), dp_limit=np.zeros(0))
    return (avail, used, ptg, pjob, ask,
            feas, aff, dev_aff, pen, active, svid, sok, scnt, sdes,
            has_t, weight, dp["dp_val_id"], dp["dp_val_ok"],
            dp["dp_counts0"], dp["dp_limit"], -1.0, float(CFG3_K), False,
            dh_tg, spread_alg, tie_perm)


def device_columns(rng, n: int, real: int, extra: int):
    """``extra`` count columns as tensor/cluster.py appends them for
    device asks (8 instances a node, or 0 or 4 where a node lacks or
    halves the group) and a last one for reserved cores (16 a node), with
    usage, an ask of one instance an ask and two cores, and a
    device-affinity sub-score of zeros, positives and negatives."""
    cap = np.zeros((n, extra))
    cap[:real] = rng.choice([0, 4, 8, 8, 8], (real, extra))
    cap[:real, -1] = 16
    used = np.minimum(cap, rng.integers(0, 6, (n, extra)))
    ask = np.array([1.0] * (extra - 1) + [2.0])
    dev_aff = np.zeros(n)
    dev_aff[:real] = rng.choice([0.0, 0.0, 0.5, 1.0, -0.25], real)
    return cap, used, ask, dev_aff


def cfg3_packed(rng, variant: str):
    """cfg3_args' solve in the kernels' packed layout, on the CPU
    (pack_solve_tensors)."""
    from nomad_tpu_torch.tensor.kernels import pack_solve_tensors

    args = cfg3_args(rng, variant)
    return pack_solve_tensors(*args[:25], node_col=args[25])


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
        packed = [a.to(dev) for a in cfg3_packed(rng, variant)]
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


B9_VARIANTS = ("cfg3", "targets", "distinct", "worstfit", "infeasible",
               "many", "many_dp", "wide", "devices", "devices_wide")


def active_steps(packed) -> int:
    return int((packed[1][:, 1] > 0.5).sum())


def phase_scan(torch, dev, card, rng):
    """B9 against its plain version on the seven cfg3 variants and the
    N_pad 16,384 one; timed at cfg3 and at 16,384."""
    from nomad_tpu_torch.tensor import kernels

    err = 0.0
    packed_of, notes = {}, []
    for variant in B9_VARIANTS:
        packed = [a.to(dev) for a in cfg3_packed(rng, variant)]
        got = kernels.solve_task_group_fused(*packed)
        want = kernels.solve_task_group_fused_ref(*packed)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            diff = int((got[:2] != want[:2]).any(0).sum())
            raise AssertionError(f"B9 {variant}: choices/founds differ from "
                                 f"the plain version at {diff} steps")
        err = max(err, score_err(got[2], want[2], f"B9 {variant}"))
        notes.append(f"{variant} {int(got[1].sum())}/{active_steps(packed)}")
        packed_of[variant] = packed
    main, wide = packed_of["cfg3"], packed_of["wide"]
    ms = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused(*main), reps=10)
    wide_ms = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused(*wide), reps=5)
    plain = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused_ref(*main), reps=2,
        warmup=1)
    b_ms, b_by = scan_bound(main)
    steps = active_steps(main)
    by_d = {}
    for variant, d in (("devices", 6), ("devices_wide", 8)):
        packed = packed_of[variant]
        by_d[f"d{d}"] = dict(zip(
            ("ms", "plain_ms"), scan_times(torch, kernels, packed)))
        by_d[f"d{d}"].update(zip(("bound_ms", "bound_by"),
                                 scan_bound(packed)))
        by_d[f"d{d}"]["variant"] = variant
    print(f"B9 scan     [{card}] choices and founds exact, scores within "
          f"{SCORE_TOL} (max {err:.3g}); found {', '.join(notes)}; kernel "
          f"{ms:.4f} ms ({ms / steps * 1e3:.2f} us an active step of "
          f"{steps}), plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}); "
          f"N_pad {N_PAD} "
          f"(3 spreads, a distinct_property, penalty steps) {wide_ms:.4f} ms "
          f"({wide_ms / active_steps(wide) * 1e3:.2f} us an active step); "
          + "; ".join(f"{k} ({v['variant']}) kernel {v['ms']:.4f} ms, plain "
                      f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.6f} ms "
                      f"({v['bound_by']})" for k, v in by_d.items()))
    return {"name": "solve_task_group", "source":
            "nomad_tpu_torch/csrc/task_group.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:448",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_per_step": ms / steps, "by_d": by_d}


def scan_times(torch, kernels, packed):
    """B9's and its plain version's device times on one packed solve."""
    return (cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused(*packed), reps=10),
        cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused_ref(*packed),
        reps=2, warmup=1))


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


def cfg5_build_nodes(store, n_nodes: int, seed: int = 0) -> None:
    """bench.py:846-860's GPU nodes: 8 instances of nvidia/gpu/a100,
    16 cores in two NUMA domains, 16,000 or 32,000 MHz, 64 GiB."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.resources import NodeDeviceResource, NumaNode

    rng = random.Random(seed)
    for i in range(n_nodes):
        n = mock.node()
        n.resources.cpu = rng.choice([16000, 32000])
        n.resources.memory_mb = 65536
        n.resources.total_cores = 16
        n.resources.numa = [NumaNode(id=0, cores=list(range(8))),
                            NumaNode(id=1, cores=list(range(8, 16)))]
        n.resources.devices = [NodeDeviceResource(
            vendor="nvidia", type="gpu", name="a100",
            instance_ids=[f"g{i}-{k}" for k in range(8)])]
        n.compute_class()
        store.upsert_node(n)


def cfg5_jobs(n_jobs: int):
    """bench.py:827-836's jobs: CFG5_K allocs of cpu 200, mem 256, one
    nvidia/gpu, two reserved cores, numa_affinity "prefer"."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.resources import RequestedDevice

    out = []
    for _ in range(n_jobs):
        j = mock.service_job(CFG5_K, cpu=200, mem=256)
        res = j.task_groups[0].tasks[0].resources
        res.devices = [RequestedDevice(name="nvidia/gpu", count=1)]
        res.cores = 2
        res.numa_affinity = "prefer"
        out.append(j)
    return out


def device_gates(h, jobs, want: int, what: str) -> None:
    """Every alloc of the jobs placed with one device instance and two
    cores; over every live alloc of the store (the warm-up's included) no
    instance or core held twice on a node, no node over its capacity or
    its instance count; every eval cleanly complete."""
    from nomad_tpu_torch.structs import enums

    snap = h.store.snapshot()
    allocs = [a for j in jobs for a in snap.allocs_by_job(j.id)
              if not a.terminal_status()]
    short = [a for a in allocs
             if sum(len(v) for v in a.allocated_devices.values()) != 1
             or len(a.allocated_cores) != 2]
    if len(allocs) != want or short:
        raise AssertionError(f"{what}: {len(allocs)} placed of {want}; "
                             f"{len(short)} without one instance and two "
                             f"cores")
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    insts = {n.id: [] for n in nodes}
    cores = {n.id: [] for n in nodes}
    for a in snap.allocs():
        if a.terminal_status():
            continue
        usage[row[a.node_id]] += a.allocated_vec
        insts[a.node_id].extend(i for v in a.allocated_devices.values()
                                for i in v)
        cores[a.node_id].extend(a.allocated_cores)
    twice = sum(len(v) != len(set(v)) for m in (insts, cores)
                for v in m.values())
    over = int((usage > cap).any(axis=1).sum()) + sum(
        len(insts[n.id]) > sum(len(g.instance_ids) for g in n.resources.devices)
        or len(cores[n.id]) > n.resources.total_cores for n in nodes)
    if twice or over:
        raise AssertionError(f"{what}: {twice} nodes with an instance or "
                             f"core held twice, {over} nodes over capacity")
    bad = [e for e in h.evals if e.status != enums.EVAL_STATUS_COMPLETE
           or e.failed_tg_allocs]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} evals not cleanly "
                             f"complete")


def cfg5_run(torch, alg: str, n_jobs: int, device="cuda", captured=None,
             clock=None):
    """bench.py cfg5's run(): the GPU nodes, a warm-up job processed and
    deleted (its allocs stay), then n_jobs through Harness.process one
    after another. With ``captured``, every B9 launch's inputs are copied
    (and its outputs kept); ``clock`` adds up the host's exact id
    assignment (``_assign_ids``) and the B9 calls (launch to result).
    Returns (the harness, the jobs, the timed wall, the launch counts)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import placer
    from nomad_tpu_torch.testing import Harness

    h = Harness(device=device)
    cfg5_build_nodes(h.store, CFG5_NODES)
    jobs = cfg5_jobs(n_jobs)
    for j in jobs:
        h.store.upsert_job(j)
    cfg = SchedulerConfiguration(scheduler_algorithm=alg)
    warm = cfg5_jobs(1)[0]
    h.store.upsert_job(warm)
    h.process(mock.eval_for(warm), cfg)
    h.store.delete_job(warm.id)
    real_solve = placer.solve_task_group_fused
    real_assign = placer.TorchPlacer._assign_ids

    def solve(*packed):
        t0 = time.perf_counter()
        if captured is not None:
            snap = [t.clone() for t in packed]
        out = real_solve(*packed)
        if clock is not None:
            torch.cuda.synchronize()
            clock["b9_s"] += time.perf_counter() - t0
        if captured is not None:
            captured.append((snap, out.clone()))
        return out

    def assign(*args):
        t0 = time.perf_counter()
        ok = real_assign(*args)
        clock["assign_ids_s"] += time.perf_counter() - t0
        return ok

    if clock is not None:
        clock.update(b9_s=0.0, assign_ids_s=0.0)
        placer.TorchPlacer._assign_ids = staticmethod(assign)
    placer.solve_task_group_fused = solve
    try:
        _ext.COUNTS.reset()
        t0 = time.perf_counter()
        for j in jobs:
            h.process(mock.eval_for(j), cfg)
        wall = time.perf_counter() - t0
        counts = _ext.COUNTS.snapshot()
    finally:
        placer.solve_task_group_fused = real_solve
        placer.TorchPlacer._assign_ids = staticmethod(real_assign)
    return h, jobs, wall, counts


def phase_devices(torch, card, device="cuda"):
    """BASELINE config 5 through Harness.process("tpu-binpack"): each
    job's 512 requests are one B9 launch with a device and a cores column
    (d = 6) and a device-affinity column, then the host's exact instance
    and core assignment per placement. Gates as device_gates, B9 launched
    once a job at d = 6 and nothing else, no plain version on CUDA; each
    launch's inputs copied and replayed against the plain version
    (choices and founds exact, scores within SCORE_TOL, and equal to the
    path's own output), timed on the card beside the plain version. Then
    the host "binpack" on the 2-job sample (bench.py:880-885). Returns
    (the launch counts, the record, B9's kernel record at d = 6)."""
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.tensor import kernels

    captured, clock = [], {}
    n_jobs = CFG5_JOBS
    h, jobs, wall, counts = cfg5_run(
        torch, enums.SCHED_ALG_TPU_BINPACK, n_jobs, device, captured, clock)
    want = n_jobs * CFG5_K
    device_gates(h, jobs, want, "devices")
    launched = counts["launches"]
    if launched["solve_task_group"] != n_jobs or any(
            v for k, v in launched.items() if k != "solve_task_group"):
        raise AssertionError(f"devices: kernel launches {launched}, want "
                             f"B9 once a job ({n_jobs}) and nothing else")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"devices: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    err, dims = 0.0, set()
    for i, (packed, out) in enumerate(captured):
        dims.add((packed[0].shape[1] - 6) // 2)
        got = kernels.solve_task_group_fused(*packed)
        want_out = kernels.solve_task_group_fused_ref(*packed)
        torch.cuda.synchronize()
        if not (torch.equal(got[:2], want_out[:2])
                and torch.equal(got, out)):
            raise AssertionError(f"devices: B9 launch {i} differs from its "
                                 f"plain version or from the path's output")
        err = max(err, score_err(got[2], want_out[2], f"devices B9 {i}"))
    if dims != {6}:
        raise AssertionError(f"devices: B9 ran at d {sorted(dims)}, want 6")
    first = captured[0][0]
    ms = statistics.mean(cuda_time_ms(
        torch, lambda _, p=packed: kernels.solve_task_group_fused(*p),
        reps=5) for packed, _ in captured)
    plain = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused_ref(*first), reps=2,
        warmup=1)
    b_ms, b_by = scan_bound(first)
    steps = active_steps(first)
    placed = want
    h_host, host_jobs, host_wall, _ = cfg5_run(
        torch, enums.SCHED_ALG_BINPACK, CFG5_SAMPLE, device)
    device_gates(h_host, host_jobs, CFG5_SAMPLE * CFG5_K, "devices binpack")
    host_n = CFG5_SAMPLE * CFG5_K
    rec = {"allocs": placed, "wall_s": wall, "allocs_per_s": placed / wall,
           "b9_launches": launched["solve_task_group"],
           "b9_device_ms_mean": ms, "b9_calls_s": clock["b9_s"],
           "assign_ids_s": clock["assign_ids_s"],
           "binpack_sample": {"allocs": host_n, "wall_s": host_wall,
                              "allocs_per_s": host_n / host_wall},
           "per_alloc_ratio": (host_wall / host_n) / (wall / placed),
           "card": card}
    print(f"devices     [{card}] {placed} allocs of config 5 ({CFG5_NODES} GPU "
          f"nodes, {n_jobs} jobs x {CFG5_K}) in {wall:.3f} s = "
          f"{placed / wall:.1f} allocs/s; B9 {launched['solve_task_group']} "
          f"launches at d 6, {ms:.4f} ms device time a launch (mean over "
          f"the replays; plain {plain:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}); {steps} active steps), the B9 calls {clock['b9_s']:.3f}"
          f" s and the host's instance and core assignment "
          f"{clock['assign_ids_s']:.3f} s of the wall; replays exact, scores "
          f"within {SCORE_TOL} (max {err:.3g}); host binpack sample "
          f"{host_n} allocs in {host_wall:.3f} s; per-alloc ratio "
          f"{rec['per_alloc_ratio']:.2f} (bench.py's vs_baseline formula)")
    kernel = {"name": "solve_task_group_d6", "source":
              "nomad_tpu_torch/csrc/task_group.cu",
              "replaces": "nomad_tpu/tensor/kernels.py:448",
              "launches": launched["solve_task_group"], "max_abs_err": err,
              "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
              "bound_by": b_by, "library_ms": None,
              "ms_per_step": ms / steps}
    return launched, rec, kernel


def phase_constraints(torch, card, device="cuda"):
    """BASELINE config 2 through the port's Server (bench.py run_server):
    1,024 nodes, a warm-up job registered and deregistered, then 10 batch
    jobs x 1,024 allocs with an instance.type constraint, a version
    constraint (>= 4.19 on ${attr.kernel.version}) and a zone affinity,
    registered at once to 4 workers, every plan re-checked by the applier.
    Gates as server_gates (every alloc live once, no node over capacity,
    no eval left blocked), every alloc on a large node with kernel 4.19 or
    later, B1 launched once a service launch and no plain version on
    CUDA. Returns (the launch counts, the record)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.structs import Affinity, Constraint
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service

    def jobs_fn():
        cons = [Constraint(ltarget="${attr.instance.type}", rtarget="large",
                           operand="="),
                Constraint(ltarget="${attr.kernel.version}",
                           rtarget=">= 4.19", operand="version")]
        affs = [Affinity(ltarget="${attr.zone}", rtarget="z0", operand="=",
                         weight=50)]
        return [mock.service_job(CFG2_K, batch=True, constraints=cons,
                                 affinities=affs) for _ in range(CFG2_JOBS)]

    srv = Server(ServerConfig(
        num_workers=CFG2_WORKERS, device=device,
        sched_config=SchedulerConfiguration(scheduler_algorithm="tpu-binpack"),
        nack_timeout=900.0, failed_eval_followup_delay=3600.0,
        failed_eval_unblock_interval=0.5))
    mock.build_nodes(srv.store, CFG2_NODES, seed=0)
    jobs = jobs_fn()
    svc = get_service(srv.device)
    with srv:
        warm = jobs_fn()[0]
        srv.register_job(warm)
        if not srv.wait_for_idle(120.0, include_delayed=False):
            raise AssertionError("constraints: the warm-up did not drain")
        srv.deregister_job(warm.id)
        if not srv.wait_for_idle(120.0, include_delayed=False):
            raise AssertionError("constraints: the warm stop did not drain")
        srv.plan_applier.stats.update(applied=0, nodes_rejected=0,
                                      partial_commits=0)
        base = dict(svc.stats)
        _ext.COUNTS.reset()
        t0 = time.perf_counter()
        for j in jobs:
            srv.register_job(j)
        deadline = time.time() + 300.0
        while True:
            if not srv.wait_for_idle(max(1.0, deadline - time.time()),
                                     include_delayed=False):
                raise AssertionError("constraints: the queue did not drain")
            if srv.blocked.blocked_count() == 0:
                break
            if time.time() > deadline:
                raise AssertionError(f"constraints: blocked evals did not "
                                     f"drain: {blocked_report(srv)}")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        counts = _ext.COUNTS.snapshot()
        stats = dict(srv.plan_applier.stats)
        svc_stats = {k: svc.stats[k] - base[k] for k in base}
        want = CFG2_JOBS * CFG2_K
        statuses = server_gates(srv, jobs, want, "constraints")
        snap = srv.store.snapshot()
        zones = Counter()
        for j in jobs:
            for a in snap.allocs_by_job(j.id):
                node = snap.node_by_id(a.node_id)
                if (node.attributes["instance.type"] != "large"
                        or node.attributes["kernel.version"] not in
                        ("4.19.0", "5.10.0")):
                    raise AssertionError(f"constraints: alloc {a.id} on a "
                                         f"node its constraints exclude")
                zones[node.attributes["zone"]] += 1
    svc.stop()
    launched = counts["launches"]
    if not 0 < launched["bulk_fill"] == svc_stats["launches"]:
        raise AssertionError(f"constraints: B1 launched "
                             f"{launched['bulk_fill']} times for "
                             f"{svc_stats['launches']} service launches")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"constraints: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    rejected = stats["nodes_rejected"]
    rate = rejected / max(want + rejected, 1)
    rec = {"allocs": want, "wall_s": wall, "allocs_per_s": want / wall,
           "applied": stats["applied"], "nodes_rejected": rejected,
           "partial_commits": stats["partial_commits"],
           "rejection_rate": rate, "evals": statuses,
           "zones": dict(sorted(zones.items())),
           "service_launches": svc_stats["launches"],
           "launches": {k: v for k, v in launched.items() if v},
           "card": card}
    print(f"constraints [{card}] {want} allocs of config 2 ({CFG2_NODES} "
          f"nodes, {CFG2_JOBS} batch jobs x {CFG2_K}, {CFG2_WORKERS} "
          f"workers) in "
          f"{wall:.3f} s = {want / wall:.1f} allocs/s through the Server; "
          f"applied {stats['applied']}, nodes_rejected {rejected}, "
          f"partial_commits {stats['partial_commits']}, plan rejection rate "
          f"{rate:.6f}; allocs by zone {rec['zones']}; evals {statuses}; "
          f"kernel launches {rec['launches']}")
    return launched, rec


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


# ---------------------------------------------------------------------------
# preemption: B7 and B12, BASELINE config 4, the cutover
# ---------------------------------------------------------------------------

PREEMPT_K = 512
PREEMPT_V = 8
PREEMPT_VARIANTS = ("main", "ties", "inactive", "infeasible", "wide",
                    "flagged", "fits", "allneg", "ragged", "n32768")
# N_pad of the variants that change it: not a multiple of 32 (the tree's
# last segment part empty), and above where B7's keys fit in shared memory
PREEMPT_N_PAD = {"ragged": N_NODES + 7, "n32768": 32768}
# feasible nodes of "allneg", each able to take one request
ALLNEG_NODES = 200
# BASELINE config 4 (bench.py:698-818 cfg4_system_preemption)
CFG4_NODES = 1024
# (N_pad, K_pad) of the cutover sweep, V 8
CUTOVER_SHAPES = ((256, 64), (1024, 128), (1024, 512), (4096, 512))


def preempt_inputs(rng, variant: str, n_pad=N_PAD, n_real=N_NODES,
                   k=PREEMPT_K, v=PREEMPT_V):
    """B7 inputs as numpy arrays, in preempt_solve's order. By default at
    the C2M width: the build_nodes capacities of 10,240 nodes padded to
    16,384, cpu and memory used at 95-105% so most rows evict, K 512
    requests of (2,500 MHz, 2,048 MB, 300 MB), up to V 8 victims a node,
    sorted by priority. Variants: "ties" (every real node identical),
    "inactive" (no active row), "infeasible" (no feasible node), "wide"
    (one feasible node with 512 small victims), "flagged" (every first
    victim flagged), "fits" (a tenth of the nodes have room), "allneg"
    (ALLNEG_NODES feasible nodes, full, each with one victim of the ask's
    size: each takes one request, then every node is NEG)."""
    d = 4
    if variant == "wide":
        v = 512
    avail = np.zeros((n_pad, d), np.float32)
    if n_real == N_NODES:
        avail[:n_real] = c2m_capacity()
    else:
        avail[:n_real] = (rng.choice([8000, 16000, 32000], n_real)[:, None]
                          * np.array([1.0, 2.048, 6.4, 0.75]))
    used = np.zeros((n_pad, d), np.float32)
    used[:n_real, :2] = np.floor(avail[:n_real, :2]
                                 * rng.uniform(0.95, 1.05, (n_real, 2)))
    used[:n_real, 2] = np.floor(avail[:n_real, 2] * 0.5)
    ask = np.array([2500, 2048, 300, 0], np.float32)
    feasible = np.zeros(n_pad, bool)
    feasible[:n_real] = rng.random(n_real) < 0.95
    active = np.ones(k, bool)
    v_prio = np.zeros((n_pad, v), np.float32)
    v_vec = np.zeros((n_pad, v, d), np.float32)
    v_elig = np.zeros((n_pad, v), bool)
    counts = rng.integers(0, min(v, 8) + 1, n_real)
    for i in np.flatnonzero(counts):
        c = int(counts[i])
        v_prio[i, :c] = np.sort(rng.integers(1, 60, c))
        v_vec[i, :c, 0] = rng.integers(200, 2500, c)
        v_vec[i, :c, 1] = rng.integers(200, 4000, c)
        v_vec[i, :c, 2] = 300
        v_elig[i, :c] = True
    v_flag = np.zeros((n_pad, v), bool)
    if variant == "ties":
        src = int(np.argmax(counts))        # a node with the most victims
        for a in (avail, used, v_prio, v_vec, v_elig):
            a[:n_real] = a[src]
        feasible[:n_real] = True
    elif variant == "inactive":
        active[:] = False
    elif variant == "infeasible":
        feasible[:] = False
    elif variant == "wide":
        feasible[:] = False
        feasible[77] = True
        v_prio[77] = np.repeat(np.arange(1, 65), 8)
        v_vec[77] = (20, 20, 1, 0)
        v_elig[77] = True
    elif variant == "flagged":
        v_flag[:, 0] = v_elig[:, 0]
    elif variant == "fits":
        room = rng.random(n_real) < 0.1
        used[:n_real][room] = np.floor(avail[:n_real][room] * 0.5)
    elif variant == "allneg":
        feasible[:] = False
        feasible[rng.choice(n_real, ALLNEG_NODES, replace=False)] = True
        used[:] = avail
        v_prio[:] = 0.0
        v_vec[:] = 0.0
        v_elig[:] = False
        v_prio[:n_real, 0] = 20.0
        v_vec[:n_real, 0] = ask
        v_elig[:n_real, 0] = True
    max_p = v_prio.max(axis=1)
    net_prio = np.where(max_p > 0,
                        max_p + v_prio.sum(axis=1) / np.maximum(max_p, 1.0),
                        0.0).astype(np.float32)
    return (avail, used, ask, feasible, net_prio, active, v_prio, v_vec,
            v_elig, v_flag)


def preempt_bound(args, picks, victims):
    """Least time of one B7 launch on these inputs, counting what the
    function needs on this data. Bytes: the per-node and per-request
    inputs and v_elig read once, v_vec only at its eligible columns and
    v_flag only at the selected ones (v_prio is not read: the columns
    come sorted), and the outputs written once. Operations: only the
    chosen node's carry changes in a step, so each feasible node is
    scored once (~(6 D + 66), the fitness's two powf counted 20 each)
    with its preemption score (~20) and its evictable sum (D per eligible
    column); then per placed step the chosen node re-scored, a log2 N
    argmax update (~2 a level), and, where it evicts, a scan of its
    unclaimed eligible columns (~(3 D + 4) each)."""
    avail, _, _, feasible, _, active, _, v_vec, v_elig, _ = args
    n, d = avail.shape
    v, k = v_vec.shape[1], active.shape[0]
    elig = int(v_elig.sum())
    n_bytes = (n * d * 8 + d * 4 + n + n * 4 + k + n * v + elig * d * 4
               + int(victims.sum()) + k * 4 + k * v + k + k * 4)
    taken = np.zeros_like(v_elig)
    scanned = 0
    for step in np.flatnonzero(victims.any(axis=1)):
        b = int(picks[step])
        scanned += int((v_elig[b] & ~taken[b]).sum())
        taken[b] |= victims[step]
    placed = int((picks >= 0).sum())
    n_feas = int(feasible.sum())
    ops = (n_feas * (6 * d + 66 + 20) + elig * d
           + placed * (6 * d + 66 + 2 * int(np.ceil(np.log2(n))))
           + scanned * (3 * d + 4))
    return bound(n_bytes, ops)


def pick_preempt_bound(args, picks):
    """Least time of one B12 launch: capacity, usage and evictable (N, D)
    and the per-node and per-request inputs read once, the picks written
    once; each feasible node scored once (~(6 D + 66) and ~20 for its
    preemption score), then per placed step the chosen node re-scored
    with a log2 N argmax update."""
    avail, _, _, feasible, _, active, _, _, _, _ = args
    n, d = avail.shape
    k = active.shape[0]
    ops = (int(feasible.sum()) * (6 * d + 66 + 20)
           + int((picks >= 0).sum()) * (6 * d + 66
                                        + 2 * int(np.ceil(np.log2(n)))))
    return bound(n * d * 12 + d * 4 + n * 5 + k + k * 4, ops)


def on_card(torch, host, dev):
    """B7's inputs copied to the card as the placer copies them: v_prio
    (never read) stays on the host, as None."""
    return [None if i == 6 else torch.tensor(a, device=dev)
            for i, a in enumerate(host)]


def as_f64(host):
    """B7's inputs as the float64 numpy mirror takes them."""
    return [a.astype(np.float64) if a is not None and a.dtype == np.float32
            else a for a in host]


def _pick_from(args):
    avail, used, ask, feasible, net_prio, active, _, v_vec, v_elig, _ = args
    evictable = (v_vec * v_elig[:, :, None]).sum(axis=1).astype(np.float32)
    return (avail, used, evictable, ask, feasible, net_prio, active)


def _host_ms(fn, reps=3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_preempt(torch, got, want, what):
    """B7 outputs exact against the plain version's."""
    torch.cuda.synchronize()
    for name, x, y in zip(("picks", "victims", "flagged", "scores"), got,
                          want):
        if not torch.equal(x, y):
            raise AssertionError(f"B7 {what}: {name} differ from the plain "
                                 f"version")
    return float((got[3] - want[3]).abs().max())


def phase_preempt_kernels(torch, dev, card, rng):
    """B7 and B12 at the C2M width on ten variants, exact against their
    plain versions; both timed on "main" beside the plain versions and
    the numpy mirrors, and on "infeasible", where every step after the
    set-up pass exits early. Returns the B12 record (B7's comes from the
    cfg4 path's own launch)."""
    from nomad_tpu_torch.tensor.kernels import (preempt_pick,
                                                preempt_pick_ref,
                                                preempt_solve,
                                                preempt_solve_ref)
    from nomad_tpu_torch.tensor.placer import (_preempt_pick_host,
                                               _preempt_solve_host)

    err = p_err = 0.0
    notes = []
    main = None
    for variant in PREEMPT_VARIANTS:
        host = preempt_inputs(rng, variant,
                              n_pad=PREEMPT_N_PAD.get(variant, N_PAD))
        args = on_card(torch, host, dev)
        got = preempt_solve(*args)
        err = max(err, check_preempt(torch, got, preempt_solve_ref(*args),
                                     variant))
        if variant == "allneg" and int((got[0] >= 0).sum()) != ALLNEG_NODES:
            raise AssertionError(f"B7 allneg: placed "
                                 f"{int((got[0] >= 0).sum())}, want "
                                 f"{ALLNEG_NODES}")
        pick_args = [torch.tensor(a, device=dev) for a in _pick_from(host)]
        picked = preempt_pick(*pick_args)
        want = preempt_pick_ref(*pick_args)
        if not torch.equal(picked, want):
            raise AssertionError(f"B12 {variant}: picks differ from the "
                                 f"plain version")
        p_err = max(p_err, float((picked - want).abs().max()))
        notes.append(f"{variant} {int((got[0] >= 0).sum())} placed "
                     f"{int(got[1].sum())} victims")
        if variant == "main":
            main = (host, args, pick_args, got, picked)
        if variant == "infeasible":
            empty, empty_pick = args, pick_args
    host, args, pick_args, got, picked = main
    ms = cuda_time_ms(torch, lambda _: preempt_solve(*args), reps=5)
    setup = cuda_time_ms(torch, lambda _: preempt_solve(*empty), reps=5)
    placed = int((got[0] >= 0).sum())
    plain = cuda_time_ms(torch, lambda _: preempt_solve_ref(*args), reps=2,
                         warmup=1)
    f64 = as_f64(host)
    mirror = _host_ms(lambda: _preempt_solve_host(*f64), reps=1)
    b_ms, b_by = preempt_bound(host, got[0].cpu().numpy(),
                               got[1].cpu().numpy())
    p_ms = cuda_time_ms(torch, lambda _: preempt_pick(*pick_args), reps=5)
    p_setup = cuda_time_ms(torch, lambda _: preempt_pick(*empty_pick),
                           reps=5)
    p_placed = int((picked >= 0).sum())
    p_plain = cuda_time_ms(torch, lambda _: preempt_pick_ref(*pick_args),
                           reps=2, warmup=1)
    p64 = as_f64(_pick_from(host))
    p_mirror = _host_ms(lambda: _preempt_pick_host(
        *[a.copy() for a in p64]), reps=1)
    pb_ms, pb_by = pick_preempt_bound(host, picked.cpu().numpy())
    print(f"B7/B12      [{card}] {len(PREEMPT_VARIANTS)} variants at N_pad "
          f"{N_PAD}, K {PREEMPT_K}, V {PREEMPT_V} (wide: 512): B7 picks, "
          f"victims, flags and scores exact (max_abs_err {err}), B12 picks "
          f"exact (max_abs_err {p_err}); {'; '.join(notes)}")
    print(f"B7/B12      [{card}] main: B7 kernel {ms:.4f} ms ({placed} "
          f"placed steps: {ms / placed * 1e3:.2f} us a step; the set-up "
          f"pass alone {setup:.4f} ms, (ms - set-up) a step "
          f"{(ms - setup) / placed * 1e3:.2f} us), plain {plain:.4f} ms, "
          f"numpy mirror {mirror:.4f} ms, bound {b_ms:.6f} "
          f"ms ({b_by}); B12 kernel {p_ms:.4f} ms ({p_placed} placed "
          f"steps; the set-up pass alone {p_setup:.4f} ms, (ms - set-up) a "
          f"step {(p_ms - p_setup) / p_placed * 1e3:.2f} us), plain "
          f"{p_plain:.4f} ms, numpy mirror {p_mirror:.4f} ms, bound "
          f"{pb_ms:.6f} ms ({pb_by})")
    return {"name": "preempt_pick", "source":
            "nomad_tpu_torch/csrc/preempt.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:766",
            "max_abs_err": p_err, "ms": p_ms, "plain_ms": p_plain,
            "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": None,
            "ms_per_step": (p_ms - p_setup) / p_placed, "setup_ms": p_setup}


def cfg4_run(device, captured=None):
    """BASELINE config 4 (bench.py:720-788) through Harness(device): 1,024
    nodes; the warm job and the filler (set-up), then the priority-80
    service and the system job, each timed. Ids are minted from a seeded
    generator, so two runs give the same ids. With ``captured`` (a list)
    each preempt_solve launch's inputs are copied as it is dispatched.
    Returns a dict of the run's results."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs.operator import (PreemptionConfig,
                                                  SchedulerConfiguration)
    from nomad_tpu_torch.tensor import placer
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness
    from nomad_tpu_torch.utils import ids

    ids._rng.seed(4)
    h = Harness(device=device)
    for i in range(CFG4_NODES):
        n = mock.node(id=f"bench4-node-{i:04d}", name=f"bench4-node-{i:04d}")
        n.attributes["rack"] = f"r{i % 20}"
        n.resources.cpu = 16000
        n.resources.memory_mb = 32768
        n.compute_class()
        h.store.upsert_node(n)
    cfg = SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack",
        preemption_config=PreemptionConfig(system_scheduler_enabled=True,
                                           service_scheduler_enabled=True))
    warm = mock.service_job(512, cpu=1, mem=1, priority=20)
    warm.id = warm.name = "bench4-warm"
    h.store.upsert_job(warm)
    h.process(mock.eval_for(warm, id="bench4-ev-warm"), cfg)
    h.store.delete_job(warm.id)
    filler = mock.service_job(2 * CFG4_NODES, cpu=7900, mem=14000,
                              priority=20)
    filler.id = filler.name = "bench4-filler"
    h.store.upsert_job(filler)
    h.process(mock.eval_for(filler, id="bench4-ev-fill"), cfg)
    hi = mock.service_job(512, cpu=2500, mem=2048, priority=80)
    hi.id = hi.name = "bench4-hi"
    sysj = mock.system_job(id="bench4-sys", name="bench4-sys")
    sysj.task_groups[0].tasks[0].resources.cpu = 400
    sysj.task_groups[0].tasks[0].resources.memory_mb = 128
    for j in (hi, sysj):
        h.store.upsert_job(j)
    plans0 = len(h.plans)

    real = placer.preempt_solve

    def capture(*args):
        captured.append([None if a is None else a.clone() for a in args])
        return real(*args)

    if captured is not None:
        placer.preempt_solve = capture
    try:
        _ext.COUNTS.reset()
        s0 = placer.preempt_stats()
        t0 = time.perf_counter()
        with GcClock() as gc_hi:
            h.process(mock.eval_for(hi, id="bench4-ev-hi"), cfg)
        t1 = time.perf_counter()
        s1 = placer.preempt_stats()
        with GcClock() as gc_sys:
            h.process(mock.eval_for(sysj, id="bench4-ev-sys"), cfg)
        t2 = time.perf_counter()
        counts = _ext.COUNTS.snapshot()
    finally:
        placer.preempt_solve = real
    get_service(device).stop()

    snap = h.store.snapshot()
    by_id = {a.id: a for a in snap.allocs()}
    live = [a for a in by_id.values() if not a.terminal_status()]
    evictions = [a for p in h.plans[plans0:]
                 for allocs in p.node_preemptions.values() for a in allocs]
    nodes = {n.id: n for n in snap.nodes()}
    usage = {nid: np.zeros(4) for nid in nodes}
    for a in live:
        usage[a.node_id] += a.allocated_vec
    over = sum(int((usage[nid] > nodes[nid].available_vec()).any())
               for nid in nodes)
    evicted = sorted(
        (a.id, a.job_id, by_id[a.preempted_by_allocation].job_id,
         by_id[a.preempted_by_allocation].name,
         by_id[a.preempted_by_allocation].node_id)
        for a in by_id.values() if a.desired_status == "evict")
    gap = [a.id for a in evictions
           if by_id[a.preempted_by_allocation].job.priority
           - a.job.priority < 10]
    return {
        "hi_s": t1 - t0, "sys_s": t2 - t1, "counts": counts,
        "hi_gc": str(gc_hi), "sys_gc": str(gc_sys),
        "stats": {k: s1[k] - s0[k] for k in s1},
        "hi": sorted((a.name, a.node_id) for a in live
                     if a.job_id == hi.id),
        "sys": sorted(a.node_id for a in live if a.job_id == sysj.id),
        "evicted": evicted, "evictions": len(evictions),
        "evicted_once": len({a.id for a in evictions}) == len(evictions),
        "by_job": dict(Counter(e[1] for e in evicted)),
        "over": over, "gap": gap,
        "evals_ok": all(e.status == "complete" for e in h.evals),
    }


def phase_cfg4(torch, card):
    """The cfg4 path on the card, with its gates. Returns (the launch
    counts of its timed region, the copied preempt_solve inputs, the
    run's results)."""
    captured = []
    r = cfg4_run("cuda", captured)
    launched = r["counts"]["launches"]
    fails = []
    if len(r["hi"]) != 512:
        fails.append(f"hi placed {len(r['hi'])}, want 512")
    if len(r["sys"]) != CFG4_NODES:
        fails.append(f"system job placed {len(r['sys'])}, want {CFG4_NODES}")
    if r["over"]:
        fails.append(f"{r['over']} nodes over capacity")
    if not r["evicted_once"]:
        fails.append("an alloc was evicted twice")
    if r["gap"]:
        fails.append(f"{len(r['gap'])} victims within 10 priorities of "
                     f"their evictor")
    if r["stats"] != {"kernel_preempted": 512, "host_preempted": 0,
                      "victim_parity_checked": 512}:
        fails.append(f"preempt stats {r['stats']}")
    if launched["preempt_solve"] < 1 or len(captured) != launched[
            "preempt_solve"]:
        fails.append(f"preempt_solve launched {launched['preempt_solve']} "
                     f"times, {len(captured)} copied")
    if any(r["counts"]["plain_on_cuda"].values()):
        fails.append(f"plain versions ran on CUDA: "
                     f"{r['counts']['plain_on_cuda']}")
    if not r["evals_ok"]:
        fails.append("an eval did not complete")
    if fails:
        raise AssertionError("cfg4 path: " + "; ".join(fails))
    print(f"cfg4 path   [{card}] hi eval {r['hi_s']:.3f} s ({r['hi_gc']}): "
          f"{len(r['hi'])} placed, stats {r['stats']}; system eval "
          f"{r['sys_s']:.3f} s ({r['sys_gc']}): {len(r['sys'])} placed; "
          f"evicted in all {r['by_job']} "
          f"({r['evictions']} evictions, none twice), 0 nodes over "
          f"capacity; kernel launches {launched}; plain on CUDA "
          f"{r['counts']['plain_on_cuda']}")
    return launched, captured, r


def phase_cfg4_replay(torch, card, captured):
    """The cfg4 path's own preempt_solve launches replayed from their
    copied inputs: the kernel exact against the plain version and, on
    picks, victims and flags, the numpy mirror; the kernel, the plain
    version, the mirror and the inputs' host-to-device copy timed, and
    the kernel's set-up pass alone (the same inputs with no feasible node:
    every step exits early) and its time a placed step. Returns B7's
    record (means over the launches)."""
    from nomad_tpu_torch.tensor.kernels import (preempt_solve,
                                                preempt_solve_ref)
    from nomad_tpu_torch.tensor.placer import _preempt_solve_host

    rows = []
    err = 0.0
    for i, args in enumerate(captured):
        got = preempt_solve(*args)
        err = max(err, check_preempt(torch, got, preempt_solve_ref(*args),
                                     f"path launch {i}"))
        host = [None if a is None else a.cpu().numpy() for a in args]
        f64 = as_f64(host)
        mirror = _preempt_solve_host(*f64)
        for name, x, y in zip(("picks", "victims", "flagged"), got, mirror):
            if not np.array_equal(x.cpu().numpy(), y):
                raise AssertionError(f"B7 path launch {i}: {name} differ "
                                     f"from the numpy mirror")

        def h2d():
            out = on_card(torch, host, args[0].device)
            torch.cuda.synchronize()
            return out

        empty = list(args)
        empty[3] = torch.zeros_like(args[3])
        rows.append((
            cuda_time_ms(torch, lambda _: preempt_solve(*args), reps=5),
            cuda_time_ms(torch, lambda _: preempt_solve_ref(*args), reps=2,
                         warmup=1),
            _host_ms(lambda: _preempt_solve_host(*f64), reps=1),
            _host_ms(h2d, reps=5),
            preempt_bound(host, got[0].cpu().numpy(),
                          got[1].cpu().numpy()),
            tuple(args[0].shape) + (args[5].shape[0], args[7].shape[1]),
            int(sum(a.nbytes for a in host if a is not None)),
            cuda_time_ms(torch, lambda _: preempt_solve(*empty), reps=5),
            int((got[0] >= 0).sum())))
    mean = statistics.fmean
    ms = mean(r[0] for r in rows)
    setup = mean(r[7] for r in rows)
    placed = mean(r[8] for r in rows)
    print(f"cfg4 runs   [{card}] the path's {len(rows)} preempt_solve "
          f"launches replayed at (N_pad, D, K_pad, V_pad) "
          f"{sorted({r[5] for r in rows})}: exact against the plain "
          f"version and the numpy mirror; kernel {ms:.4f} ms ({placed:.0f} "
          f"placed steps: {ms / placed * 1e3:.2f} us a step; the set-up "
          f"pass alone {setup:.4f} ms, (ms - set-up) a step "
          f"{(ms - setup) / placed * 1e3:.2f} us), plain "
          f"{mean(r[1] for r in rows):.4f} ms, mirror "
          f"{mean(r[2] for r in rows):.4f} ms, inputs "
          f"{mean(r[6] for r in rows) / 1e6:.2f} MB copied to the card in "
          f"{mean(r[3] for r in rows):.4f} ms, bound "
          f"{mean(r[4][0] for r in rows):.6f} ms ({rows[0][4][1]})")
    return {"name": "preempt_solve",
            "source": "nomad_tpu_torch/csrc/preempt.cu",
            "replaces": "nomad_tpu/tensor/kernels.py:823",
            "max_abs_err": err, "ms": ms,
            "plain_ms": mean(r[1] for r in rows),
            "bound_ms": mean(r[4][0] for r in rows),
            "bound_by": rows[0][4][1], "library_ms": None,
            "ms_per_step": ms / placed, "setup_ms": setup}


def phase_cfg4_parity(card, card_run):
    """The cfg4 path with device="cpu" gives the card's placements and
    victims."""
    cpu = cfg4_run("cpu")
    for key in ("hi", "sys", "evicted", "stats"):
        if cpu[key] != card_run[key]:
            raise AssertionError(f"cfg4: card and CPU differ in {key}")
    print(f"parity      card == CPU on cfg4 ({len(cpu['hi'])} + "
          f"{len(cpu['sys'])} placed, {len(cpu['evicted'])} evicted)")


def phase_cutover(torch, dev, card, rng):
    """The preemption solve's two routes on the card's host: the numpy
    mirror against the kernel with its copies (inputs to the card,
    outputs back) at four (N_pad, K_pad) shapes, V 8. The kernel is held
    exact against its plain version; the float64 mirror may order two
    nodes whose f32 scores tie differently, so its agreement in picks is
    reported, not required (the path's own launch holds it exactly)."""
    from nomad_tpu_torch.tensor.kernels import (preempt_solve,
                                                preempt_solve_ref)
    from nomad_tpu_torch.tensor.placer import _preempt_solve_host

    out = []
    for n_pad, k_pad in CUTOVER_SHAPES:
        host = preempt_inputs(rng, "main", n_pad=n_pad,
                              n_real=n_pad - n_pad // 8, k=k_pad)
        f64 = as_f64(host)

        def kernel():
            res = preempt_solve(*on_card(torch, host, dev))
            return [t.cpu().numpy() for t in res]

        args = on_card(torch, host, dev)
        check_preempt(torch, preempt_solve(*args), preempt_solve_ref(*args),
                      f"cutover ({n_pad}, {k_pad})")
        same = int((kernel()[0] == _preempt_solve_host(*f64)[0]).sum())
        k_ms = _host_ms(kernel, reps=5)
        m_ms = _host_ms(lambda: _preempt_solve_host(*f64), reps=3)
        out.append(f"({n_pad}, {k_pad}) = {n_pad * k_pad}: mirror "
                   f"{m_ms:.3f} ms, kernel with copies {k_ms:.3f} ms, "
                   f"picks agree {same}/{k_pad}")
    print(f"cutover     [{card}] PREEMPT_DEVICE_MIN = 262144 cells; "
          + "; ".join(out))


# the bulk fallbacks (B11, B11'): groups above the service's MAX_K
LARGE_K = 40_000
LARGE_JOBS = 8
B11_VARIANTS = ("main", "over", "zero_ask", "spread_alg", "dh_tg",
                "spreads", "identical")


def b11_inputs(rng, variant: str):
    """One bulk scan at the C2M width (10,240 build_nodes capacities
    padded to 16,384, D 4, usage at 0-99 allocs of (50, 32, 300) a node)
    as (form, args, kwargs): "main" fused with k 40,000; "over" fused with
    an ask that leaves a remainder; "zero_ask" fused with an all-zero ask
    (infinite caps clamped to the budget); "spread_alg", "dh_tg" and
    "spreads" (two tables: explicit targets, and even spread over 32
    values) through the generic form with its own permutation;
    "identical" fused on identical empty nodes, where the permutation
    decides every step."""
    f = np.float32
    avail = np.zeros((N_PAD, 4), f)
    avail[:N_NODES] = c2m_capacity()
    used = np.zeros((N_PAD, 4), f)
    fill = rng.integers(0, 100, N_NODES).astype(f)
    used[:N_NODES, :3] = fill[:, None] * np.array([50, 32, 300], f)
    feas = np.zeros(N_PAD, bool)
    feas[:N_NODES] = rng.random(N_NODES) < 0.95
    aff = np.zeros(N_PAD, f)
    aff[:N_NODES] = rng.choice([0.0, 0.0, 0.0, 0.5, -0.5], N_NODES)
    ptg = np.zeros(N_PAD, np.int32)
    ptg[:N_NODES] = rng.integers(0, 3, N_NODES)
    ask = np.array([50, 32, 300, 0], f)
    k = LARGE_K
    if variant == "identical":
        avail[:N_NODES] = avail[0]
        used[:] = 0.0
        aff[:] = 0.0
        ptg[:] = 0
        feas[:N_NODES] = True
    if variant == "over":
        ask = np.array([4000, 8192, 300, 0], f)
    if variant == "zero_ask":
        ask[:] = 0.0
    seed = int(rng.integers(0, 2 ** 32))
    if variant in ("main", "over", "zero_ask", "identical"):
        dyn = np.concatenate([used, ptg[:, None], ptg[:, None]],
                             axis=1).astype(f)
        return "fused", [avail, feas, aff, dyn, ask], (k, float(k), seed)
    s, v = (2, 32) if variant == "spreads" else (0, 1)
    svid = rng.integers(0, v, (s, N_PAD)).astype(np.int32)
    sok = rng.random((s, N_PAD)) < 0.9
    scnt = rng.integers(0, 50, (s, v)).astype(np.int32)
    desired = np.full((s, v), np.nan, f)
    if s:
        desired[0] = rng.integers(0, 400, v)
        desired[0, 3] = 0.0
    has_targets = np.arange(s) == 0
    weight = np.full(s, 0.5, f)
    perm = rng.permutation(N_PAD).astype(np.int32)
    args = [avail, used, ask, feas, ptg, ptg.copy(), aff, np.zeros(N_PAD, f),
            svid, sok, scnt, desired, has_targets, weight, perm]
    return "generic", args, (k, float(k), variant == "dh_job",
                             variant == "dh_tg", variant == "spread_alg")


def b11_steps(k: int):
    k_pad = 256
    while k_pad < k:
        k_pad *= 2
    return k_pad // 256


def b11_runner(torch, dev, form, host, scalars, plain=False):
    """One b11_inputs case's inputs on ``dev``, and a function that runs
    it through the wrapper or its plain version -> (N,) int32 counts."""
    from nomad_tpu_torch.tensor import kernels

    t = [torch.tensor(a, device=dev) for a in host]
    kw = {"batch": 256, "n_steps": b11_steps(scalars[0])}
    if form == "fused":
        fn = kernels.solve_bulk_fused_ref if plain else kernels.solve_bulk_fused
        return lambda: fn(*t, *scalars, **kw)
    fn = kernels.solve_bulk_ref if plain else kernels.solve_bulk
    return lambda: fn(*t[:14], *scalars, t[14], **kw)


def b11_call(torch, dev, form, host, scalars, plain=False):
    """Run one b11_inputs case on ``dev`` through the wrapper or its plain
    version -> (N,) int32 counts."""
    return b11_runner(torch, dev, form, host, scalars, plain)()


def b11_bound(n_pad: int, d: int, n_feas: int, counts, s: int = 0):
    """Least time of one bulk scan on these inputs, counting what the
    function needs on this data. Bytes: the (N,) mask read and the (N,)
    counts written once; the other per-node columns (capacity, usage and
    the two placement counts, affinity, permutation) read once at the
    feasible nodes only, since the counts of the rest are 0 whatever they
    hold. Operations: each feasible node scored once (~(6 D + 66) for B8,
    ~12 a spread, ~3 D for its cap); then, per active step, the nodes
    that took placements rescored and put back in order (a log2 N
    update, ~2 a level). A node takes its whole cap in one step unless
    the step's budget runs out inside it, so the (node, step) pairs that
    placed number at most the placed nodes plus the active steps."""
    placed = int(counts.sum())
    nnz = int((counts > 0).sum())
    steps = -(-placed // 256)
    per_node = 6 * d + 66 + 12 * s + 3 * d
    ops = (n_feas * per_node
           + (nnz + steps) * (per_node + 2 * int(np.ceil(np.log2(n_pad)))))
    n_bytes = n_pad * (1 + 4) + n_feas * (d * 4 + (d + 2) * 4 + 4 + 4)
    return bound(n_bytes, ops)


def tie_perm_bound(n: int):
    """Least time of one permutation draw: the (n,) int32 result written
    once; per round, one threefry (~120 32-bit ops) a position and a
    comparison sort of n 64-bit keys (n log2 n comparisons, 2 ops each)."""
    from nomad_tpu_torch.tensor.prng import permutation_rounds

    r = permutation_rounds(n)
    ops = r * (n * 120 + 2 * n * int(np.ceil(np.log2(max(n, 2)))))
    return bound(n * 4, ops)


# B11' sizes: one round at 1,024, two from 16,384 on; above 16,384 its
# buffers are in a global scratch (no path runs it there: B11 refuses)
PERM_SIZES = (1024, N_PAD, 32768, 65536)
PERM_TIMED = (N_PAD, 65536)
# the second round of permutation(113, 16,384) draws two pairs of equal
# words (tests/test_torch_perm_radix.py): a sort that is not stable fails
COLLIDING_SEED = 113


def phase_tie_perm(torch, dev, card, rng):
    """B11' bitwise against permutation_ref at PERM_SIZES, seeds 0, 7,
    2^31, 2^32 - 1, COLLIDING_SEED and four random; timed at PERM_TIMED
    beside its plain version and, as a yardstick only (no one call draws
    the words and permutes), torch.sort(stable=True) of one round's int64
    words. Returns {n: its times}."""
    from nomad_tpu_torch.tensor.prng import (permutation, permutation_ref,
                                             permutation_rounds,
                                             random_bits_keys, seed_keys,
                                             split_ref)

    seeds = [0, 7, 2 ** 31, 2 ** 32 - 1, COLLIDING_SEED] + [
        int(x) for x in rng.integers(0, 2 ** 32, 4)]
    for n in PERM_SIZES:
        for seed in seeds:
            got = permutation(seed, n, dev)
            want = permutation_ref(seed, n, dev)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"B11' permutation differs from "
                                     f"permutation_ref at n={n}, "
                                     f"seed={seed}")
    timed = {}
    for n in PERM_TIMED:
        _, sub = split_ref(seed_keys(torch.tensor([COLLIDING_SEED],
                                                  device=dev)))
        words = random_bits_keys(sub, n)[0]
        timed[str(n)] = {
            "ms": cuda_time_ms(
                torch, lambda _: permutation(COLLIDING_SEED, n, dev),
                reps=20),
            "plain_ms": cuda_time_ms(
                torch, lambda _: permutation_ref(COLLIDING_SEED, n, dev),
                reps=5),
            "torch_sort_ms": cuda_time_ms(
                torch, lambda _: torch.sort(words, stable=True), reps=20),
            "bound_ms": tie_perm_bound(n)[0]}
    print(f"B11' perm   [{card}] bitwise equal at n "
          + ", ".join(f"{n:,} ({permutation_rounds(n)} round"
                      f"{'s' if permutation_rounds(n) > 1 else ''})"
                      for n in PERM_SIZES)
          + f", {len(seeds)} seeds each (seed {COLLIDING_SEED}'s draws "
          f"collide at 16,384); "
          + "; ".join(f"n {n}: kernel {t['ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms, one round's torch.sort "
                      f"{t['torch_sort_ms']:.4f} ms, bound "
                      f"{t['bound_ms']:.6f} ms" for n, t in timed.items()))
    return timed


def phase_b11(torch, dev, card, rng):
    """B11 exact against its plain version on every variant at N_pad
    16,384; the cap <= 1 variants (a prefix of 256 positions each step)
    timed, with their time an active step."""
    notes, timed = [], []
    for variant in B11_VARIANTS:
        form, host, scalars = b11_inputs(rng, variant)
        got = b11_call(torch, dev, form, host, scalars)
        want = b11_call(torch, dev, form, host, scalars, plain=True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = int((got != want).sum())
            raise AssertionError(f"B11 {variant}: counts differ from the "
                                 f"plain version on {diff} nodes")
        placed = int(got.sum())
        if variant == "over" and not 0 < placed < scalars[0]:
            raise AssertionError(f"B11 over: placed {placed}, want a "
                                 f"remainder")
        if variant in ("spread_alg", "dh_tg") and int(got.max()) > (
                b11_steps(scalars[0]) if variant == "spread_alg" else 1):
            raise AssertionError(f"B11 {variant}: a node took "
                                 f"{int(got.max())}")
        notes.append(f"{variant} ({form}) {placed} on "
                     f"{int((got > 0).sum())} nodes")
        if variant in ("spread_alg", "dh_tg", "spreads"):
            run = b11_runner(torch, dev, form, host, scalars)
            ms = cuda_time_ms(torch, lambda _: run(), reps=5)
            steps = -(-placed // 256)
            timed.append(f"{variant} {ms:.4f} ms ({ms / steps * 1e3:.1f} us "
                         f"an active step of {steps})")
    refused = b11_refusals(torch, dev)
    print(f"B11 scan    [{card}] {len(B11_VARIANTS)} variants at N_pad "
          f"{N_PAD}, k {LARGE_K}, exact: {'; '.join(notes)}; kernel "
          f"{'; '.join(timed)}; the kernel's entry refuses {refused}")


def b11_refusals(torch, dev):
    """The shapes the scan kernel's own entry refuses, which the wrappers
    leave to it: a batch above the 16-bit cap field, more than MAX_DIMS
    resource columns, and spread count tables that do not fit in shared
    memory (the cached terms move to the scratch first). Each must raise
    before anything runs."""
    from nomad_tpu_torch.tensor import kernels

    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cases = {"batch 65,536": (4, 0, 1, 65536),
             f"D {kernels.MAX_DIMS + 1}": (kernels.MAX_DIMS + 1, 0, 1, 256),
             "8 spreads of 4,096 values": (4, 8, 4096, 256)}
    for name, (d, s, v, batch) in cases.items():
        args = (z(N_PAD, d), z(N_PAD, d), z(d), z(N_PAD, dtype=b8),
                z(N_PAD, dtype=i32), z(N_PAD, dtype=i32), z(N_PAD), z(N_PAD),
                z(s, N_PAD, dtype=i32), z(s, N_PAD, dtype=b8),
                z(s, v, dtype=i32), z(s, v), z(s, dtype=b8), z(s), 10, 10.0,
                False, False, False,
                torch.arange(N_PAD, dtype=i32, device=dev))
        try:
            kernels.solve_bulk(*args, batch=batch, n_steps=1)
        except RuntimeError as e:
            if "bulk_scan launch" in str(e):
                continue
            raise
        raise AssertionError(f"B11: the kernel's entry took {name}")
    return ", ".join(cases)


def phase_large_groups(torch, card, device="cuda"):
    """The bulk fallback's main path: Harness(device) under
    "tpu-binpack" on the 10,240 build_nodes nodes, 8 batch jobs of one
    group of 40,000 allocs (cpu 50, mem 32), ids pinned, processed one
    after another from one thread on a Harness of their own. Each group
    is above the service's MAX_K, so each eval is one solve_bulk_fused
    call (B11' then B11, N_pad 16,384, k_pad 65,536, 256 steps at most).
    The fused scan reads the store and neither reads nor feeds the solver
    service's carry (ROADMAP C), so the jobs run alone here and the
    capacity gate measures this slice. Each call's inputs are copied and
    its device time taken by CUDA events around it. Returns (the launch
    counts of the run, per-eval walls in s, the copied calls, the device
    ms of each call, the job 0 fingerprint)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import placer
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    h = Harness(device=device)
    mock.build_nodes(h.store, N_NODES, seed=0)
    jobs = []
    for i in range(LARGE_JOBS):
        j = mock.service_job(LARGE_K, cpu=50, mem=32, batch=True)
        j.id = j.name = f"large-{i}"
        h.store.upsert_job(j)
        jobs.append(j)
    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    real = placer.solve_bulk_fused
    captured, events = [], []

    def capture(*args, **kw):
        captured.append(([a.clone() for a in args[:5]], args[5:], kw))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    svc = get_service(device)
    base = dict(svc.stats)
    placer.solve_bulk_fused = capture
    walls = []
    try:
        _ext.COUNTS.reset()
        for i, j in enumerate(jobs):
            t0 = time.perf_counter()
            h.process(mock.eval_for(j, id=f"large-ev-{i}"), cfg)
            walls.append(time.perf_counter() - t0)
        counts = _ext.COUNTS.snapshot()
    finally:
        placer.solve_bulk_fused = real
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in events]
    stats = {k: svc.stats[k] - base[k] for k in base}
    svc.stop()

    snap = h.store.snapshot()
    total = sum(len(snap.allocs_by_job(j.id)) for j in jobs)
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    for block in snap.alloc_blocks():
        for m, nid in enumerate(block.node_ids):
            usage[row[nid]] += block.allocated_vec * float(block.counts[m])
    over = int((usage > cap).any(axis=1).sum())
    launched = counts["launches"]
    fails = []
    if total != LARGE_JOBS * LARGE_K:
        fails.append(f"placed {total}, want {LARGE_JOBS * LARGE_K}")
    if over:
        fails.append(f"{over} nodes over capacity")
    for name in ("bulk_scan", "tie_perm"):
        if launched[name] != LARGE_JOBS:
            fails.append(f"{name} launched {launched[name]} times, want "
                         f"{LARGE_JOBS}")
    if stats["launches"] or launched["bulk_fill"]:
        fails.append(f"the service launched {stats['launches']} times")
    if any(counts["plain_on_cuda"].values()):
        fails.append(f"plain versions ran on CUDA: {counts['plain_on_cuda']}")
    if any(e.status != enums.EVAL_STATUS_COMPLETE or e.failed_tg_allocs
           for e in h.evals):
        fails.append("an eval did not complete cleanly")
    if fails:
        raise AssertionError("large groups path: " + "; ".join(fails))
    wall = sum(walls)
    print(f"large path  [{card}] {total} allocs in {LARGE_JOBS} evals of "
          f"{LARGE_K}: {wall:.3f} s = {total / wall:.1f} allocs/s; eval "
          f"walls {', '.join(f'{w:.3f}' for w in walls)} s; solve_bulk_fused "
          f"on the card {', '.join(f'{m:.2f}' for m in device_ms)} ms = "
          f"{100 * sum(device_ms) / 1e3 / wall:.1f}% of the wall; 0 nodes "
          f"over capacity; kernel launches {launched}; plain on CUDA "
          f"{counts['plain_on_cuda']}")
    first = sorted((row[nid], int(c)) for b in snap.alloc_blocks()
                   if b.job_id == jobs[0].id
                   for nid, c in zip(b.node_ids, b.counts))
    return launched, walls, captured, device_ms, first


def phase_large_replay(torch, card, captured):
    """The path's own solve_bulk_fused calls replayed from their copies:
    the wrapper (B11' + B11) exact against solve_bulk_fused_ref; then the
    permutation kernel and the scan kernel each timed alone beside its
    plain version (the scan on the permutation of its call). Returns the
    B11 and B11' records (means over the calls)."""
    from nomad_tpu_torch.tensor import kernels
    from nomad_tpu_torch.tensor.prng import permutation, permutation_ref

    rows, err, perm_err = [], 0, 0
    for i, (t, scalars, kw) in enumerate(captured):
        avail, feas, aff, dyn, ask = t
        k, tgc, seed = scalars
        got = kernels.solve_bulk_fused(*t, *scalars, **kw)
        want = kernels.solve_bulk_fused_ref(*t, *scalars, **kw)
        n, d = avail.shape
        dev = avail.device
        perm = permutation(seed, n, dev)
        perm_want = permutation_ref(seed, n, dev)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
        perm_err = max(perm_err, int((perm - perm_want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"B11 path call {i}: counts differ from "
                                 f"the plain version")
        if not torch.equal(perm, perm_want):
            raise AssertionError(f"B11' path call {i}: the permutation "
                                 f"differs from the plain version")
        none = torch.empty(0, device=dev)
        scal = kernels._scalars(ask, tgc, False, False, False)

        def scan(_):
            return kernels._launch_bulk_scan(
                avail, dyn, feas, aff, None, perm, none, none, none, scal, k,
                s=0, v=1, **kw)

        def scan_ref(_):
            return kernels._bulk_scan_ref(
                avail, dyn[:, :d], ask, feas, dyn[:, d].to(torch.int32),
                dyn[:, d + 1].to(torch.int32), aff,
                torch.zeros(n, device=dev),
                torch.zeros((0, n), dtype=torch.int32, device=dev),
                torch.zeros((0, n), dtype=torch.bool, device=dev),
                torch.zeros((0, 1), dtype=torch.int32, device=dev),
                torch.zeros((0, 1), device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, device=dev), k, tgc, False, False, False,
                perm, **kw)

        if not torch.equal(scan(None), got):
            raise AssertionError(f"B11 path call {i}: the scan alone "
                                 f"differs from the wrapper")
        counts = got.cpu().numpy()
        rows.append((
            cuda_time_ms(torch, scan, reps=5),
            cuda_time_ms(torch, scan_ref, reps=2, warmup=1),
            b11_bound(n, d, int(feas.sum()), counts),
            cuda_time_ms(torch, lambda _: permutation(seed, n, dev), reps=10),
            cuda_time_ms(torch, lambda _: permutation_ref(seed, n, dev),
                         reps=5),
            int(counts.sum()), int((counts > 0).sum()), n))
    mean = statistics.fmean
    steps = mean(-(-r[5] // 256) for r in rows)
    t_ms, t_by = tie_perm_bound(rows[0][7])
    print(f"large runs  [{card}] the path's {len(rows)} solve_bulk_fused "
          f"calls replayed at N_pad {rows[0][7]}: exact against the plain "
          f"version; {mean(r[5] for r in rows):.0f} placed on "
          f"{mean(r[6] for r in rows):.0f} nodes in {steps:.0f} active "
          f"steps a call; B11 scan {mean(r[0] for r in rows):.4f} ms "
          f"({mean(r[0] for r in rows) / steps * 1e3:.1f} us a step), plain "
          f"{mean(r[1] for r in rows):.4f} ms, bound "
          f"{mean(r[2][0] for r in rows):.6f} ms ({rows[0][2][1]}); B11' "
          f"permutation {mean(r[3] for r in rows):.4f} ms, plain "
          f"{mean(r[4] for r in rows):.4f} ms, bound {t_ms:.6f} ms ({t_by})")
    return [{"name": "bulk_scan", "source": "nomad_tpu_torch/csrc/bulk_scan.cu",
             "replaces": "nomad_tpu/tensor/kernels.py:597",
             "max_abs_err": err, "ms": mean(r[0] for r in rows),
             "plain_ms": mean(r[1] for r in rows),
             "bound_ms": mean(r[2][0] for r in rows),
             "bound_by": rows[0][2][1], "library_ms": None,
             "ms_per_step": mean(r[0] for r in rows) / steps},
            {"name": "tie_perm", "source": "nomad_tpu_torch/csrc/bulk_scan.cu",
             "replaces": "nomad_tpu/tensor/kernels.py:618",
             "max_abs_err": perm_err, "ms": mean(r[3] for r in rows),
             "plain_ms": mean(r[4] for r in rows), "bound_ms": t_ms,
             "bound_by": t_by, "library_ms": None}]


def phase_large_parity(card, card_first):
    """Job 0 of the large-group path (40,000 allocs, pinned ids) through
    Harness(device="cpu") on the same nodes: the card's per-node counts."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.testing import Harness

    h = Harness(device="cpu")
    mock.build_nodes(h.store, N_NODES, seed=0)
    j = mock.service_job(LARGE_K, cpu=50, mem=32, batch=True)
    j.id = j.name = "large-0"
    h.store.upsert_job(j)
    t0 = time.perf_counter()
    h.process(mock.eval_for(j, id="large-ev-0"), SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK))
    wall = time.perf_counter() - t0
    snap = h.store.snapshot()
    row = {n.id: i for i, n in enumerate(snap.nodes())}
    cpu = sorted((row[nid], int(c)) for b in snap.alloc_blocks()
                 for nid, c in zip(b.node_ids, b.counts))
    if cpu != card_first:
        raise AssertionError("large groups: card and CPU per-node counts "
                             "differ on job 0")
    print(f"parity      card == CPU on one {LARGE_K}-alloc group "
          f"({len(cpu)} nodes; the CPU's plain scan took {wall:.3f} s)")


def preempt_scenario_run(device, route):
    """The reference's _run_preempt_scenario (tests/test_preempt_solve.py:
    290-376) with its BULK_MIN 16 through Harness(device): 16 nodes of
    (4,000 MHz, 8,192 MB), a priority-20 batch job of 32 x (1,900, 3,800),
    then a priority-80 batch job of 32 x (1,000, 2,000), both through
    _place_bulk; the second's remainder goes to one preemption solve, the
    numpy mirror ("mirror") or, with PREEMPT_DEVICE_MIN 0, B7 ("kernel").
    Ids are minted from a seeded generator."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs.operator import (PreemptionConfig,
                                                  SchedulerConfiguration)
    from nomad_tpu_torch.tensor import placer
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness
    from nomad_tpu_torch.utils import ids

    ids._rng.seed(5)
    cls = placer.TorchPlacer
    old = cls.BULK_MIN, cls.PREEMPT_DEVICE_MIN
    cls.BULK_MIN = 16
    if route == "kernel":
        cls.PREEMPT_DEVICE_MIN = 0
    try:
        h = Harness(device=device)
        for i in range(16):
            n = mock.node(id=f"ps-node-{i:02d}", name=f"ps-node-{i:02d}")
            n.resources.cpu = 4000
            n.resources.memory_mb = 8192
            n.compute_class()
            h.store.upsert_node(n)
        cfg = SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack",
            preemption_config=PreemptionConfig(batch_scheduler_enabled=True))
        s0 = placer.preempt_stats()
        for jid, cpu, mem, prio in (("ps-filler", 1900, 3800, 20),
                                    ("ps-hi", 1000, 2000, 80)):
            j = mock.service_job(32, cpu=cpu, mem=mem, batch=True,
                                 priority=prio)
            j.id = j.name = jid
            h.store.upsert_job(j)
            h.process(mock.eval_for(j, id=f"{jid}-ev"), cfg)
        s1 = placer.preempt_stats()
    finally:
        cls.BULK_MIN, cls.PREEMPT_DEVICE_MIN = old
    get_service(device).stop()
    snap = h.store.snapshot()
    by_id = {a.id: a for a in snap.allocs()}
    live = [a for a in by_id.values() if not a.terminal_status()]
    nodes = {n.id: n for n in snap.nodes()}
    usage = {nid: np.zeros(4) for nid in nodes}
    for a in live:
        usage[a.node_id] += a.allocated_vec
    evicted = sorted((a.id, a.name, a.node_id,
                      by_id[a.preempted_by_allocation].name)
                     for a in by_id.values() if a.desired_status == "evict")
    return {"hi": sorted((a.name, a.node_id) for a in live
                         if a.job_id == "ps-hi"),
            "evicted": evicted,
            "over": sum(int((usage[nid] > nodes[nid].available_vec()).any())
                        for nid in nodes),
            "stats": {k: s1[k] - s0[k] for k in s1}}


def phase_bulk_preempt(torch, card):
    """The bulk-preemption scenario on both routes, on the card and on the
    CPU: 32 placed, victims unique, capacity holds, card == CPU."""
    from nomad_tpu_torch import _ext

    notes = []
    for route in ("mirror", "kernel"):
        _ext.COUNTS.reset()
        card_run = preempt_scenario_run("cuda", route)
        counts = _ext.COUNTS.snapshot()
        cpu_run = preempt_scenario_run("cpu", route)
        fails = []
        if len(card_run["hi"]) != 32:
            fails.append(f"hi placed {len(card_run['hi'])}, want 32")
        if not card_run["evicted"] or len(
                {e[0] for e in card_run["evicted"]}) != len(
                card_run["evicted"]):
            fails.append("victims missing or not unique")
        if card_run["over"]:
            fails.append(f"{card_run['over']} nodes over capacity")
        if card_run["stats"]["host_preempted"]:
            fails.append(f"preempt stats {card_run['stats']}")
        want_b7 = 1 if route == "kernel" else 0
        if counts["launches"]["preempt_solve"] != want_b7:
            fails.append(f"preempt_solve launched "
                         f"{counts['launches']['preempt_solve']} times")
        if any(counts["plain_on_cuda"].values()):
            fails.append(f"plain versions ran on CUDA: "
                         f"{counts['plain_on_cuda']}")
        if card_run != cpu_run:
            fails.append("card and CPU differ")
        if fails:
            raise AssertionError(f"bulk preemption ({route}): "
                                 + "; ".join(fails))
        notes.append(f"{route}: 32 placed, {len(card_run['evicted'])} "
                     f"victims, stats {card_run['stats']}")
    print(f"bulk preempt [{card}] card == CPU, 0 nodes over capacity, "
          f"victims unique; {'; '.join(notes)}")


# the node-sharded solve (B13-B15): shard counts of the kernel phases, the
# path's mesh, bench.py cfg7_sharded_5k's shape (:986-1002)
SHARDS = (2, 4, 8)
PATH_SHARDS = 4
MANY_SHARDS = 32   # more of B14's CTAs than one card holds at once
CFG7_NODES = 10240
CFG7_K = 512
PARITY_JOBS = 8


def mesh_of(shards: int):
    """S shards on the card's devices, in turn; with one card the list
    repeats cuda:0 (sharding.shard_mesh, as dryrun_multichip's)."""
    from nomad_tpu_torch.tensor.sharding import shard_mesh

    return shard_mesh(shards, "cuda")


@contextlib.contextmanager
def mesh_service(torch, shards: int):
    """A fresh service on the card, with a mesh of ``shards`` (none for
    1), in the place of get_service's for the run; stopped after."""
    from nomad_tpu_torch.tensor import solver

    dev = torch.device("cuda", torch.cuda.current_device())
    svc = solver.BulkSolverService(
        dev, mesh=mesh_of(shards) if shards > 1 else None)
    key = str(dev)
    old = solver._services.get(key)
    solver._services[key] = svc
    try:
        yield svc
    finally:
        svc.stop()
        if old is None:
            solver._services.pop(key, None)
        else:
            solver._services[key] = old


def shard_args(mesh, t):
    """The (used, avail, feas, aff) parts of full tensors (a fresh used),
    and a joint variant's evict / net_prio parts."""
    from nomad_tpu_torch.tensor import sharding as sh

    args = [sh.shard_rows(mesh, t["used"].clone()),
            sh.shard_rows(mesh, t["avail"]), sh.shard_cols(mesh, t["feas"]),
            sh.shard_cols(mesh, t["aff"])]
    kw = {}
    if t.get("evict") is not None:
        kw = dict(evict=sh.shard_rows(mesh, t["evict"]),
                  net_prio=sh.shard_rows(mesh, t["net_prio"]))
    return args, kw


def clone_parts(args):
    return [[p.clone() for p in a] if isinstance(a, list) else a
            for a in args]


def cfg7_inputs(torch, dev, tight=False):
    """bench.py cfg7_sharded_5k: 10,240 nodes, G 16, k 512, asks (50, 32),
    its RandomState(0) capacities and masks. ``tight``: cpu capacity of
    one alloc of 500 a node and k 256, so every eval takes many rounds."""
    rng = np.random.RandomState(0)
    n, g = CFG7_NODES, G
    avail = np.stack([rng.choice([8000, 16000, 32000], n),
                      rng.choice([16384, 32768, 65536], n),
                      np.full(n, 100 * 1024), np.full(n, 12001)],
                     axis=1).astype(np.float32)
    feas = rng.rand(g, n) > 0.1
    ask = np.tile(np.array([50.0, 32.0, 0.0, 0.0], np.float32), (g, 1))
    k = np.full(g, CFG7_K, np.int32)
    if tight:
        avail[:, 0] = rng.choice([600, 700], n)
        ask[:, 0] = 500.0
        k[:] = 256
    t = {name: torch.tensor(v, device=dev) for name, v in (
        ("used", np.zeros((n, 4), np.float32)), ("avail", avail),
        ("feas", feas), ("aff", np.zeros((g, n), np.float32)),
        ("ask", ask), ("k", k), ("seeds", np.arange(g).astype(np.int64)),
        ("cidx", np.zeros(64, np.int32)),
        ("cdelta", np.zeros((64, 4), np.float32)))}
    t["tgc"] = torch.ones(g, device=dev)
    return t


def padded(torch, t, n_pad):
    """Full tensors padded to n_pad nodes with empty, infeasible rows."""
    n = t["used"].shape[0]
    out = dict(t)
    for name in ("used", "avail"):
        out[name] = torch.cat([t[name], t[name].new_zeros((n_pad - n, 4))])
    for name in ("feas", "aff"):
        out[name] = torch.cat([t[name], t[name].new_zeros(
            (t[name].shape[0], n_pad - n))], dim=1)
    return out


def one_launch_a_card(mesh, name: str, what: str, solve):
    """``solve()``, which must launch the kernel ``name`` once on each
    card of ``mesh`` and no other kernel but B15's fold."""
    from nomad_tpu_torch import _ext

    before = _ext.COUNTS.snapshot()["launches"]
    out = solve()
    after = _ext.COUNTS.snapshot()["launches"]
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved != {name: mesh.cards, "scatter_shard": mesh.size}:
        raise AssertionError(f"{what}: launches {moved}, want {name} once on "
                             f"each of {mesh.cards} card(s) and the fold")
    return out


def check_b13(torch, mesh, t, top_r, what):
    """B13 on full tensors ``t``: kernel == plain (counts, carry, rounds),
    counts and carry == single-device B1. Returns the rounds."""
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import solve_bulk_multi

    g = t["feas"].shape[0]
    rep = (t["ask"], t["k"], t["seeds"], t["cidx"], t["cdelta"])
    args, _ = shard_args(mesh, t)
    got = one_launch_a_card(mesh, "bulk_shard", what, lambda: (
        sh.solve_bulk_multi_sharded(mesh, *args, *rep, g=g, top_r=top_r)))
    args, _ = shard_args(mesh, t)
    want = sh.solve_bulk_multi_sharded_ref(mesh, *args, *rep, g=g,
                                           top_r=top_r)
    n = t["used"].shape[0]
    n_pad = 1 << (n - 1).bit_length()
    tp = padded(torch, t, n_pad)
    u1, c1 = solve_bulk_multi(tp["used"].clone(), tp["avail"], tp["feas"],
                              tp["aff"], t["ask"], t["k"], t["tgc"],
                              t["seeds"], t["cidx"], t["cdelta"], g=g)
    torch.cuda.synchronize()
    gu, gc = sh.gather_rows(got[0]), sh.gather_rows(got[1], dim=1)
    wu, wc = sh.gather_rows(want[0]), sh.gather_rows(want[1], dim=1)
    for name, x, y in (("used", gu, wu), ("counts", gc, wc),
                       ("rounds", got[2], want[2])):
        if not torch.equal(x, y):
            raise AssertionError(f"B13 {what}: {name} differs from the "
                                 f"plain version")
    if not (torch.equal(gc, c1[:, :n]) and torch.equal(gu, u1[:n])):
        raise AssertionError(f"B13 {what}: counts or carry differ from "
                             f"single-device B1")
    return got[2].tolist()


def phase_sharded_twin(torch, card, device="cuda"):
    """The incremental feed's twin on a PATH_SHARDS mesh on the card (B15's
    adds: one host call, one launch a shard) against its single-device
    twin (B4), at the C2M width (10,240 nodes, N_pad 16,384): both
    uploaded, then the same deltas (an AllocBlock over 2,048 nodes, 256
    single allocs, 64 of them stopped) flushed into each by one launch.
    Gates: each flush one launch (B4 once, B15 once a shard), the mesh's
    parts put together equal to the single twin, both equal to
    base.astype(f32), and the feed's verify."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.core.events import EventBroker
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.structs.alloc import AllocBlock, Allocation
    from nomad_tpu_torch.tensor import incremental
    from nomad_tpu_torch.tensor.cluster import ClusterStatic
    from nomad_tpu_torch.device import resolve
    from nomad_tpu_torch.tensor.sharding import gather_rows, shard_mesh

    store = StateStore()
    broker = EventBroker(store)
    tracker = incremental.StateTracker()
    feed = tracker.attach(store, broker)
    mock.build_nodes(store, N_NODES, seed=0)
    nodes = list(store.snapshot().nodes())
    static = ClusterStatic(nodes, store=store)
    dev = resolve(device)
    mesh = shard_mesh(PATH_SHARDS, dev)
    feed.device_used(static, dev)
    feed.device_used(static, dev, mesh)
    rng = np.random.default_rng(21)
    vec = np.zeros(4)
    vec[:2] = (50.0, 32.0)
    picked = rng.choice(N_NODES, 2048, replace=False)
    block = AllocBlock(
        id="twin-blk", eval_id="twin-ev", job_id="twin-job",
        task_group="web", name_indices=np.arange(4096, dtype=np.int64),
        node_ids=[nodes[i].id for i in picked],
        node_names=[nodes[i].name for i in picked],
        counts=np.full(2048, 2, dtype=np.int64), allocated_vec=vec)
    singles = []
    for i in range(256):
        a = Allocation(id=f"twin-a{i}", name=f"twin-a{i}",
                       node_id=nodes[int(rng.integers(0, N_NODES))].id,
                       job_id="twin-job", eval_id="twin-ev")
        a.allocated_vec = vec * float(rng.integers(1, 5))
        singles.append(a)
    store.upsert_plan_results(singles, alloc_blocks=[block])
    stops = []
    for a in singles[:64]:
        stop = Allocation(**{k: getattr(a, k) for k in (
            "id", "name", "node_id", "job_id", "eval_id", "allocated_vec")})
        stop.desired_status = "stop"
        stops.append(stop)
    store.upsert_plan_results([], stopped_allocs=stops)
    _ext.COUNTS.reset()
    single = feed.device_used(static, dev).clone()
    parts = feed.device_used(static, dev, mesh)
    counts = _ext.COUNTS.snapshot()
    launched = counts["launches"]
    on_card = dev.type == "cuda"
    if not (launched["scatter_add"] == on_card
            and launched["scatter_shard"] == PATH_SHARDS * on_card
            and not any(counts["plain_on_cuda"].values())):
        raise AssertionError(f"sharded twin: launches {launched}, plain on "
                             f"CUDA {counts['plain_on_cuda']}")
    want = torch.tensor(feed.base_for(static).astype(np.float32), device=dev)
    if not (torch.equal(gather_rows(parts), single)
            and torch.equal(single, want)):
        raise AssertionError("sharded twin: B15's flush differs from B4's "
                             "or from the base")
    if not feed.force_verify() or tracker.violations:
        raise AssertionError(f"sharded twin: verify failed "
                             f"{tracker.violations}")
    rows = 2048 + 256 + 64
    print(f"twin shards [{card}] the feed's twin at S {PATH_SHARDS} (B15's "
          f"adds, {rows} rows, one launch a shard) equal to the single "
          f"twin (one B4 launch) and to base.astype(f32) at N_pad "
          f"{static.n_pad}; verify exact")


def phase_sharded_kernels(torch, dev, card):
    """B15, B13 and B14 against their plain versions and the single-device
    kernels at S = 2, 4, 8 on one card."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.scatter import scatter_add

    from nomad_tpu_torch.tensor.prng import jitter, jitter_fold

    rng = np.random.default_rng(6)
    # each shard's jitter slice (B3 and B3' with a node offset) is the
    # full draw's columns, bit for bit
    seeds = torch.tensor(np.concatenate([[0, 2 ** 32 - 1], rng.integers(
        0, 2 ** 32, G - 2)]).astype(np.int64), device=dev)
    full = jitter(seeds, N_PAD, bs.TIE_JITTER).view(torch.int32)
    full_t = jitter_fold(seeds, N_PAD, bs._jitter_his()).view(torch.int32)
    for s_n in SHARDS:
        m = N_PAD // s_n
        for s in range(s_n):
            lo = s * m
            part = jitter(seeds, m, bs.TIE_JITTER, offset=lo)
            part_t = jitter_fold(seeds, m, bs._jitter_his(), offset=lo)
            if not (torch.equal(part.view(torch.int32), full[:, lo:lo + m])
                    and torch.equal(part_t.view(torch.int32),
                                    full_t[..., lo:lo + m])):
                raise AssertionError(f"jitter slice {s} of {s_n} differs "
                                     f"from the full draw")
    print(f"B3/B3' shard [{card}] every shard's slice bitwise equal to the "
          f"full draw's columns at S {SHARDS}, G {G}, N_pad {N_PAD}")
    # B15: 1,024 rows with duplicates and (0, 0) padding at N_pad 16,384
    used0 = torch.tensor(rng.integers(0, 5000, (N_PAD, 4)).astype(
        np.float32), device=dev)
    b = 1024
    idx_np = rng.integers(0, N_NODES, b).astype(np.int32)
    idx_np[100:200] = idx_np[0]
    idx_np[-64:] = 0
    delta_np = rng.integers(-300, 300, (b, 4)).astype(np.float32)
    delta_np[-64:] = 0.0
    idx, delta = torch.tensor(idx_np, device=dev), torch.tensor(delta_np,
                                                               device=dev)
    # a twin flush's size: 4,096 rows, negative sums for the clamp
    flush_idx = torch.tensor(rng.integers(0, N_NODES, 4096).astype(np.int32),
                             device=dev)
    flush_delta = torch.tensor(rng.integers(-6000, 300, (4096, 4)).astype(
        np.float32), device=dev)
    for rows, (i_t, d_t) in ((b, (idx, delta)),
                             (4096, (flush_idx, flush_delta))):
        single = scatter_add(used0.clone(), i_t, d_t)
        for s_n in SHARDS:
            mesh = mesh_of(s_n)
            got = sh.state_scatter_sharded(mesh, sh.shard_rows(
                mesh, used0.clone()), i_t, d_t)
            want = sh.state_scatter_sharded_ref(mesh, sh.shard_rows(
                mesh, used0.clone()), i_t, d_t)
            # the B13/B14 correction fold: the adds, then max(., 0)
            got_c = sh.shard_rows(mesh, used0.clone())
            sh._scatter_launch(mesh, got_c, i_t, d_t, clamp=True)
            want_c = sh.state_scatter_sharded_ref(mesh, sh.shard_rows(
                mesh, used0.clone()), i_t, d_t, clamp=True)
            torch.cuda.synchronize()
            got = sh.gather_rows(got)
            if not (torch.equal(got, sh.gather_rows(want))
                    and torch.equal(got, single)):
                raise AssertionError(f"B15 S={s_n}, {rows} rows: differs "
                                     f"from the plain version or B4")
            if not torch.equal(sh.gather_rows(got_c),
                               sh.gather_rows(want_c)):
                raise AssertionError(f"B15 S={s_n}, {rows} rows, clamp: "
                                     f"differs from the plain version")
    mesh = mesh_of(PATH_SHARDS)
    refusals(torch, "B15", lambda u, i, d: sh.state_scatter_sharded(
        mesh, u, i, d), (sh.shard_rows(mesh, used0.clone()), idx, delta))
    ms = cuda_time_ms(torch, lambda u: sh.state_scatter_sharded(
        mesh, u, idx, delta), setup=lambda: sh.shard_rows(mesh, used0.clone()))
    idx64 = idx.to(torch.int64)
    lib = cuda_time_ms(torch, lambda u: u.index_add_(0, idx64, delta),
                       setup=used0.clone)
    print(f"B15 shard   [{card}] exact against the plain version and B4 at "
          f"S {SHARDS} ({b} rows, duplicates, padding; and 4,096 rows), "
          f"with the clamp against the plain version, N_pad {N_PAD}; "
          f"ValueError on a wrong dtype, shape and device; at S "
          f"{PATH_SHARDS} on {mesh.cards} card(s), {b} rows: kernel "
          f"{ms:.4f} ms, index_add_ on one card {lib:.4f} ms (host issue)")

    notes = []
    t7 = cfg7_inputs(torch, dev)
    c2m = b1_inputs(torch, dev, np.random.default_rng(7))
    for s_n in SHARDS:
        mesh = mesh_of(s_n)
        r7 = check_b13(torch, mesh, t7, 64, f"cfg7 S={s_n}")
        rc = check_b13(torch, mesh, c2m, 64, f"C2M S={s_n}")
        notes.append(f"S {s_n}: rounds cfg7 {sum(r7)}, C2M {sum(rc)}")
    tight = cfg7_inputs(torch, dev, tight=True)
    rt = check_b13(torch, mesh_of(4), tight, 8, "top_r 8")
    if max(rt) <= 3:
        raise AssertionError(f"B13 top_r 8: rounds {rt}, want many")
    print(f"B13 shard   [{card}] counts, carry and rounds exact against the "
          f"plain version, counts and carry against single-device B1, at "
          f"cfg7 ({CFG7_NODES} nodes, G {G}, k {CFG7_K}) and C2M (N_pad "
          f"{N_PAD}, k {K}, hazards) widths: " + "; ".join(notes)
          + f"; top_r 8 at S 4 (one alloc a node, k 256): rounds {rt}")

    notes = []
    srng = np.random.default_rng(8)
    for variant in ("main", "evict", "correction", "sparse", "cap", "wide"):
        t = solve_inputs(torch, dev, srng, variant)
        rep = (t["ask"], t["k"], t["seeds"], t["cidx"], t["cdelta"])
        one = bs.solve_batch(t["used"].clone(), t["avail"], t["feas"],
                             t["aff"], t["ask"], t["k"], t["tgc"],
                             t["seeds"], t["cidx"], t["cdelta"], t["evict"],
                             t["net_prio"], g=G, rounds=t["rounds"])
        gathers = []
        for s_n in SHARDS:
            mesh = mesh_of(s_n)
            args, kw = shard_args(mesh, t)
            got = one_launch_a_card(
                mesh, "joint_shard", f"B14 {variant} S={s_n}",
                lambda: sh.solve_batch_sharded(mesh, *args, *rep, g=G,
                                               rounds=t["rounds"], **kw))
            args, kw = shard_args(mesh, t)
            want = sh.solve_batch_sharded_ref(mesh, *args, *rep, g=G,
                                              rounds=t["rounds"], **kw)
            torch.cuda.synchronize()
            gu, gc = sh.gather_rows(got[0]), sh.gather_rows(got[1], dim=1)
            for name, x, y in (
                    ("used", gu, sh.gather_rows(want[0])),
                    ("counts", gc, sh.gather_rows(want[1], dim=1)),
                    ("info", got[2], want[2]), ("gathers", got[3], want[3])):
                if not torch.equal(x, y):
                    raise AssertionError(f"B14 {variant} S={s_n}: {name} "
                                         f"differs from the plain version")
            if not (torch.equal(gc, one[1]) and torch.equal(gu, one[0])
                    and torch.equal(got[2][2:], one[2][2:])):
                raise AssertionError(f"B14 {variant} S={s_n}: differs from "
                                     f"single-device solve_batch")
            rel = float(((got[2][:2] - one[2][:2]).abs()
                         / one[2][:2].abs().clamp_min(1e-30)).max())
            if rel > SCORE_TOL:
                raise AssertionError(f"B14 {variant} S={s_n}: scores "
                                     f"{rel:.3g} from solve_batch")
            gathers.append(int(got[3]))
        notes.append(f"{variant}: gathers {gathers}")
    # S 32: on one card B14's 6 x 32 CTAs exceed its 132 SMs, so each CTA
    # takes two shards of its group in turn
    t = solve_inputs(torch, dev, srng, "cap")
    rep = (t["ask"], t["k"], t["seeds"], t["cidx"], t["cdelta"])
    mesh = mesh_of(MANY_SHARDS)
    args, kw = shard_args(mesh, t)
    got = one_launch_a_card(mesh, "joint_shard", f"B14 S={MANY_SHARDS}",
                            lambda: sh.solve_batch_sharded(
                                mesh, *args, *rep, g=G, rounds=t["rounds"],
                                **kw))
    args, kw = shard_args(mesh, t)
    want = sh.solve_batch_sharded_ref(mesh, *args, *rep, g=G,
                                      rounds=t["rounds"], **kw)
    torch.cuda.synchronize()
    for name, x, y in (
            ("used", sh.gather_rows(got[0]), sh.gather_rows(want[0])),
            ("counts", sh.gather_rows(got[1], dim=1),
             sh.gather_rows(want[1], dim=1)),
            ("info", got[2], want[2]), ("gathers", got[3], want[3])):
        if not torch.equal(x, y):
            raise AssertionError(f"B14 S={MANY_SHARDS}: {name} differs from "
                                 f"the plain version")
    notes.append(f"cap at S {MANY_SHARDS} on {mesh.cards} card(s): gathers "
                 f"{int(got[3])}")
    print(f"B14 shard   [{card}] used, counts, info and gathers exact "
          f"against the plain version, counts, used and info[2:] against "
          f"single-device solve_batch (scores within {SCORE_TOL}), 6 "
          f"variants at N_pad {N_PAD}, G {G}, S {SHARDS}, and against the "
          f"plain version at S {MANY_SHARDS}, one launch a card a solve; "
          + "; ".join(notes))
    mesh_times(torch, dev, card, t7, solve_inputs(torch, dev, srng, "main"))


def mesh_times(torch, dev, card, t7, tj):
    """B13 at cfg7 and B14 on the "main" variant at S 4, one solve's
    device time (the window on the first card): on phase 21's mesh
    (over every visible card) and, where that spans cards, on one."""
    from nomad_tpu_torch.tensor import sharding as sh

    meshes = [mesh_of(PATH_SHARDS)]
    if meshes[0].cards > 1:
        meshes.append(sh.NodeMesh([dev] * PATH_SHARDS))
    notes = []
    for mesh in meshes:
        rep7 = (t7["ask"], t7["k"], t7["seeds"], t7["cidx"], t7["cdelta"])
        repj = (tj["ask"], tj["k"], tj["seeds"], tj["cidx"], tj["cdelta"])
        b13 = cuda_time_ms(torch, lambda a: sh.solve_bulk_multi_sharded(
            mesh, *a, *rep7, g=G), setup=lambda: shard_args(mesh, t7)[0],
            reps=5)
        b14 = cuda_time_ms(torch, lambda a: sh.solve_batch_sharded(
            mesh, *a, *repj, g=G, rounds=tj["rounds"]),
            setup=lambda: shard_args(mesh, tj)[0], reps=5)
        notes.append(f"{mesh.cards} card(s): B13 {b13:.4f} ms, B14 "
                     f"{b14:.4f} ms")
    print(f"mesh times  [{card}] S {PATH_SHARDS}, a solve (B13 at cfg7, B14 "
          f"main at N_pad {N_PAD}): " + "; ".join(notes))


def phase_barrier(torch, dev, card):
    """csrc/mesh.cuh's barrier alone (sharding.barrier_probe): 2,000
    rounds of 48 CTAs on one card, no stale read, timed a barrier; then
    a barrier missing a participant, in a process of its own (the trap
    leaves that process's CUDA context unusable), which must raise, not
    hang."""
    from nomad_tpu_torch.tensor import sharding as sh

    ctas, rounds = 48, 2000
    out = sh.barrier_probe(dev, ctas, ctas, rounds)
    torch.cuda.synchronize()
    if int(out[-1]) or not bool((out[ctas:2 * ctas] == rounds).all()):
        raise AssertionError(f"barrier probe: {int(out[-1])} stale reads, "
                             f"last slots {out[ctas:2 * ctas].tolist()}")
    us = cuda_time_ms(torch, lambda _: sh.barrier_probe(
        dev, ctas, ctas, rounds), reps=5) * 1e3 / rounds
    timeout_ms = 1000
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from nomad_tpu_torch.tensor import sharding as sh\n"
        "t0 = time.perf_counter()\n"
        "try:\n"
        f"    sh.barrier_probe('cuda:0', 4, 5, 1, timeout_ms={timeout_ms})\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print(f'{time.perf_counter() - t0:.3f} s: '\n"
        "          f'{str(e).strip().splitlines()[0]}')\n"
        "    sys.exit(3)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180)
    wall = time.perf_counter() - t0
    waited = (float(proc.stdout.split()[0]) if proc.returncode == 3
              else -1.0)
    if not timeout_ms / 1e3 <= waited < 60.0:
        raise AssertionError(f"barrier missing a participant: exit "
                             f"{proc.returncode}, {proc.stdout} {proc.stderr}")
    print(f"barrier     [{card}] {rounds} rounds of {ctas} CTAs, no stale "
          f"read, {us:.3f} us a round; a barrier missing one of 5 "
          f"participants raised in its process after "
          f"{proc.stdout.strip()} (bound {timeout_ms} ms; {wall:.1f} s with "
          f"the process's start)")


def path_gates(h, jobs, want: int, what: str) -> None:
    """Every alloc placed once, no node over capacity (from the store),
    every eval cleanly complete."""
    from nomad_tpu_torch.structs import enums

    snap = h.store.snapshot()
    total = sum(len(snap.allocs_by_job(j.id)) for j in jobs)
    ids = [a.id for a in snap.allocs()]
    if total != want or len(ids) != want or len(set(ids)) != want:
        raise AssertionError(f"{what}: placed {total} / {len(ids)} allocs "
                             f"({len(set(ids))} unique ids), want {want}")
    nodes = list(snap.nodes())
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    for block in snap.alloc_blocks():
        for m, nid in enumerate(block.node_ids):
            usage[row[nid]] += block.allocated_vec * float(block.counts[m])
    over = int((usage > cap).any(axis=1).sum())
    if over:
        raise AssertionError(f"{what}: {over} nodes over capacity")
    bad = [e for e in h.evals if e.status != enums.EVAL_STATUS_COMPLETE
           or e.failed_tg_allocs]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} evals not cleanly "
                             f"complete")


def capture_into(torch, captured, real):
    """A stand-in for a sharded solve that copies each launch's inputs
    (on the service's stream) and keeps its outputs."""
    def capture(mesh, *args, **kw):
        snap = [[p.clone() for p in a] if isinstance(a, list)
                else a.clone() if torch.is_tensor(a) else a for a in args]
        out = real(mesh, *args, **kw)
        captured.append((mesh, snap, dict(kw), out))
        return out
    return capture


def run_sharded_path(torch, card):
    """The C2M bulk path (10,240 nodes, 64 batch jobs x 4,000 allocs, 16
    threads) with a 4-shard mesh service, each launch's inputs copied.
    Returns (the launch counts of its run, its wall, the copied launches,
    the service's stats, its mesh)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import solver
    from nomad_tpu_torch.testing import Harness

    h = Harness(device="cuda")
    mock.build_nodes(h.store, N_NODES, seed=0)
    jobs = []
    for _ in range(JOBS):
        j = mock.service_job(K, cpu=50, mem=32, batch=True)
        h.store.upsert_job(j)
        jobs.append(j)
    evals = [mock.eval_for(j) for j in jobs]
    cfg = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    captured = []
    real = solver.solve_bulk_multi_sharded
    with mesh_service(torch, PATH_SHARDS) as svc:
        print(f"shards      path mesh {svc._mesh!r}: {svc._mesh.size} "
              f"shards, {svc._mesh.cards} distinct card(s)")
        solver.solve_bulk_multi_sharded = capture_into(torch, captured, real)
        try:
            _ext.COUNTS.reset()
            t1 = time.perf_counter()
            with ThreadPoolExecutor(THREADS) as pool:
                for f in [pool.submit(h.process, ev, cfg) for ev in evals]:
                    f.result()
            wall = time.perf_counter() - t1
            counts = _ext.COUNTS.snapshot()
        finally:
            solver.solve_bulk_multi_sharded = real
        stats = dict(svc.stats)
    path_gates(h, jobs, JOBS * K, "sharded C2M path")
    return counts, wall, captured, stats, svc._mesh


def host_calls(counts, stats, mesh, solve: str) -> float:
    """Host calls a solve from the launch counts: B15's fold is one call
    for its S launches, the solve one call for its launch a card; every
    other kernel launch is a call of its own."""
    n = counts["launches"]
    calls = n["scatter_shard"] / mesh.size + n[solve] / mesh.cards + sum(
        v for name, v in n.items() if name not in ("scatter_shard", solve))
    return calls / stats["launches"]


def phase_sharded_path(torch, card):
    """The C2M bulk path with a 4-shard mesh service and its gates: one
    B13 launch a card a solve, B15's fold one a shard. Returns (the
    launch counts of its run, its wall, the copied launches)."""
    counts, wall, captured, stats, mesh = run_sharded_path(torch, card)
    for name in ("scatter_shard", "bulk_shard"):
        if counts["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"sharded path")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    rounds = sum(int(c[3][2].sum()) for c in captured)
    if not (stats["sharded"] == stats["launches"] == len(captured) >= 1
            and stats["allgathers"] == rounds):
        raise AssertionError(f"sharded path: launches {stats['launches']}, "
                             f"sharded {stats['sharded']}, copied "
                             f"{len(captured)}, allgathers "
                             f"{stats['allgathers']} vs rounds {rounds}")
    if counts["launches"]["scatter_shard"] != PATH_SHARDS * stats["launches"]:
        raise AssertionError(f"sharded path: B15 launched "
                             f"{counts['launches']['scatter_shard']} times, "
                             f"not one a shard for each of "
                             f"{stats['launches']} solves")
    if counts["launches"]["bulk_shard"] != mesh.cards * stats["launches"]:
        raise AssertionError(f"sharded path: B13 launched "
                             f"{counts['launches']['bulk_shard']} times, not "
                             f"one a card for each of {stats['launches']} "
                             f"solves")
    calls = host_calls(counts, stats, mesh, "bulk_shard")
    print(f"shard path  [{card}] {JOBS * K} allocs in {wall:.3f} s = "
          f"{JOBS * K / wall:.1f} allocs/s on {PATH_SHARDS} shards "
          f"launches "
          f"{stats['launches']} (all sharded), evals/launch "
          f"{stats['solves'] / stats['launches']:.2f}, all-gathers "
          f"{stats['allgathers']}, host calls a solve {calls:.2f}; kernel "
          f"launches {counts['launches']}")
    return counts["launches"], wall, captured


def run_sharded_solve_path(torch, card):
    """The tpu-solve c2m_mini path (2,560 nodes, 50 x 800, worker batches
    of 8) with a 4-shard mesh service, each launch's inputs copied.
    Returns (the launch counts of its run, its wall, the copied launches,
    the service's stats, its mesh)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import solver
    from nomad_tpu_torch.tensor.solver import batch_member, open_batch
    from nomad_tpu_torch.testing import Harness

    h = Harness(device="cuda")
    mock.build_nodes(h.store, MINI_NODES, seed=0)
    jobs = []
    for i in range(MINI_JOBS):
        cpu, mem = SOLVE_ASKS[i % len(SOLVE_ASKS)]
        j = mock.service_job(SOLVE_K, cpu=cpu, mem=mem, batch=True)
        h.store.upsert_job(j)
        jobs.append(j)
    evals = [mock.eval_for(j) for j in jobs]
    cfg = SchedulerConfiguration(scheduler_algorithm=enums.SCHED_ALG_TPU_SOLVE)

    def member(ctx, ev):
        with batch_member(ctx):
            h.process(ev, cfg)

    captured = []
    real = solver.solve_batch_sharded
    with mesh_service(torch, PATH_SHARDS) as svc:
        solver.solve_batch_sharded = capture_into(torch, captured, real)
        try:
            _ext.COUNTS.reset()
            t1 = time.perf_counter()
            with ThreadPoolExecutor(MINI_BATCH) as pool:
                for b in range(0, len(evals), MINI_BATCH):
                    batch = evals[b:b + MINI_BATCH]
                    ctx = open_batch(len(batch))
                    for f in [pool.submit(member, ctx, ev) for ev in batch]:
                        f.result()
            wall = time.perf_counter() - t1
            counts = _ext.COUNTS.snapshot()
        finally:
            solver.solve_batch_sharded = real
        stats = dict(svc.stats)
    path_gates(h, jobs, MINI_JOBS * SOLVE_K, "sharded tpu-solve path")
    return counts, wall, captured, stats, svc._mesh


def phase_sharded_solve_path(torch, card):
    """The tpu-solve path with a 4-shard mesh service and its gates: one
    B14 launch a card a joint solve (its greedy arm inside), B15's fold
    one a shard, joint score >= greedy score."""
    counts, wall, captured, stats, mesh = run_sharded_solve_path(torch, card)
    joint = stats["joint_launches"]
    for name in ("scatter_shard", "joint_shard"):
        if counts["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"sharded tpu-solve path")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    gathers = sum(int(c[3][3]) for c in captured)
    if not (joint >= 1 and stats["sharded"] == stats["launches"] == joint
            == len(captured) and stats["allgathers"] == gathers):
        raise AssertionError(f"sharded tpu-solve path: stats {stats}, "
                             f"copied {len(captured)}, gathers {gathers}")
    if stats["joint_score"] < stats["greedy_score"]:
        raise AssertionError(f"joint score {stats['joint_score']} below the "
                             f"greedy score {stats['greedy_score']}")
    if (counts["launches"]["joint_shard"] != mesh.cards * joint
            or counts["launches"]["bulk_shard"]):
        raise AssertionError(f"sharded tpu-solve path: B14 launched "
                             f"{counts['launches']['joint_shard']} times for "
                             f"{joint} solves on {mesh.cards} card(s), B13 "
                             f"{counts['launches']['bulk_shard']}")
    calls = host_calls(counts, stats, mesh, "joint_shard")
    print(f"shard solve [{card}] {MINI_JOBS * SOLVE_K} allocs in {wall:.3f} s "
          f"on {PATH_SHARDS} shards; joint launches {joint} (all sharded), "
          f"auction won {stats['auction_won']}, all-gathers "
          f"{stats['allgathers']}, host calls a solve {calls:.2f}, joint "
          f"score "
          f"{stats['joint_score']:.4f} vs greedy {stats['greedy_score']:.4f}; "
          f"kernel launches {counts['launches']}")
    return counts["launches"], wall, captured


def pool_bytes(s_n: int, rounds: int, entries: int) -> int:
    """A round's gathered pools: each shard writes its f32 triplets once
    and every shard reads all of them."""
    return rounds * s_n * entries * 3 * 4 * (1 + s_n)


def b13_work(n: int, g: int, c: int, s_n: int, rounds: int, r: int):
    """Bytes and operations one B13 launch needs, each input read once
    and each output written once: the carry in and out and the capacity,
    the (G, N) mask and boosts in and int16 counts out, the asks, budgets
    and seeds, the C corrections, and the gathered pools of its rounds;
    ~74 operations per (eval, node) as B1's bound counts them, plus one
    threefry draw (~120) for the node's jitter."""
    return (n * 16 * 3 + g * n * (1 + 4 + 2) + g * 28 + c * 20
            + pool_bytes(s_n, rounds, r), g * n * (74 + 120))


def max_diff(pairs) -> float:
    """The largest absolute difference over (got, want) tensor pairs."""
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in pairs)


def phase_sharded_replay(torch, card, bulk, joint, wall_bulk, wall_joint,
                         plain_too=True):
    """The two sharded paths' launches replayed: exact against the plain
    sharded versions and the single-device kernels; B13, B14, B1 and
    solve_batch (and, with ``plain_too``, the plain versions) timed on
    each. Returns the B13 and B14 records, the single-device kernel's
    mean under ``single_ms``."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import solve_bulk_multi
    from nomad_tpu_torch.tensor.prng import jitter_fold
    from nomad_tpu_torch.tensor.scatter import scatter_add_ref

    torch.cuda.synchronize()
    mean = statistics.fmean
    rec = {"bulk": [], "joint": []}
    err = {"bulk": 0.0, "joint": 0.0}
    for i, (mesh, args, kw, _) in enumerate(bulk):
        g = kw["g"]
        got = sh.solve_bulk_multi_sharded(mesh, *clone_parts(args), **kw)
        want = sh.solve_bulk_multi_sharded_ref(mesh, *clone_parts(args),
                                               **kw)
        full = [sh.gather_rows(a, dim=0 if j < 2 else 1)
                for j, a in enumerate(args[:4])]
        ask, k, seeds, cidx, cdelta = args[4:]
        one = solve_bulk_multi(full[0].clone(), *full[1:], ask, k,
                               torch.ones(g, device=ask.device), seeds, cidx,
                               cdelta, g=g)
        torch.cuda.synchronize()
        gu, gc = sh.gather_rows(got[0]), sh.gather_rows(got[1], dim=1)
        e = max_diff([(gu, sh.gather_rows(want[0])),
                      (gc, sh.gather_rows(want[1], dim=1)),
                      (got[2], want[2])])
        if e:
            raise AssertionError(f"sharded path launch {i}: B13 differs "
                                 f"from the plain version by {e}")
        err["bulk"] = max(err["bulk"], e)
        if not (torch.equal(gc, one[1]) and torch.equal(gu, one[0])):
            raise AssertionError(f"sharded path launch {i}: B13 differs "
                                 f"from single-device B1")
        n = full[0].shape[0]
        rounds = int(got[2].sum())
        ms = cuda_time_ms(torch, lambda a: sh.solve_bulk_multi_sharded(
            mesh, *a, **kw), setup=lambda: clone_parts(args), reps=5)
        plain = cuda_time_ms(torch, lambda a: sh.solve_bulk_multi_sharded_ref(
            mesh, *a, **kw), setup=lambda: clone_parts(args), reps=2,
            warmup=1) if plain_too else None
        b1 = cuda_time_ms(torch, lambda u: solve_bulk_multi(
            u, *full[1:], ask, k, torch.ones(g, device=ask.device), seeds,
            cidx, cdelta, g=g), setup=full[0].clone, reps=5)
        rec["bulk"].append((ms, plain, bound(*b13_work(
            n, g, cidx.shape[0], mesh.size, rounds,
            min(kw.get("top_r", 64), n // mesh.size))), b1, rounds))
    his, eps = bs._jitter_his(), bs._price_eps()
    for i, (mesh, args, kw, _) in enumerate(joint):
        g = kw["g"]
        got = sh.solve_batch_sharded(mesh, *clone_parts(args), **kw)
        want = sh.solve_batch_sharded_ref(mesh, *clone_parts(args), **kw)
        full = [sh.gather_rows(a, dim=0 if j < 2 else 1)
                for j, a in enumerate(args[:4])]
        ask, k, seeds, cidx, cdelta = args[4:]
        tgc = k.float()
        one = bs.solve_batch(full[0].clone(), *full[1:], ask, k, tgc, seeds,
                             cidx, cdelta, g=g)
        torch.cuda.synchronize()
        gu, gc = sh.gather_rows(got[0]), sh.gather_rows(got[1], dim=1)
        e = max_diff([(gu, sh.gather_rows(want[0])),
                      (gc, sh.gather_rows(want[1], dim=1)),
                      (got[2], want[2]), (got[3], want[3])])
        if e:
            raise AssertionError(f"sharded solve launch {i}: B14 differs "
                                 f"from the plain version by {e}")
        err["joint"] = max(err["joint"], e)
        if not (torch.equal(gc, one[1]) and torch.equal(gu, one[0])
                and torch.equal(got[2][2:], one[2][2:])):
            raise AssertionError(f"sharded solve launch {i}: B14 differs "
                                 f"from single-device solve_batch")
        n = full[0].shape[0]
        ms = cuda_time_ms(torch, lambda a: sh.solve_batch_sharded(
            mesh, *a, **kw), setup=lambda: clone_parts(args), reps=5)
        plain = cuda_time_ms(torch, lambda a: sh.solve_batch_sharded_ref(
            mesh, *a, **kw), setup=lambda: clone_parts(args), reps=1,
            warmup=1) if plain_too else None
        one_ms = cuda_time_ms(torch, lambda u: bs.solve_batch(
            u, *full[1:], ask, k, tgc, seeds, cidx, cdelta, g=g),
            setup=full[0].clone, reps=5)
        # the whole launch's work, each input read and each output written
        # once: the greedy arm's (B13's work, its pools among it), the
        # restarts' rounds and gathered pools, their fold_in draws, the
        # arm scores and the pick, the info row and the gather count
        folded = scatter_add_ref(full[0].clone(), cidx, cdelta).clamp_min(0.0)
        ev_kw = {key: sh.gather_rows(kw[key]) for key in ("evict", "net_prio")
                 if kw.get(key) is not None}
        a_ops, run, _ = auction_ops(torch, folded, full[1], full[2], full[3],
                                 ask, k, jitter_fold(seeds, n, his), eps,
                                 kw.get("rounds", 64), **ev_kw)
        greedy_rounds = int(got[3]) - sum(run) - len(run) - 1
        n_bytes, ops = b13_work(n, g, cidx.shape[0], mesh.size,
                                greedy_rounds,
                                min(kw.get("top_r", 64), n // mesh.size))
        n_bytes += (pool_bytes(mesh.size, sum(run),
                               g * min(16, n // mesh.size)) + 28
                    + (n * 20 if ev_kw else 0))
        ops += (a_ops + len(his) * g * (n + 1) * 120
                + (len(eps) + 1) * n * (g + 60))
        rec["joint"].append((ms, plain, bound(n_bytes, ops), one_ms,
                             int(got[3])))
    n_b, n_j = len(bulk), len(joint)

    def plain_mean(key):
        return (mean(r[1] for r in rec[key]) if plain_too
                else float("nan"))

    print(f"shard runs  [{card}] the sharded C2M path's {n_b} launches: B13 "
          f"exact against the plain version and single-device B1 on each; "
          f"per launch (mean) B13 {mean(r[0] for r in rec['bulk']):.4f} ms, "
          f"B1 at the same inputs {mean(r[3] for r in rec['bulk']):.4f} ms, "
          f"plain {plain_mean('bulk'):.4f} ms, all-gathers "
          f"{[r[4] for r in rec['bulk']]}; {n_b} launches "
          f"{sum(r[0] for r in rec['bulk']):.4f} ms of device time = "
          f"{100.0 * sum(r[0] for r in rec['bulk']) / 1e3 / wall_bulk:.2f}% "
          f"of the path's {wall_bulk:.3f} s wall")
    print(f"shard runs  [{card}] the sharded tpu-solve path's {n_j} launches: "
          f"B14 exact against the plain version and single-device "
          f"solve_batch on each; per launch (mean) B14 "
          f"{mean(r[0] for r in rec['joint']):.4f} ms, solve_batch at the "
          f"same inputs {mean(r[3] for r in rec['joint']):.4f} ms, plain "
          f"{plain_mean('joint'):.4f} ms, gathers "
          f"{[r[4] for r in rec['joint']]}; {n_j} launches "
          f"{sum(r[0] for r in rec['joint']):.4f} ms = "
          f"{100.0 * sum(r[0] for r in rec['joint']) / 1e3 / wall_joint:.2f}% "
          f"of the path's {wall_joint:.3f} s wall")
    out = []
    for name, key, src, repl in (
            ("bulk_shard", "bulk", "nomad_tpu_torch/csrc/sharded.cu",
             "nomad_tpu/tensor/sharding.py:198"),
            ("joint_shard", "joint", "nomad_tpu_torch/csrc/sharded.cu",
             "nomad_tpu/tensor/sharding.py:368")):
        v = rec[key]
        by = Counter(r[2][1] for r in v).most_common(1)[0][0]
        out.append({"name": name, "source": src, "replaces": repl,
                    "max_abs_err": err[key], "ms": mean(r[0] for r in v),
                    "plain_ms": plain_mean(key),
                    "bound_ms": mean(r[2][0] for r in v), "bound_by": by,
                    "library_ms": None,
                    "single_ms": mean(r[3] for r in v)})
    return out


def phase_b15_replay(torch, card, bulk):
    """B15 on each of the sharded C2M path's launches, replayed at its
    corrections: the launch the path makes (the correction fold,
    ``_scatter_launch(clamp=True)``: the adds, then max(., 0) over every
    row of the shard) exact against its plain version and timed, host
    issue and device-only; then ``state_scatter_sharded`` (the adds
    alone, the many-CTA kernel) exact and timed beside ``index_add_`` on
    the full carry, both readings. Returns B15's record: the fold's
    numbers, with the adds' under ``without_clamp``."""
    from nomad_tpu_torch.tensor import sharding as sh

    torch.cuda.synchronize()
    mean = statistics.fmean
    rows, err = [], 0.0
    for i, (mesh, args, _, _) in enumerate(bulk):
        cidx, cdelta = args[7:9]
        full = sh.gather_rows(args[0])
        b, n = cidx.shape[0], full.shape[0]

        def parts():
            return clone_parts([args[0]])[0]

        def fold(u):
            sh._scatter_launch(mesh, u, cidx, cdelta, clamp=True)

        def fold_ref(u):
            sh.state_scatter_sharded_ref(mesh, u, cidx, cdelta, clamp=True)

        def add(u):
            sh.state_scatter_sharded(mesh, u, cidx, cdelta)

        def add_ref(u):
            sh.state_scatter_sharded_ref(mesh, u, cidx, cdelta)

        got, want, got_a, want_a = parts(), parts(), parts(), parts()
        fold(got)
        fold_ref(want)
        add(got_a)
        add_ref(want_a)
        torch.cuda.synchronize()
        e = max_diff([(sh.gather_rows(got), sh.gather_rows(want)),
                      (sh.gather_rows(got_a), sh.gather_rows(want_a))])
        if e:
            raise AssertionError(f"sharded path launch {i}: B15 differs "
                                 f"from the plain version by {e}")
        err = max(err, e)
        idx64 = cidx.to(torch.int64)
        touched = len(set(cidx.tolist()))
        u_fold, u_add, u_lib = parts(), parts(), full.clone()
        rows.append({
            "ms": cuda_time_ms(torch, fold, setup=parts),
            "device_ms": device_only_ms(torch, lambda: fold(u_fold)),
            "plain_ms": cuda_time_ms(torch, fold_ref, setup=parts, reps=5),
            # each input read once (idx, delta, the carry) and the carry
            # written once: the clamp reads and writes every row
            "bound": bound(b * 4 + b * 16 + 2 * n * 16, b * 4 + n * 4),
            "add_ms": cuda_time_ms(torch, add, setup=parts),
            "add_device_ms": device_only_ms(torch, lambda: add(u_add)),
            "add_plain_ms": cuda_time_ms(torch, add_ref, setup=parts,
                                         reps=5),
            "add_bound": bound(b * 4 + b * 16 + 2 * touched * 16, b * 4),
            "lib_ms": cuda_time_ms(torch, lambda u: u.index_add_(
                0, idx64, cdelta), setup=full.clone),
            "lib_device_ms": device_only_ms(
                torch, lambda: u_lib.index_add_(0, idx64, cdelta)),
        })

    def avg(key):
        return mean(r[key] for r in rows)

    def most(key):
        return Counter(r[key][1] for r in rows).most_common(1)[0][0]

    mesh, args = bulk[0][:2]
    print(f"B15 path    [{card}] the sharded C2M path's {len(rows)} "
          f"launches' corrections ({args[7].shape[0]} slots, S {mesh.size} "
          f"on {mesh.cards} card(s)), exact against the plain version; per "
          f"launch (mean): the path's fold (adds, then clamp) "
          f"{avg('ms'):.4f} ms host issue, {avg('device_ms'):.4f} ms "
          f"device-only, plain {avg('plain_ms'):.4f} ms; the adds alone "
          f"(state_scatter_sharded) {avg('add_ms'):.4f} / "
          f"{avg('add_device_ms'):.4f} ms, index_add_ on the full carry "
          f"{avg('lib_ms'):.4f} / {avg('lib_device_ms'):.4f} ms")
    return {"name": "scatter_shard",
            "source": "nomad_tpu_torch/csrc/sharded.cu",
            "replaces": "nomad_tpu/tensor/sharding.py:213",
            "max_abs_err": err, "ms": avg("ms"), "plain_ms": avg("plain_ms"),
            "bound_ms": mean(r["bound"][0] for r in rows),
            "bound_by": most("bound"), "library_ms": None,
            "device_ms": avg("device_ms"),
            "without_clamp": {
                "replaces": "nomad_tpu/tensor/sharding.py:144",
                "ms": avg("add_ms"), "device_ms": avg("add_device_ms"),
                "plain_ms": avg("add_plain_ms"),
                "bound_ms": mean(r["add_bound"][0] for r in rows),
                "bound_by": most("add_bound"), "library_ms": avg("lib_ms"),
                "library_device_ms": avg("lib_device_ms")}}


def phase_sharded_parity(torch, card):
    """A pinned one-thread workload at 10,240 nodes, 8 jobs x 4,000
    (tpu-binpack) and 8 joint evals of 800 cycling the solve asks
    (tpu-solve), on a fresh service with no mesh and with 2, 4 and 8
    shards: the same fingerprint at every S."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.testing import Harness

    prints, notes = {}, []
    for s_n in (1,) + SHARDS:
        h = Harness(device="cuda")
        mock.build_nodes(h.store, N_NODES, seed=0)
        jobs = []
        with mesh_service(torch, s_n) as svc:
            for i in range(2 * PARITY_JOBS):
                joint = i >= PARITY_JOBS
                cpu, mem = SOLVE_ASKS[i % len(SOLVE_ASKS)] if joint else (50,
                                                                          32)
                j = mock.service_job(SOLVE_K if joint else K, cpu=cpu,
                                     mem=mem, batch=True)
                j.id = j.name = f"shard-parity-{i}"
                h.store.upsert_job(j)
                jobs.append(j)
                h.process(mock.eval_for(j, id=f"shard-parity-ev-{i}"),
                          SchedulerConfiguration(scheduler_algorithm=(
                              enums.SCHED_ALG_TPU_SOLVE if joint
                              else enums.SCHED_ALG_TPU_BINPACK)))
            stats = dict(svc.stats)
        want = PARITY_JOBS * (K + SOLVE_K)
        path_gates(h, jobs, want, f"parity S={s_n}")
        if stats["sharded"] != (stats["launches"] if s_n > 1 else 0):
            raise AssertionError(f"parity S={s_n}: stats {stats}")
        prints[s_n] = fingerprint(h, jobs)
        notes.append(f"S {s_n}: {stats['launches']} launches, all-gathers "
                     f"{stats['allgathers']}")
    for s_n in SHARDS:
        if prints[s_n] != prints[1]:
            bad = [j for j in prints[1] if prints[s_n][j] != prints[1][j]]
            raise AssertionError(f"parity: S={s_n} differs from no mesh on "
                                 f"{bad}")
    print(f"parity      [{card}] the same fingerprint (per-job counts, "
          f"per-node multisets, scores) at S 1, 2, 4, 8 on {N_NODES} nodes, "
          f"{PARITY_JOBS} x {K} tpu-binpack + {PARITY_JOBS} x {SOLVE_K} "
          f"tpu-solve, one thread; " + "; ".join(notes))


B16_VARIANTS = ("cfg3", "targets", "distinct", "worstfit", "infeasible")


def c2m_task_group_args(rng):
    """The per-eval solve at the C2M width: build_nodes capacities of
    10,240 nodes padded to 16,384, usage filled 0-60%, K 512 of (cpu 50,
    mem 32) with a rack spread over 20 values, and a tie_perm."""
    n, real, k = N_PAD, N_NODES, 512
    avail = np.zeros((n, 4))
    avail[:real] = c2m_capacity()
    used = np.zeros((n, 4))
    used[:real, :2] = np.floor(avail[:real, :2] * rng.uniform(
        0, 0.6, (real, 1)))
    feas = np.arange(n) < real
    svid = (np.arange(n) % 20)[None, :]
    sok = feas[None, :].copy()
    return (avail, used, np.zeros(n), np.zeros(n),
            np.array([50.0, 32.0, 0.0, 0.0]), feas, np.zeros(n),
            np.zeros(n), np.full(k, -1), np.ones(k, bool), svid, sok,
            np.zeros((1, 32)), np.full((1, 32), np.nan), np.zeros(1, bool),
            np.ones(1), np.zeros((0, n)), np.zeros((0, n), bool),
            np.zeros((0, 1)), np.zeros(0), -1.0, float(k), False, False,
            False, rng.permutation(n))


def same_bits(torch, got, want) -> bool:
    """Choices, founds and score bits equal."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2].view(torch.int32),
                            want[2].view(torch.int32)))


def b16_solve(sh, mesh, args):
    """One B16 solve, gated: one host call, one launch a card of the
    mesh and no other launch."""
    from nomad_tpu_torch import _ext

    before = _ext.COUNTS.snapshot()["launches"]
    out = sh.solve_task_group_sharded(mesh, args)
    after = _ext.COUNTS.snapshot()["launches"]
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    if launched != {"task_group_shard": mesh.cards}:
        raise AssertionError(f"B16 on {mesh}: launched {launched}, not one "
                             f"launch a card")
    return out


def phase_task_group_shard(torch, dev, card, rng):
    """B16 against single-device B9 (bit for bit) at S = 2, 4, 8 on the
    five cfg3 variants and at the C2M width, one launch a card a solve,
    and against its plain version; timed at cfg3, S 4, beside B9."""
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import (pack_solve_tensors,
                                                solve_task_group)

    err, notes, main, plain_ms = 0.0, [], None, None
    for variant in B16_VARIANTS:
        args = tuple(torch.as_tensor(a).to(dev)
                     for a in cfg3_args(rng, variant))
        want = solve_task_group(*args)
        for s_n in SHARDS:
            got = b16_solve(sh, mesh_of(s_n), args)
            if not same_bits(torch, got, want):
                diff = int((got[0] != want[0]).sum())
                raise AssertionError(f"B16 {variant} S={s_n}: differs from "
                                     f"B9 ({diff} choices)")
        s_plain = PATH_SHARDS if variant == "cfg3" else 2
        mesh = mesh_of(s_plain)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = sh.solve_task_group_sharded_ref(
            mesh, sh.shard_solve_args(mesh, args))
        end.record()
        end.synchronize()
        if variant == "cfg3":
            main, plain_ms = args, start.elapsed_time(end)
        got = b16_solve(sh, mesh, args)
        if not (torch.equal(got[0], plain[0])
                and torch.equal(got[1], plain[1])):
            raise AssertionError(f"B16 {variant} S={s_plain}: choices or "
                                 f"founds differ from the plain version")
        err = max(err, score_err(got[2], plain[2], f"B16 {variant}"))
        notes.append(f"{variant} {int(want[1].sum())}/{CFG3_K}")
    args = tuple(torch.as_tensor(a).to(dev) for a in c2m_task_group_args(rng))
    want = solve_task_group(*args)
    if not same_bits(torch, b16_solve(sh, mesh_of(8), args), want):
        raise AssertionError("B16 at the C2M width, S 8: differs from B9")
    mesh = mesh_of(PATH_SHARDS)
    ms = cuda_time_ms(torch, lambda _: sh.solve_task_group_sharded(mesh,
                                                                   main),
                      reps=5, warmup=1)
    b9_ms = cuda_time_ms(torch, lambda _: solve_task_group(*main), reps=5,
                         warmup=1)
    b_ms, b_by = scan_bound(pack_solve_tensors(*main[:25],
                                               node_col=main[25]))
    print(f"B16 shard   [{card}] bit-equal to B9 at S {SHARDS} on "
          f"{len(B16_VARIANTS)} cfg3 variants (found "
          f"{', '.join(notes)}) and at the "
          f"C2M width ({N_PAD} nodes, S 8, {int(want[1].sum())}/512 "
          f"found), one launch a card a solve; against the plain version "
          f"choices and founds exact, scores within {SCORE_TOL} (max "
          f"{err:.3g}); at cfg3, S {PATH_SHARDS}: kernel {ms:.4f} ms a "
          f"solve ({mesh.cards} launch(es)), B9 {b9_ms:.4f} ms "
          f"({ms / b9_ms:.2f}x), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by})")
    return {"name": "solve_task_group_sharded", "source":
            "nomad_tpu_torch/csrc/task_group_shard.cu",
            "replaces": "nomad_tpu/tensor/sharding.py:107",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_entry(torch, card):
    """The port's entry points on the card: entry()'s solve, then
    dryrun_multichip at 2, 4 and 8 shards; after the run, B16 at the
    dryruns' own shapes against its plain version and B9. Returns the
    launch counts of the run and B16's largest score difference."""
    from nomad_tpu_torch import _ext
    from nomad_tpu_torch.graft_entry import (_example_solve_args,
                                             dryrun_multichip, entry)
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import solve_task_group

    _ext.COUNTS.reset()
    t0 = time.perf_counter()
    fn, args = entry()
    choices, founds, scores = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = args[8].shape[0]
    if ([tuple(o.shape) for o in (choices, founds, scores)] != [(k,)] * 3
            or not choices.is_cuda or not bool(founds.all())):
        raise AssertionError(f"entry: {choices}, {founds}, {scores}")
    notes = [f"entry {wall:.3f} s, {int(founds.sum())}/{k} found"]
    b16_calls = 0  # each dryrun solves on its mesh and on one shard
    for s_n in SHARDS:
        mesh = mesh_of(s_n)
        b16_calls += mesh.cards + 1
        t0 = time.perf_counter()
        dryrun_multichip(s_n)
        torch.cuda.synchronize()
        notes.append(f"{s_n} shards on {mesh.cards} card(s) "
                     f"{time.perf_counter() - t0:.3f} s")
    counts = _ext.COUNTS.snapshot()
    for name in ("solve_task_group", "task_group_shard", "bulk_shard",
                 "bulk_fill"):
        if not counts["launches"][name]:
            raise AssertionError(f"entry: {name} never launched: "
                                 f"{counts['launches']}")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    if counts["launches"]["task_group_shard"] != b16_calls:
        raise AssertionError(f"entry: B16 launched "
                             f"{counts['launches']['task_group_shard']} "
                             f"times, one a card a solve is {b16_calls}")
    # B16 at the path's own shapes (32, 32 and 64 nodes at S 2, 4, 8, K 8:
    # most of a CTA's warps idle), after the snapshot: against its plain version
    # and bit for bit against B9
    err = 0.0
    for s_n in SHARDS:
        mesh = mesh_of(s_n)
        small = _example_solve_args(n_nodes=max(8 * s_n, 32), k=8)
        got = sh.solve_task_group_sharded(mesh, small)
        plain = sh.solve_task_group_sharded_ref(
            mesh, sh.shard_solve_args(mesh, small))
        if not (torch.equal(got[0], plain[0])
                and torch.equal(got[1], plain[1])):
            raise AssertionError(f"B16 entry shape S={s_n}: choices or "
                                 f"founds differ from the plain version")
        err = max(err, score_err(got[2], plain[2], f"B16 entry S={s_n}"))
        if not same_bits(torch, got, solve_task_group(*small,
                                                      device="cuda")):
            raise AssertionError(f"B16 entry shape S={s_n}: differs from "
                                 f"B9")
    notes.append(f"B16 at the dryruns' shapes, S {SHARDS}: bit-equal to "
                 f"B9, against the plain version choices and founds "
                 f"exact, scores within {SCORE_TOL} (max {err:.3g})")
    # one B16 solve at dryrun_multichip(8)'s own shape, from host arrays
    mesh, small = mesh_of(8), _example_solve_args(n_nodes=64, k=8)
    small_ms = cuda_time_ms(
        torch, lambda _: sh.solve_task_group_sharded(mesh, small), reps=5,
        warmup=1)
    notes.append(f"one B16 solve at dryrun_multichip(8)'s shape (64 "
                 f"nodes, K 8, S 8) {small_ms:.4f} ms")
    print(f"entry       [{card}] {'; '.join(notes)}; B16 launches "
          f"{counts['launches']['task_group_shard']}, B9 "
          f"{counts['launches']['solve_task_group']}, B13 "
          f"{counts['launches']['bulk_shard']}, B1 "
          f"{counts['launches']['bulk_fill']}; no plain version on CUDA")
    return counts["launches"], err


def sharded_only(torch, dev, card, rng) -> int:
    """``--sharded``: phases 21 (the sharded kernels), 25 and 26 alone, on
    meshes over every visible card; prints B16's record and the
    summary."""
    print(f"cards       {torch.cuda.device_count()}: meshes "
          f"{', '.join(repr(mesh_of(s_n)) for s_n in SHARDS)}")
    phase_barrier(torch, dev, card)
    phase_sharded_kernels(torch, dev, card)
    phase_sharded_twin(torch, card)
    b16 = phase_task_group_shard(torch, dev, card, rng)
    launches, err = phase_entry(torch, card)
    b16.update(route="cuda", launches=launches["task_group_shard"],
               max_abs_err=max(b16["max_abs_err"], err))
    print(json.dumps({"kernels": [b16]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shard_times(torch, card) -> int:
    """``--shard-times``: the sharded C2M and tpu-solve paths through a
    4-shard mesh service, their launches replayed exact against the
    plain versions and single-device B1 / solve_batch, and B13, B14, B1
    and solve_batch timed on them, through wrappers that this tree and
    its parent (53e33be) both have: this script copied into another
    checkout times that checkout's B13 and B14 in the same call. Prints
    one JSON line of ms (walls in s)."""
    _, wall_b, bulk, _, _ = run_sharded_path(torch, card)
    _, wall_j, joint, _, _ = run_sharded_solve_path(torch, card)
    b13, b14 = phase_sharded_replay(torch, card, bulk, joint, wall_b, wall_j,
                                    plain_too=False)
    print(json.dumps({"b13": b13["ms"], "b1": b13["single_ms"],
                      "b14": b14["ms"], "solve_batch": b14["single_ms"],
                      "wall_c2m": wall_b, "wall_solve": wall_j}))
    print(card)
    return 0


def kernel_times(torch, dev, card, rng) -> int:
    """``--kernel-times``: B7 at cfg4's shape (N_pad 1,024, K 512, V 512)
    and at the C2M width ("main", N_pad 16,384, K 512, V 8), B11' at n
    16,384, B9 at cfg3, B11 on its seven variants at N_pad 16,384, B16 at
    cfg3, S 4 beside B9 on the same inputs, and B1 (solve_bulk_multi)
    beside B13 at S 4 on phase 5's inputs, B5 alone (``b5_*``), the
    whole solve_batch (``b6_*``) and the pick alone on B5's restarts and
    B1's greedy arm (``b6p_*``) at the tpu-solve path's shape (N_pad
    4,096, G 16) and at "main" and "wide" (N_pad 16,384), B3'
    (jitter_fold, 5 x 16 x 4,096) by events and device-only
    (``b3p_device``), and B12 at the C2M width (``b12_c2m``, K 512) and
    its set-up pass alone (``b12_c2m_setup``: no feasible node), each
    exact against its plain version (B16 bit-equal to B9, B13 to B1's
    counts) and timed, through wrappers that this tree and its parent
    (d428029) both have (B5 through auction_runner), so this script
    copied into another checkout times that checkout's kernels. Prints
    one JSON line of ms."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import kernels
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.prng import (jitter_fold, jitter_fold_ref,
                                             permutation, permutation_ref)

    times = {}
    # B5 and solve_batch on inputs of their own seed: the same in any tree
    srng = np.random.default_rng(13)
    his, eps = bs._jitter_his(), bs._price_eps()
    for variant in ("path", "main", "wide"):
        t = solve_inputs(torch, dev, srng, variant)
        n = t["avail"].shape[0]
        a_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"])
        run = auction_runner(torch, bs, t["used"], a_args, t["seeds"], his,
                             eps, rounds=t["rounds"])
        check_auction(torch, bs, run(), t["used"], a_args,
                      jitter_fold_ref(t["seeds"], n, his), eps, variant,
                      rounds=t["rounds"])
        times[f"b5_{variant}"] = cuda_time_ms(torch, lambda _: run(), reps=5)
        s_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"],
                  t["tgc"], t["seeds"], t["cidx"], t["cdelta"])
        got = bs.solve_batch(t["used"].clone(), *s_args, g=G,
                             rounds=t["rounds"])
        want = bs.solve_batch_ref(t["used"].clone(), *s_args, g=G,
                                  rounds=t["rounds"])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"solve_batch {variant}: differs from the "
                                 f"plain version")
        times[f"b6_{variant}"] = cuda_time_ms(
            torch, lambda u: bs.solve_batch(u, *s_args, g=G,
                                            rounds=t["rounds"]),
            setup=t["used"].clone, reps=5)
        times[f"b6_{variant}_rounds"] = int(got[2][4])
        # the pick alone, on this variant's restarts and greedy arm
        used_g = torch.clamp_min(t["used"], 0.0)
        counts_g = kernels.bulk_fill(used_g, *a_args, t["seeds"])
        p_args = (t["avail"], *run(), used_g, counts_g)
        check_pick(torch, bs, bs.batch_pick(*p_args), p_args, variant)
        times[f"b6p_{variant}"] = cuda_time_ms(
            torch, lambda _: bs.batch_pick(*p_args), reps=20)
        if variant == "path":
            seeds = t["seeds"]
    times["b3p_path"] = cuda_time_ms(
        torch, lambda _: jitter_fold(seeds, PATH_PAD, his), reps=20)
    times["b3p_device"] = device_only_ms(
        torch, lambda: jitter_fold(seeds, PATH_PAD, his))
    for name, host in (
            ("b7_cfg4", preempt_inputs(rng, "main", n_pad=CFG4_NODES,
                                       n_real=CFG4_NODES, v=512)),
            ("b7_c2m", preempt_inputs(rng, "main"))):
        args = on_card(torch, host, dev)
        got = kernels.preempt_solve(*args)
        check_preempt(torch, got, kernels.preempt_solve_ref(*args), name)
        times[name] = cuda_time_ms(
            torch, lambda _: kernels.preempt_solve(*args), reps=10)
        times[f"{name}_placed"] = int((got[0] >= 0).sum())
    if not torch.equal(permutation(COLLIDING_SEED, N_PAD, dev),
                       permutation_ref(COLLIDING_SEED, N_PAD, dev)):
        raise AssertionError("B11' 16,384: differs from the plain version")
    times["b11p_16384"] = cuda_time_ms(
        torch, lambda _: permutation(COLLIDING_SEED, N_PAD, dev), reps=20)
    main = [a.to(dev) for a in cfg3_packed(rng, "cfg3")]
    got = kernels.solve_task_group_fused(*main)
    want = kernels.solve_task_group_fused_ref(*main)
    torch.cuda.synchronize()
    if not (torch.equal(got[:2], want[:2])):
        raise AssertionError("B9 cfg3: differs from the plain version")
    score_err(got[2], want[2], "B9 cfg3")
    times["b9_cfg3"] = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group_fused(*main), reps=10)
    for variant in B11_VARIANTS:
        form, host, scalars = b11_inputs(rng, variant)
        run = b11_runner(torch, dev, form, host, scalars)
        got = run()
        want = b11_runner(torch, dev, form, host, scalars, plain=True)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B11 {variant}: differs from the plain "
                                 f"version")
        times[f"b11_{variant}"] = cuda_time_ms(torch, lambda _: run(),
                                               reps=5)
        times[f"b11_{variant}_steps"] = -(-int(got.sum()) // 256)
    args = tuple(torch.as_tensor(a).to(dev) for a in cfg3_args(rng, "cfg3"))
    mesh = mesh_of(PATH_SHARDS)
    if not same_bits(torch, sh.solve_task_group_sharded(mesh, args),
                     kernels.solve_task_group(*args)):
        raise AssertionError("B16 cfg3: differs from B9")
    times["b16_cfg3_s4"] = cuda_time_ms(
        torch, lambda _: sh.solve_task_group_sharded(mesh, args), reps=5,
        warmup=1)
    times["b9_cfg3_args"] = cuda_time_ms(
        torch, lambda _: kernels.solve_task_group(*args), reps=5, warmup=1)
    # B1 (one solve_bulk_multi: the fold, the jitter and the fill) and B13
    # at S 4 on one card, on phase 5's C2M-width inputs
    t = b1_inputs(torch, dev, rng)
    rest = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"], t["tgc"],
            t["seeds"], t["cidx"], t["cdelta"])
    got = kernels.solve_bulk_multi(t["used"].clone(), *rest, g=G)
    want = kernels.solve_bulk_multi_ref(t["used"].clone(), *rest, g=G)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("B1: differs from the plain version")
    times["b1_c2m"] = cuda_time_ms(
        torch, lambda u: kernels.solve_bulk_multi(u, *rest, g=G),
        setup=t["used"].clone, reps=10)
    parts, _ = shard_args(mesh, t)
    tail = (t["ask"], t["k"], t["seeds"], t["cidx"], t["cdelta"])
    got13 = sh.solve_bulk_multi_sharded(mesh, *clone_parts(parts), *tail,
                                        g=G)
    if not torch.equal(sh.gather_rows(got13[1], dim=1), want[1]):
        raise AssertionError("B13: differs from B1's plain version")
    times["b13_c2m_s4"] = cuda_time_ms(
        torch, lambda p: sh.solve_bulk_multi_sharded(mesh, *p, *tail, g=G),
        setup=lambda: clone_parts(parts), reps=10)
    # B12 at the C2M width, and its set-up pass alone (no feasible node:
    # every step exits early)
    for name, variant in (("b12_c2m", "main"),
                          ("b12_c2m_setup", "infeasible")):
        args = [torch.tensor(a, device=dev)
                for a in _pick_from(preempt_inputs(rng, variant))]
        got = kernels.preempt_pick(*args)
        if not torch.equal(got, kernels.preempt_pick_ref(*args)):
            raise AssertionError(f"B12 {variant}: differs from the plain "
                                 f"version")
        times[name] = cuda_time_ms(
            torch, lambda _: kernels.preempt_pick(*args), reps=10)
        times[f"{name}_placed"] = int((got >= 0).sum())
    print(f"kernel times [{card}] " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in times.items()))
    print(json.dumps(times))
    print(card)
    return 0


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
    from nomad_tpu_torch.structs import enums

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
    if sys.argv[1:] == ["--sharded"]:
        return sharded_only(torch, dev, card, rng)
    if sys.argv[1:] == ["--b5-split"]:
        return b5_split(torch, dev, card, rng)
    if sys.argv[1:] == ["--launch-split"]:
        phase_launch_split(torch, dev, card)
        print(card)
        return 0
    if sys.argv[1:] == ["--kernel-times"]:
        return kernel_times(torch, dev, card, rng)
    if sys.argv[1:] == ["--shard-times"]:
        return shard_times(torch, card)
    if sys.argv[1:] == ["--server"]:
        return server_only(torch, card)
    if sys.argv[1:] == ["--devices"]:
        return devices_only(torch, dev, card, rng)
    bulk = [phase_jitter(torch, dev, card, rng),
            phase_scatter(torch, dev, card, rng),
            phase_fill(torch, dev, card, rng)]
    phase_fill_wide(torch, dev, card, rng)
    per_eval = [phase_score_once(torch, dev, card, rng),
                phase_scan(torch, dev, card, rng)]
    phase_jitter_fold(torch, dev, card, rng)
    phase_solve(torch, dev, card, rng)
    launches, wall = phase_path(torch, card)
    for k in bulk:
        k["launches"] = launches[k["name"]]
    arms = phase_server(torch, card, wall)
    server = {"server": arms["1"][1], "server_incr0": arms["0"][1]}
    server["binpack"] = phase_binpack(torch, card)
    launches = phase_spread(torch, card)
    for k in per_eval:
        k["launches"] = launches[k["name"]]
    _, server["devices"], b9_devices = phase_devices(torch, card)
    per_eval.append(b9_devices)
    launches, server["constraints"] = phase_constraints(torch, card)
    bulk[2]["constraints_launches"] = launches["bulk_fill"]
    launches, wall, captured = phase_solve_path(torch, card)
    joint = phase_solve_launches(torch, card, wall, captured)
    for k in joint:
        k["launches"] = launches[k["name"]]
    for incr, key in (("1", "server_solve"), ("0", "server_solve_incr0")):
        server[key] = phase_server_solve(torch, card, wall, incr=incr)[1]
    # B4 is off the Harness C2M path (B1 folds the corrections): its
    # launches are solve_batch's folds on the tpu-solve path and, on the
    # Server's fed arm, the feed's twin flushes and the twin route's folds
    bulk[1]["launches"] += launches["scatter_add"]
    bulk[1]["launches"] += arms["1"][0]["scatter_add"]
    bulk[1]["server_launches"] = arms["1"][0]["scatter_add"]
    bulk[1]["twin"] = arms["1"][1]["b4_timed"]
    pick = phase_preempt_kernels(torch, dev, card, rng)
    launches, captured, cfg4 = phase_cfg4(torch, card)
    preempt = [phase_cfg4_replay(torch, card, captured), pick]
    for k in preempt:
        k["launches"] = launches[k["name"]]
    phase_cutover(torch, dev, card, rng)
    perm = phase_tie_perm(torch, dev, card, rng)
    phase_b11(torch, dev, card, rng)
    launches, _, captured, _, first = phase_large_groups(torch, card)
    large = phase_large_replay(torch, card, captured)
    for k in large:
        k["launches"] = launches[k["name"]]
    large[1]["by_n"] = perm
    phase_large_parity(card, first)
    phase_bulk_preempt(torch, card)
    phase_parity(enums.SCHED_ALG_TPU_BINPACK)
    phase_parity(enums.SCHED_ALG_TPU_SOLVE)
    phase_spread_parity()
    phase_cfg4_parity(card, cfg4)
    phase_barrier(torch, dev, card)
    phase_sharded_kernels(torch, dev, card)
    phase_sharded_twin(torch, card)
    launches_b, wall_b, bulk_runs = phase_sharded_path(torch, card)
    launches_j, wall_j, joint_runs = phase_sharded_solve_path(torch, card)
    sharded = phase_sharded_replay(torch, card, bulk_runs, joint_runs,
                                   wall_b, wall_j)
    sharded.append(phase_b15_replay(torch, card, bulk_runs))
    sharded[0]["launches"] = launches_b["bulk_shard"]
    sharded[1]["launches"] = launches_j["joint_shard"]
    sharded[2]["launches"] = launches_b["scatter_shard"]
    phase_sharded_parity(torch, card)
    b16 = phase_task_group_shard(torch, dev, card, rng)
    launches, err = phase_entry(torch, card)
    b16["launches"] = launches["task_group_shard"]
    b16["max_abs_err"] = max(b16["max_abs_err"], err)
    sharded.append(b16)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    kernels = bulk + per_eval + joint + preempt + large + sharded
    for k in kernels:
        k["route"] = "cuda"
    extra = ("device_ms", "library_device_ms", "without_clamp",
             "ms_per_step", "setup_ms", "by_n", "server_launches", "twin",
             "by_d", "constraints_launches")
    print(json.dumps({"server": server}))
    print(json.dumps({"kernels": [{key: k[key] for key in order + extra
                                   if key in k} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
